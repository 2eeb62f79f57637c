"""Stage: run the WHOLE pipeline DAG from one config file.

Counterpart of `kmsr_tpu.pipeline.run_all`: the same JSON config (every
stage block maps 1:1 onto that stage's CLI flags, `--flag-name` ->
"flag_name"; `enabled: false` skips a stage), the same stage order,
enable rules and validation errors, and the same `--resume` markers
(`<workdir>/.stages/<stage>.json`, each recording its argv and the keys
of every stage before it). The stages are this package's own CLIs, each
given the JAX package's argv; every stage whose CLI takes `--device`
(denoise, the kernel trainer, factory / apply_kernel, the SR stages) gets
`--device DEVICE` appended, cuda by default.

    [calibrate] -> cut -> denoise -> noise_pool
        -> train_kernel(single|fleet|dynamic|moe)
        -> factory (fused C_30+E_) | apply_kernel + make_train_data
        -> check_shapes -> [sr_train -> sr_infer] -> analyze

trainer "fleet" runs the reference's actual single-kernel workflow, one
kernel PER scene (`train.fleet`), and the factory / apply stage degrades
each scene's patches with ITS kernel (`--kernel-root`); trainer "single"
pools all scenes' patches into one kernel.

The JAX package enables its persistent compilation cache here; the port
has no counterpart: its CUDA kernels are built once into
`kmsr_tpu_torch/kernels/_build/` and reused by every later process.

Usage:
    python -m kmsr_tpu_torch.pipeline.run_all --write-config pipeline.json
    python -m kmsr_tpu_torch.pipeline.run_all --config pipeline.json \
        [--workdir RUNDIR] [--from-stage denoise] [--only cut,denoise] \
        [--resume] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import copy
import glob
import hashlib
import json
import os
import time

from ..device import resolve_device, set_cublas_workspace_config

#: Template config, equal to the JAX package's.
DEFAULT_CONFIG: dict = {
    "workdir": "kmsr_run",
    "input_dir": "scenes",  # calibrated 5-band .nc scenes (geophysical_data)
    "lr_input_dir": None,  # native-LR sensor scenes (GOCI-like) for the
    #   cut_lr stage; with trainer "fleet" + train_kernel.real_is_lr the
    #   fleet D's real side is per-scene pools of these patches
    "landsat_root": None,  # raw Landsat C2 L1 scene dirs; used by calibrate
    "trainer": "single",  # single | fleet (per-scene kernels) | dynamic | moe
    "kernel_file": None,  # pre-trained kernel .npy for the factory stage
    "use_fused_factory": True,  # one device pass (C_30+E_); else apply+make
    "stages": {
        "calibrate": {
            "enabled": False,  # on: TIF+MTL under landsat_root -> workdir
            "mode": "rad",
            "bands": [1, 2, 3, 4, 5],
        },
        "cut": {
            "enabled": True,
            "patch_size": 256,
            "stride_ratio": 0.5,
            "nan_threshold": 0.0,
        },
        "cut_lr": {
            "enabled": False,  # on: cut lr_input_dir scenes into native-LR
            #   patches (patch_size = the trainers' lr_crop_size; raw, no
            #   denoise — the real sensor's noise IS the signal the D needs)
            "patch_size": 32,
            "stride_ratio": 0.5,
            "nan_threshold": 0.0,
        },
        "denoise": {"enabled": True, "h_factor": 1.0, "device_batch": 8},
        "noise_pool": {
            "enabled": True,
            "patch_size": 32,
            "samples_per_file": 5,
            "seed": 42,
        },
        "train_kernel": {
            "enabled": True,
            "iters": 10000,
            "batch_size": 16,
        },
        "factory": {"enabled": True, "factor": 8, "seed": 42},
        "check_shapes": {"enabled": True},
        "sr_train": {
            "enabled": False,
            "iters": 2000,
            "batch_size": 16,
            "width": 32,
            "n_blocks": 4,
            "upsampler": "oneshot",
        },
        "sr_infer": {"enabled": False},
        "sr_scene": {"enabled": False, "in_group": "geophysical_data",
                     "tile": 64},
        "analyze": {"enabled": True},
    },
}

#: the stages whose CLI takes --device
DEVICE_STAGES = ("denoise", "train_kernel", "factory", "apply_kernel",
                 "sr_train", "sr_infer", "sr_scene")


def _argv(options: dict, **extra) -> list[str]:
    """Stage config block -> CLI argv (skips 'enabled'; bools are flags;
    lists become nargs-style multi-token values)."""
    out = []
    merged = {**options, **extra}
    merged.pop("enabled", None)
    for key, val in merged.items():
        flag = "--" + key.replace("_", "-")
        if isinstance(val, bool):
            if val:
                out.append(flag)
        elif isinstance(val, (list, tuple)):
            out += [flag, *[str(v) for v in val]]
        else:
            out += [flag, str(val)]
    return out


def _marker_path(work: str, stage: str) -> str:
    return os.path.join(work, ".stages", f"{stage}.json")


def _load_marker(work: str, stage: str) -> dict | None:
    try:
        with open(_marker_path(work, stage), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _stage_done(work: str, stage: str, argv: list[str],
                upstream: dict[str, str]) -> bool:
    """True when a completion marker exists AND was written for the same
    stage argv AND against the same upstream marker chain. Each marker
    records a fresh unique `key` plus the keys of every stage before it: if
    ANY upstream stage re-executes, its key changes, every downstream
    marker's recorded `upstream` no longer matches, and --resume re-runs
    from there instead of serving outputs computed from old upstream
    data."""
    m = _load_marker(work, stage)
    return (
        m is not None
        and m.get("argv") == argv
        and m.get("upstream") == upstream
    )


def _mark_done(work: str, stage: str, argv: list[str], seconds: float,
               upstream: dict[str, str]) -> str:
    """Write the completion marker; returns its unique key (fed into the
    `upstream` chain of every later stage's marker)."""
    key = hashlib.sha256(
        json.dumps([stage, argv, upstream, time.time_ns()]).encode()
    ).hexdigest()[:16]
    path = _marker_path(work, stage)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"stage": stage, "argv": argv, "seconds": seconds,
                   "key": key, "upstream": upstream}, f)
    return key


def run_pipeline(config: dict, from_stage: str | None = None,
                 only: list[str] | None = None, resume: bool = False,
                 device: str = "cuda") -> dict:
    """Execute the DAG; returns {stage: seconds}. Raises on stage failure.

    resume=True skips every stage whose completion marker matches the
    stage's current argv and upstream chain: a crashed or interrupted run
    re-executes only the failed stage and everything after it. device goes
    to every stage of `DEVICE_STAGES` as `--device`."""
    resolve_device(device)  # a CUDA request without a card raises here
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg.update({k: v for k, v in config.items() if k != "stages"})
    for name, block in (config.get("stages") or {}).items():
        cfg["stages"].setdefault(name, {}).update(block)

    work = cfg["workdir"]
    os.makedirs(work, exist_ok=True)
    paths = {
        "calibrated": os.path.join(work, "calibrated"),
        "patches": os.path.join(work, "patches"),
        "patches_lr": os.path.join(work, "patches_lr"),
        "denoised": os.path.join(work, "denoised"),
        "pool": os.path.join(work, "noise_pool.npy"),
        "gan": os.path.join(work, "kernel_run"),
        "pairs": os.path.join(work, "train_pairs"),
        "blurred": os.path.join(work, "blurred"),
        "sr": os.path.join(work, "sr_run"),
        "sr_out": os.path.join(work, "sr_out"),
    }
    trainer = cfg["trainer"]
    if trainer not in ("single", "fleet", "dynamic", "moe"):
        raise ValueError(
            f"trainer must be single|fleet|dynamic|moe, got {trainer}"
        )
    # fleet has no single artifact: downstream stages get kernel_root
    # (per-scene <scene>/kernel_per_band.npy under the trainer outdir). An
    # explicit kernel_file overrides the workdir artifact.
    kernel_art = cfg.get("kernel_file") or os.path.join(
        paths["gan"],
        {"single": "kernel_per_band.npy", "fleet": "",
         "dynamic": os.path.join("final_results", "kernel_per_band.npy"),
         "moe": "kernel_0.npy"}[trainer],
    )
    s = cfg["stages"]
    if s["calibrate"]["enabled"] and not cfg.get("landsat_root"):
        raise ValueError("calibrate stage enabled but landsat_root not set")
    if s["cut_lr"]["enabled"] and not cfg.get("lr_input_dir"):
        raise ValueError("cut_lr stage enabled but lr_input_dir not set")
    real_is_lr = bool(s["train_kernel"].get("real_is_lr"))
    if real_is_lr and trainer != "fleet":
        raise ValueError(
            "train_kernel.real_is_lr is only supported by trainer 'fleet' "
            "in the pipeline (per-scene native-LR pools)"
        )
    if real_is_lr and not s["cut_lr"]["enabled"]:
        raise ValueError(
            "train_kernel.real_is_lr needs the cut_lr stage enabled "
            "(it supplies the native-LR patches)"
        )
    scenes_dir = (
        paths["calibrated"] if s["calibrate"]["enabled"] else cfg["input_dir"]
    )

    def stage_list():
        from ..analysis import log_analyzer
        from . import (  # local imports: a stage's modules load when run
            apply_kernel, calibrate_landsat, check_shapes, cut, denoise_cli,
            factory, make_train_data, noise_pool_cli, sr_infer, sr_scene,
            train_dynamic_cli, train_fleet_cli, train_moe_cli,
            train_single_kernel_cli, train_sr_cli,
        )

        train_main = {
            "single": train_single_kernel_cli.main,
            "fleet": train_fleet_cli.main,
            "dynamic": train_dynamic_cli.main,
            "moe": train_moe_cli.main,
        }[trainer]
        steps = [
            ("calibrate", calibrate_landsat.main, _argv(
                s["calibrate"], root=cfg.get("landsat_root") or "",
                out_dir=paths["calibrated"])),
            ("cut", cut.main, _argv(
                s["cut"], input_dir=scenes_dir, output_dir=paths["patches"])),
            ("cut_lr", cut.main, _argv(
                s["cut_lr"], input_dir=cfg.get("lr_input_dir") or "",
                output_dir=paths["patches_lr"])),
            ("denoise", denoise_cli.main, ["--batch", paths["patches"]] + _argv(
                s["denoise"], output=paths["denoised"])),
            ("noise_pool", noise_pool_cli.main, _argv(
                s["noise_pool"], input_dir=paths["denoised"],
                output_file=paths["pool"])),
            ("train_kernel", train_main, _argv(
                s["train_kernel"],
                # the JAX package's quirk, kept: every trainer but "single"
                # gets --format nc (the denoised patches are .nc)
                **({"patch_dir": paths["denoised"], "format": "nc"}
                   if trainer != "single" else {"patch_dir": paths["denoised"]}),
                **({"real_lr_dir": paths["patches_lr"]}
                   if real_is_lr else {}),
                outdir=paths["gan"])),
        ]
        if cfg["use_fused_factory"]:
            # the moe trainer's bank routes content-adaptively through the
            # factory's --moe mode; single/dynamic use their final kernel
            kernel_sel = (
                {"moe": paths["gan"]} if trainer == "moe"
                else {"kernel_root": paths["gan"]} if trainer == "fleet"
                else {"kernel": kernel_art}
            )
            steps.append(("factory", factory.main, _argv(
                s["factory"], input_dir=paths["denoised"],
                noise_pool=paths["pool"], output_dir=paths["pairs"],
                **kernel_sel)))
        else:
            fac = dict(s["factory"])
            fac.pop("seed", None)
            k_sel = (
                {"kernel_root": paths["gan"]} if trainer == "fleet"
                else {"kernel": kernel_art}
            )
            steps.append(("apply_kernel", apply_kernel.main, _argv(
                fac, input_dir=paths["denoised"], **k_sel,
                output_dir=paths["blurred"])))
            steps.append(("make_train_data", make_train_data.main, _argv(
                {"seed": s["factory"].get("seed", 42)},
                input_dir=paths["blurred"], noise_pool=paths["pool"],
                output_dir=paths["pairs"])))
        steps.append(("check_shapes", check_shapes.main, _argv(
            s["check_shapes"], input_dir=paths["pairs"], group="lr")))
        steps.append(("sr_train", train_sr_cli.main, _argv(
            s["sr_train"], train_dir=paths["pairs"], outdir=paths["sr"],
            factor=s["factory"].get("factor", 8))))
        steps.append(("sr_infer", sr_infer.main, _argv(
            s["sr_infer"], input_dir=paths["pairs"],
            model=os.path.join(paths["sr"], "sr_model.npz"),
            output_dir=paths["sr_out"],
            factor=s["factory"].get("factor", 8),
            width=s["sr_train"].get("width", 32),
            n_blocks=s["sr_train"].get("n_blocks", 4),
            upsampler=s["sr_train"].get("upsampler", "oneshot"))))
        steps.append(("sr_scene", sr_scene.main, _argv(
            s["sr_scene"], input=scenes_dir,
            model=os.path.join(paths["sr"], "sr_model.npz"),
            output_dir=os.path.join(work, "sr_scenes"),
            factor=s["factory"].get("factor", 8),
            width=s["sr_train"].get("width", 32),
            n_blocks=s["sr_train"].get("n_blocks", 4),
            upsampler=s["sr_train"].get("upsampler", "oneshot"))))
        if trainer == "fleet":
            def analyze_fleet(_argv_unused):
                logs = sorted(glob.glob(
                    os.path.join(paths["gan"], "*", "training_log.txt")
                ))
                for log in logs:
                    print(f"[run_all] analyze: {log}")
                    rc = log_analyzer.main([log])
                    if rc not in (0, None):
                        return rc
                return 0

            steps.append(("analyze", analyze_fleet, []))
        else:
            steps.append(("analyze", log_analyzer.main,
                          [os.path.join(paths["gan"], "training_log.txt")]))
        return [(name, fn, argv + ["--device", device] if name in DEVICE_STAGES
                 else argv) for name, fn, argv in steps]

    enabled = {
        "calibrate": s["calibrate"]["enabled"],
        "cut": s["cut"]["enabled"],
        "cut_lr": s["cut_lr"]["enabled"],
        "denoise": s["denoise"]["enabled"],
        "noise_pool": s["noise_pool"]["enabled"],
        "train_kernel": s["train_kernel"]["enabled"],
        "factory": s["factory"]["enabled"],
        "apply_kernel": s["factory"]["enabled"],
        "make_train_data": s["factory"]["enabled"],
        "check_shapes": s["check_shapes"]["enabled"],
        "sr_train": s["sr_train"]["enabled"],
        "sr_infer": s["sr_infer"]["enabled"],
        "sr_scene": s["sr_scene"]["enabled"],
        # the analyzer only applies to the single-kernel-format CSV log
        # (one log for trainer=single; one per scene for trainer=fleet)
        "analyze": s["analyze"]["enabled"] and trainer in ("single", "fleet"),
    }

    timings: dict[str, float] = {}
    started = from_stage is None
    # Upstream marker-key chain for this walk (see _stage_done): stages
    # excluded from this invocation contribute their on-disk key (if any),
    # so a later full --resume only trusts downstream markers whose
    # recorded chain still matches what is actually on disk.
    upstream: dict[str, str] = {}

    def _chain_from_disk(name: str) -> None:
        m = _load_marker(work, name)
        if m and m.get("key"):
            upstream[name] = m["key"]

    for name, fn, argv in stage_list():
        if not started:
            if name == from_stage:
                started = True
            else:
                print(f"[run_all] {name}: skipped (--from-stage)")
                _chain_from_disk(name)
                continue
        if only is not None and name not in only:
            _chain_from_disk(name)
            continue
        if not enabled[name]:
            print(f"[run_all] {name}: disabled")
            continue
        if resume and _stage_done(work, name, argv, upstream):
            print(f"[run_all] {name}: skipped (--resume, already complete)")
            _chain_from_disk(name)
            continue
        print(f"[run_all] {name}: {' '.join(argv)}")
        t0 = time.time()
        rc = fn(argv)
        timings[name] = time.time() - t0
        if rc not in (0, None):
            raise RuntimeError(f"stage '{name}' failed with exit code {rc}")
        upstream[name] = _mark_done(work, name, argv, timings[name], upstream)
        print(f"[run_all] {name}: done in {timings[name]:.1f}s")
    total = sum(timings.values())
    print(f"[run_all] pipeline complete: {len(timings)} stages, {total:.1f}s")
    return timings


def main(argv=None) -> int:
    # the training stages run in this process, under deterministic
    # algorithms on the card: cuBLAS must see this before its first use
    set_cublas_workspace_config()
    p = argparse.ArgumentParser(description="Run the full kmsr pipeline DAG")
    p.add_argument("--config", help="JSON config (see --write-config)")
    p.add_argument("--write-config", metavar="PATH",
                   help="write the template config and exit")
    p.add_argument("--workdir", help="override config workdir")
    p.add_argument("--input-dir", help="override config input_dir")
    p.add_argument("--from-stage", help="resume the DAG at this stage")
    p.add_argument("--only", help="comma-separated subset of stages to run")
    p.add_argument("--resume", action="store_true",
                   help="skip stages already completed in this workdir "
                        "(markers in <workdir>/.stages; a changed stage "
                        "config re-runs the stage)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, passed to every stage whose "
                        "CLI takes --device")
    a = p.parse_args(argv)

    if a.write_config:
        with open(a.write_config, "w", encoding="utf-8") as f:
            json.dump(DEFAULT_CONFIG, f, indent=2)
        print(f"template config -> {a.write_config}")
        return 0
    if not a.config:
        p.error("--config or --write-config required")
    with open(a.config, encoding="utf-8") as f:
        config = json.load(f)
    if a.workdir:
        config["workdir"] = a.workdir
    if a.input_dir:
        config["input_dir"] = a.input_dir
    run_pipeline(
        config,
        from_stage=a.from_stage,
        only=a.only.split(",") if a.only else None,
        resume=a.resume,
        device=a.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
