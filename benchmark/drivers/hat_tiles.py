"""Driver of HAT-SRx4 inference on LR tiles: `kmsr_tpu_torch.pipeline.
sr_infer.run_batches`, the SR stage's device loop, with a `HATConfig`, fed
from memory.

Set-up builds the `HATConfig` first (a program without HAT fails there, at
once), then makes the network's weights (the configuration's `assumed`
says how they are drawn) and a pool of `pool_tiles` GOCI-like LR tiles from
the seed, and warms the loop with `warm_batches` batches. The window is
`drivers.sr_tiles.window`, the closed loop every SR cell is measured by:
the next `batch_size` tiles when the loop asks, a batch counted when its
predictions reached the callback inside the window, a seeded reservoir of
`check_tiles` predictions kept for the check.

The check runs the plain float32 forward (`reference.hat`) on the sampled
tiles, in blocks of `REF_BLOCK` tiles (the OCAB's scores, 256 x 576 a
window and head, are 57 MB a tile in float32): `hat_rel_err` is the worst
tile's ||pred - ref||_2 / ||ref||_2.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import imagery
from drivers.sr_tiles import window  # noqa: F401  (the cell's window)
from reference import hat as plain

#: the draw (configuration's `assumed`): SwinIR-M's cell's relative-position
#: table bound and LayerNorm spread around 1 / 0, and the factors over
#: fan-in uniform of the weights that make each of HAT's parts show
QKV_SCALE, TABLE_BOUND, NORM_SPREAD = 3.0, 6.0, 0.25
OCAB_TABLE_BOUND, ATTN_PROJ_SCALE, OCAB_PROJ_SCALE = 16.0, 3.0, 20.0
CAB_SCALE, GATE_SCALE = 16.0, 8.0
#: tiles a block of the reference
REF_BLOCK = 8


def _shapes(cfg: dict) -> dict:
    return plain.param_shapes(cfg["bands"], cfg["embed_dim"], cfg["depths"], cfg["num_heads"],
                              cfg["window_size"], cfg["overlap_ratio"], cfg["compress_ratio"],
                              cfg["squeeze_factor"], cfg["mlp_ratio"], cfg["num_feat"],
                              cfg["factor"])


def _scale(module: str) -> float:
    """The draw's factor over fan-in uniform for the weights of `module`."""
    for end, scale in ((".qkv", QKV_SCALE), ("overlap_attn.proj", OCAB_PROJ_SCALE),
                       ("attn.proj", ATTN_PROJ_SCALE), ("conv_block.cab.0", CAB_SCALE),
                       ("conv_block.cab.2", CAB_SCALE), ("attention.3", GATE_SCALE)):
        if module.endswith(end):
            return scale
    return 1.0


def _params(run, cfg: dict) -> dict:
    """The seeded weights under the published names, drawn on the device in
    one call and cut into tensors."""
    shapes = _shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = imagery.uniform(run.generator("hat_weights"), (sum(sizes),), 1.0, run.device)
    params, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        u = flat[at:at + n].view(shape)
        at += n
        module, kind = name.rsplit(".", 1)
        layer = module.rsplit(".", 1)[-1]
        if layer in ("norm", "norm1", "norm2"):
            t = u * NORM_SPREAD + (1.0 if kind == "weight" else 0.0)
        elif kind == "relative_position_bias_table":
            t = u * (OCAB_TABLE_BOUND if "overlap_attn" in module else TABLE_BOUND)
        else:
            t = u / math.sqrt(math.prod(shapes[module + ".weight"][1:])) * _scale(module)
            if name == "conv_first.weight":
                t = t - t.mean(dim=(2, 3), keepdim=True)
        params[name] = t.contiguous()
    return params


def hat_config(cfg: dict):
    """The program's `HATConfig` of a configuration's `sr` section."""
    from kmsr_tpu_torch.models.hat import HATConfig

    return HATConfig(in_ch=cfg["bands"], embed_dim=cfg["embed_dim"],
                     depths=tuple(cfg["depths"]), num_heads=tuple(cfg["num_heads"]),
                     window_size=cfg["window_size"], overlap_ratio=cfg["overlap_ratio"],
                     compress_ratio=cfg["compress_ratio"], squeeze_factor=cfg["squeeze_factor"],
                     conv_scale=cfg["conv_scale"], mlp_ratio=cfg["mlp_ratio"],
                     num_feat=cfg["num_feat"], factor=cfg["factor"], img_range=cfg["img_range"],
                     resi_connection=cfg["resi_connection"], upsampler=cfg["upsampler"])


def setup(run) -> dict:
    sr_cfg = hat_config(run.config["sr"])  # a program without HAT fails here
    from kmsr_tpu_torch.pipeline.sr_infer import run_batches

    cfg, tr = run.config["sr"], run.traffic
    n, s = tr["pool_tiles"], cfg["lr_size"]
    tiles = imagery.fields(run.generator("tiles"), n, cfg["bands"], s, s, run.device)
    state = {"params": _params(run, cfg), "tiles": tiles.cpu().numpy(), "sr_cfg": sr_cfg}
    run.note("weights and tiles made")
    b = cfg["batch_size"]
    warm = [([f"w{j}" for j in range(b)],
             [(state["tiles"][(k * b + j) % n], None) for j in range(b)], [])
            for k in range(tr["warm_batches"])]
    run_batches(warm, state["params"], sr_cfg, lambda *a: None, run.device)
    run.note("warm")
    return state


def compare(run, state, fp8: bool = False) -> dict:
    """The largest ||pred - ref||_2 / ||ref||_2 over the sampled tiles, ref
    the plain float32 forward; fp8=True puts the control (the plain forward
    with float8 operands) in the program's place."""
    cfg = run.config["sr"]
    kw = dict(factor=cfg["factor"], window_size=cfg["window_size"], depths=cfg["depths"],
              num_heads=cfg["num_heads"], overlap_ratio=cfg["overlap_ratio"],
              conv_scale=cfg["conv_scale"], img_range=cfg["img_range"])
    worst = 0.0
    sample = state["sample"]
    for lo in range(0, len(sample), REF_BLOCK):
        part = sample[lo:lo + REF_BLOCK]
        x = torch.from_numpy(np.stack([state["tiles"][i] for i, _ in part])).to(run.device)
        ref = plain.forward(state["params"], x, **kw)
        if fp8:
            got = plain.forward(state["params"], x, fp8=True, **kw)
        else:
            got = torch.from_numpy(np.stack([p for _, p in part])).to(run.device)
        err = (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
        worst = max(worst, float(err.max()))
    return {"hat_rel_err": worst}


def verify(run, state) -> None:
    run.check("batches_in_window", run.counts["tiles"] // run.config["sr"]["batch_size"],
              1, at_least=True)
    run.check("failed_tiles", run.failed, 0)
    run.check("tiles_checked", len(state["sample"]), 1, at_least=True)
    run.check("hat_rel_err", compare(run, state)["hat_rel_err"],
              run.traffic["limits"]["hat_rel_err"])


def control(run, state) -> dict:
    return compare(run, state, fp8=True)
