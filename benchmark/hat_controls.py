"""Knock-outs of HAT's parts patched into the program, the controls that
show each part is seen by `hat-x4-tiles64`'s check: for each knock-out and
seed, a short window of the cell with that part of the program's forward
removed, then `hat_rel_err` as the program's output gives it (the
knocked-out network against the plain reference of the whole one) and as
the fp8 control gives it (`control.readings`). One JSON line a reading.

    python3 benchmark/hat_controls.py --seconds S --seeds N [N ...] --knock K [K ...]

Knock-outs (`KNOCK_OUTS`): `cab`, the conv branch left out of the HAB's
residual; `gate`, the channel gate held at 1; `masked`, the OCAB's padded
keys masked out of the softmax instead of taking part as zero vectors;
`ocab_bias`, the OCAB's relative-position bias zero; `shift_mask`, the
shifted HABs' -100 mask dropped. `none` reads the program as it is.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

KNOCK_OUTS = ("none", "cab", "gate", "masked", "ocab_bias", "shift_mask")
CELL = "hat-x4-tiles64"


def _ocab_bias(change):
    """A patch of the HAT forward's weight preparation that replaces each
    OCAB's bias with change(bias, hw, cfg)."""
    from kmsr_tpu_torch.models import hat

    real = hat._prepare

    def prepare(params, cfg, dt, hw):
        wts = real(params, cfg, dt, hw)
        for name, s in wts.items():
            if name.endswith("overlap_attn."):
                s["bias"] = change(s["bias"], hw, cfg)
        return wts
    return mock.patch.object(hat, "_prepare", prepare)


def _masked(bias, hw, cfg):
    """bias [1, heads, N, M] -> [nW, heads, N, M], -inf at each window's
    keys outside the map."""
    from kmsr_tpu_torch.models import hat

    ws, ows = cfg.window_size, cfg.overlap_size
    pad = hat._oca_gather(*hw, ws, ows, bias.device).view(-1, 1, 1, ows * ows) == hw[0] * hw[1]
    return bias.masked_fill(pad, float("-inf"))


def knock_out(name: str):
    """A context manager under which the program's HAT forward runs with the
    part `name` knocked out (module docstring)."""
    import torch

    from kmsr_tpu_torch.models import hat, swinir

    if name == "none":
        return contextlib.nullcontext()
    if name == "cab":
        return mock.patch.object(hat, "_cab", lambda x, s, hw: (
            torch.zeros_like(x), torch.ones_like(x[:, :1], dtype=torch.float32)))
    if name == "gate":
        return mock.patch.object(hat, "_channel_gate", lambda y, s: torch.ones(
            y.shape[:2], device=y.device))
    if name == "masked":
        return _ocab_bias(_masked)
    if name == "ocab_bias":
        return _ocab_bias(lambda bias, hw, cfg: torch.zeros_like(bias))
    if name == "shift_mask":
        real = swinir.attn_bias
        return mock.patch.object(swinir, "attn_bias", lambda table, h, w, ws, shift, dtype:
                                 real(table, h, w, ws, 0, dtype))
    raise ValueError(f"no knock-out {name!r}; one of {KNOCK_OUTS}")


def readings(knock: str, seed: int, seconds: float, device, config=None, traffic=None) -> dict:
    """One seed's readings with the knock-out `knock` patched in."""
    import control
    import harness

    cell = harness.find_cell(harness.spec(), CELL)
    with knock_out(knock):
        out = control.readings(cell, seed, seconds, device, config, traffic)
    return {"knock": knock, **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--knock", nargs="+", choices=KNOCK_OUTS, required=True)
    a = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("the knock-outs run on a CUDA card", file=sys.stderr)
        return 1
    for knock in a.knock:
        for seed in a.seeds:
            print(json.dumps(readings(knock, seed, a.seconds, torch.device("cuda", 0))),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
