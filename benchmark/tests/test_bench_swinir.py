"""The SwinIR cell (`swinir-x8-tiles64`) at a tiny size on the CPU, through
`harness.execute` with its own small configuration (`conftest.TINY` holds
the other drivers'): correct traced and untraced; not correct under the
control, the planted `answer-sr` fault, or either attention knock-out
(no relative-position bias, no shift mask) patched into the program; and
the FLOP count against the hand count at the published shape."""
from __future__ import annotations

import copy
import time
from unittest import mock

import pytest
import torch

import control
import counts_swinir
import faults
import harness

CELL = "swinir-x8-tiles64"
TINY_SR = dict(embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=4, batch_size=4,
               lr_size=8)
TINY_TRAFFIC = dict(pool_tiles=16, check_tiles=8, trace_s=0.5)


def _tiny():
    cell = harness.find_cell(harness.spec(), CELL)
    cfg, tr = (copy.deepcopy(x) for x in harness.cell_files(cell))
    cfg["sr"].update(TINY_SR)
    tr.update(TINY_TRAFFIC)
    return cell, cfg, tr


def _run(seconds: float = 0.6, trace: bool = False) -> dict:
    cell, cfg, tr = _tiny()
    bench = harness.spec()
    return harness.execute(bench, cell, 2**31 + 91, seconds, trace, torch.device("cpu"),
                           time.time(), cfg, tr)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    res = _run(seconds=1.5 if trace else 0.6, trace=trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in harness.cell_metrics(harness.spec(), CELL, trace)}
    if trace:
        # no device timeline on the CPU: the span and op metrics read
        assert {"swinir.host_ms_per_batch", "swinir.ops_per_batch"} <= set(res["metrics"])
        assert set(res["metrics"]) <= want
    else:
        assert set(res["metrics"]) == want == {"mpix_per_s", "batch_ms_p95", "setup_s"}
    assert res["checks"]["swinir_rel_err"]["value"] < res["checks"]["swinir_rel_err"]["limit"]


def test_control_is_not_correct():
    cell, cfg, tr = _tiny()
    got = control.readings(cell, 2**31 + 93, 0.5, torch.device("cpu"), cfg, tr)
    assert got["correct"]
    assert got["control"]["swinir_rel_err"] > tr["limits"]["swinir_rel_err"]


def _knock(kind: str):
    from kmsr_tpu_torch.models import swinir

    real = swinir.attn_bias
    if kind == "B_rel":
        def bias(table, h, w, ws, shift, dtype):
            return real(torch.zeros_like(table), h, w, ws, shift, dtype)
    else:
        def bias(table, h, w, ws, shift, dtype):
            return real(table, h, w, ws, 0, dtype)
    return mock.patch.object(swinir, "attn_bias", bias)


@pytest.mark.parametrize("broken", ["answer-sr", "B_rel", "M"])
def test_a_broken_path_is_not_correct(broken):
    with faults.plant(broken) if broken == "answer-sr" else _knock(broken):
        res = _run(seconds=0.5)
    assert res["correct"] is False
    assert res["checks"]["swinir_rel_err"]["value"] > res["checks"]["swinir_rel_err"]["limit"]


def test_flops_equal_the_hand_count():
    cfg = harness.cell_files(harness.find_cell(harness.spec(), CELL))[0]["sr"]
    t, e = 64 * 64, 180
    linears = 36 * 2 * t * (540 * e + e * e + 2 * 360 * e)         # 76.44 GFLOP
    attention = 36 * 6 * (64 * 2 * 2 * 64 * 64 * 30)              # 6.79: 64 windows x 6 heads
    convs = 2 * t * 9 * (5 * e + 7 * e * e + e * 64)               # 17.64
    upsample = 2 * 9 * (64 * 256 * (t + 4 * t + 16 * t) + 64 * 5 * 64 * t)   # 26.88
    assert counts_swinir.swinir_flops_per_tile(cfg, 64, 64) == \
        linears + attention + convs + upsample == 127_750_275_072
