"""The HAT cell (`hat-x4-tiles64`) at a tiny size on the CPU, through
`harness.execute` with its own small configuration: correct traced and
untraced; not correct under the control, the planted `answer-sr` fault, or
any knock-out of `hat_controls.py` patched into the program; the FLOP count
against hand counts at a small and at the published shape; and the three
per-layer readers on a fake run."""
from __future__ import annotations

import copy
import time
from types import SimpleNamespace

import pytest
import torch

import control
import counts_hat
import faults
import harness
import hat_controls

CELL = "hat-x4-tiles64"
#: narrow and shallow, at the published window (the cell's draw is tuned for
#: its 256-token windows): 2 x 2 windows a tile
TINY_SR = dict(embed_dim=60, depths=[2, 2], num_heads=[6, 6], window_size=16, batch_size=2,
               lr_size=32)
TINY_TRAFFIC = dict(pool_tiles=16, check_tiles=8, trace_s=0.5)


def _tiny():
    cell = harness.find_cell(harness.spec(), CELL)
    cfg, tr = (copy.deepcopy(x) for x in harness.cell_files(cell))
    cfg["sr"].update(TINY_SR)
    tr.update(TINY_TRAFFIC)
    return cell, cfg, tr


def _run(seconds: float = 0.6, trace: bool = False) -> dict:
    cell, cfg, tr = _tiny()
    return harness.execute(harness.spec(), cell, 2**31 + 191, seconds, trace,
                           torch.device("cpu"), time.time(), cfg, tr)


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(trace):
    res = _run(seconds=1.5 if trace else 0.6, trace=trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in harness.cell_metrics(harness.spec(), CELL, trace)}
    if trace:
        # no device timeline or peak on the CPU: the span metric reads
        assert "hat.host_ms_per_batch" in res["metrics"]
        assert set(res["metrics"]) <= want == {"hat.mfu", "device_idle.hat",
                                               "hat.host_ms_per_batch"}
    else:
        assert set(res["metrics"]) == want == {"mpix_per_s", "batch_ms_p95", "setup_s"}
    assert res["checks"]["hat_rel_err"]["value"] < res["checks"]["hat_rel_err"]["limit"]


def test_control_is_not_correct():
    cell, cfg, tr = _tiny()
    got = control.readings(cell, 2**31 + 193, 0.5, torch.device("cpu"), cfg, tr)
    assert got["correct"]
    assert got["control"]["hat_rel_err"] > tr["limits"]["hat_rel_err"]


@pytest.mark.parametrize("broken", ["answer-sr", *hat_controls.KNOCK_OUTS[1:]])
def test_a_broken_path_is_not_correct(broken):
    cell, cfg, tr = _tiny()
    if broken == "answer-sr":
        with faults.plant(broken):
            got = control.readings(cell, 2**31 + 195, 0.5, torch.device("cpu"), cfg, tr)
    else:
        got = hat_controls.readings(broken, 2**31 + 195, 0.5, torch.device("cpu"), cfg, tr)
    assert got["correct"] is False
    assert got["program"]["hat_rel_err"] > tr["limits"]["hat_rel_err"]


def _hand_count(t: int, e: int, hid: int, mid: int, n: int, m: int, blocks: int,
                groups: int, bands: int, nf: int) -> int:
    linears = 2 * t * (3 * e * e + e * e + 2 * e * hid)
    hab = linears + 2 * 2 * t * n * e + 2 * t * 9 * (e * mid + mid * e)
    ocab = linears + 2 * 2 * t * m * e
    convs = 2 * t * 9 * (bands * e + (groups + 1) * e * e + e * nf)
    upsample = 2 * 9 * (nf * 4 * nf * (t + 4 * t) + nf * bands * 16 * t)
    return blocks * hab + groups * ocab + convs + upsample


def test_flops_equal_the_hand_count():
    """At the published shape 207.9 GFLOP a 64^2 tile: 36 HABs 160.95 (linears
    76.44, attention at N = 256 27.18, the conv branch 57.33), 6 OCABs 22.93
    (attention at M = 576 10.19), the LR convs 17.64, the x4 upsampler and
    conv_last 6.42; at the tiny shape the same formula."""
    cfg = harness.cell_files(harness.find_cell(harness.spec(), CELL))[0]["sr"]
    want = _hand_count(64 * 64, 180, 360, 60, 256, 576, 36, 6, 5, 64)
    assert counts_hat.hat_flops_per_tile(cfg, 64, 64) == want == 207_938_027_520
    tiny = {**cfg, **TINY_SR, "depths": [2, 2]}
    assert counts_hat.hat_flops_per_tile(tiny, 32, 32) == _hand_count(
        1024, 60, 120, 20, 256, 576, 4, 2, 5, 64)


def _span(name, start_ns, end_ns):
    return SimpleNamespace(name=name, start_ns=start_ns, end_ns=end_ns, counts={}, id=0,
                           parent=None)


def test_readers_on_a_fake_run(monkeypatch):
    import spans

    cfg = harness.cell_files(harness.find_cell(harness.spec(), CELL))[0]
    run = SimpleNamespace(config=cfg, peaks={"bf16": 989e12}, counts={"traced_tiles": 96},
                          trace_summary={"busy_s": 4.0, "window_s": 5.0})
    flops = counts_hat.hat_flops_per_tile(cfg["sr"], 64, 64)
    assert harness.reader("hat.mfu")(run) == pytest.approx(100 * flops * 96 / 5.0 / 989e12)
    assert harness.reader("device_idle.hat")(run) == pytest.approx(20.0)
    rows = [_span("hat.forward", 1_000, 3_001_000), _span("hat.forward", 4_000_000, 9_000_000),
            _span("hat.forward", 50, 900), _span("swinir.forward", 2_000, 9_000_000)]
    monkeypatch.setattr(spans, "traced", lambda r: (1_000, 10_000_000, rows))
    assert harness.reader("hat.host_ms_per_batch")(run) == pytest.approx(4.0)  # (3 + 5) / 2
    monkeypatch.setattr(spans, "traced", lambda r: None)
    assert harness.reader("hat.host_ms_per_batch")(run) is None
    for missing in ({"trace_summary": None}, {"peaks": None}, {"counts": {}}):
        assert harness.reader("hat.mfu")(SimpleNamespace(**{**vars(run), **missing})) is None
    assert harness.reader("device_idle.hat")(SimpleNamespace(**{**vars(run),
                                                              "trace_summary": None})) is None
