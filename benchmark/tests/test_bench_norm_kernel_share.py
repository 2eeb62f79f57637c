"""The reader of `swinir.norm_kernel_share`: nothing in a traced run of the
SwinIR cell at a tiny size on the CPU (no kernel launches there), and on
hand-made span rows the `norm_kernels` of the `swinir.forward` spans
started in the traced window over the norms those forwards hold."""
from __future__ import annotations

import copy
import time
import types

import pytest
import torch

import harness
import spans
from kmsr_tpu_torch.utils.profiling import Span

CELL = "swinir-x8-tiles64"
TINY_SR = dict(embed_dim=24, depths=[2, 2], num_heads=[2, 2], window_size=4, batch_size=4,
               lr_size=8)
TINY_TRAFFIC = dict(pool_tiles=16, check_tiles=8, trace_s=0.5)


def test_norm_kernel_share_reads_nothing_on_the_cpu():
    """A CPU forward launches no kernel: its spans count 0 norm kernels."""
    cell = harness.find_cell(harness.spec(), CELL)
    cfg, tr = (copy.deepcopy(x) for x in harness.cell_files(cell))
    cfg["sr"].update(TINY_SR)
    tr.update(TINY_TRAFFIC)
    res = harness.execute(harness.spec(), cell, 2**31 + 97, 1.5, True, torch.device("cpu"),
                          time.time(), cfg, tr)
    assert res["correct"] is True
    assert "swinir.host_ms_per_batch" in res["metrics"]
    assert "swinir.norm_kernel_share" not in res["metrics"]


T0, T1 = 1_000, 2_000
#: (start_ns, norm_kernels or None) of `swinir.forward` spans; 74 norms a
#: forward at SwinIR-M's depths
CASES = {
    "every norm on the kernel": ([(1100, 74), (1200, 74)], 100.0),
    "one forward of two": ([(1100, 74), (1200, 0)], 50.0),
    "started outside the window": ([(990, 0), (1100, 74), (2005, 0)], 100.0),
    "a program without the count": ([(1100, None), (1200, None)], None),
    "no launches (the CPU)": ([(1100, 0), (1200, 0)], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_norm_kernel_share_reads_the_window(monkeypatch, case):
    specs, want = CASES[case]
    rows = [Span(i, None, "swinir.forward", 1, start, start + 10, i,
                 {"tiles": 32} if n is None else {"tiles": 32, "norm_kernels": n})
            for i, (start, n) in enumerate(specs)]
    monkeypatch.setattr(spans, "traced", lambda run: (T0, T1, rows))
    run = types.SimpleNamespace(config={"sr": {"depths": [6] * 6}})
    assert harness.reader("swinir.norm_kernel_share")(run) == want


def test_norm_kernel_share_reads_nothing_untraced(monkeypatch):
    monkeypatch.setattr(spans, "traced", lambda run: None)
    assert harness.reader("swinir.norm_kernel_share")(types.SimpleNamespace()) is None
