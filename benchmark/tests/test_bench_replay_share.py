"""The reader of `fleet.replay_share` on hand-made span rows: the
`scene_its` of the `kernelgan.replay` spans started in the traced window
over those `fleet.gather` counted there, and nothing without a replay."""
from __future__ import annotations

import types

import pytest

import harness
import spans
from kmsr_tpu_torch.utils.profiling import Span

T0, T1 = 1_000, 2_000


def _rows(*specs) -> list:
    """(name, start_ns, scene_its or None) -> span rows 10 ns long."""
    return [Span(i, None, name, 1, start, start + 10, i, {} if n is None else {"scene_its": n})
            for i, (name, start, n) in enumerate(specs)]


G, R = "fleet.gather", "kernelgan.replay"
CASES = {
    "every step replayed": (_rows((G, 1100, 2), (R, 1120, 2), (G, 1200, 2), (R, 1220, 2)), 100.0),
    "one of two eager": (_rows((G, 1100, 1), (R, 1120, 1), (G, 1200, 1),
                               ("kernelgan.d_update", 1220, None)), 50.0),
    "started outside the window": (_rows((G, 990, 1), (R, 995, 1), (G, 1100, 1), (R, 1120, 1),
                                         (G, 1990, 1), (R, 2005, 1)), 50.0),
    "no replay (a program without the graph)": (_rows((G, 1100, 1),
                                                      ("kernelgan.g_update", 1120, None)), None),
    "no gather": (_rows((R, 1120, 1)), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replay_share_reads_the_window(monkeypatch, case):
    rows, want = CASES[case]
    monkeypatch.setattr(spans, "traced", lambda run: (T0, T1, rows))
    assert harness.reader("fleet.replay_share")(types.SimpleNamespace()) == want


def test_replay_share_reads_nothing_untraced(monkeypatch):
    monkeypatch.setattr(spans, "traced", lambda run: None)
    assert harness.reader("fleet.replay_share")(types.SimpleNamespace()) is None
