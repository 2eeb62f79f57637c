"""Port parity: the device-sync watchdog and the sync-stall tools
(kmsr_tpu_torch.pipeline.common, kmsr_tpu_torch.utils.profiling vs
kmsr_tpu.pipeline.common, kmsr_tpu.utils.profiling), on the CPU.

The port keeps JAX's watchdog (thresholds, history, abort, one monitor
thread per label, the KMSR_SYNC_* variables) and replaces the diagnosis:
a `torch.cuda.Event` recorded when the sync began is pending (the card is
still running queued work: never aborts), or done while the host idles (a
suspected wedge: aborts), or done with the host busy. On the CPU no event
exists, so only host_busy and suspected_wedge come out.
"""
import contextlib
import os
import threading
import time

import numpy as np
import pytest

from kmsr_tpu.pipeline import common as jcommon
from kmsr_tpu.utils import profiling as jprof
from kmsr_tpu_torch.pipeline import common as tcommon
from kmsr_tpu_torch.utils import profiling as tprof


def _wait_for(cond, timeout=3.0):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < timeout:
        time.sleep(0.02)
    return cond()


# --------------------------------------------------------------- watchdog
def test_sync_watchdog_simulated_hang():
    """`tests/test_pipeline.py::test_sync_watchdog_simulated_hang` on the
    port: a persistent wedge diagnosis aborts with its history; the pending
    state (the role of JAX's remote compile) is logged and never aborts;
    no sync in progress, no log."""
    aborts, logs = [], []
    wd = tcommon.SyncWatchdog(
        label="t", threshold_s=0.05, poll_s=0.05, wedge_abort_s=0.15,
        diagnose=lambda: ("suspected_wedge", {"host_cpu_util": 0.0}),
        on_abort=aborts.append, log=logs.append,
    )
    with wd:
        with wd.watch():
            for _ in range(60):  # simulated blocked sync
                if aborts:
                    break
                time.sleep(0.05)
    assert aborts, "persistent wedge never aborted"
    assert aborts[0]["wedge_persist_s"] >= 0.15
    assert aborts[0]["label"] == "t" and aborts[0]["detail"] == {"host_cpu_util": 0.0}
    assert any(s == "suspected_wedge" for _, s in aborts[0]["history"])
    assert any("SUSPECTED WEDGE" in m for m in logs)
    assert not wd._thread.is_alive()

    aborts2, logs2 = [], []
    wd2 = tcommon.SyncWatchdog(
        label="t2", threshold_s=0.05, poll_s=0.05, wedge_abort_s=0.1,
        diagnose=lambda: ("device_pending", {"event": "pending"}),
        on_abort=aborts2.append, log=logs2.append,
    )
    with wd2:
        with wd2.watch():
            time.sleep(0.5)
        assert not aborts2
        assert any("the card is still running queued work" in m for m in logs2)
        assert {s for _, s in wd2.diagnoses} == {"device_pending"}
        n_logs = len(logs2)
        time.sleep(0.2)
        assert len(logs2) == n_logs

    # host_busy resets the wedge clock, as in JAX: no abort
    aborts3 = []
    states = iter(["suspected_wedge", "host_busy"] * 100)
    wd3 = tcommon.SyncWatchdog(
        label="t3", threshold_s=0.0, poll_s=0.03, wedge_abort_s=0.1,
        diagnose=lambda: (next(states), {}), on_abort=aborts3.append, log=lambda m: None)
    with wd3, wd3.watch():
        time.sleep(0.4)
    assert not aborts3 and len(wd3.diagnoses) >= 4


def test_watchdog_defaults_match_jax():
    """The constructor's defaults and the default abort (log, then
    os._exit(86))."""
    import inspect

    got = inspect.signature(tcommon.SyncWatchdog.__init__).parameters
    want = inspect.signature(jcommon.SyncWatchdog.__init__).parameters
    assert list(got) == list(want)
    for name in ("label", "threshold_s", "poll_s", "wedge_abort_s", "on_abort", "log"):
        assert got[name].default == want[name].default, name
    assert got["diagnose"].default is None  # diagnose_sync_state on the watched event
    exits, wd = [], None
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(os, "_exit", exits.append)
            wd = tcommon.SyncWatchdog(label="abort", poll_s=3600)
            wd._default_abort({"elapsed_s": 1.0, "detail": {"x": 1}})
    finally:
        if wd is not None:
            wd.stop()
    assert exits == [86]


@contextlib.contextmanager
def _fresh_watchdogs(module):
    saved = dict(module._WATCHDOGS)
    module._WATCHDOGS.clear()
    try:
        yield module._WATCHDOGS
    finally:
        for wd in module._WATCHDOGS.values():
            wd.stop()
        module._WATCHDOGS.clear()
        module._WATCHDOGS.update(saved)


@pytest.mark.parametrize("env", [
    {},
    {"KMSR_SYNC_WATCHDOG_THRESHOLD_S": "7", "KMSR_SYNC_WEDGE_ABORT_S": "0"},
    {"KMSR_SYNC_WEDGE_ABORT_S": "30"},
    {"KMSR_SYNC_WATCHDOG": "0"},
])
def test_sync_watch_environment_matches_jax(monkeypatch, env):
    """sync_watch builds one watchdog per label from the same variables and
    defaults as JAX's (threshold 120, abort 900, 0 = no abort, poll 30), and
    KMSR_SYNC_WATCHDOG=0 makes it a no-op."""
    for k in ("KMSR_SYNC_WATCHDOG", "KMSR_SYNC_WATCHDOG_THRESHOLD_S",
              "KMSR_SYNC_WEDGE_ABORT_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with _fresh_watchdogs(tcommon) as twd, _fresh_watchdogs(jcommon) as jwd:
        for mod in (tcommon, jcommon):
            with mod.sync_watch("stage"):
                pass
            with mod.sync_watch("stage"):
                pass
        if env.get("KMSR_SYNC_WATCHDOG") == "0":
            assert twd == {} and jwd == {}
            assert isinstance(tcommon.sync_watch("stage"), contextlib.nullcontext)
            return
        assert list(twd) == list(jwd) == ["stage"]
        got, want = twd["stage"], jwd["stage"]
        for attr in ("label", "threshold_s", "poll_s", "wedge_abort_s"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert got.diagnoses == [] and got._thread.is_alive()


def test_watch_records_no_event_on_the_cpu():
    wd = tcommon.SyncWatchdog(label="cpu", poll_s=3600)
    try:
        with wd.watch():
            assert wd._sync_since is not None and wd._event is None
        assert wd._sync_since is None
    finally:
        wd.stop()


# -------------------------------------------------------------- diagnosis
class _Event:
    def __init__(self, done=True, error=None):
        self.done, self.error = done, error

    def query(self):
        if self.error:
            raise RuntimeError(self.error)
        return self.done


def test_diagnose_sync_state_on_the_cpu():
    """No event: an idle host is a suspected wedge, a busy one host_busy
    (JAX's /proc rule); never device_pending."""
    state, detail = tcommon.diagnose_sync_state(cpu_sample_s=0.2)
    assert state in ("suspected_wedge", "host_busy") and detail["event"] is None
    assert (state == "suspected_wedge") == (detail["host_cpu_util"] < 0.05)
    stop = threading.Event()

    def burn():
        x = 0
        while not stop.is_set():
            x += 1

    t = threading.Thread(target=burn, daemon=True)
    t.start()
    try:
        state, detail = tcommon.diagnose_sync_state(cpu_sample_s=0.3)
    finally:
        stop.set()
        t.join(5)
    assert not t.is_alive()
    assert state == "host_busy" and detail["host_cpu_util"] >= 0.05
    assert tcommon._proc_cpu_seconds() == pytest.approx(jcommon._proc_cpu_seconds(), abs=0.5)


def test_diagnose_sync_state_event_rule():
    """The CUDA rule on a stand-in event: pending -> device_pending (no CPU
    sample), a raising query -> device_error with its text, done -> the
    host's CPU decides."""
    t0 = time.monotonic()
    assert tcommon.diagnose_sync_state(5.0, event=_Event(done=False)) == (
        "device_pending", {"event": "pending"})
    state, detail = tcommon.diagnose_sync_state(5.0, event=_Event(error="an illegal memory access"))
    assert time.monotonic() - t0 < 1.0
    assert state == "device_error" and "illegal memory access" in detail["error"]
    state, detail = tcommon.diagnose_sync_state(0.2, event=_Event(done=True))
    assert state in ("suspected_wedge", "host_busy") and detail["event"] == "done"
    assert (state == "suspected_wedge") == (detail["host_cpu_util"] < 0.05)


def test_default_diagnosis_reads_the_watched_event(monkeypatch):
    """The default diagnose queries the event `watch()` recorded: pending is
    logged and never aborts, a done event on an idle host aborts."""
    for done, want in ((False, "device_pending"), (True, "suspected_wedge")):
        aborts, logs = [], []
        wd = tcommon.SyncWatchdog(label="ev", threshold_s=0.0, poll_s=0.05,
                                  wedge_abort_s=0.0, on_abort=aborts.append,
                                  log=logs.append)
        # an idle host for the CPU sample: no CPU seconds pass
        monkeypatch.setattr(tcommon, "_proc_cpu_seconds", lambda: 1.0)
        with wd, wd.watch():
            with wd._lock:
                wd._event = _Event(done=done)
            assert _wait_for(lambda: wd.diagnoses)
        monkeypatch.undo()
        assert wd.diagnoses[0][1] == want
        assert bool(aborts) == (want == "suspected_wedge")


# ------------------------------------------------------- the wrapped syncs
def test_factory_and_denoise_syncs_are_watched(tmp_path, monkeypatch):
    """The factory's writeback sync and the denoise stage's finalize run
    inside sync_watch("factory") / sync_watch("denoise")."""
    from kmsr_tpu_torch.io.ncio import write_band_stack
    from kmsr_tpu_torch.io.schema import GROUP_GEO
    from kmsr_tpu_torch.pipeline import denoise_cli, factory

    seen = []

    @contextlib.contextmanager
    def spy(label):
        seen.append(label)
        yield

    monkeypatch.setattr(factory, "sync_watch", spy)
    monkeypatch.setattr(denoise_cli, "sync_watch", spy)
    rng = np.random.default_rng(0)
    src = tmp_path / "npy"
    src.mkdir()
    for i in range(3):
        np.save(src / f"p{i}.npy", rng.normal(5, 1, (5, 32, 32)).astype(np.float32))
    k = np.zeros((5, 13, 13), np.float32)
    k[:, 6, 6] = 1.0
    np.save(tmp_path / "k.npy", k)
    np.save(tmp_path / "pool.npy", rng.normal(0, 0.1, (4, 5, 4, 4)).astype(np.float32))
    rep = factory.run_factory(str(src), str(tmp_path / "k.npy"), str(tmp_path / "pool.npy"),
                              str(tmp_path / "pairs"), batch_size=2, progress=False,
                              device="cpu")
    assert rep.n_ok == 3 and seen == ["factory", "factory"]
    seen.clear()
    nc = tmp_path / "nc"
    nc.mkdir()
    for i in range(2):
        write_band_stack(str(nc / f"s{i}.nc"), GROUP_GEO,
                         rng.normal(5, 1, (5, 24, 24)).astype(np.float32), mode="w")
    rep = denoise_cli.batch_denoise(str(nc), str(tmp_path / "den"), device_batch=2,
                                    progress=False, device="cpu")
    assert rep.n_ok == 2 and seen == ["denoise"]


# -------------------------------------------------------- profiling tools
def _rec(s):
    return {"calls": 1, "total_s": s, "mean_s": s, "max_s": s}


@pytest.mark.parametrize("case", ["incident", "clean", "first_call", "over_floor", "knobs"])
def test_detect_sync_stall_matches_jax(case):
    """`tests/test_checkpoint_viz.py::test_detect_sync_stall`'s records
    through both packages: the same flags, record for record."""
    scopes, stages, kw = {
        "incident": ({"factory.device_sync": _rec(555.95), "factory.host_write": _rec(19.0),
                      "factory.host_read_bg": _rec(40.0), "denoise.device_sync": _rec(35.0),
                      "denoise.host_write": _rec(30.0), "denoise.host_read": _rec(22.0)},
                     {"factory": 580.0, "denoise": 95.0}, {}),
        "clean": ({"factory.device_sync": _rec(45.0), "factory.host_write": _rec(20.0),
                   "denoise.device_sync": _rec(35.0), "denoise.host_write": _rec(30.0)}, {}, {}),
        "first_call": ({"factory.device_sync": _rec(100.0)}, {}, {}),
        "over_floor": ({"factory.device_sync": _rec(130.0)}, {}, {}),
        "knobs": ({"sr_infer.device_sync": _rec(12.0), "sr_infer.h2d": _rec(1.0),
                   "factory.device_sync": _rec(3.0)}, {"sr_infer": 14.0},
                  {"ratio": 2.0, "floor_s": 5.0}),
    }[case]
    got = tprof.detect_sync_stall(scopes, stages, **kw)
    want = jprof.detect_sync_stall(scopes, stages, **kw)
    np.testing.assert_equal(got, want)
    if case == "incident":
        assert [f["stage"] for f in got] == ["factory"] and got[0]["host_s"] == 19.0
    if case == "over_floor":
        assert got and got[0]["sync_to_host_ratio"] is None


def test_bench_windows_return_shape():
    """JAX's return keys, min <= median <= max, and the same number of
    calls (one first call, two warm-up calls, windows x iters); `drain`
    sees each window's last output."""
    def counter():
        calls = []
        return calls, lambda x: calls.append(x) or len(calls)

    tc, tfn = counter()
    jc, jfn = counter()
    drained = []
    got = tprof.bench_windows(tfn, 1, iters=3, windows=4, drain=drained.append)
    want = jprof.bench_windows(jfn, 1, iters=3, windows=4, drain=lambda o: None)
    assert set(got) == set(want) == {"median_s", "min_s", "max_s"}
    assert got["min_s"] <= got["median_s"] <= got["max_s"]
    assert len(tc) == len(jc) == 1 + 2 + 4 * 3
    assert drained == [1, 3, 6, 9, 12, 15]
    res = tprof.bench_windows(lambda: None, iters=2, windows=3)  # default drain on the CPU
    assert set(res) == {"median_s", "min_s", "max_s"}


def test_device_trace_writes_a_chrome_trace(tmp_path, capsys):
    import torch

    with tprof.device_trace(str(tmp_path / "t")):
        torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    with tcommon.maybe_trace(str(tmp_path / "m")):
        torch.ones(4).sum()
    assert (tmp_path / "m" / "trace.json").exists()
    assert "[trace] timeline written to" in capsys.readouterr().out
    with tcommon.maybe_trace(None):
        pass
