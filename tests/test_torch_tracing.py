"""The port's program spans (`kmsr_tpu_torch.utils.profiling`) on the CPU:
ids, parents and threads, the bounded ring beside the aggregates,
`timing_report`'s shape, the spans in a torch.profiler trace as host ops
and no profiler op without one, and the spans of the SR loop
(`pipeline.sr_infer.run_batches`) and of the KernelGAN fleet's advance
(`train.fleet.make_fleet_advance`)."""
import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

from kmsr_tpu_torch.models.discriminator import DiscriminatorConfig
from kmsr_tpu_torch.models.generator import GeneratorConfig
from kmsr_tpu_torch.models.sr import SRConfig, init_sr
from kmsr_tpu_torch.pipeline import sr_infer
from kmsr_tpu_torch.train import fleet
from kmsr_tpu_torch.train.single_kernel import SingleKernelConfig, init_training
from kmsr_tpu_torch.train.state import tree_leaves
from kmsr_tpu_torch.utils import profiling as tprof

SR_NAMES = ("sr_infer.source_wait", "sr_infer.dispatch", "sr_infer.stage", "sr_infer.launch",
            "sr_infer.device_sync", "sr_infer.assemble", "sr_infer.deliver")
GAN_PHASES = ("kernelgan.g_forward", "kernelgan.d_forward", "kernelgan.d_backward",
              "kernelgan.d_update", "kernelgan.g_loss", "kernelgan.g_backward",
              "kernelgan.g_update")


@pytest.fixture(autouse=True)
def empty_registry():
    tprof.timing_report(reset=True)
    yield
    tprof.timing_report(reset=True)


def _by_name(rows):
    out = collections.defaultdict(list)
    for s in rows:
        out[s.name].append(s)
    return out


# --------------------------------------------------------------- records
def test_nested_spans_and_a_second_thread():
    """Ids are distinct, the parent is the innermost span open on the same
    thread, and a span on another thread carries its own thread id and no
    parent from the thread that started it, though that one's span is open."""
    done = threading.Event()

    def worker():
        with tprof.stage_timer("bg.outer"):
            with tprof.stage_timer("bg.inner"):
                pass
        done.set()

    with tprof.stage_timer("main.outer", item=7):
        with tprof.stage_timer("main.inner", item=7):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
        with tprof.stage_timer("main.second"):
            pass
    assert done.is_set() and not t.is_alive()
    got = {s.name: s for s in tprof.spans()}
    assert len({s.id for s in got.values()}) == 5
    main, bg = got["main.outer"], got["bg.outer"]
    assert main.parent is None and main.item == 7
    assert got["main.inner"].parent == main.id and got["main.inner"].item == 7
    assert got["main.second"].parent == main.id
    assert bg.parent is None and got["bg.inner"].parent == bg.id
    assert bg.thread == got["bg.inner"].thread != main.thread == got["main.inner"].thread
    assert main.start_ns <= got["main.inner"].start_ns <= got["main.inner"].end_ns <= main.end_ns


def test_exception_closes_the_span():
    with pytest.raises(ValueError):
        with tprof.stage_timer("fails"):
            raise ValueError("x")
    with tprof.stage_timer("after"):
        pass
    got = {s.name: s for s in tprof.spans()}
    assert got["after"].parent is None
    assert tprof.timing_report()["fails"]["calls"] == 1


def test_ring_is_bounded_and_the_totals_count_every_span(monkeypatch):
    assert tprof._RING.maxlen == tprof.RING_SPANS
    monkeypatch.setattr(tprof, "_RING", collections.deque(maxlen=8))
    for i in range(20):
        with tprof.stage_timer("many", item=i, bytes=2):
            pass
    rows = tprof.spans()
    assert len(rows) == 8 and [s.item for s in rows] == list(range(12, 20))
    assert all(s.counts == {"bytes": 2} for s in rows)
    assert tprof.timing_report()["many"]["calls"] == 20


@pytest.mark.parametrize("reset", [False, True])
def test_timing_report_keys_and_reset(reset):
    for _ in range(3):
        with tprof.stage_timer("plain"):
            pass
    with tprof.stage_timer("counted", scene_its=4) as counts:
        counts["bytes"] = 100
    assert tprof.spans()[-1].counts == {"scene_its": 4, "bytes": 100}
    rep = tprof.timing_report(reset=reset)
    for name in ("plain", "counted"):
        assert set(rep[name]) == {"calls", "total_s", "mean_s", "max_s"}
    p = rep["plain"]
    assert p["calls"] == 3 and 0 <= p["mean_s"] <= p["max_s"] <= p["total_s"]
    assert p["mean_s"] == pytest.approx(p["total_s"] / 3)
    after = tprof.timing_report()
    assert (after == {} and tprof.spans() == []) if reset else after.keys() == rep.keys()


def test_spans_in_a_window():
    for name in ("a", "b", "c"):
        with tprof.stage_timer(name):
            pass
    a, b, c = tprof.spans()
    assert [s.name for s in tprof.spans(b.start_ns, b.end_ns)] == ["b"]
    assert [s.name for s in tprof.spans(since_ns=b.start_ns)] == ["b", "c"]
    assert [s.name for s in tprof.spans(until_ns=b.end_ns)] == ["a", "b"]
    assert tprof.spans(c.end_ns + 1) == []


# ------------------------------------------------------- the profiler
def test_spans_land_in_a_profiler_trace(tmp_path):
    """Under a CPU torch.profiler each span is a host op of its name around
    the ops it ran, not a user annotation (which the profiler mirrors onto
    the card's timeline as if it were device work); a span still open when
    the profiler stops closes cleanly."""
    import json

    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with tprof.stage_timer("traced.outer"):
        with tprof.stage_timer("traced.inner"):
            torch.ones(8).sum()
    with tprof.stage_timer("traced.open"):
        prof.stop()
    names = [e.name for e in prof.events()]
    assert "traced.outer" in names and "traced.inner" in names and "aten::sum" in names
    assert {s.name for s in tprof.spans()} == {"traced.outer", "traced.inner", "traced.open"}
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as fh:
        cats = {e["name"]: e.get("cat") for e in json.load(fh)["traceEvents"]}
    assert cats["traced.outer"] == cats["traced.inner"] == "cpu_op"


def test_no_profiler_no_host_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler op {name!r} entered with no profiler running")

    monkeypatch.setattr(tprof, "_RecordFunctionFast", refuse)
    with tprof.stage_timer("quiet"):
        with tprof.stage_timer("quiet.inner"):
            pass
    assert tprof.timing_report()["quiet"]["calls"] == 1


# ------------------------------------------------------- the SR loop
@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
@pytest.mark.parametrize("with_hr", [False, True])
def test_run_batches_spans_one_of_each_a_group(with_hr, devices):
    """Each `sr_infer.*` span once a group (`stage` and `launch` once a
    device's block) with the group's number as item, and
    `sr_infer.assemble` counting the bytes handed to the callback: b = 3
    rows of predictions (and of metrics with hr), on one device and over
    two, where the group is padded to 4."""
    cfg = SRConfig(width=8, n_blocks=1, factor=4)
    params = init_sr(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(2)

    def item():
        lr = rng.normal(3, 1, (5, 8, 8)).astype(np.float32)
        return lr, rng.normal(3, 1, (5, 32, 32)).astype(np.float32) if with_hr else None

    chunks = [([f"{k}:{j}" for j in range(3)], [item() for _ in range(3)], []) for k in range(4)]
    seen = []
    fail = sr_infer.run_batches(chunks, params, cfg,
                                lambda p, preds, m: seen.append((preds, m)), device="cpu",
                                devices=devices)
    assert fail == [] and len(seen) == 4
    by = _by_name(tprof.spans())
    blocks = 1 if devices is None else len(devices)
    per_block = [g for g in range(4) for _ in range(blocks)]
    want = {"sr_infer.source_wait": [0, 1, 2, 3, 4],
            "sr_infer.stage": per_block, "sr_infer.launch": per_block}
    for name in SR_NAMES:
        assert [s.item for s in by[name]] == want.get(name, [0, 1, 2, 3]), name
    dispatch = {s.item: s.id for s in by["sr_infer.dispatch"]}
    for name in ("sr_infer.stage", "sr_infer.launch"):
        assert all(s.parent == dispatch[s.item] for s in by[name])
    for name in set(SR_NAMES) - {"sr_infer.stage", "sr_infer.launch"}:
        assert all(s.parent is None for s in by[name]), name
    nbytes = 3 * (5 * 32 * 32 + (2 if with_hr else 0)) * 4
    for s, (preds, mets) in zip(by["sr_infer.assemble"], seen, strict=True):
        assert s.counts == {"bytes": nbytes}
        assert preds.nbytes + (mets.nbytes if with_hr else 0) == nbytes


# ------------------------------------------------------- the fleet
def _fleet(scenes: int, k: int):
    cfg = SingleKernelConfig(
        iters=k, hr_patch_size=32, lr_crop_size=4, batch_size=2, steps_per_call=k,
        real_is_lr=True, raw_sum_reg=0.1, fake_noise_sigma=(0.1,) * 5, outdir="unused",
        verbose=False, save_intermediate=False,
        generator=GeneratorConfig(mid_ch=8, forward_mode="compose"),
        discriminator=DiscriminatorConfig(base_ch=8, num_blocks=1))
    states = [init_training(dataclasses.replace(cfg, seed=s), "cpu") for s in range(scenes)]
    gen = torch.Generator().manual_seed(5)
    pool = torch.randn((scenes, 6, 5, 32, 32), generator=gen) + 3
    crops = torch.randn((scenes, 10, 5, 4, 4), generator=gen) + 3
    chunks = [fleet._stack_states(states)]
    host_rngs = None if k > 1 else [np.random.default_rng(s) for s in range(scenes)]
    adv = fleet.make_fleet_advance(cfg, chunks, pool, crops, [6] * scenes, [10] * scenes,
                                   host_rngs)
    return adv, chunks


@pytest.mark.parametrize("scenes,k", [(1, 3), (2, 3), (2, 1)])
def test_fleet_advance_spans_each_phase_a_step(scenes, k):
    """One advance at K steps: each `kernelgan.*` phase K times with the
    step count as item, one `fleet.draw` and `fleet.gather` a step, one
    `fleet.collect` at K > 1, `scene_its` summing to K x S, and no span
    inside another."""
    adv, _ = _fleet(scenes, k)
    adv()
    rows = tprof.spans()
    by = _by_name(rows)
    for name in GAN_PHASES + ("fleet.draw", "fleet.gather"):
        assert [s.item for s in by[name]] == list(range(k)), name
    assert [s.item for s in by["fleet.collect"]] == ([0] if k > 1 else [])
    assert sum(s.counts["scene_its"] for s in by["fleet.gather"]) == k * scenes
    assert all(s.parent is None for s in rows)


@pytest.mark.parametrize("scenes", [1, 2])
def test_fleet_step_is_bit_equal_under_the_profiler(scenes):
    from torch.profiler import ProfilerActivity, profile

    plain, plain_chunks = _fleet(scenes, 2)
    traced, traced_chunks = _fleet(scenes, 2)
    want = plain()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = traced()
    assert "kernelgan.d_update" in {e.name for e in prof.events()}
    for a, b in zip(want, got):
        for key in ("loss_D", "loss_G_adv", "grad_norm_D", "grad_norm_G", "kernels"):
            assert torch.equal(a[key], b[key]), key
    for tree in ("g_params", "d_params", "d_state"):
        for a, b in zip(tree_leaves(getattr(plain_chunks[0], tree)),
                        tree_leaves(getattr(traced_chunks[0], tree))):
            assert torch.equal(a, b), tree


# ------------------------------------------- the benchmark's span readers
BENCH = __import__("pathlib").Path(__file__).resolve().parents[1] / "benchmark"
SPAN_METRICS = ("sr_infer.assemble_ms_per_batch", "sr_infer.assemble_gb_per_s",
                "sr_infer.unspanned_ms_per_batch", "fleet.host_ms_per_scene_it",
                "kernelgan.update_ms_per_scene_it")


def _metric(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"metric_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traced_run(monkeypatch, before: int, inside: int, bytes_=1000):
    """Spans written before and inside a traced window into a ring of 8;
    returns a run with the window's perf_counter marks."""
    import time
    import types

    monkeypatch.syspath_prepend(str(BENCH))
    monkeypatch.setattr(tprof, "_RING", collections.deque(maxlen=8))
    monkeypatch.setattr(tprof, "RING_SPANS", 8)

    def step(i):
        with tprof.stage_timer("sr_infer.assemble", item=i, bytes=bytes_):
            time.sleep(0.0005)
        with tprof.stage_timer("fleet.gather", item=i, scene_its=1):
            pass
        with tprof.stage_timer("kernelgan.d_update", item=i):
            pass

    for i in range(before):
        step(i)
    time.sleep(0.002)
    t0 = time.perf_counter()
    for i in range(inside):
        step(before + i)
    t1 = time.perf_counter()
    return types.SimpleNamespace(trace_t0=t0, trace_t1=t1)


@pytest.mark.parametrize("before,inside,whole", [(1, 2, True), (9, 2, True), (0, 3, False),
                                                  (2, 5, False)])
def test_bench_window_refused_once_the_ring_dropped_part_of_it(monkeypatch, before, inside, whole):
    """The benchmark's `spans.traced` gives the window's spans while the
    ring holds all of them, a ring wrapped before the window included, and
    None, for every span metric, once the ring dropped a span of it."""
    import importlib

    run = _traced_run(monkeypatch, before, inside)
    got = importlib.import_module("spans").traced(run)
    values = {name: _metric(name).read(run) for name in SPAN_METRICS}
    if whole:
        t0, t1, rows = got
        assert [s.item for s in rows if s.name == "sr_infer.assemble"] == list(
            range(before, before + inside))
        assert all(v is not None and v > 0 for v in values.values()), values
    else:
        assert got is None and all(v is None for v in values.values()), values


def test_bench_assemble_rate_is_bytes_over_span_time(monkeypatch):
    run = _traced_run(monkeypatch, 0, 2, bytes_=10**6)
    done = [s for s in tprof.spans() if s.name == "sr_infer.assemble"]
    ns = sum(s.end_ns - s.start_ns for s in done)
    assert _metric("sr_infer.assemble_gb_per_s").read(run) == pytest.approx(2e6 / ns)


@pytest.mark.parametrize("replayed", [2, 1, 0])
def test_bench_replay_share_is_the_window_replays_over_its_gathers(monkeypatch, replayed):
    """`fleet.replay_share` on the ring's spans: 100 x the `scene_its` of
    the `kernelgan.replay` spans started in the window over those its
    `fleet.gather` spans counted (a replay before the window left out);
    nothing when the window holds no replay."""
    import time
    import types

    monkeypatch.syspath_prepend(str(BENCH))
    with tprof.stage_timer("kernelgan.replay", item=0, scene_its=3):
        pass
    t0 = time.perf_counter()
    for i in range(2):
        with tprof.stage_timer("fleet.gather", item=i, scene_its=3):
            pass
        name = "kernelgan.replay" if i < replayed else "kernelgan.d_update"
        with tprof.stage_timer(name, item=i, **({"scene_its": 3} if i < replayed else {})):
            pass
    run = types.SimpleNamespace(trace_t0=t0, trace_t1=time.perf_counter())
    got = _metric("fleet.replay_share").read(run)
    assert got == (50.0 * replayed if replayed else None)
