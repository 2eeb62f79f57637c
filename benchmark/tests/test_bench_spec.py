"""BENCHMARK.json against the benchmark's contract, alone and with the held
cells merged in (so either can be moved into it as it stands), every file
it names found by name, and the imports of the benchmark's sources."""
from __future__ import annotations

import ast
import json
import re

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(params=[False, True], ids=["committed", "with_held"])
def bench(request) -> dict:
    return harness.spec(held=request.param)


def test_held_cells_are_out_of_the_benchmark():
    cells = {w["name"] for w in harness.spec()["workloads"]}
    for path in sorted((harness.BENCH / "held").glob("*.json")):
        held = harness.load_json(path)
        assert _line(held["held"]) and set(held) <= {"held", "workloads", "end_to_end",
                                                     "per_layer"}
        assert [w["name"] for w in held["workloads"]] == [path.stem]
        assert path.stem not in cells


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        # every cell the metric lists reports the end-to-end metric it moves
        moved = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(moved)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:  # setup_s, one more end-to-end metric, one per-layer metric
        assert len(harness.cell_metrics(bench, cell, False)) >= 2
        assert harness.cell_metrics(bench, cell, True)


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert harness.load_json(harness.ROOT / c["file"])["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cfg, tr = harness.cell_files(w)
        drv = harness.driver(tr["driver"])
        assert all(callable(getattr(drv, f)) for f in ("setup", "window", "verify", "control"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def _imports(path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_anywhere_and_a_reference_of_its_own():
    # nor the JAX-era harnesses at the checkout's root
    banned = {"jax", "jaxlib", "flax", "kmsr_tpu", "bench", "bench_fleet", "bench_pipeline",
              "bench_scene", "bench_sr", "chip_smoke"}
    for path in harness.BENCH.rglob("*.py"):
        assert not _imports(path) & banned, path
    for path in (harness.BENCH / "reference").rglob("*.py"):
        assert "kmsr_tpu_torch" not in _imports(path), path
