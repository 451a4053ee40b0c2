"""BENCHMARK.json against the benchmark's contract, and the harness's
claim that a new cell needs new files and new entries only."""

import hashlib
import json
import re

import pytest

from conftest import ROOT, TINY_CELLS
from portbench.harness import core, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 * 24 runs, each run_seconds + 60,
    # 2 * 90 s a cell to compile, 1200 s spare, within 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = {"configs": set(), "workloads": set(), "metrics": set()}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names["configs"].add(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert line(w["why"])
        names["workloads"].add(w["name"])
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in SOURCES
            names["metrics"].add(m["name"])
    count = lambda k: len(BENCH[k])  # noqa: E731
    assert len(names["configs"]) == count("configs")
    assert len(names["workloads"]) == count("workloads")
    assert len(names["metrics"]) == count("end_to_end") + count("per_layer")
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == count("workloads")
    assert 1 <= count("configs") <= 24 and 1 <= count("workloads") <= 24
    assert 1 <= count("end_to_end") <= 16 and 1 <= count("per_layer") <= 128
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) \
        <= max(1, count("workloads") // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in BENCH["per_layer"])


def test_every_name_finds_its_files():
    bench = spec.Bench()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        cell = bench.cell(w["name"])
        cell.entry(), cell.reference()
        assert cell.per_layer and cell.end_to_end
        p = cell.config["params"]
        lo = p.get("minDisparity", 0)
        hi = p.get("maxDisparity", lo + p.get("numDisparities", 1) - 1)
        scene = cell.traffic["scene"]
        assert all(lo <= d <= hi for d in [scene["background"]]
                   + [layer[0] for layer in scene["layers"]])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(bench.module("metrics", m["name"]).read)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A copy of the benchmark gains two configurations, two traffic
    mixes and four cells; every file it had stays as it was, and each new
    cell resolves and runs through the copy's harness on the CPU."""
    import shutil

    from conftest import add_tiny_cells
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    add_tiny_cells(tmp_path)
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {tmp_path.joinpath("BENCHMARK.json").relative_to(
        tmp_path)}
    old = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key in old:  # entries added, none changed or removed
        if isinstance(old[key], list) and old[key] \
                and isinstance(old[key][0], dict):
            assert new[key][:len(old[key])] == old[key]
        else:
            assert new[key] == old[key]
    bench = spec.Bench(root=tmp_path, bench_dir=tmp_path / "portbench")
    for name, _, _ in TINY_CELLS:
        r = core.run(bench.cell(name), 2**31 + 3, 0.2, False, "cpu", 0.0)
        assert r["correct"], r["checks"]
        assert set(r["metrics"]) == {"results_per_s", "call_ms_p95",
                                     "setup_s"}
        assert list(r)[-1] == "checks"
