"""Tests of the port's benchmark harness. They run on the CPU:

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA card and skip without one; run them on
the card with the same command."""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Cells small enough for the CPU: the two matchers at the benchmark's
# settings but for the window and the image, each one pair a call and two.
TINY_SCENE = {"background": 3, "layers": [[5, 0.1, 0.5, 0.2, 0.6],
                                          [8, 0.5, 0.8, 0.3, 0.9]]}
TINY_CONFIGS = {
    "tiny_asw": {"entry": "stereo_asw", "reference": "asw",
                 "params": {"winSize": 7, "minDisparity": 2,
                            "maxDisparity": 9, "gammaC": 15, "gammaP": 17.5,
                            "consistent": True},
                 "image": {"height": 32, "width": 48},
                 "limits": {"mismatch_pct": 0.0}},
    "tiny_sgm": {"entry": "stereo_sgm", "reference": "sgm",
                 "params": {"minDisparity": 1, "numDisparities": 12,
                            "blockSize": 3, "costMethod": "census",
                            "censusWindow": 7, "P1": 120, "P2": 480,
                            "paths": 8, "uniquenessRatio": 10,
                            "disp12MaxDiff": 1},
                 "image": {"height": 32, "width": 48},
                 "limits": {"mismatch_pct": 0.0}},
}
TINY_TRAFFIC = {
    "tiny.frame": {"pairs_per_call": 1, "pool_pairs": 4,
                   "scene": TINY_SCENE, "trace_skip": 1, "trace_calls": 2,
                   "check_calls": 3},
    "tiny.batch2": {"pairs_per_call": 2, "pool_pairs": 4,
                    "scene": TINY_SCENE, "trace_skip": 1, "trace_calls": 2,
                    "check_calls": 2},
}
TINY_CELLS = [(f"{c}.{t.split('.')[1]}", c, t)
              for c in TINY_CONFIGS for t in TINY_TRAFFIC]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    """The card, or a skip: decided inside the test, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 only")
    return torch.device("cuda:0")


def add_tiny_cells(root):
    """Add TINY_CONFIGS, TINY_TRAFFIC and TINY_CELLS to the benchmark at
    ``root`` as a later change would: new files and new BENCHMARK.json
    entries only."""
    bench = root / "portbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, conf in TINY_CONFIGS.items():
        (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
        spec["configs"].append({"name": name, "source": "a CPU test",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "CPU test"})
    for name, traffic in TINY_TRAFFIC.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    spec["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "CPU test"} for n, c, t in TINY_CELLS]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the tiny cells added."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    add_tiny_cells(root)
    return root


@pytest.fixture(scope="module")
def tiny_bench(tiny_root):
    from portbench.harness import spec
    return spec.Bench(root=tiny_root, bench_dir=tiny_root / "portbench")
