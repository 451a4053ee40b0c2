"""The ``sgm_cloud720`` configuration's pieces on the CPU: the BT
reference (``reference/sgm_bt.py``) equal to the port bit for bit, its
speckle filter equal to the port's host filter, the reference free of the
port, the control failing the limit, whole runs with each planted fault
not correct, and the speckle filter's two readers on hand-made events."""

import json
import shutil
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_SCENE, TINY_TRAFFIC
from portbench.harness import core, scenes, spec
from portbench.harness.faults import FAULTS, plant
from portbench.harness.trace import CALL_RANGE, Trace

H100 = "NVIDIA H100 80GB HBM3"
CLOUD = json.loads((ROOT / "portbench" / "configs"
                    / "sgm_cloud720.json").read_text())["params"]


def ref():
    return spec.Bench().module("reference", "sgm_bt")


def pairs(n, w, h, seed=11, scene=TINY_SCENE):
    rng = core.rngs(seed)[0]
    made = [scenes.layered_pair(rng, w, h, scene)[:2] for _ in range(n)]
    return (np.stack([a for a, _ in made]), np.stack([b for _, b in made]))


@pytest.mark.parametrize("params", [
    dict(CLOUD, numDisparities=12, speckleWindowSize=20),
    dict(CLOUD, numDisparities=12, blockSize=5, P1=0, P2=0, paths=4,
         disp12MaxDiff=-1, speckleWindowSize=0),
    dict(CLOUD, minDisparity=0, numDisparities=16, blockSize=3, P1=0, P2=0,
         uniquenessRatio=0, disp12MaxDiff=0, preFilterCap=15,
         speckleWindowSize=8, speckleRange=1),
], ids=["cloud-small", "paths4-no-lr", "block3-lr0"])
def test_the_bt_reference_equals_the_port(params):
    from simplestereo_tpu_torch.passive import StereoSGM
    lefts, rights = pairs(3, 72, 36)
    want = StereoSGM(**params, device="cpu").computeBatch(lefts, rights)
    got = ref().disparity({"params": params}, lefts, rights, "cpu", block=2)
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_the_speckles_equal_the_host_filter(seed):
    from simplestereo_tpu_torch.passive.sgm import filter_speckles
    rng = np.random.default_rng(seed)
    cell = int(rng.integers(1, 4))
    coarse = rng.integers(-4, 9, (3, 40 // cell + 1, 60 // cell + 1)) * 16
    maps = np.repeat(np.repeat(coarse, cell, 1), cell, 2)[:, :40, :60]
    maps = (maps + rng.integers(-20, 21, maps.shape)
            * (rng.random(maps.shape) < 0.2)).astype(np.int16)
    size, max_diff = int(rng.integers(1, 30)), int(rng.choice([1, 16, 32]))
    got = ref().speckles(torch.tensor(maps), -16, size, max_diff).numpy()
    want = np.stack([filter_speckles(m, -16, size, max_diff) for m in maps])
    assert np.array_equal(got, want)


def test_the_reference_imports_nothing_of_the_port():
    text = (spec.BENCH_DIR / "reference" / "sgm_bt.py").read_text()
    assert "simplestereo" not in text
    assert "jax" not in text.lower()


def test_the_control_fails_the_limit():
    cell = spec.Bench().cell("sgm_cloud720.frame")
    lefts, rights = pairs(2, 224, 64, seed=3_000_000_019,
                          scene=cell.traffic["scene"])
    want = ref().disparity(cell.config, lefts, rights, "cpu")
    low = ref().disparity(cell.config, lefts, rights, "cpu",
                          dtype=torch.bfloat16)
    assert core.worst_map_mismatch_pct(low, want) \
        > cell.config["limits"]["mismatch_pct"]


TINY_BT = {"entry": "stereo_sgm", "reference": "sgm_bt",
           "params": dict(CLOUD, numDisparities=12, speckleWindowSize=20),
           "image": {"height": 32, "width": 48},
           "limits": {"mismatch_pct": 0.0}}
TINY_BT_CELLS = [("tiny_bt.frame", "tiny.frame"),
                 ("tiny_bt.batch2", "tiny.batch2")]


@pytest.fixture(scope="module")
def bt_bench(tmp_path_factory):
    """A copy of the benchmark with a BT cell at a CPU size added, as a
    later change would: new files and new entries only."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "tiny_bt.json").write_text(
        json.dumps(TINY_BT))
    bench["configs"].append({"name": "tiny_bt", "source": "a CPU test",
                             "file": "portbench/configs/tiny_bt.json",
                             "reduced": [], "why": "CPU test"})
    for name, traffic in TINY_BT_CELLS:
        (root / "portbench" / "traffic" / f"{traffic}.json").write_text(
            json.dumps(TINY_TRAFFIC[traffic]))
        bench["workloads"].append({"name": name, "config": "tiny_bt",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return spec.Bench(root=root, bench_dir=root / "portbench")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", [c for c, _ in TINY_BT_CELLS])
def test_a_broken_timed_path_is_not_correct(bt_bench, cell_name, fault):
    cell = bt_bench.cell(cell_name)
    mend = plant(cell, fault)
    if mend is None:
        pytest.skip(f"{fault} needs a stack of pairs a call")
    try:
        r = core.run(cell, 2**31 + 23, 0.3, False, "cpu", 0.0)
    finally:
        mend()
    assert not r["correct"]
    assert r["checks"]["mismatch_pct"]["value"] \
        > r["checks"]["mismatch_pct"]["limit"]


@pytest.mark.parametrize("cell_name", [c for c, _ in TINY_BT_CELLS])
def test_the_same_run_unbroken_is_correct(bt_bench, cell_name):
    r = core.run(bt_bench.cell(cell_name), 2**31 + 23, 0.3, False, "cpu",
                 0.0)
    assert r["correct"] and r["failed"] == 0


# -- the speckle filter's readers ---------------------------------------

def ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def one_call(t0, speckle=True):
    """A call of 100 us: match [10, 80) holding the post [20, 40) and,
    with ``speckle``, the filter [50, 78) and its four kernels (one
    launched through cuLaunchKernel), then the readback [80, 100)."""
    n = t0 * 10
    events = [
        ev("user_annotation", CALL_RANGE, t0, 100),
        ev("user_annotation", "match", t0 + 10, 70),
        ev("user_annotation", "sgm.post", t0 + 20, 20),
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 22, 2, n + 1),
        ev("kernel", "reduce_kernel", t0 + 30, 8, n + 1),
        ev("user_annotation", "readback", t0 + 80, 20),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t0 + 85, 10),
    ]
    if speckle:
        events += [ev("user_annotation", "sgm.speckle", t0 + 50, 28)]
        for i, k in enumerate(("speckle_local_kernel",
                               "speckle_border_kernel",
                               "speckle_roots_kernel",
                               "speckle_write_kernel")):
            cat = "cuda_driver" if i == 1 else "cuda_runtime"
            events += [ev(cat, "cudaLaunchKernel", t0 + 52 + 5 * i, 2,
                          n + 10 + i),
                       ev("kernel", f"{k}(short const*, int*)",
                          t0 + 60 + 4 * i, 3, n + 10 + i)]
    return events


def ctx_of(speckle=True):
    bench = spec.Bench()
    t = Trace(one_call(0, speckle) + one_call(200, speckle))
    return types.SimpleNamespace(trace=t, kind=H100,
                                 hand_kernels=bench.hand_kernels(),
                                 cell=bench.cell("sgm_cloud720.frame")), bench


def test_the_speckle_kernels_are_read_by_name():
    ctx, bench = ctx_of()
    assert bench.module("metrics", "speckle_device_ms").read(ctx) \
        == pytest.approx(0.012)
    roof = bench.module("metrics", "speckle_roofline")
    assert roof.read(ctx) == pytest.approx(
        100 * 1280 * 720 * 4 / 3.35e12 / 12e-6)
    # the speckle kernels are not among the accepted hand kernels: the
    # glue counts them with the post's reduce_kernel
    assert "speckle_local_kernel" not in bench.hand_kernels()
    assert bench.module("metrics", "glue_device_ms").read(ctx) \
        == pytest.approx(0.020)


def test_a_program_that_filters_on_the_host_reads_nothing():
    ctx, bench = ctx_of(speckle=False)
    for name in ("speckle_device_ms", "speckle_roofline"):
        assert bench.module("metrics", name).read(ctx) is None
    ctx.trace = None
    for name in ("speckle_device_ms", "speckle_roofline"):
        assert bench.module("metrics", name).read(ctx) is None


def test_the_bound_is_the_map_read_and_written_once():
    roof = spec.Bench().module("metrics", "speckle_roofline")
    ops, nbytes = roof.count(CLOUD, 720, 1280, 1)
    assert (ops, nbytes) == (0, 3_686_400)
    assert nbytes / 3.35e12 == pytest.approx(1.10e-6, rel=1e-3)


def test_the_cell_reports_its_metrics():
    cell = spec.Bench().cell("sgm_cloud720.frame")
    assert [m["name"] for m in cell.end_to_end] == [
        "results_per_s", "call_ms_p95", "setup_s"]
    # every accepted per-layer metric but K1's, and the two new ones
    assert [m["name"] for m in cell.per_layer] == [
        "device_idle_pct", "launches_per_call", "glue_device_ms",
        "copy_device_ms", "k2_roofline", "cost_device_ms",
        "finish_device_ms", "idle_in_match_ms", "readback_wait_ms",
        "package_import_s", "speckle_device_ms", "speckle_roofline"]
    assert cell.shape == (720, 1280) and cell.pairs_per_call == 1
