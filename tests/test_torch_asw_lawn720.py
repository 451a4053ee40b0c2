"""The benchmark's ``asw_lawn720`` configuration (example 009's matcher:
``StereoASW(winSize=35, minDisparity=1, maxDisparity=90, gammaC=15,
gammaP=17.5, consistent=True, step=2)`` on a 1280x720 pair) against the
benchmark's plain reference, ``portbench/reference/asw.py``.

On the CPU the port's twin is held to the reference on small layered
scenes with this configuration's features: the step lattice (2 and 3),
the left-right check on and off, windows 7 and 11, and disparity ranges
that cross the kernel's chunks of 12 (1..13 and 1..30), with nearer
layers that occlude. The launch plan of the cell's shape, the
configuration and traffic files and K1's bound are pinned too. The
reference and the scene generator are loaded by path, as the benchmark
loads them; this file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_asw_lawn720.py
"""

import importlib.util
import itertools
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from cuda_card import card  # noqa: F401 (the fixture)
from simplestereo_tpu_torch.passive import StereoASW, asw_cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CONFIG = json.loads((BENCH / "configs" / "asw_lawn720.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "lawn720_d90.frame.json")
                     .read_text())
PARAMS = CONFIG["params"]
LIMIT = CONFIG["limits"]["mismatch_pct"]


def _load(rel):
    """A file of the benchmark imported by its path, as its harness does."""
    path = BENCH / rel
    name = "lawn720_" + path.stem
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("reference/asw.py")
scenes = _load("harness/scenes.py")


def _mismatch_pct(got, want):
    """Worst map's share (%) of pixels that differ, as the benchmark's
    check reads it."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.int16
    return float(max((g != w).mean() for g, w in zip(got, want)) * 100.0)


def _pairs(seed, W, H, scene, n):
    """``n`` (left, right) stacks of ``scene`` drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    made = [scenes.layered_pair(rng, W, H, scene) for _ in range(n)]
    return (np.stack([m[0] for m in made]), np.stack([m[1] for m in made]),
            np.stack([m[3] for m in made]))


def _small_scene(dmax):
    """The cell's scene cut to 1..dmax: a far band, a background in the
    middle of the range and two nearer layers, the nearest at dmax."""
    return {"background": max(dmax // 2, 2),
            "layers": [[2, 0.00, 1.00, 0.00, 0.15],
                       [dmax - 4, 0.10, 0.40, 0.30, 0.80],
                       [dmax, 0.55, 0.80, 0.20, 0.70]]}


# (step, consistent, winSize, maxDisparity): every combination.
CASES = list(itertools.product((2, 3), (True, False), (7, 11), (13, 30)))


@pytest.mark.parametrize("step,consistent,win,dmax", CASES,
                         ids=["step{}-{}-w{}-d{}".format(
                             s, "lr" if c else "nolr", w, d)
                             for s, c, w, d in CASES])
def test_twin_within_the_limit_of_the_reference(step, consistent, win, dmax):
    params = dict(PARAMS, winSize=win, maxDisparity=dmax, step=step,
                  consistent=consistent)
    lefts, rights, nonocc = _pairs(100 * step + win + dmax + consistent,
                                   160, 48, _small_scene(dmax), 2)
    assert not nonocc.all()  # the near layers occlude
    got = StereoASW(**params, device="cpu").computeBatch(lefts, rights)
    want = ref.disparity({"params": params}, lefts, rights, "cpu")
    assert _mismatch_pct(got, want) <= LIMIT
    if consistent:
        return
    # Without the check a differing pixel must be a near-tie of the
    # reference's own costs: the two sum in other orders.
    cost = ref.cost_volume(torch.as_tensor(lefts).float(),
                           torch.as_tensor(rights).float(), win,
                           float(params["gammaC"]), float(params["gammaP"]),
                           1, dmax, step).numpy()
    n, y, x = np.nonzero(got != want)
    a = cost[n, y, x, got[n, y, x] - 1]
    b = cost[n, y, x, want[n, y, x] - 1]
    assert np.all(np.abs(a - b) <= 1e-5 * np.abs(b))


def test_the_cell_walks_the_window_once_on_the_wide_path():
    """All 90 disparities in one wide chunk of 96 (8 groups of 12), every
    one of the lattice's 17 columns in one e2 group, one block of 16 warps
    an SM; the tile kernel would take eight chunks of 12."""
    args = (PARAMS["winSize"], PARAMS["step"],
            PARAMS["maxDisparity"] - PARAMS["minDisparity"] + 1, 1, 720, 1280)
    plan = asw_cuda._plan(*args)
    assert plan == dict(path="wide", chunk=96, dcp=100, jg=17,
                        smem=181_748, frames=1, grid=(40, 180, 1), step=2)
    tile = asw_cuda._tile_plan(*args)
    assert tile["path"] == "tile" and tile["chunk"] == 12
    assert tile["jg"] == 17 and tile["smem"] == 68_376
    assert tile["grid"] == (40, 90, 8)


def test_config_and_traffic_files_fit_together():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "asw_lawn720")
    assert entry["file"] == "portbench/configs/asw_lawn720.json"
    assert entry["reduced"] == CONFIG["reduced"] == ["scene"]
    cell = next(w for w in bench["workloads"]
                if w["name"] == "asw_lawn720.frame")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "asw_lawn720", "lawn720_d90.frame", 1)
    assert PARAMS == {"winSize": 35, "minDisparity": 1, "maxDisparity": 90,
                      "gammaC": 15, "gammaP": 17.5, "consistent": True,
                      "step": 2}
    assert not PARAMS.get("subpixel", False)
    assert CONFIG["image"] == {"height": 720, "width": 1280}
    scene = TRAFFIC["scene"]
    ds = [scene["background"]] + [layer[0] for layer in scene["layers"]]
    assert all(PARAMS["minDisparity"] <= d <= PARAMS["maxDisparity"]
               for d in ds)
    assert TRAFFIC["pairs_per_call"] == 1


def test_the_cells_scenes_occlude():
    _, _, nonocc = _pairs(7, 1280, 720, TRAFFIC["scene"], 1)
    assert 0.0 < (~nonocc).mean() < 0.5


def test_k1_bound_of_a_frame():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    k1 = _load("metrics/k1_roofline.py")
    ops, nbytes = k1.count(PARAMS, 720, 1280, 1)
    assert ops == 921_600 * (289 * (23 + 4 * 90) + 90 * 12)
    assert nbytes == 921_600 * (48 + 2 * 4)
    assert max(ops / 67e12, nbytes / 3.35e12) == pytest.approx(1.537e-3,
                                                               rel=1e-3)


@pytest.mark.card
@pytest.mark.parametrize("seed", [3_300_023_001, 4_100_023_777])
def test_cell_on_the_card_within_the_limit(card, seed):  # noqa: F811
    lefts, rights, _ = _pairs(seed, 1280, 720, TRAFFIC["scene"], 2)
    stereo = StereoASW(**PARAMS, device=card)
    before = asw_cuda.launches, asw_cuda.wide_launches
    got = []
    for k in range(len(lefts)):
        got.append(stereo.compute(lefts[k], rights[k]))
        assert (asw_cuda.launches, asw_cuda.wide_launches) == (
            before[0] + k + 1, before[1] + k + 1)
    got = np.stack(got)
    want = ref.disparity(CONFIG, lefts, rights, card)
    assert _mismatch_pct(got, want) <= LIMIT
