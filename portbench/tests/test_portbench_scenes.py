"""The scenes: drawn from the seed alone, new in every call, and true to
their layers (the right view shows each seen left pixel at its
disparity, and nearer layers hide some)."""

import json

import numpy as np
import pytest

from conftest import ROOT
from portbench.harness import core, scenes

TRAFFIC = sorted((ROOT / "portbench" / "traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 5, 3_000_000_000)


def _scene(path):
    return json.loads(path.read_text())["scene"]


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_is_deterministic_from_the_seed(seed):
    scene = _scene(TRAFFIC[0])
    a = scenes.pool(core.rngs(seed)[0], 64, 40, scene, 4, 2)
    b = scenes.pool(core.rngs(seed)[0], 64, 40, scene, 4, 2)
    for (l1, r1), (l2, r2) in zip(a, b):
        assert np.array_equal(l1, l2) and np.array_equal(r1, r2)


def test_seeds_and_calls_differ():
    scene = _scene(TRAFFIC[0])
    pools = [scenes.pool(core.rngs(s)[0], 64, 40, scene, 6, 1)
             for s in SEEDS]
    for p in pools:  # consecutive calls, and every pair of the pool
        lefts = [left for left, _ in p]
        assert all(not np.array_equal(a, b)
                   for i, a in enumerate(lefts) for b in lefts[i + 1:])
    firsts = [p[0][0] for p in pools]
    assert all(not np.array_equal(a, b)
               for i, a in enumerate(firsts) for b in firsts[i + 1:])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_batch_pool_stacks_consecutive_pairs(seed):
    scene = _scene(TRAFFIC[0])
    one = scenes.pool(core.rngs(seed)[0], 64, 40, scene, 6, 1)
    three = scenes.pool(core.rngs(seed)[0], 64, 40, scene, 6, 3)
    assert [x[0].shape for x in three] == [(3, 40, 64, 3)] * 2
    assert np.array_equal(three[1][1][2], one[5][1])


def test_pool_needs_two_calls():
    with pytest.raises(ValueError):
        scenes.pool(core.rngs(0)[0], 64, 40, _scene(TRAFFIC[0]), 8, 8)


@pytest.mark.parametrize("path", TRAFFIC, ids=lambda p: p.stem)
def test_scene_is_true_to_its_layers(path):
    scene = _scene(path)
    w = 2 * max(d for d, *_ in scene["layers"]) + 64
    h = 48
    left, right, disp, nonocc = scenes.layered_pair(
        core.rngs(11)[0], w, h, scene)
    assert left.dtype == right.dtype == np.uint8
    assert left.shape == right.shape == (h, w, 3)
    boxes = scenes.layer_boxes(w, h, scene)
    assert set(np.unique(disp)) <= {b[0] for b in boxes}
    ys, xs = np.nonzero(nonocc)
    assert np.array_equal(right[ys, xs - disp[ys, xs]], left[ys, xs])
    # occlusions inside the image, not only past its left border
    inner = ~nonocc & (np.arange(w)[None, :] >= disp)
    assert inner.any()
    assert nonocc.mean() > 0.5
