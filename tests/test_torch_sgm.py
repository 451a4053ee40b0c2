"""PyTorch port: the SGM functions (passive/sgm.py) and the aggregation
wrapper and twin (passive/sgm_cuda.py) on the CPU, against the JAX
package on the same numpy-seeded inputs.

Tolerances:
- gray, Sobel prefilter, edge shift, BT and census costs, box sum, the
  whole cost volume, the post pass and the copied speckle filter:
  bit-equal. The port does the JAX functions' float operations in their
  order (the census Hamming distance is an integer count), and a census
  bit flips on any ulp of gray, so nothing looser would be honest;
- the twin ``_aggregate``: ``atol=1e-3`` against JAX ``_aggregate`` and
  against ``sgm_pallas.aggregate_pallas(..., interpret=True)``, the JAX
  package's own bound between its two aggregators
  (tests/test_passive_asw.py::test_sgm_pallas_aggregation_matches_scan).
  Against ``_aggregate`` it is in fact bit-equal (same min/add steps,
  same summation order), and the test asserts that too; the Pallas
  kernel sums the paths in another order, so only the bound holds there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplestereo_tpu.passive import sgm as jsgm
from simplestereo_tpu.passive.sgm_pallas import aggregate_pallas
from simplestereo_tpu_torch.passive import sgm, sgm_cuda

ATOL_AGG = 1e-3


def _pair(seed, h=24, w=40, shift=3):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, -shift, axis=1)


def _grays(seed):
    img1, img2 = _pair(seed)
    return (np.asarray(jsgm.bgr_to_gray(img1)),
            np.asarray(jsgm.bgr_to_gray(img2)))


def _volume(seed, shape):
    return np.random.default_rng(seed).uniform(0, 50, shape).astype(
        np.float32)


@pytest.mark.parametrize("color", [True, False])
def test_bgr_to_gray_matches_jax(color):
    img, _ = _pair(1)
    if not color:
        img = img[..., 1]
    got = sgm.bgr_to_gray(torch.tensor(img)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jsgm.bgr_to_gray(img)))


@pytest.mark.parametrize("cap", [15.0, 63.0])
def test_xsobel_matches_jax(cap):
    g, _ = _grays(2)
    np.testing.assert_array_equal(sgm._xsobel(torch.tensor(g), cap).numpy(),
                                  np.asarray(jsgm._xsobel(g, cap)))


@pytest.mark.parametrize("d", [0, 3, -4, 40, -55])
def test_shift_edge_matches_jax(d):
    g, _ = _grays(3)
    np.testing.assert_array_equal(sgm._shift_edge(torch.tensor(g), d).numpy(),
                                  np.asarray(jsgm._shift_edge(g, d)))


@pytest.mark.parametrize("min_disp,num_disp", [(0, 8), (-4, 11), (2, 30)])
def test_bt_cost_matches_jax(min_disp, num_disp):
    g1, g2 = _grays(4)
    s1, s2 = np.asarray(jsgm._xsobel(g1, 63.0)), np.asarray(
        jsgm._xsobel(g2, 63.0))
    want = np.asarray(jsgm._bt_cost(s1, s2, min_disp, num_disp))
    got = sgm._bt_cost(torch.tensor(s1), torch.tensor(s2), min_disp,
                       num_disp).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win", [3, 5, 7])
@pytest.mark.parametrize("min_disp,num_disp", [(0, 8), (-4, 11)])
def test_census_cost_matches_jax(win, min_disp, num_disp):
    g1, g2 = _grays(5)
    want = np.asarray(jsgm._census_cost(g1, g2, min_disp, num_disp, win))
    got = sgm._census_cost(torch.tensor(g1), torch.tensor(g2), min_disp,
                           num_disp, win).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win", [3, 5, 7])
def test_census_words_match_jax(win):
    """The port's one int64 code holds the JAX uint32 words' bits: word w
    is bits 24w .. 24w+23."""
    g, _ = _grays(6)
    words = [np.asarray(w).astype(np.int64)
             for w in jsgm._census_words(g, win)]
    want = sum(w << (24 * i) for i, w in enumerate(words))
    np.testing.assert_array_equal(
        sgm._census_words(torch.tensor(g), win).numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_box_sum_matches_jax(k):
    C = _volume(7, (16, 24, 11))
    np.testing.assert_array_equal(sgm._box_sum(torch.tensor(C), k).numpy(),
                                  np.asarray(jsgm._box_sum(C, k)))


@pytest.mark.parametrize("cost_method", ["bt", "census", "bt+census"])
@pytest.mark.parametrize("rows", [None, (2, 21)])
def test_sgm_cost_matches_jax(cost_method, rows):
    """The whole cost volume, and the row-sharded form (rows outside
    [lo, hi) invalid, filled from the nearest valid row)."""
    img1, img2 = _pair(8)
    row_valid = None
    if rows is not None:
        row_valid = np.zeros(img1.shape[0], bool)
        row_valid[rows[0]:rows[1]] = True
    kw = dict(min_disp=-2, num_disp=9, block_size=3, prefilter_cap=31.0,
              cost_method=cost_method, census_window=7)
    want = np.asarray(jsgm._sgm_cost(
        img1, img2, row_valid=None if rows is None else jnp.asarray(
            row_valid), **kw))
    got = sgm._sgm_cost(torch.tensor(img1), torch.tensor(img2),
                        row_valid=None if rows is None else torch.tensor(
                            row_valid), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_sgm_cost_rejects_unknown_method():
    img1, img2 = _pair(8)
    with pytest.raises(ValueError, match="costMethod"):
        sgm._sgm_cost(torch.tensor(img1), torch.tensor(img2), min_disp=0,
                      num_disp=4, block_size=3, prefilter_cap=15.0,
                      cost_method="sad")


@pytest.mark.parametrize("paths", [4, 8])
@pytest.mark.parametrize("shape", [(24, 40, 8), (16, 24, 11), (9, 5, 3)])
def test_aggregate_twin_matches_jax(paths, shape):
    C = _volume(9, shape)
    got = sgm_cuda._aggregate(torch.tensor(C), 8.0, 32.0, paths).numpy()
    scan = np.asarray(jsgm._aggregate(jnp.asarray(C), 8.0, 32.0, paths))
    pallas = np.asarray(aggregate_pallas(jnp.asarray(C), 8.0, 32.0, paths,
                                         interpret=True))
    np.testing.assert_allclose(got, scan, rtol=0, atol=ATOL_AGG)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_AGG)
    # Recorded: bit-equal to the JAX scan aggregator, not only within atol.
    np.testing.assert_array_equal(got, scan)


def test_aggregate_wrapper_cpu_runs_twin_per_frame():
    """On a CPU tensor the wrapper runs the twin (no launch is counted),
    and a frame stack gives the per-frame sums bit for bit."""
    C = _volume(10, (2, 12, 20, 6))
    before = sgm_cuda.launches
    S = sgm_cuda.aggregate(torch.tensor(C), 12.0, 40.0, 8)
    assert sgm_cuda.launches == before
    assert S.shape == C.shape and S.dtype == torch.float32
    for i in range(2):
        np.testing.assert_array_equal(
            S[i].numpy(),
            sgm_cuda.aggregate(torch.tensor(C[i]), 12.0, 40.0, 8).numpy())


@pytest.mark.parametrize("make,err", [
    (lambda c: c.to(torch.float64), "float32"),
    (lambda c: c.transpose(0, 1), "contiguous"),
    (lambda c: c[0], r"\(H, W, D\)"),
    (lambda c: c[:, :0], "empty"),
    (lambda c: torch.empty(c.shape, device="meta"), "device meta"),
])
def test_aggregate_refusals(make, err):
    C = torch.tensor(_volume(11, (6, 8, 4)))
    with pytest.raises(ValueError, match=err):
        sgm_cuda.aggregate(make(C), 8.0, 32.0, 8)


@functools.cache
def _path_sum(min_disp):
    """JAX path sum of a noise pair with a true shift of 3, D = 9."""
    img1, img2 = _pair(12)
    return np.asarray(jsgm._aggregate(jsgm._sgm_cost(
        img1, img2, min_disp=min_disp, num_disp=9, block_size=3,
        prefilter_cap=63.0), 24.0, 96.0, 8))


@pytest.mark.parametrize("min_disp", [0, -3])
@pytest.mark.parametrize("disp12_max_diff", [-1, 1])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("uniqueness", [0.0, 10.0])
def test_sgm_post_matches_jax(min_disp, disp12_max_diff, subpixel,
                              uniqueness):
    S = _path_sum(min_disp)
    kw = dict(min_disp=min_disp, num_disp=9, uniqueness=uniqueness,
              disp12_max_diff=disp12_max_diff, subpixel=subpixel)
    want = np.asarray(jsgm._sgm_post(jnp.asarray(S), **kw))
    got = sgm._sgm_post(torch.tensor(S), **kw).numpy()
    assert want.dtype == np.int16 and got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    # the invalid marker occurs, so the comparison covers it
    assert (got == (min_disp - 1) * 16).any() or disp12_max_diff < 0


@pytest.mark.parametrize("max_diff,size", [(16, 10), (1, 4), (32, 30)])
def test_filter_speckles_copy_matches_jax(max_diff, size):
    rng = np.random.default_rng(13)
    d = (rng.integers(0, 6, (30, 40)) * 16).astype(np.int16)
    d[5:15, 5:20] = 48
    np.testing.assert_array_equal(
        sgm.filter_speckles(d, -16, size, max_diff),
        jsgm.filter_speckles(d, -16, size, max_diff))
