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

import sgm_post_cases as cases

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


# -- the post kernel's algorithm ---------------------------------------------
# csrc/sgm_kernel.cu: sgm_post_kernel, emulated in torch: a pixel's
# candidates k = g + G * j spread over the G lanes of a group (j < NJ in a
# lane), one pass that keeps each lane's first least value and scatters the
# right view's packed keys, a butterfly over the group, the second minimum
# outside best +- 1, the neighbours from the lanes that hold them, and the
# right view's winner decoded from the least key of each column.

def _right_key(v, k):
    """The kernel's right-view key as a signed int64 of the same order: the
    float's order-preserving bits (-0 read as +0) in the high word, k in
    the low one."""
    v = torch.where(v == 0, torch.zeros_like(v), v)
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 2**31, ~u & 0xFFFFFFFF, u | 2**31)
    return ((u - 2**31) << 32) + k  # minus 2**31: unsigned order, signed


def _butterfly(vals, pick):
    """Lane g takes lane g ^ o's entry where ``pick`` says, for o = G/2,
    ..., 1, over the last axis (the group); every lane ends equal."""
    G = vals[0].shape[-1]
    g = torch.arange(G)
    o = G // 2
    while o:
        other = [a[..., g ^ o] for a in vals]
        take = pick(other, vals)
        vals = [torch.where(take, b, a) for a, b in zip(vals, other)]
        o //= 2
    for a in vals:
        assert (a == a[..., :1]).all()
    return [a[..., 0] for a in vals]


def _emulate_post(S, min_disp, num_disp, uniqueness, disp12_max_diff,
                  subpixel):
    nj, G = sgm_cuda._post_plan(num_disp)
    nj = nj or -(-num_disp // G)  # NJ 0: the same candidates, read again
    *lead, H, W, D = S.shape
    x = torch.arange(W)[:, None]
    k = torch.arange(G * nj)  # k = g + G * j: lane g, register j
    inside = (k < D) & (k >= x - (W - 1) - min_disp) & (k <= x - min_disp)
    v = torch.full((*lead, H, W, G * nj), torch.inf)
    v[..., :D] = S
    v = torch.where(inside, v, torch.inf)  # masked as it is loaded
    lanes = v.unflatten(-1, (nj, G))

    # The pass: each lane's first least value, in j order ...
    bv, bk = lanes[..., 0, :], torch.arange(G).expand(lanes[..., 0, :].shape)
    for j in range(1, nj):
        less = lanes[..., j, :] < bv
        bv = torch.where(less, lanes[..., j, :], bv)
        bk = torch.where(less, j * G + torch.arange(G), bk)
    # ... and the group's least (value, k).
    bv, best = _butterfly([bv, bk], lambda o, s: (o[0] < s[0]) | (
        (o[0] == s[0]) & (o[1] < s[1])))
    valid = torch.isfinite(bv)
    if uniqueness > 0:
        off = k - best[..., None] + 1
        far = (off < 0) | (off > 2)  # (unsigned)(k - best + 1) > 2
        s2 = torch.where(far, v, torch.inf).unflatten(-1, (nj, G)).amin(-2)
        s2, = _butterfly([s2], lambda o, s: o[0] < s[0])
        valid &= ~(s2 * 100.0 < bv * (100.0 + uniqueness))
    disp = best + min_disp
    d16 = disp.to(torch.float32) * 16.0
    if subpixel:
        def pick(kk):  # register kk // G of lane kk % G
            reg = lanes.gather(-2, (kk // G)[..., None, None].expand(
                *kk.shape, 1, G))[..., 0, :]
            return reg.gather(-1, (kk % G)[..., None])[..., 0]
        bm1 = pick((best - 1).clamp(min=0))
        bp1 = pick((best + 1).clamp(max=D - 1))
        bm1 = torch.where(torch.isfinite(bm1), bm1, bv)
        bp1 = torch.where(torch.isfinite(bp1), bp1, bv)
        denom = (bm1 + bp1) - 2.0 * bv
        delta = torch.where(denom > 1e-6, (bm1 - bp1) / (2.0 * denom), 0.0)
        delta = delta.clamp(-0.5, 0.5)
        interior = (best > 0) & (best < D - 1)
        d16 = d16 + torch.where(interior, delta, 0.0) * 16.0
    marker = float((min_disp - 1) * 16)
    out = torch.where(valid, d16, marker).round().to(torch.int16)
    if disp12_max_diff >= 0:
        # Every in-image candidate's atomicMin on its right column's key.
        xr = (x - min_disp - k).clamp(0, W - 1).expand(W, G * nj)
        src = torch.where(inside, _right_key(v, k),
                          torch.iinfo(torch.int64).max)
        keys = torch.full((*lead, H, W), int(_right_key(
            torch.tensor(torch.inf), 0)))
        keys = keys.scatter_reduce(-1, xr.flatten().expand(
            *lead, H, -1), src.flatten(-2), "amin")
        dr = (keys & 0xFFFFFFFF) + min_disp
        lr = torch.gather(dr, -1, (torch.arange(W) - disp).clamp(0, W - 1))
        out = torch.where((lr - disp).abs() > disp12_max_diff,
                          torch.tensor(marker).round().to(torch.int16), out)
    return out


def _jax_post(S, kw):
    """JAX's ``_sgm_post`` of a (..., H, W, D) S, one frame at a time."""
    frames = S.reshape(-1, *S.shape[-3:])
    return np.stack([np.asarray(jsgm._sgm_post(jnp.asarray(f), **kw))
                     for f in frames]).reshape(S.shape[:-1])


@pytest.mark.parametrize("kind", cases.KINDS)
def test_post_golden_is_jax(kind):
    """The maps tests/test_torch_sgm_post.py holds the kernel to are JAX's
    of today, on the S it generates (or JAX's own path sum)."""
    S, md = cases.planted(kind)
    if kind in cases.STORED:
        np.testing.assert_array_equal(S, _path_sum(md))
    want = cases.golden_maps(kind)
    for kw, w in zip(cases.options(md, S.shape[-1]), want):
        np.testing.assert_array_equal(_jax_post(S, kw), w)


@pytest.mark.parametrize("uniqueness", [0.0, 10.0])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("disp12_max_diff", [-1, 0, 1])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_post_kernel_algorithm_equals_twin(kind, disp12_max_diff, subpixel,
                                           uniqueness):
    """The emulated kernel and the twin, both equal to JAX's post."""
    S, md = cases.planted(kind)
    kw = dict(min_disp=md, num_disp=S.shape[-1], uniqueness=uniqueness,
              disp12_max_diff=disp12_max_diff, subpixel=subpixel)
    want = _jax_post(S, kw)
    got = _emulate_post(torch.tensor(S), **kw)
    assert got.dtype == torch.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sgm._sgm_post(torch.tensor(S), **kw).numpy(),
                                  want)


@pytest.mark.parametrize("D", [1, 16, 31, 96, 128, 129, 256, 300, 512, 513])
def test_post_plan_holds_every_candidate(D):
    nj, group = sgm_cuda._post_plan(D)
    assert group in (8, 16, 32)
    if D > sgm_cuda.POST_D_MAX:
        assert (nj, group) == (0, 32)
    else:
        assert nj in sgm_cuda.POST_NJ and group * nj >= D
        assert all(group * n < D for n in sgm_cuda.POST_NJ if n < nj)


def test_cpu_post_runs_the_twin():
    S = torch.tensor(_path_sum(0))
    before = sgm_cuda.post_launches
    kw = dict(min_disp=0, num_disp=9, uniqueness=10.0, disp12_max_diff=1,
              subpixel=True)
    np.testing.assert_array_equal(sgm._sgm_post(S, **kw).numpy(),
                                  np.asarray(jsgm._sgm_post(
                                      jnp.asarray(S.numpy()), **kw)))
    img1, img2 = _pair(15)
    sgm.StereoSGM(numDisparities=8, disp12MaxDiff=1, device="cpu").compute(
        img1, img2)
    assert sgm_cuda.post_launches == before


def test_post_refuses_other_devices():
    kw = dict(min_disp=0, num_disp=4, uniqueness=10.0, disp12_max_diff=-1,
              subpixel=True)
    with pytest.raises(ValueError, match="device meta"):
        sgm._sgm_post(torch.empty((3, 5, 4), device="meta"), **kw)


@pytest.mark.parametrize("S,match", [
    (torch.zeros(3, 5, 4), "CUDA"),
    (torch.zeros(3, 5, 4, dtype=torch.float64), "float32"),
    (torch.zeros(3, 5, 6), "float32"),
    (torch.zeros(5, 4), "float32"),
])
def test_post_kernel_refuses(S, match):
    before = sgm_cuda.post_launches
    with pytest.raises(ValueError, match=match):
        sgm_cuda.post(S, 0, 4, 10.0, -1, True)
    assert sgm_cuda.post_launches == before
