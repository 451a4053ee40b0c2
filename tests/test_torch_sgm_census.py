"""SGM's census cost: the census kernels (``sgm_cuda.census_cost``) and
their twin, the torch code of ``sgm._cost_from_gray``.

On the CPU a numpy spec of the kernels' direct formula,

    C(y, x, d) = sum over the box of popcount(L[cy, cx] ^ R[cy, clamp(cx - d)])

with cx the box's columns clamped to the image and cy its rows clamped to
the valid rows (the image's, or a row-tiled block's ``row_valid``), holds
the twin's indexing; the dispatch rule and the wrapper's refusals are
checked too. Tests marked ``card`` run the kernels and skip without a CUDA
card. This file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sgm_census.py
"""

import numpy as np
import pytest
import torch

import simplestereo_tpu_torch as tss
from cuda_card import card  # noqa: F401 (the fixture)
from simplestereo_tpu_torch.passive import sgm, sgm_cuda

# (B, H, W, min_disp, D, census window, block size): the windows, block
# sizes and min_disp in every combination, then D (96 and 128 wider than
# the image), an image narrower than D, stacks of 1, 3 and 8 frames, and
# blocks above 35 (sums a candidate a word), wider than the image.
CASES = (
    [(1, 11, 23, md, 13, win, k) for win in (3, 5, 7) for k in (1, 3, 5, 9)
     for md in (-3, 0, 1)]
    + [(1, 7, 40, 1, D, 5, 3) for D in (1, 13, 16, 96, 128)]
    + [(1, 9, 6, -3, 13, 7, 5)]
    + [(B, 6, 19, 1, 16, 7, 3) for B in (1, 3, 8)]
    + [(1, 7, 9, 1, 5, 7, 37), (2, 8, 10, -2, 8, 3, 41)])
# Valid rows of a row-tiled block (halo rows beyond the image, above,
# below or both; every row; none, which the twin reads as every row), each
# at a block of 3 and of 9 on a 12-row image.
VALID = {"top": (3, 11), "bottom": (0, 8), "both": (2, 9), "all": (0, 11),
         "none": None}


def _ids(case):
    return "B{}-{}x{}-md{}-D{}-win{}-k{}".format(*case)


def _grays(B, H, W, seed=0):
    """Two (B, H, W) float32 stacks: few levels, so neighbours tie often,
    on a fine ramp, so most do not."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 6, (2, B, H, W)).astype(np.float32)
    return g[0] + rng.random((B, H, W), np.float32) * 0.5 * (g[0] > 2), g[1]


def _valid(H, name):
    """(H,) bool row mask of VALID[name], and the rows the box reads."""
    span = VALID[name]
    v = np.zeros(H, bool)
    if span is not None:
        v[span[0]:span[1] + 1] = True
    return torch.as_tensor(v), span or (0, H - 1)


def _spec_codes(g, win):
    """Census codes of (B, H, W) gray: bit j iff the j-th window neighbour
    (row-major, centre skipped, clamped to the image) is the greater."""
    H, W = g.shape[-2:]
    p = win // 2
    ys, xs = np.mgrid[0:H, 0:W]
    code = np.zeros(g.shape, np.uint64)
    j = 0
    for di in range(-p, p + 1):
        for dj in range(-p, p + 1):
            if di == 0 and dj == 0:
                continue
            nb = g[:, np.clip(ys + di, 0, H - 1), np.clip(xs + dj, 0, W - 1)]
            code |= (nb > g).astype(np.uint64) << np.uint64(j)
            j += 1
    return code


def _spec_popcount(x):
    n = np.zeros(x.shape, np.int64)
    for b in range(48):
        n += ((x >> np.uint64(b)) & np.uint64(1)).astype(np.int64)
    return n


def _spec_cost(g1, g2, min_disp, D, win, k, rows=None):
    """The kernels' formula, cell by cell of the box: (B, H, W, D); the
    box's rows clamped to ``rows`` (first, last), the image's by default."""
    L, R = _spec_codes(g1, win), _spec_codes(g2, win)
    H, W = g1.shape[-2:]
    lo, hi = rows or (0, H - 1)
    off = np.arange(-(k // 2), k // 2 + 1)
    cy = np.clip(np.arange(H)[:, None] + off, lo, hi)[:, :, None, None, None]
    cx = np.clip(np.arange(W)[:, None] + off, 0, W - 1)[None, None, :, :,
                                                        None]
    rx = np.clip(cx - (min_disp + np.arange(D)), 0, W - 1)
    h = _spec_popcount(L[:, cy, cx] ^ R[:, cy, rx])  # (B, H, k, W, k, D)
    return h.sum(axis=(2, 4)).astype(np.float32)


def _glue(g1, g2, min_disp, D, win, k, **kw):
    return sgm._cost_from_gray(
        torch.as_tensor(g1), torch.as_tensor(g2), min_disp=min_disp,
        num_disp=D, block_size=k, prefilter_cap=63.0, cost_method="census",
        census_window=win, **kw)


def _twin(g1, g2, min_disp, D, win, k, row_valid=None):
    """The torch code on the tensors' own device, whatever the dispatch."""
    C = sgm._census_cost(g1, g2, min_disp, D, win)
    if row_valid is not None:
        C = sgm._edge_fill_rows(C, row_valid, row_axis=C.dim() - 3)
    return sgm._box_sum(C, k)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_glue_equals_the_kernels_formula(case):
    B, H, W, md, D, win, k = case
    g1, g2 = _grays(B, H, W)
    got = _glue(g1, g2, md, D, win, k)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, D)
    np.testing.assert_array_equal(got.numpy(),
                                  _spec_cost(g1, g2, md, D, win, k))


@pytest.mark.parametrize("k", (3, 9))
@pytest.mark.parametrize("name", VALID)
def test_glue_on_valid_rows_equals_the_kernels_formula(name, k):
    g1, g2 = _grays(2, 12, 17, seed=3)
    valid, rows = _valid(12, name)
    got = _glue(g1, g2, 1, 13, 5, k, row_valid=valid)
    np.testing.assert_array_equal(got.numpy(),
                                  _spec_cost(g1, g2, 1, 13, 5, k, rows))


def test_cpu_census_takes_the_glue():
    g1, g2 = _grays(2, 12, 30)
    before = sgm_cuda.census_launches
    _glue(g1, g2, 0, 8, 7, 3)
    _glue(g1, g2, 0, 8, 7, 3, row_valid=_valid(12, "both")[0])
    m = tss.passive.StereoSGM(numDisparities=8, costMethod="census",
                              censusWindow=7, device="cpu")
    m.compute(g1[0].astype(np.uint8), g2[0].astype(np.uint8))
    m.computeBatch(g1.astype(np.uint8), g2.astype(np.uint8))
    assert sgm_cuda.census_launches == before


def test_valid_range():
    for name in VALID:
        valid, rows = _valid(12, name)
        assert tuple(int(r) for r in sgm._valid_range(valid)) == rows


@pytest.mark.parametrize("bad, match", [
    ({}, "CUDA"),
    ({"census_window": 9}, "window"),
    ({"census_window": 1}, "window"),
    ({"gray2": torch.zeros(5, 8)}, "shape"),
    ({"gray2": torch.zeros(1, 6, 8)}, "shape"),
    ({"gray1": torch.zeros(6, 8, dtype=torch.float64)}, "float32"),
    ({"block_size": 4}, "block"),
    ({"block_size": 0}, "block"),
    ({"block_size": sgm_cuda.CENSUS_BLOCK_MAX + 2}, "block"),
    ({"num_disp": 0}, "num_disp"),
])
def test_census_cost_refuses(bad, match):
    kw = dict(gray1=torch.zeros(6, 8), gray2=torch.zeros(6, 8), min_disp=0,
              num_disp=4, census_window=5, block_size=3)
    before = sgm_cuda.census_launches
    with pytest.raises(ValueError, match=match):
        sgm_cuda.census_cost(**{**kw, **bad})
    assert sgm_cuda.census_launches == before


def test_census_block_max_keeps_sums_exact():
    # A box sum is at most 48 k * k; below 2**24 every float32 order of
    # summation gives the same whole number.
    k = sgm_cuda.CENSUS_BLOCK_MAX
    assert k % 2 == 1 and 48 * k * k < 2 ** 24 <= 48 * (k + 2) ** 2


# -- on the card ------------------------------------------------------------

def _kernel(card, g1, g2, md, D, win, k, **kw):
    before = sgm_cuda.census_launches
    got = _glue(torch.tensor(g1, device=card), torch.tensor(g2, device=card),
                md, D, win, k, **kw)
    torch.cuda.synchronize()
    assert sgm_cuda.census_launches == before + 1
    return got


@pytest.mark.card
@pytest.mark.parametrize("case", CASES + [
    (1, 288, 384, 0, 16, 7, 3),      # the census configuration at 384x288
    (1, 720, 1280, 1, 96, 7, 3),     # the benchmark's shapes
    (8, 720, 1280, 1, 96, 7, 3),
    (70_000, 2, 3, 1, 13, 3, 1),     # two launches, scalar stores
    (70_000, 2, 3, -2, 16, 5, 3),    # two launches, 16-byte stores
], ids=_ids)
def test_kernels_equal_the_glue(card, case):
    B, H, W, md, D, win, k = case
    g1, g2 = _grays(B, H, W, seed=B * H + W)
    got = _kernel(card, g1, g2, md, D, win, k)
    assert got.is_contiguous() and got.shape == (B, H, W, D)
    assert torch.equal(got.cpu(), _glue(g1, g2, md, D, win, k))


@pytest.mark.card
@pytest.mark.parametrize("case", [
    (1, 60, 70, 1, 32, 5, 45),       # the box's rows staged in two parts
    (2, 40, 50, -2, 13, 7, 101),     # in more parts, scalar stores
    (1, 9, 20, 0, 32, 3, 591),       # the largest: 16 candidates a block
], ids=_ids)
def test_large_blocks_equal_the_glue(card, case):
    B, H, W, md, D, win, k = case
    g1, g2 = _grays(B, H, W, seed=k)
    got = _kernel(card, g1, g2, md, D, win, k)
    want = _twin(torch.tensor(g1, device=card),
                 torch.tensor(g2, device=card), md, D, win, k)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("k", (3, 9, 45))
@pytest.mark.parametrize("name", VALID)
def test_valid_rows_equal_the_glue(card, name, k):
    g1, g2 = _grays(2, 12, 40, seed=k)
    valid = _valid(12, name)[0]
    got = _kernel(card, g1, g2, -1, 20, 7, k, row_valid=valid.to(card))
    assert torch.equal(got.cpu(), _glue(g1, g2, -1, 20, 7, k,
                                        row_valid=valid))


@pytest.mark.card
def test_other_costs_and_blocks_take_the_glue(card):
    g1, g2 = (torch.tensor(g, device=card) for g in _grays(2, 16, 40))
    before = sgm_cuda.census_launches
    for method in ("bt", "bt+census"):
        sgm._cost_from_gray(g1, g2, min_disp=0, num_disp=8, block_size=3,
                            prefilter_cap=63.0, cost_method=method,
                            census_window=5)
    k = sgm_cuda.CENSUS_BLOCK_MAX + 2
    big = _glue(g1, g2, 1, 4, 7, k)
    assert sgm_cuda.census_launches == before
    assert torch.equal(big, _twin(g1, g2, 1, 4, 7, k))
    with pytest.raises(ValueError, match="rows"):
        sgm_cuda.census_cost(g1, g2, 0, 8, 5, 3,
                             torch.zeros(2, dtype=torch.int64, device=card))
    assert sgm_cuda.census_launches == before


@pytest.mark.card
@pytest.mark.parametrize("bad", [
    dict(block=sgm_cuda.CENSUS_BLOCK_MAX + 2), dict(block=2), dict(win=9),
    dict(B=0), dict(B=65_536), dict(D=0), dict(C=4)])
def test_entry_refuses(card, bad):
    # The C entry's own checks, past the wrapper's: C is 16-byte aligned
    # where D % 4 == 0, so an offset of 4 bytes is refused.
    g = torch.zeros(3, 4, 8, device=card)
    codes = torch.empty(3, 2, 4, 8, dtype=torch.int64, device=card)
    out = torch.empty(3, 4, 8, 4, device=card)
    kw = {**dict(B=3, D=4, win=5, block=3, C=0), **bad}
    with pytest.raises(RuntimeError, match="^census entry: invalid argument$"):
        sgm_cuda.LIBRARY.launch(
            "sgm_census_cost", card, g.data_ptr(), g.data_ptr(), None,
            codes.data_ptr(), out.data_ptr() + kw["C"], kw["B"], 4, 8, 0,
            kw["D"], kw["win"], kw["block"], what="census entry")


@pytest.mark.card
@pytest.mark.parametrize("kw", [
    dict(minDisparity=1, numDisparities=16, blockSize=3, censusWindow=7,
         P1=120, P2=480),
    dict(minDisparity=-3, numDisparities=13, blockSize=5, censusWindow=5,
         disp12MaxDiff=1, paths=4),
])
def test_matcher_on_the_card_equals_the_glue(card, kw):
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (3, 40, 72, 3), np.uint8)
    right = np.roll(left, -4, axis=2)
    gpu = tss.passive.StereoSGM(costMethod="census", device="cuda", **kw)
    cpu = tss.passive.StereoSGM(costMethod="census", device="cpu", **kw)
    before = sgm_cuda.census_launches
    np.testing.assert_array_equal(gpu.compute(left[0], right[0]),
                                  cpu.compute(left[0], right[0]))
    np.testing.assert_array_equal(gpu.computeBatch(left, right),
                                  cpu.computeBatch(left, right))
    assert sgm_cuda.census_launches == before + 2
