"""SGM's Birchfield-Tomasi cost: the BT kernels (``sgm_cuda.bt_cost``) and
their twin, the torch code of ``sgm._cost_from_gray``.

On the CPU a numpy spec of the kernels' direct formula, in the twin's
float32 operations and order,

    s, lo, hi  = the clipped x-Sobel of each image and the interval of it
                 and its two half-pixel interpolants
    h(y, x, d) = min(max(max(sL - hiR, loR - sL), 0),
                     max(max(sR - hiL, loL - sR), 0)), R at clamp(x - d)
    C(y, x, d) = at each of the box's columns (clamped to the image) a left
                 fold of h over the box's rows (clamped to the valid rows),
                 top row first, then a left fold of those sums, leftmost
                 first

holds the twin bit for bit; the dispatch rule and the wrapper's refusals
are checked too. Tests marked ``card`` run the kernels and skip without a
CUDA card. This file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sgm_bt.py
"""

import numpy as np
import pytest
import torch

import simplestereo_tpu_torch as tss
from cuda_card import card  # noqa: F401 (the fixture)
from simplestereo_tpu_torch.passive import sgm, sgm_cuda

# (B, H, W, min_disp, D, prefilter cap, block size): the caps (4 clips
# often, 63 at the strongest edges only), blocks and min_disp in every
# combination, then D (96 and 128 wider than the image), an image narrower
# than D, stacks of 1, 3 and 8 frames, and the largest block.
CASES = (
    [(1, 11, 23, md, 13, cap, k) for cap in (4, 63) for k in (1, 3, 5, 7, 9)
     for md in (-3, 0, 1)]
    + [(1, 7, 40, 1, D, 63, 3) for D in (1, 13, 16, 96, 128)]
    + [(1, 9, 6, -3, 13, 4, 5)]
    + [(B, 6, 19, 1, 16, 63, 3) for B in (1, 3, 8)]
    + [(1, 8, 30, 0, 16, 63, sgm_cuda.BT_BLOCK_MAX)])
# Valid rows of a row-tiled block (halo rows beyond the image, above,
# below or both; every row; none, which the twin reads as every row), on
# a 12-row image.
VALID = {"top": (3, 11), "bottom": (0, 8), "both": (2, 9), "all": (0, 11),
         "none": None}
# sgm_cloud720's matcher (portbench/configs/sgm_cloud720.json): example
# 011's StereoSGM, BT at block 7 with the left-right check and speckles.
CLOUD = dict(minDisparity=1, numDisparities=96, blockSize=7,
             disp12MaxDiff=1, speckleWindowSize=120, speckleRange=2)


def _ids(case):
    return "B{}-{}x{}-md{}-D{}-cap{}-k{}".format(*case)


def _grays(B, H, W, seed=0):
    """Two (B, H, W) float32 stacks: a few levels 20 apart, so the Sobel
    clips and neighbours tie often, with fractions on half the pixels;
    half of the right image is the left one moved 3 columns, so many costs
    are near zero."""
    rng = np.random.default_rng(seed)
    g = (rng.integers(0, 8, (2, B, H, W)) * 20).astype(np.float32)
    g += (rng.random((2, B, H, W), np.float32) * 0.75
          * (rng.random((2, B, H, W)) < 0.5))
    right = np.where(rng.random((B, H, W)) < 0.5,
                     np.roll(g[0], -3, axis=-1), g[1])
    return g[0], right.astype(np.float32)


def _valid(H, name):
    """(H,) bool row mask of VALID[name], and the rows the box reads."""
    span = VALID[name]
    v = np.zeros(H, bool)
    if span is not None:
        v[span[0]:span[1] + 1] = True
    return torch.as_tensor(v), span or (0, H - 1)


def _spec_planes(g, cap):
    """(s, lo, hi) of (B, H, W) float32 gray: the x-Sobel's six terms as a
    left fold, / 4 and clipped, then the interval of s and its
    interpolants, the neighbours clamped to the image."""
    H, W = g.shape[-2:]
    ys, xs = np.arange(H), np.arange(W)
    up, dn = np.clip(ys - 1, 0, H - 1), np.clip(ys + 1, 0, H - 1)
    lf, rt = np.clip(xs - 1, 0, W - 1), np.clip(xs + 1, 0, W - 1)

    def at(rows, cols):
        return g[:, rows][:, :, cols]

    two, cap = np.float32(2), np.float32(cap)
    dx = at(up, rt) + two * at(ys, rt)
    dx = dx + at(dn, rt)
    dx = dx - at(up, lf)
    dx = dx - two * at(ys, lf)
    dx = dx - at(dn, lf)
    s = np.clip(dx / np.float32(4), -cap, cap)
    half = np.float32(0.5)
    sm, sp = half * (s + s[..., lf]), half * (s + s[..., rt])
    return (s, np.minimum(np.minimum(sm, sp), s),
            np.maximum(np.maximum(sm, sp), s))


def _spec_h(g1, g2, min_disp, D, cap):
    """The pre-box cost h: (B, H, W, D) float32."""
    sL, loL, hiL = _spec_planes(g1, cap)
    sR, loR, hiR = _spec_planes(g2, cap)
    W = g1.shape[-1]
    xr = np.clip(np.arange(W)[:, None] - (min_disp + np.arange(D)), 0, W - 1)
    sL, loL, hiL = sL[..., None], loL[..., None], hiL[..., None]
    sR, loR, hiR = sR[..., xr], loR[..., xr], hiR[..., xr]
    c_rt = np.maximum(sL - hiR, loR - sL)
    c_tr = np.maximum(sR - hiL, loL - sR)
    zero = np.float32(0)
    return np.minimum(np.maximum(c_rt, zero), np.maximum(c_tr, zero))


def _spec_box(h, k, rows=None, columns_first=False):
    """The k x k box of h: at each clamped column a left fold over the
    rows (clamped to ``rows``, the image's by default), top row first,
    then a left fold of those sums, leftmost first; ``columns_first``
    swaps the two folds (another order, for contrast)."""
    H, W = h.shape[1:3]
    lo, hi = rows or (0, H - 1)
    off = np.arange(k) - k // 2
    cy = np.clip(np.arange(H)[:, None] + off, lo, hi)
    cx = np.clip(np.arange(W)[:, None] + off, 0, W - 1)
    inner, outer = (cx, cy) if columns_first else (cy, cx)
    inner_axis, outer_axis = (2, 1) if columns_first else (1, 2)
    out = None
    for u in range(k):
        part = np.take(h, outer[:, u], axis=outer_axis)
        s = np.take(part, inner[:, 0], axis=inner_axis)
        for t in range(1, k):
            s = s + np.take(part, inner[:, t], axis=inner_axis)
        out = s if out is None else out + s
    return out


def _spec_cost(g1, g2, min_disp, D, cap, k, rows=None):
    """The kernels' formula: (B, H, W, D) float32; the box's rows clamped
    to ``rows`` (first, last), the image's by default."""
    return _spec_box(_spec_h(g1, g2, min_disp, D, cap), k, rows)


def _glue(g1, g2, min_disp, D, cap, k, **kw):
    return sgm._cost_from_gray(
        torch.as_tensor(g1), torch.as_tensor(g2), min_disp=min_disp,
        num_disp=D, block_size=k, prefilter_cap=float(cap),
        cost_method="bt", **kw)


def _twin(g1, g2, min_disp, D, cap, k, row_valid=None):
    """The torch code on the tensors' own device, whatever the dispatch."""
    C = sgm._bt_cost(sgm._xsobel(g1, float(cap)), sgm._xsobel(g2, float(cap)),
                     min_disp, D)
    if row_valid is not None:
        C = sgm._edge_fill_rows(C, row_valid, row_axis=C.dim() - 3)
    return sgm._box_sum(C, k)


def test_the_order_of_the_sums_shows():
    # On these values the order of the box's adds changes the result:
    # rows first (the twin's) equals the glue, columns first does not. So
    # the equalities below hold the order, not only the sums.
    g1, g2 = _grays(1, 20, 40, seed=5)
    h = _spec_h(g1, g2, 0, 16, 63)
    glue = _glue(g1, g2, 0, 16, 63, 7).numpy()
    assert h.dtype == np.float32 and (h > 0).mean() > 0.3 and (h == 0).any()
    np.testing.assert_array_equal(_spec_box(h, 7), glue)
    assert not np.array_equal(_spec_box(h, 7, columns_first=True), glue)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_glue_equals_the_kernels_formula(case):
    B, H, W, md, D, cap, k = case
    g1, g2 = _grays(B, H, W)
    got = _glue(g1, g2, md, D, cap, k)
    assert got.dtype == torch.float32 and got.shape == (B, H, W, D)
    np.testing.assert_array_equal(got.numpy(),
                                  _spec_cost(g1, g2, md, D, cap, k))


@pytest.mark.parametrize("k", (3, 9))
@pytest.mark.parametrize("name", VALID)
def test_glue_on_valid_rows_equals_the_kernels_formula(name, k):
    g1, g2 = _grays(2, 12, 17, seed=3)
    valid, rows = _valid(12, name)
    got = _glue(g1, g2, 1, 13, 4, k, row_valid=valid)
    np.testing.assert_array_equal(got.numpy(),
                                  _spec_cost(g1, g2, 1, 13, 4, k, rows))


@pytest.mark.parametrize("method, device, k, kernel", [
    ("bt", "cuda", 1, "bt"),
    ("bt", "cuda:0", sgm_cuda.BT_BLOCK_MAX, "bt"),
    ("bt", "cuda", sgm_cuda.BT_BLOCK_MAX + 2, None),
    ("bt", "cpu", 3, None),
    ("bt+census", "cuda", 3, None),
    ("census", "cuda", 3, "census"),
    ("census", "cuda", sgm_cuda.CENSUS_BLOCK_MAX + 2, None),
    ("census", "cpu", 3, None),
])
def test_dispatch_rule(method, device, k, kernel):
    assert sgm._cost_kernel(method, torch.device(device), k) == kernel


def test_cpu_bt_takes_the_glue():
    g1, g2 = _grays(2, 12, 30)
    before = sgm_cuda.bt_launches
    _glue(g1, g2, 0, 8, 63, 3)
    _glue(g1, g2, 0, 8, 63, 3, row_valid=_valid(12, "both")[0])
    m = tss.passive.StereoSGM(numDisparities=8, blockSize=5, device="cpu")
    m.compute(g1[0].astype(np.uint8), g2[0].astype(np.uint8))
    m.computeBatch(g1.astype(np.uint8), g2.astype(np.uint8))
    assert sgm_cuda.bt_launches == before


@pytest.mark.parametrize("bad, match", [
    ({}, "CUDA"),
    ({"gray2": torch.zeros(5, 8)}, "shape"),
    ({"gray2": torch.zeros(1, 6, 8)}, "shape"),
    ({"gray1": torch.zeros(0, 8), "gray2": torch.zeros(0, 8)}, "non-empty"),
    ({"gray1": torch.zeros(6, 8, dtype=torch.float64)}, "float32"),
    ({"block_size": 4}, "block"),
    ({"block_size": 0}, "block"),
    ({"block_size": sgm_cuda.BT_BLOCK_MAX + 2}, "block"),
    ({"num_disp": 0}, "num_disp"),
])
def test_bt_cost_refuses(bad, match):
    kw = dict(gray1=torch.zeros(6, 8), gray2=torch.zeros(6, 8), min_disp=0,
              num_disp=4, prefilter_cap=63.0, block_size=3)
    before = sgm_cuda.bt_launches
    with pytest.raises(ValueError, match=match):
        sgm_cuda.bt_cost(**{**kw, **bad})
    assert sgm_cuda.bt_launches == before


def test_census_and_bt_refuse_in_the_same_words():
    g = torch.zeros(6, 8)
    for block in (4, 0):
        with pytest.raises(ValueError) as bt:
            sgm_cuda.bt_cost(g, g, 0, 4, 63.0, block)
        with pytest.raises(ValueError) as census:
            sgm_cuda.census_cost(g, g, 0, 4, 5, block)
        assert (str(bt.value).replace(str(sgm_cuda.BT_BLOCK_MAX), "MAX")
                == str(census.value).replace(
                    str(sgm_cuda.CENSUS_BLOCK_MAX), "MAX"))
    with pytest.raises(ValueError, match="^the BT kernels take CUDA"):
        sgm_cuda.bt_cost(g, g, 0, 4, 63.0, 3)


# -- on the card ------------------------------------------------------------

def _kernel(card, g1, g2, md, D, cap, k, **kw):
    before = sgm_cuda.bt_launches
    got = _glue(torch.tensor(g1, device=card), torch.tensor(g2, device=card),
                md, D, cap, k, **kw)
    torch.cuda.synchronize()
    assert sgm_cuda.bt_launches == before + 1
    return got


@pytest.mark.card
@pytest.mark.parametrize("case", CASES + [
    (1, 720, 1280, 1, 96, 63, 7),    # sgm_cloud720's shapes, one frame
    (70_000, 2, 3, 1, 13, 63, 1),    # two launches, scalar stores
    (70_000, 2, 3, -2, 16, 4, 3),    # two launches, 16-byte stores
], ids=_ids)
def test_kernels_equal_the_glue(card, case):
    B, H, W, md, D, cap, k = case
    g1, g2 = _grays(B, H, W, seed=B * H + W)
    got = _kernel(card, g1, g2, md, D, cap, k)
    assert got.is_contiguous() and got.shape == (B, H, W, D)
    assert torch.equal(got.cpu(), _glue(g1, g2, md, D, cap, k))


@pytest.mark.card
@pytest.mark.parametrize("case", [
    (8, 720, 1280, 1, 96, 63, 7),    # a stack at sgm_cloud720's shapes
    (1, 720, 1280, 0, 128, 15, 3),   # chip_smoke's BT main path
    (2, 300, 517, -5, 61, 63, 11),   # ragged: D % 4 != 0, the largest block
], ids=_ids)
def test_kernels_equal_the_twin_on_the_card(card, case):
    B, H, W, md, D, cap, k = case
    g1, g2 = (torch.tensor(g, device=card) for g in _grays(B, H, W, seed=H))
    got = _kernel(card, g1.cpu().numpy(), g2.cpu().numpy(), md, D, cap, k)
    assert torch.equal(got, _twin(g1, g2, md, D, cap, k))


@pytest.mark.card
@pytest.mark.parametrize("k", (3, 9, sgm_cuda.BT_BLOCK_MAX))
@pytest.mark.parametrize("name", VALID)
def test_valid_rows_equal_the_glue(card, name, k):
    g1, g2 = _grays(2, 12, 40, seed=k)
    valid = _valid(12, name)[0]
    got = _kernel(card, g1, g2, -1, 20, 63, k, row_valid=valid.to(card))
    assert torch.equal(got.cpu(), _glue(g1, g2, -1, 20, 63, k,
                                        row_valid=valid))


@pytest.mark.card
def test_other_costs_and_blocks_take_the_glue(card):
    g1, g2 = (torch.tensor(g, device=card) for g in _grays(2, 16, 40))
    before = sgm_cuda.bt_launches
    sgm._cost_from_gray(g1, g2, min_disp=0, num_disp=8, block_size=3,
                        prefilter_cap=63.0, cost_method="bt+census",
                        census_window=5)
    k = sgm_cuda.BT_BLOCK_MAX + 2
    big = sgm._cost_from_gray(g1, g2, min_disp=1, num_disp=4, block_size=k,
                              prefilter_cap=63.0, cost_method="bt")
    assert sgm_cuda.bt_launches == before
    assert torch.equal(big, _twin(g1, g2, 1, 4, 63, k))
    with pytest.raises(ValueError, match="rows"):
        sgm_cuda.bt_cost(g1, g2, 0, 8, 63.0, 3,
                         torch.zeros(2, dtype=torch.int64, device=card))
    assert sgm_cuda.bt_launches == before


@pytest.mark.card
def test_no_count_without_a_launch(card, monkeypatch):
    before = sgm_cuda.bt_launches
    empty = torch.zeros(0, 6, 8, device=card)
    with pytest.raises(ValueError, match="non-empty"):
        sgm_cuda.bt_cost(empty, empty, 0, 4, 63.0, 3)

    def refused(*args, what):
        raise RuntimeError(f"{what}: refused")

    monkeypatch.setattr(sgm_cuda.LIBRARY, "launch", refused)
    g = torch.zeros(6, 8, device=card)
    with pytest.raises(RuntimeError, match="^BT kernel launch failed"):
        sgm_cuda.bt_cost(g, g, 0, 4, 63.0, 3)
    assert sgm_cuda.bt_launches == before


@pytest.mark.card
@pytest.mark.parametrize("bad", [
    dict(block=sgm_cuda.BT_BLOCK_MAX + 2), dict(block=2), dict(B=0),
    dict(B=65_536), dict(D=0), dict(C=4)])
def test_entry_refuses(card, bad):
    # The C entry's own checks, past the wrapper's: C is 16-byte aligned
    # where D % 4 == 0, so an offset of 4 bytes is refused.
    g = torch.zeros(3, 4, 8, device=card)
    planes = torch.empty(3, 2, 3, 4, 8, device=card)
    out = torch.empty(3, 4, 8, 4, device=card)
    kw = {**dict(B=3, D=4, block=3, C=0), **bad}
    with pytest.raises(RuntimeError, match="^BT entry: invalid argument$"):
        sgm_cuda.LIBRARY.launch(
            "sgm_bt_cost", card, g.data_ptr(), g.data_ptr(), None,
            planes.data_ptr(), out.data_ptr() + kw["C"], kw["B"], 4, 8, 0,
            kw["D"], kw["block"], 63.0, what="BT entry")


@pytest.mark.card
@pytest.mark.parametrize("kw", [
    dict(minDisparity=1, numDisparities=16, blockSize=7, disp12MaxDiff=1),
    dict(minDisparity=-3, numDisparities=13, blockSize=5, preFilterCap=4,
         paths=4),
])
def test_matcher_on_the_card_equals_the_cpu(card, kw):
    rng = np.random.default_rng(7)
    left = rng.integers(0, 256, (3, 40, 72, 3), np.uint8)
    right = np.roll(left, -4, axis=2)
    gpu = tss.passive.StereoSGM(device="cuda", **kw)
    cpu = tss.passive.StereoSGM(device="cpu", **kw)
    before = sgm_cuda.bt_launches
    np.testing.assert_array_equal(gpu.compute(left[0], right[0]),
                                  cpu.compute(left[0], right[0]))
    np.testing.assert_array_equal(gpu.computeBatch(left, right),
                                  cpu.computeBatch(left, right))
    assert sgm_cuda.bt_launches == before + 2


@pytest.mark.card
def test_cloud720_matcher_equals_the_twin_s(card, monkeypatch):
    # sgm_cloud720's matcher at 1280x720, its cost from the kernels, and
    # the same matcher with its cost from the torch code on the card.
    rng = np.random.default_rng(11)
    left = rng.integers(0, 256, (2, 720, 1280, 3), np.uint8)
    right = np.roll(left, -9, axis=2)
    m = tss.passive.StereoSGM(device="cuda", **CLOUD)
    before = sgm_cuda.bt_launches
    one = m.compute(left[0], right[0])
    batch = m.computeBatch(left, right)
    assert sgm_cuda.bt_launches == before + 2
    monkeypatch.setattr(sgm, "_cost_kernel", lambda *args: None)
    np.testing.assert_array_equal(one, m.compute(left[0], right[0]))
    np.testing.assert_array_equal(batch, m.computeBatch(left, right))
    assert sgm_cuda.bt_launches == before + 2
    assert (np.abs(one[8:-8, 110:-8] / 16.0 - 9) <= 0.5).mean() > 0.9
