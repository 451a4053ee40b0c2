"""PyTorch port: the ASW twin (passive/asw_ref.py) and the kernel wrapper
(passive/asw_cuda.py) on the CPU, against the JAX package.

Tolerances:
- cost volumes: the same inf pattern exactly, rtol 1e-5 on finite
  entries (the twin keeps the oracle's arithmetic order; 1e-5 leaves room
  for summation-order differences between XLA and PyTorch);
- disparities: mismatch <= 1.2%, the budget of tests/test_passive_asw.py
  (argmin near-ties flip on last-ulp cost differences);
- the reference-C++ golden maps: <= 3%, as tests/test_passive_asw.py;
- occlusion fill: bit-exact (integer code).
"""

import os

import numpy as np
import pytest
import torch

from simplestereo_tpu.passive import asw_ref as jax_ref
from simplestereo_tpu.passive.lab import bgr_to_lab as jax_bgr_to_lab
from simplestereo_tpu_torch.passive import asw_cuda, asw_ref

MISMATCH = 0.012


def _pair(seed, h=21, w=37, shift=3):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, -shift, axis=1)


@pytest.mark.parametrize("direction", [+1, -1])
@pytest.mark.parametrize("win,min_disp,max_disp,step",
                         [(7, 1, 6, 1), (5, 0, 4, 2), (5, 0, 17, 1)])
def test_cost_volume_matches_jax(direction, win, min_disp, max_disp, step):
    img1, img2 = _pair(1)
    if direction < 0:
        img1, img2 = img2, img1
    f1, f2 = img1.astype(np.float32), img2.astype(np.float32)
    l1 = np.asarray(jax_bgr_to_lab(img1))
    l2 = np.asarray(jax_bgr_to_lab(img2))
    args = (win, 5.0, 17.5, min_disp, max_disp, direction, step)
    want, want_ok = jax_ref._cost_volume(f1, f2, l1, l2, *args)
    got, got_ok = asw_ref._cost_volume(
        torch.tensor(f1), torch.tensor(f2), torch.tensor(l1),
        torch.tensor(l2), *args)
    want, got = np.asarray(want), got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)


@pytest.mark.parametrize("consistent", [False, True])
@pytest.mark.parametrize("min_disp,max_disp,win,step",
                         [(1, 6, 7, 1), (0, 4, 5, 1), (1, 6, 7, 2),
                          (0, 17, 7, 1)])
def test_asw_disparity_ref_matches_jax(consistent, min_disp, max_disp, win,
                                       step):
    img1, img2 = _pair(2)
    kw = dict(win_size=win, max_disp=max_disp, min_disp=min_disp,
              consistent=consistent, step=step)
    want = np.asarray(jax_ref.asw_disparity_ref(img1, img2, **kw))
    got = asw_ref.asw_disparity_ref(torch.tensor(img1), torch.tensor(img2),
                                    **kw).numpy()
    assert got.dtype == np.int16 and got.shape == want.shape
    assert (got != want).mean() <= MISMATCH


def test_asw_disparity_ref_negative_min_disp():
    """min_disp < 0: the twin marks candidates whose matched column leaves
    the image on either side as invalid; the JAX oracle checks only one
    side, so the two are compared where that side cannot be reached
    (columns x >= -min_disp)."""
    img1, img2 = _pair(3, h=24, w=48)
    kw = dict(win_size=5, max_disp=16, min_disp=-3, consistent=True)
    want = np.asarray(jax_ref.asw_disparity_ref(img1, img2, **kw))
    got = asw_ref.asw_disparity_ref(torch.tensor(img1), torch.tensor(img2),
                                    **kw).numpy()
    assert (got[:, 3:] != want[:, 3:]).mean() <= MISMATCH


@pytest.mark.parametrize("invalid", [-1, -4])
def test_occlusion_fill_matches_jax(invalid):
    rng = np.random.default_rng(4)
    disp = rng.integers(0, 9, (6, 23)).astype(np.int32)
    disp[rng.random(disp.shape) < 0.4] = invalid
    disp[2] = invalid                      # a row with no valid pixel
    disp[3, :5] = invalid                  # a border run on each side
    disp[3, -4:] = invalid
    want = np.asarray(jax_ref.occlusion_fill(disp, invalid=invalid))
    got = asw_ref.occlusion_fill(torch.tensor(disp), invalid=invalid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[2] == invalid).all()


def test_occlusion_fill_semantics():
    row = torch.tensor([[5, -1, -1, 3, -1, 7]], dtype=torch.int32)
    assert asw_ref.occlusion_fill(row).tolist() == [[5, 3, 3, 3, 3, 7]]
    row = torch.tensor([[-1, -1, 4, -1]], dtype=torch.int32)
    assert asw_ref.occlusion_fill(row).tolist() == [[4, 4, 4, 4]]


def test_reference_cpp_golden_fixture():
    """The four ASW maps of the reference C++ kernels in
    tests/golden/matcher_golden.npz, through the port's CPU path."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "matcher_golden.npz"))
    img1, img2 = torch.tensor(g["img1"]), torch.tensor(g["img2"])
    cases = {
        "asw_w7_d1_6": dict(win_size=7, max_disp=6, min_disp=1,
                            consistent=False),
        "asw_w7_d1_6_cons": dict(win_size=7, max_disp=6, min_disp=1,
                                 consistent=True),
        "asw_w5_d0_4": dict(win_size=5, max_disp=4, min_disp=0,
                            consistent=False),
        "asw_w7_d0_17_cons": dict(win_size=7, max_disp=17, min_disp=0,
                                  consistent=True),
    }
    for name, kw in cases.items():
        ours = asw_cuda.asw_disparity(img1, img2, **kw).numpy()
        mismatch = (ours != g[name]).mean()
        assert mismatch <= 0.03, f"{name}: {mismatch:.2%} vs reference C++"


def _planes(seed, B=2, h=12, w=20, win=5, min_disp=-2, max_disp=5):
    rng = np.random.default_rng(seed)
    imgs1 = rng.integers(0, 256, (B, h, w, 3), np.uint8)
    imgs2 = np.roll(imgs1, -2, axis=2)
    planes = asw_cuda._build_planes(torch.tensor(imgs1), torch.tensor(imgs2),
                                    win, min_disp, max_disp)
    kw = dict(H=h, W=w, win_size=win, min_disp=min_disp, max_disp=max_disp,
              gamma_c=5.0, gamma_p=17.5)
    return imgs1, imgs2, planes, kw


def test_build_planes_layout():
    imgs1, imgs2, planes, kw = _planes(5)
    pad, left, right = asw_cuda._pads(5, -2, 5)
    assert (pad, left, right) == (2, 7, 4)
    assert tuple(planes.shape) == (2, 12, 12 + 4, 20 + 11)
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    inner = planes[:, :, pad:pad + 12, left:left + 20].permute(0, 2, 3, 1)
    np.testing.assert_array_equal(inner[..., 6:9].numpy(), imgs1)
    np.testing.assert_array_equal(inner[..., 9:12].numpy(), imgs2)
    ring = torch.ones(planes.shape[2:], dtype=torch.bool)
    ring[pad:pad + 12, left:left + 20] = False
    assert (planes[:, 0:6][..., ring] == asw_cuda.LAB_SENTINEL).all()
    assert (planes[:, 6:12][..., ring] == 0).all()


@pytest.mark.parametrize("consistent,subpixel", [(False, False),
                                                 (True, True)])
def test_plain_pass_selection(consistent, subpixel):
    """The wrapper's CPU path: first-minimum left map, right map from the
    same volume (cost_R(x, d) = cost(x + d, d), inf off the image) and the
    winner's neighbourhood, checked against a direct numpy reading of the
    volume it returns."""
    _, _, planes, kw = _planes(6)
    before = asw_cuda.launches
    cost, dispL, dispR, csub = asw_cuda._asw_pass(
        planes, consistent=consistent, subpixel=subpixel, **kw)
    assert asw_cuda.launches == before  # the CPU path launches nothing
    c = cost.numpy()
    B, D, H, W = c.shape
    assert (B, D, H, W) == (2, 8, 12, 20)
    xs = np.arange(W)
    ds = np.arange(-2, 6)
    tgt = xs[None, :] - ds[:, None]
    np.testing.assert_array_equal(
        np.isinf(c), np.broadcast_to(((tgt < 0) | (tgt > W - 1))[None, :, None],
                                     c.shape))
    best = c.argmin(1)
    np.testing.assert_array_equal(dispL.numpy(), best - 2)
    assert (dispR is None) == (not consistent)
    assert (csub is None) == (not subpixel)
    if consistent:
        src = xs[None, :] + ds[:, None]
        ok = (src >= 0) & (src <= W - 1)
        cR = np.where(ok[None, :, None],
                      np.take_along_axis(
                          c, np.broadcast_to(np.clip(src, 0, W - 1)[None, :,
                                                                    None],
                                             c.shape), 3), np.inf)
        np.testing.assert_array_equal(dispR.numpy(), cR.argmin(1) - 2)
    if subpixel:
        s = csub.numpy()
        c0 = np.take_along_axis(c, best[:, None], 1)[:, 0]
        np.testing.assert_array_equal(s[:, 1], c0)
        cm = np.where(best >= 1, np.take_along_axis(
            c, np.maximum(best - 1, 0)[:, None], 1)[:, 0], 0)
        np.testing.assert_array_equal(s[:, 0], cm)


def test_pass_rejects_what_the_kernel_cannot_take():
    _, _, planes, kw = _planes(7)
    with pytest.raises(ValueError, match="no ASW kernel"):
        asw_cuda._asw_pass(planes.to("meta"), **kw)
    with pytest.raises(ValueError, match="float32"):
        asw_cuda._asw_pass(planes.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        asw_cuda._asw_pass(planes.transpose(2, 3).contiguous()
                           .transpose(2, 3), **kw)
    with pytest.raises(ValueError, match="planes must be"):
        asw_cuda._asw_pass(planes[:, :, 1:], **kw)
    with pytest.raises(ValueError, match="odd"):
        asw_cuda._asw_pass(planes, **dict(kw, win_size=4))
