"""PyTorch port: the WLS smoother and the quality preset against the JAX
package, on the CPU (where the S2 kernel's wrapper runs its plain twin).

Tolerances, relative to the output's scale (atol = tol * max|ref|):

- the lambda schedule: equal to JAX's jitted expression (XLA folds its
  constants into one float32 factor; the port computes that factor);
- the line solve, ``_thomas_plain`` against ``_thomas_rows`` on the same
  diagonals, and ``_fgs`` given JAX's own weights: 1e-5 (XLA contracts
  ``d - lo * c`` into a fused multiply-add, the twin rounds twice, as the
  kernel does on the card; measured at most 3.3e-6, at lambda 128);
- the whole filter on the smooth-guide scenes of tests/test_wls.py: 1e-4,
  and the properties those tests assert;
- the whole filter with zero-confidence pixels on a noise guide: 2e-3.
  A marker pixel between tiny weights has a diagonal of eps plus those
  weights, and its value is a ratio of tiny numbers that amplifies any
  reordering: on the SGM preset's scene (seed 2) JAX's own jitted and
  eager runs differ by 5.5e-4, and the port differs from the jitted run
  by at most 6.5e-4 over 12 seeds (1.9e-7 on the 72x96 scenes below);
- the preset: the SGM leg's pre-WLS map bit-equal (the port's SGM is
  bit-equal to JAX's) and its filtered map within the zero-confidence
  bound; the ASW leg's map differs from JAX's only by argmin near-ties
  (the budget of tests/test_torch_asw.py) and its WLS pass is held to
  JAX's WLS of the port's map; the same ValueErrors.

The kernel's launch plan (a warp of lines a block, the grid, the frame
pieces, the workspace) is held to the H100's limits and to the source.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from simplestereo_tpu.passive import presets as jpresets
from simplestereo_tpu.passive import wls as jwls
from simplestereo_tpu_torch import _build
from simplestereo_tpu_torch.passive import presets, wls

SOLVE_TOL = 1e-5
WHOLE_TOL = 1e-4
ZERO_CONF_TOL = 2e-3


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _weights(rng, H, W, lam=4.0, conf_zero=0.0):
    """A WLS-like system of H lines of W: (d, lo, rhs) as _fgs builds them
    from noise weights, with a share of zero-confidence pixels."""
    w = np.exp(-rng.uniform(0, 6, (H, W - 1))).astype(np.float32)
    conf = (rng.random((H, W)) >= conf_zero).astype(np.float32)
    u = rng.normal(20, 5, (H, W)).astype(np.float32)
    lam = np.float32(lam)
    lo = -lam * w
    d = conf + np.float32(1e-5) + lam * (np.pad(w, ((0, 0), (1, 0)))
                                         + np.pad(w, ((0, 0), (0, 1))))
    return d, lo, conf * u + np.float32(1e-5) * u


def test_lam_schedule_matches_jax():
    """1,500 values: 100 lambdas x T 1..5 x every t."""
    rng = np.random.default_rng(1)
    lams = np.concatenate([rng.uniform(0.1, 1000, 93),
                           [2, 4, 64, 128, 200, 500, 1e-3]]).astype(
                               np.float32)
    n = 0
    for T in range(1, 6):
        for t in range(1, T + 1):
            f = jax.jit(lambda lam, t=t, T=T:
                        1.5 * lam * 4.0 ** (T - t) / (4.0 ** T - 1.0))
            for lam in lams:
                want = np.float32(f(jnp.float32(lam)))
                assert np.float32(wls._lam_schedule(lam, T, t)) == want
                n += 1
    assert n == 1500


@pytest.mark.parametrize("shape,conf_zero", [
    ((40, 56), 0.0), ((1, 30), 0.0), ((7, 1), 0.0), ((12, 2), 0.3),
    ((16, 40), 0.5)])
def test_thomas_plain_matches_jax(shape, conf_zero):
    rng = np.random.default_rng(3)
    d, lo, rhs = _weights(rng, *shape, conf_zero=conf_zero)
    want = jwls._thomas_rows(jnp.asarray(d), jnp.asarray(lo),
                             jnp.asarray(lo), jnp.asarray(rhs))
    got = wls._thomas_plain(*(torch.tensor(a) for a in (d, lo, lo, rhs)))
    _close(got, want, SOLVE_TOL)


@pytest.mark.parametrize("H,W,lam,sigma,invalid_share", [
    (40, 56, 4.0, 2.0, 0.0), (72, 96, 128.0, 8.0, 0.0),
    (72, 96, 2.0, 8.0, 0.025)])
def test_fgs_with_jax_weights(H, W, lam, sigma, invalid_share):
    rng = np.random.default_rng(4)
    d = rng.normal(20, 5, (H, W)).astype(np.float32)
    conf = (rng.random((H, W)) >= invalid_share).astype(np.float32)
    g = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    wx, wy = jwls._edge_weights(g, jnp.float32(sigma))
    want = jwls._fgs(d * conf, conf, wx, wy, jnp.float32(lam), 3)
    t = lambda a: torch.tensor(np.asarray(a))[None]
    got = wls._fgs(t(d * conf), t(conf), t(wx), t(wy),
                   float(np.float32(lam)), 3)[0]
    _close(got, want, SOLVE_TOL)


def test_edge_weights_match_jax(rng):
    g = rng.integers(0, 256, (2, 9, 13, 3)).astype(np.float32)
    wx, wy = wls._edge_weights(torch.tensor(g), 8.0)
    for i in range(2):
        jx, jy = jwls._edge_weights(g[i], jnp.float32(8.0))
        np.testing.assert_allclose(wx[i].numpy(), np.asarray(jx), rtol=1e-6)
        np.testing.assert_allclose(wy[i].numpy(), np.asarray(jy), rtol=1e-6)


# -- the scenes of tests/test_wls.py ------------------------------------------

def test_constant_signal_is_fixed_point(rng):
    guide = rng.integers(0, 256, (12, 18)).astype(np.float32)
    src = np.full((12, 18), 7.25, np.float32)
    out = wls.fast_global_smoother(src, guide, lambda_=500.0, device="cpu")
    _close(out, jwls.fast_global_smoother(src, guide, lambda_=500.0),
           WHOLE_TOL)
    np.testing.assert_allclose(out, 7.25, atol=1e-3)


def test_smooths_noise_within_regions(rng):
    src = np.full((16, 24), 10.0, np.float32)
    noisy = src + rng.normal(0, 1.0, src.shape).astype(np.float32)
    guide = np.zeros_like(src)
    out = wls.fast_global_smoother(noisy, guide, lambda_=200.0,
                                   device="cpu")
    _close(out, jwls.fast_global_smoother(noisy, guide, lambda_=200.0),
           WHOLE_TOL)
    assert np.abs(out - src).std() < 0.3 * np.abs(noisy - src).std()


def test_edge_preserving(rng):
    H, W = 16, 24
    guide = np.zeros((H, W), np.float32)
    guide[:, W // 2:] = 255.0
    src = np.zeros((H, W), np.float32)
    src[:, W // 2:] = 10.0
    noisy = src + rng.normal(0, 0.5, src.shape).astype(np.float32)
    out = wls.fast_global_smoother(torch.tensor(noisy), torch.tensor(guide),
                                   lambda_=200.0, sigma_color=8.0)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    out = out.numpy()
    _close(out, jwls.fast_global_smoother(noisy, guide, lambda_=200.0,
                                          sigma_color=8.0), WHOLE_TOL)
    assert np.abs(out[:, :W // 2 - 1]).max() < 1.0
    assert np.abs(out[:, W // 2 + 1:] - 10.0).max() < 1.0
    assert out[:, W // 2].mean() - out[:, W // 2 - 1].mean() > 8.0


def test_invalid_pixels_filled_from_neighbors():
    d = np.full((12, 20), 5.0 * 16, np.float32)
    d[5:7, 8:12] = -16.0
    guide = np.zeros((12, 20), np.float32)
    kw = dict(lambda_=64.0, invalid=-16, disp_scale=1 / 16.0)
    out = wls.wls_filter_disparity(d, guide, device="cpu", **kw)
    _close(out, jwls.wls_filter_disparity(d, guide, **kw), WHOLE_TOL)
    assert np.abs(out - 5.0).max() < 0.2


def test_batched_matches_per_frame(rng):
    d = rng.normal(8, 2, (2, 10, 14)).astype(np.float32)
    g = rng.integers(0, 256, (2, 10, 14, 3)).astype(np.float32)
    batch = wls.fast_global_smoother(d, g, lambda_=50.0, device="cpu")
    _close(batch, jwls.fast_global_smoother(d, g, lambda_=50.0), WHOLE_TOL)
    for i in range(2):
        # the frames of a stack are independent lines of one solve
        np.testing.assert_array_equal(
            batch[i], wls.fast_global_smoother(d[i], g[i], lambda_=50.0,
                                               device="cpu"))
    with pytest.raises(ValueError):
        wls.wls_filter_disparity(d[0, 0], g, device="cpu")
    with pytest.raises(ValueError):
        wls.wls_filter_disparity(d, g[:1], device="cpu")


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("lam,sigma,share,block", [
    (2.0, 8.0, 0.025, False), (128.0, 2.0, 0.025, True),
    (2.0, 0.5, 0.3, True)])
def test_zero_confidence_on_noise_guide(seed, lam, sigma, share, block):
    rng = np.random.default_rng(seed)
    H, W = 72, 96
    d = (rng.normal(20, 5, (H, W)) * 16).astype(np.float32)
    d[rng.random((H, W)) < share] = -16
    if block:
        d[20:40, 30:70] = -16
    g = rng.integers(0, 256, (H, W, 3)).astype(np.float32)
    kw = dict(lambda_=lam, sigma_color=sigma, invalid=-16,
              disp_scale=1 / 16.0)
    _close(wls.wls_filter_disparity(d, g, device="cpu", **kw),
           jwls.wls_filter_disparity(d, g, **kw), ZERO_CONF_TOL)


def test_numpy_input_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        wls.fast_global_smoother(np.zeros((4, 5), np.float32),
                                 np.zeros((4, 5), np.float32))


# -- the S2 launch plan --------------------------------------------------------

def test_plan_matches_the_kernel_source():
    """The kernel's block is 32 lines, one warp, and its static shared
    memory (three stages of conf, w and u tiles) stays under the 48 KB a
    block may take without opting in; the binding has the C signature's
    13 arguments."""
    src = (pathlib.Path(_build.__file__).parent / "csrc"
           / "thomas_kernel.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kLines"] == 32
    tile = const["kChunk"] * (const["kLines"] + 1)
    assert 3 * const["kStages"] * tile * 4 <= 48 * 1024
    assert "thomas_solve" in _build._SIGNATURES["thomas_kernel"]
    argtypes, _ = _build._SIGNATURES["thomas_kernel"]["thomas_solve"]
    assert len(argtypes) == 13


@pytest.mark.parametrize("along_y", [False, True])
def test_plan_fits_every_shape(along_y):
    for B in (1, 8, 65_535, 70_000):
        for H, W in ((720, 1280), (1, 1), (1, 47), (33, 1), (33, 47)):
            plan = wls._plan(B, H, W, along_y)
            frames = plan["frames"]
            assert frames == min(B, 65_535)
            covered = [b for b0, b1 in plan["pieces"] for b in range(b0, b1)]
            assert covered == list(range(B))
            assert all(b1 - b0 <= frames for b0, b1 in plan["pieces"])
            # c' and r' of every line position of a launch's frames.
            assert plan["work_bytes"] == frames * 2 * H * W * 4
    assert len(wls._plan(70_000, 4, 5, along_y)["pieces"]) == 2


def test_cpu_solve_counts_no_launch_and_checks_shapes():
    conf = torch.ones(2, 5, 7)
    n0 = wls.launches
    out = wls._solve(conf, torch.rand(2, 5, 6), torch.rand(2, 5, 7), 1.5,
                     along_y=False)
    assert out.shape == (2, 5, 7) and wls.launches == n0
    with pytest.raises(ValueError):
        wls._solve(conf, torch.rand(2, 5, 6), torch.rand(2, 5, 7), 1.5,
                   along_y=True)
    with pytest.raises(ValueError):
        wls._solve(conf.double(), torch.rand(2, 5, 6).double(),
                   torch.rand(2, 5, 7).double(), 1.5, along_y=False)


# -- the quality preset ----------------------------------------------------------

def _shift_scene(rng, H=24, W=48, d_true=3):
    base = rng.integers(0, 256, (H, W + d_true, 3), np.uint8)
    return base[:, :W], base[:, d_true:]


@pytest.mark.parametrize("matcher,wls_lambda", [
    ("asw", None), ("asw", 4.0), ("sgm", None)])
def test_quality_preset_matches_jax(rng, matcher, wls_lambda):
    """SGM leg: within the zero-confidence bound of JAX's map (the fill
    of the LR check's markers on a noise guide). ASW legs: the matcher's
    map differs from JAX's only by argmin near-ties (at most 1.2%, the
    budget of tests/test_torch_asw.py); the WLS pass is then held to
    JAX's WLS of the port's own map."""
    from simplestereo_tpu.passive.asw_pallas import asw_disparity as jasw
    from simplestereo_tpu_torch.passive.asw_cuda import asw_disparity

    d_true = 3
    img1, img2 = _shift_scene(rng, d_true=d_true)
    kw = dict(matcher=matcher, min_disp=0, max_disp=6,
              wls_lambda=wls_lambda)
    if matcher == "asw":
        kw.update(win_size=7)
    disp = presets.quality_disparity(img1, img2, device="cpu", **kw)
    assert disp.shape == img1.shape[:2] and disp.dtype == np.float32
    if matcher == "sgm":
        _close(disp, jpresets.quality_disparity(img1, img2, **kw),
               ZERO_CONF_TOL)
    else:
        akw = dict(win_size=7, min_disp=0, max_disp=6, gamma_c=15.0,
                   gamma_p=17.5, consistent=True)
        raw = asw_disparity(torch.tensor(img1), torch.tensor(img2),
                            **akw).numpy().astype(np.float32)
        assert (raw != np.asarray(jasw(img1, img2, **akw))).mean() <= 0.012
        want = raw if wls_lambda is None else jwls.wls_filter_disparity(
            raw, jpresets._gray_guide(img1), lambda_=wls_lambda,
            sigma_color=2.0)
        _close(disp, want, 0 if wls_lambda is None else WHOLE_TOL)
    inner = disp[4:-4, 8:-4]
    assert abs(np.median(inner) - d_true) < 0.5
    assert (np.abs(inner - d_true) < 1.0).mean() > 0.9


def test_quality_preset_sgm_map_bit_equal(rng):
    """The SGM leg's map before the WLS fill equals JAX's."""
    from simplestereo_tpu.passive import StereoSGM as JSGM
    from simplestereo_tpu_torch.passive import StereoSGM

    img1, img2 = _shift_scene(rng)
    kw = dict(minDisparity=0, numDisparities=16, blockSize=3, P1=120,
              P2=480, uniquenessRatio=10, disp12MaxDiff=1,
              costMethod="census", censusWindow=7)
    np.testing.assert_array_equal(
        StereoSGM(device="cpu", **kw).compute(img1, img2),
        JSGM(**kw).compute(img1, img2))


def test_quality_preset_validates_inputs(rng):
    img1, img2 = _shift_scene(rng)
    with pytest.raises(ValueError):
        presets.quality_disparity(img1[..., 0], img2[..., 0], device="cpu")
    with pytest.raises(ValueError):
        presets.quality_disparity(img1, img2, matcher="magic", device="cpu")
    t = presets.quality_disparity(torch.tensor(img1), torch.tensor(img2),
                                  matcher="sgm", max_disp=6)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
