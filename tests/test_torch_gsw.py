"""PyTorch port: the GSW twin and MI pieces (passive/gsw.py) and the kernel
front end (passive/gsw_cuda.py) on the CPU, against the JAX package on the
same numpy-seeded inputs (its Pallas kernel in interpret mode, as its own
tests run it on the CPU).

Tolerances:
- window shifts, target shifts, gray quantization, the MI cost maps from
  one table, the copied probe and the cost-method rule: bit-equal (the
  same selections and the same float operations);
- support weights: rtol 1e-6 with atol 1e-10, JAX's zeros exactly 0
  (XLA's exp and PyTorch's differ in the last ulps; on weights below 1e-5,
  exp of arguments under -11, XLA's is up to 2e-6 off relatively, 1.4e-11
  absolutely);
- Parzen smoothing and the MI table: rtol 1e-5 with atol 2e-6 (the
  7-tap sums and logs are taken in another order; the histogram counts
  are exact);
- disparity maps: at most 1% of pixels differ, and each pixel that
  differs is a near-tie in the twin's cost volume (relative gap <= 1e-5):
  window sums in another order flip last-ulp ties, and noise pairs tie at
  the fMax cap where the true shift is out of range. Measured on these
  seeds: the twin's raw maps differ from JAX ``_gsw_pass`` in 4 of 17
  cases, by 1-3 pixels; the front end differs from
  ``gsw_disparity_pallas(interpret=True)`` in 9 of 17 cases, by 1-7
  pixels; all of them near-ties. The JAX package's own XLA and Pallas
  forms differ from each other as often, by up to 7 pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simplestereo_tpu.passive import gsw as jgsw
from simplestereo_tpu.passive.gsw_pallas import gsw_disparity_pallas
from simplestereo_tpu_torch.passive import gsw, gsw_cuda

MISMATCH = 0.01
TIE = 1e-5

# tests/test_passive_gsw_pallas.py CASES and NORM_CASES:
# (h, w, win, min_disp, max_disp, consistent, step)
CASES = [
    (20, 40, 5, 0, 4, False, 1),
    (24, 52, 7, 2, 9, True, 1),
    (17, 33, 5, -3, 4, True, 1),
    (9, 17, 1, 0, 3, True, 1),
    (12, 20, 9, 2, 2, False, 1),
    (16, 140, 7, 0, 5, True, 1),
    (16, 48, 3, 0, 20, False, 1),
    (16, 48, 3, -2, 19, True, 1),
    (24, 52, 9, 2, 9, True, 2),
    (17, 33, 5, -3, 4, True, 3),
    (16, 48, 5, 0, 20, True, 2),
]
NORM_CASES = [
    (20, 40, 5, 0, 4, False, 1),
    (24, 52, 7, 2, 9, True, 1),
    (17, 33, 5, -3, 4, True, 1),
    (16, 48, 3, 0, 20, False, 1),
    (24, 52, 9, 2, 9, True, 2),
    (16, 140, 7, 0, 5, True, 1),
]


def _pair(seed, h, w, shift=2):
    """True disparity ``shift``: img2(x) = img1(x + shift)."""
    img1 = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, -shift, axis=1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_flips_are_ties(got, want, cost, min_disp):
    """At most MISMATCH of the pixels differ, and at each the two picks are
    a near-tie in the (D, H, W) volume ``cost``."""
    bad = got != want
    assert bad.mean() <= MISMATCH, bad.mean()
    D = cost.shape[0]
    for y, x in np.argwhere(bad):
        a, b = int(got[y, x]) - min_disp, int(want[y, x]) - min_disp
        assert 0 <= a < D and 0 <= b < D, (y, x, got[y, x], want[y, x])
        ca, cb = float(cost[a, y, x]), float(cost[b, y, x])
        assert abs(ca - cb) <= TIE * max(abs(cb), 1e-30), (y, x, ca, cb)


@pytest.mark.parametrize("shape,win,fill", [
    ((9, 13, 3), 5, np.inf), ((9, 13, 3), 1, np.inf), ((9, 13), 7, 0.0),
    ((6, 11, 4), 3, 0.0)])
def test_window_shifts_matches_jax(shape, win, fill):
    a = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jgsw._window_shifts(a, win, fill))
    got = gsw._window_shifts(_t(a), win, fill).numpy()
    np.testing.assert_array_equal(got, want)
    offs = [0, win * win // 2, win * win - 1]
    np.testing.assert_array_equal(
        gsw._window_shifts(_t(a), win, fill, offs).numpy(), want[offs])


@pytest.mark.parametrize("d", [0, 3, -4, 40, -55])
def test_shift_tgt_matches_jax(d):
    a = np.random.default_rng(2).uniform(0, 255, (7, 30, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(gsw._shift_tgt(_t(a), d).numpy(),
                                  np.asarray(jgsw._shift_tgt(a, d)))


@pytest.mark.parametrize("win,gamma", [(1, 10.0), (5, 10.0), (9, 12.5)])
def test_gsw_weights_matches_jax(win, gamma):
    img, _ = _pair(3, 11, 17)
    f = img.astype(np.float32)
    want = np.asarray(jgsw._gsw_weights(jnp.asarray(f), win, 2, gamma))
    got = gsw._gsw_weights(_t(f), win, 2, gamma).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).any() == (win > 1)  # out-of-image offsets weigh 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", CASES)
def test_twin_pass_matches_jax(h, w, win, mind, maxd, cons, step):
    """The twin's cost volume + first argmin + empty range against JAX
    ``_gsw_pass``, in both matching directions when consistent."""
    img1, img2 = _pair(10, h, w)
    kw = dict(win_size=win, min_disp=mind, max_disp=maxd, gamma=10.0,
              f_max=60.0, iterations=1, step=step)
    dirs = [(img1, img2)] + ([(img2[:, ::-1], img1[:, ::-1])] if cons
                             else [])
    for ref, tgt in dirs:
        ref, tgt = np.ascontiguousarray(ref), np.ascontiguousarray(tgt)
        want = np.asarray(jgsw._gsw_pass(ref, tgt, **kw))
        cost = gsw._gsw_cost(_t(ref), _t(tgt), **kw)
        assert cost.shape == (maxd - mind + 1, h, w)
        np.testing.assert_array_equal(
            torch.isinf(cost).numpy(),
            np.broadcast_to(~gsw._candidate_ok(w, mind, maxd, "cpu")
                            .numpy()[:, None, :], cost.shape))
        got = gsw_cuda._empty_range(gsw._argmin_disp(cost, mind), w,
                                    mind).numpy()
        _assert_flips_are_ties(got, want, cost.numpy(), mind)


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", NORM_CASES)
def test_twin_normalize_matches_jax(h, w, win, mind, maxd, cons, step):
    img1, img2 = _pair(11, h, w)
    kw = dict(win_size=win, min_disp=mind, max_disp=maxd, gamma=10.0,
              f_max=60.0, iterations=1, step=step, normalize=True)
    want = np.asarray(jgsw._gsw_pass(img1, img2, **kw))
    cost = gsw._gsw_cost(_t(img1), _t(img2), **kw)
    got = gsw_cuda._empty_range(gsw._argmin_disp(cost, mind), w,
                                mind).numpy()
    _assert_flips_are_ties(got, want, cost.numpy(), mind)


def _front_end_vs_pallas(seed, h, w, win, mind, maxd, cons, step,
                         normalize):
    img1, img2 = _pair(seed, h, w)
    kw = dict(win_size=win, min_disp=mind, max_disp=maxd, gamma=10.0,
              f_max=60.0, consistent=cons, step=step, normalize=normalize)
    want = np.asarray(gsw_disparity_pallas(img1, img2, interpret=True, **kw))
    before = gsw_cuda.launches
    got = gsw_cuda.gsw_disparity_cuda(_t(img1), _t(img2), **kw)
    assert gsw_cuda.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.int16 and got.shape == (h, w)
    cost = gsw._gsw_cost(_t(img1), _t(img2), iterations=1,
                         **{k: v for k, v in kw.items() if k != "consistent"})
    _assert_flips_are_ties(got.numpy(), want, cost.numpy(), mind)


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", CASES)
def test_front_end_matches_pallas_interpret(h, w, win, mind, maxd, cons,
                                            step):
    _front_end_vs_pallas(12, h, w, win, mind, maxd, cons, step, False)


@pytest.mark.parametrize("h,w,win,mind,maxd,cons,step", NORM_CASES)
def test_front_end_normalize_matches_pallas_interpret(h, w, win, mind, maxd,
                                                      cons, step):
    _front_end_vs_pallas(13, h, w, win, mind, maxd, cons, step, True)


def test_front_end_batch_matches_per_frame():
    rng = np.random.default_rng(14)
    imgs1 = rng.integers(0, 256, (3, 16, 40, 3), np.uint8)
    imgs2 = np.roll(imgs1, -2, axis=2)
    for cons in (False, True):
        kw = dict(win_size=5, max_disp=4, consistent=cons)
        b = gsw_cuda.gsw_disparity_cuda_batch(_t(imgs1), _t(imgs2), **kw)
        for i in range(3):
            np.testing.assert_array_equal(
                b[i].numpy(), gsw_cuda.gsw_disparity_cuda(
                    _t(imgs1[i]), _t(imgs2[i]), **kw).numpy())


@pytest.mark.parametrize("color", [True, False])
def test_quantize_gray_matches_jax(color):
    img, _ = _pair(15, 12, 20)
    if not color:
        img = img[..., 1]
    for bins in (8, 24):
        np.testing.assert_array_equal(
            gsw._quantize_gray(_t(img), bins).numpy(),
            np.asarray(jgsw._quantize_gray(img, bins)))


@pytest.mark.parametrize("shape", [(7,), (24,), (16, 16), (9, 20)])
def test_parzen_matches_jax(shape):
    h = np.random.default_rng(16).uniform(0, 1, shape).astype(np.float32)
    got = gsw._parzen(_t(h), dims=len(shape)).numpy()
    np.testing.assert_allclose(got, np.asarray(jgsw._parzen(h)), rtol=1e-5,
                               atol=2e-6)


def _mi_inputs(seed, bins, h=16, w=30, min_disp=0, max_disp=4):
    img1, img2 = _pair(seed, h, w)
    q1 = np.asarray(jgsw._quantize_gray(img1, bins))
    q2 = np.asarray(jgsw._quantize_gray(img2, bins))
    disp = np.random.default_rng(seed + 1).integers(
        min_disp, max_disp + 1, (h, w)).astype(np.int32)
    return img1, q1, q2, disp


@pytest.mark.parametrize("bins,min_disp", [(7, 0), (16, -3), (24, 2)])
def test_mi_cost_table_matches_jax(bins, min_disp):
    _, q1, q2, disp = _mi_inputs(17, bins, min_disp=min_disp,
                                 max_disp=min_disp + 6)
    want = np.asarray(jgsw._mi_cost_table(q1, q2, disp, disp >= 0,
                                          bins=bins))
    got = gsw._mi_cost_table(_t(q1), _t(q2), _t(disp), _t(disp >= 0),
                             bins=bins).numpy()
    assert got.dtype == np.float32 and got.shape == (bins, bins)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("min_disp,max_disp", [(0, 4), (-3, 6), (2, 40)])
def test_mi_cost_maps_from_jax_table_bit_equal(min_disp, max_disp):
    bins = 16
    _, q1, q2, disp = _mi_inputs(18, bins)
    table = np.asarray(jgsw._mi_cost_table(q1, q2, disp, disp >= 0,
                                           bins=bins))
    want = np.stack(jgsw._mi_cost_maps(jnp.asarray(q1), jnp.asarray(q2),
                                       jnp.asarray(table), min_disp=min_disp,
                                       max_disp=max_disp, bins=bins))
    got = gsw._mi_cost_maps(_t(q1), _t(q2), _t(table), min_disp=min_disp,
                            max_disp=max_disp, bins=bins).numpy()
    np.testing.assert_array_equal(got, want)


def test_mi_volume_of_a_stack_is_per_frame():
    """The histogram of a stack counts each frame on its own."""
    bins = 12
    frames = [_mi_inputs(19 + i, bins) for i in range(3)]
    q1 = torch.stack([_t(f[1]) for f in frames])
    q2 = torch.stack([_t(f[2]) for f in frames])
    disp = torch.stack([_t(f[3]) for f in frames])
    vol = gsw._mi_volume(q1, q2, disp, min_disp=0, max_disp=4, bins=bins)
    for i in range(3):
        np.testing.assert_array_equal(
            vol[i].numpy(), gsw._mi_volume(q1[i], q2[i], disp[i], min_disp=0,
                                           max_disp=4, bins=bins).numpy())


@pytest.mark.parametrize("min_disp,max_disp,win", [(0, 4, 5), (-3, 4, 7)])
def test_mi_step_matches_jax(min_disp, max_disp, win):
    bins = 16
    img1, q1, q2, disp = _mi_inputs(20, bins, min_disp=min_disp,
                                    max_disp=max_disp)
    H, W = q1.shape
    w = jgsw._gsw_weights(jnp.asarray(img1, jnp.float32), win, 1, 10.0)
    want = np.asarray(jgsw._gsw_mi_step(
        w, jnp.asarray(q1), jnp.asarray(q2), jnp.asarray(disp),
        win_size=win, min_disp=min_disp, max_disp=max_disp, bins=bins))
    rp = gsw_cuda._pack_planes(_t(img1).permute(2, 0, 1)[None], win,
                               gsw_cuda.BGR_SENTINEL)
    got = gsw_cuda._gsw_mi_step(
        rp, _t(q1)[None], _t(q2)[None], _t(disp)[None], H=H, W=W,
        win_size=win, min_disp=min_disp, max_disp=max_disp, gamma=10.0,
        bins=bins)[0].numpy()
    vol = gsw._mi_volume(_t(q1), _t(q2), _t(disp), min_disp=min_disp,
                         max_disp=max_disp, bins=bins)
    cost = gsw._gsw_cost(_t(img1), None, win_size=win, min_disp=min_disp,
                         max_disp=max_disp, gamma=10.0, f_max=0.0, vol=vol)
    _assert_flips_are_ties(got, want, cost.numpy(), min_disp)


def test_mi_needs_seven_bins():
    _, q1, q2, disp = _mi_inputs(21, 6)
    with pytest.raises(ValueError, match="bins"):
        gsw._mi_cost_table(_t(q1), _t(q2), _t(disp), _t(disp >= 0), bins=6)


def _probe_inputs():
    rng = np.random.default_rng(22)
    a = rng.integers(0, 256, (2, 12, 24, 3), np.uint8)
    b = np.clip(255.0 * (a / 255.0) ** 0.5, 0, 255).astype(np.uint8)
    g = np.zeros((12, 24, 3), np.uint8)
    g[..., 1] = 255
    h = np.full((12, 24, 3), 85, np.uint8)
    return [(a[0], a[0]), (a[0], b[0]), (a, b), (a[..., 0], b[..., 0]),
            (g, h), (g[None], h[None]), (a[0, ..., 0], b[0, ..., 0])]


@pytest.mark.parametrize("i", range(7))
def test_radiometric_divergence_matches_jax(i):
    a, b = _probe_inputs()[i]
    for bins in (64, 16):
        assert gsw.radiometric_divergence(a, b, bins) \
            == jgsw.radiometric_divergence(a, b, bins)


@pytest.mark.parametrize("i", range(7))
@pytest.mark.parametrize("method,step", [("auto", 1), ("auto", 2),
                                         ("sd", 1), ("mi", 1)])
def test_resolve_cost_method_matches_jax(i, method, step):
    a, b = _probe_inputs()[i]
    assert gsw.resolve_cost_method(a, b, method, step=step) \
        == jgsw.resolve_cost_method(a, b, method, step=step)
    assert gsw.MI_AUTO_THRESHOLD == jgsw.MI_AUTO_THRESHOLD


def _planes(seed, B=2, h=12, w=20, win=5, min_disp=-2, max_disp=5):
    rng = np.random.default_rng(seed)
    imgs1 = rng.integers(0, 256, (B, h, w, 3), np.uint8)
    imgs2 = np.roll(imgs1, -2, axis=2)
    planes = gsw_cuda._build_planes(_t(imgs1), _t(imgs2), win)
    kw = dict(H=h, W=w, win_size=win, min_disp=min_disp, max_disp=max_disp,
              gamma=10.0, f_max=60.0)
    return imgs1, imgs2, planes, kw


def test_build_planes_layout():
    imgs1, imgs2, planes, kw = _planes(23)
    pad = 2
    assert tuple(planes.shape) == (2, 6, 12 + 4, 20 + 4)
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    inner = planes[:, :, pad:pad + 12, pad:pad + 20].permute(0, 2, 3, 1)
    np.testing.assert_array_equal(inner[..., 0:3].numpy(), imgs1)
    np.testing.assert_array_equal(inner[..., 3:6].numpy(), imgs2)
    ring = torch.ones(planes.shape[2:], dtype=torch.bool)
    ring[pad:pad + 12, pad:pad + 20] = False
    assert (planes[:, 0:3][..., ring] == gsw_cuda.BGR_SENTINEL).all()
    assert (planes[:, 3:6][..., ring] == 0).all()


def test_plain_pass_returns_twin_volume_and_argmin():
    imgs1, imgs2, planes, kw = _planes(24)
    before = gsw_cuda.launches
    disp, cost = gsw_cuda._gsw_pass(planes, return_cost=True, **kw)
    assert gsw_cuda.launches == before
    assert disp.dtype == torch.int32 and disp.shape == (2, 12, 20)
    assert cost.shape == (2, 8, 12, 20) and cost.is_contiguous()
    for i in range(2):
        want = gsw._gsw_cost(_t(imgs1[i]), _t(imgs2[i]), win_size=5,
                             min_disp=-2, max_disp=5, gamma=10.0,
                             f_max=60.0)
        np.testing.assert_array_equal(cost[i].numpy(), want.numpy())
    np.testing.assert_array_equal(disp.numpy(), cost.numpy().argmin(1) - 2)
    assert gsw_cuda._gsw_pass(planes, **kw)[1] is None


def test_plain_pass_ext_vol():
    """ext_vol planes (BGR(ref) + a zero-padded volume) aggregate the given
    volume; the capped-distance volume given that way reproduces SD."""
    imgs1, imgs2, planes, kw = _planes(25)
    vol = torch.stack([gsw._capdist_volume(
        _t(a).float(), _t(b).float(), -2, 5, 60.0) for a, b in
        zip(imgs1, imgs2)])
    ext = torch.cat([planes[:, 0:3], gsw_cuda._pack_planes(vol, 5, 0.0)], 1)
    d_ext, c_ext = gsw_cuda._gsw_pass(ext, ext_vol=True, return_cost=True,
                                      **kw)
    d_sd, c_sd = gsw_cuda._gsw_pass(planes, return_cost=True, **kw)
    np.testing.assert_array_equal(c_ext.numpy(), c_sd.numpy())
    np.testing.assert_array_equal(d_ext.numpy(), d_sd.numpy())


def test_pass_rejects_what_the_kernel_cannot_take():
    _, _, planes, kw = _planes(26)
    with pytest.raises(ValueError, match="no GSW kernel"):
        gsw_cuda._gsw_pass(planes.to("meta"), **kw)
    with pytest.raises(ValueError, match="float32"):
        gsw_cuda._gsw_pass(planes.double(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        gsw_cuda._gsw_pass(planes.transpose(2, 3).contiguous()
                           .transpose(2, 3), **kw)
    with pytest.raises(ValueError, match="planes must be"):
        gsw_cuda._gsw_pass(planes[:, :, 1:], **kw)
    with pytest.raises(ValueError, match="planes must be"):
        gsw_cuda._gsw_pass(planes, ext_vol=True, **kw)
    with pytest.raises(ValueError, match="odd"):
        gsw_cuda._gsw_pass(planes, **dict(kw, win_size=4))
    with pytest.raises(ValueError, match="step"):
        gsw_cuda._gsw_pass(planes, step=0, **kw)
    with pytest.raises(ValueError, match="max_disp"):
        gsw_cuda._gsw_pass(planes, **dict(kw, max_disp=-3))


def test_mi_schedule_and_bootstrap():
    assert gsw_cuda._mi_iter_steps(3, 2) == [2, 2, 1]
    assert gsw_cuda._mi_iter_steps(1, 3) == [1]
    with pytest.raises(ValueError, match="mi_iterations"):
        gsw_cuda._mi_iter_steps(0, 1)
    d = gsw_cuda._bootstrap(20, 30, -3, 4)
    assert d.dtype == torch.int32 and d.shape == (20, 30)
    assert int(d.min()) == -3 and int(d.max()) == 4
    np.testing.assert_array_equal(d.numpy(),
                                  gsw_cuda._bootstrap(20, 30, -3, 4).numpy())


def test_mi_front_end_matches_pallas_interpret():
    """The MI front end with JAX's bootstrap field against the Pallas MI
    kernel (interpret mode), consistent, coarse schedule included."""
    from simplestereo_tpu.passive.gsw_pallas import gsw_mi_disparity_pallas

    img1, img2 = _pair(27, 20, 44)
    img2 = np.clip(255.0 * (img2 / 255.0) ** 0.5, 0, 255).astype(np.uint8)
    kw = dict(win_size=7, max_disp=5, min_disp=0, gamma=10.0, bins=8,
              mi_iterations=3, consistent=True, coarse_step=2)
    want = np.asarray(gsw_mi_disparity_pallas(img1, img2, interpret=True,
                                              **kw))
    d0 = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (20, 44), 0, 6,
                                       dtype=jnp.int32))
    got = gsw_cuda.gsw_mi_disparity_cuda(_t(img1), _t(img2), disp0=_t(d0),
                                         **kw).numpy()
    assert (got != want).mean() <= MISMATCH
    with pytest.raises(ValueError, match="disp0"):
        gsw_cuda.gsw_mi_disparity_cuda(_t(img1), _t(img2), disp0=_t(d0[1:]),
                                       **kw)
