"""PyTorch port: structured-light patterns, the stripe finder and Gray-code
scanning against the JAX package, on tests/test_active.py's 128x96
synthetic camera-projector scene, on the CPU.

Tolerances: patterns, ``findCentralStripe`` (numpy path), ``computeROI``
and every decode are equal (integers; the decode's float32 threshold
tests see the same values); clouds have the same valid set and each
point lies within 1e-5 of the JAX point's distance from the camera (the
triangulation is float32 in both packages, with sums in other orders);
float16 clouds within one float16 step of that. With a distorted camera
the uint8 remap of the stack may round a pixel one grey level apart
(float32 maps that differ by ulps, see ROADMAP), which may flip a
decoded bit where a pattern and its inverse nearly tie: there the
decodes must agree on 99.9% of the pixels.
"""

import numpy as np
import pytest
import torch

import simplestereo_tpu as jss
from simplestereo_tpu.geometry.npgeom import rodrigues_to_matrix
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch import convert, imgio
from simplestereo_tpu_torch.active import graycode as tgc

CAM_RES = (128, 96)
PROJ_RES = (128, 96)
RTOL = 1e-5


def _make_rig(d1=None, d2=None):
    K = np.array([[140., 0, 63.5], [0, 140., 47.5], [0, 0, 1]])
    R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    T = np.array([[-40.], [1.0], [6.0]])
    return jss.StereoRig(CAM_RES, PROJ_RES, K, K, d1, d2, R, T)


def _proj_coords_for_plane(rig, z_plane):
    """Projector pixel hit by each camera pixel for a fronto plane."""
    w, h = rig.res1
    K1 = np.asarray(rig.intrinsic1, float)
    K2 = np.asarray(rig.intrinsic2, float)
    xs, ys = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    p = np.stack([xs, ys, np.ones_like(xs)], -1)
    P = z_plane * (p @ np.linalg.inv(K1).T)
    q = (P @ np.asarray(rig.R, float).T + np.asarray(rig.T, float).ravel()) \
        @ K2.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]


def _capture(pattern, mapu, mapv):
    """Nearest-neighbour capture of a projected pattern; pixels whose ray
    misses the projector get no light."""
    h2, w2 = pattern.shape[:2]
    ui = np.round(mapu).astype(int)
    vi = np.round(mapv).astype(int)
    lit = (ui >= 0) & (ui < w2) & (vi >= 0) & (vi < h2)
    out = pattern[np.clip(vi, 0, h2 - 1), np.clip(ui, 0, w2 - 1)]
    return np.where(lit, out, 0).astype(pattern.dtype)


def _scene(rig, z0=500.0):
    mapu, mapv = _proj_coords_for_plane(rig, z0)
    pats, _, _ = jss.active.graycode_patterns(PROJ_RES)
    caps = [_capture(p, mapu, mapv) for p in pats]
    white = _capture(np.full(PROJ_RES[::-1], 255, np.uint8), mapu, mapv)
    black = _capture(np.zeros(PROJ_RES[::-1], np.uint8), mapu, mapv)
    return caps, black, white


def _close_points(a, b, rtol=RTOL):
    a, b = a.reshape(-1, 3), b.reshape(-1, 3)
    assert a.shape == b.shape
    fa, fb = np.isfinite(a), np.isfinite(b)
    np.testing.assert_array_equal(fa, fb)
    ok = fa.all(1)
    err = np.abs(a[ok] - b[ok]).max(1) / np.linalg.norm(a[ok], axis=1)
    assert err.max() <= rtol, err.max()


@pytest.fixture(scope="module")
def scene():
    rig = _make_rig()
    caps, black, white = _scene(rig)
    return dict(rig=rig, port_rig=convert.rig_from_jax(rig, device="cpu"),
                caps=caps, black=black, white=white)


# -- patterns ----------------------------------------------------------------

PATTERNS = {
    "graycode 64x32": lambda m: m.graycode_patterns((64, 32)),
    "graycode 100x37": lambda m: m.graycode_patterns((100, 37)),
    "fringe": lambda m: m.buildFringe(16, dims=(128, 8)),
    "fringe red stripe": lambda m: m.buildFringe(
        16, dims=(128, 8), stripeColor="red", shift=3),
    "fringe vertical float": lambda m: m.buildFringe(
        12, dims=(64, 48), vertical=True, dtype=np.float32),
    "binary green": lambda m: m.buildBinaryFringe(
        period=16, dims=(128, 8), stripeColor="g"),
    "anaglyph": lambda m: m.buildAnaglyphFringe(period=16, dims=(128, 8)),
    "central peak": lambda m: m._getCentralPeak(1280, 16, 2.0),
}


@pytest.mark.parametrize("name", list(PATTERNS))
def test_patterns_equal(name):
    a = PATTERNS[name](tss.active)
    b = PATTERNS[name](jss.active)
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


def test_generate_graycode_imgs(tmp_path):
    n = tss.active.generateGrayCodeImgs(str(tmp_path / "p"), (32, 16))
    assert n == jss.active.generateGrayCodeImgs(str(tmp_path / "j"), (32, 16))
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir())
    assert len(names) == n + 2
    for name in names:
        port, jax_file = str(tmp_path / "p" / name), str(tmp_path / "j" / name)
        a = imgio.imread(port, grayscale=True)
        np.testing.assert_array_equal(a, jss.imgio.imread(port, True))
        np.testing.assert_array_equal(a, imgio.imread(jax_file, True))


# -- stripe ------------------------------------------------------------------

def _stripe_image(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, (40, 96, 3)).astype(np.uint8)
    img[:, 40:43, 2] = 220
    img[5:9, 60:62, 2] = 240  # a second blob on a few rows
    img[30:34] = 0            # rows without a stripe: filled by the fit
    return img


@pytest.mark.parametrize("interp", ["linear", "cubic"])
@pytest.mark.parametrize("color", ["r", "green"])
def test_find_central_stripe_equal(color, interp):
    img = _stripe_image()
    if color == "green":
        img = img[:, :, [0, 2, 1]]
    a = tss.active.findCentralStripe(img, color, 0.5, interp)
    b = jss.active.findCentralStripe(img, color, 0.5, interp)
    np.testing.assert_array_equal(a, b)
    t = tss.active.findCentralStripe(torch.as_tensor(img), color, 0.5, interp)
    np.testing.assert_allclose(t, b, rtol=0, atol=1e-4)
    assert tss.active.findCentralStripe(np.zeros((4, 4, 3), np.uint8)) is None


@pytest.mark.parametrize("kw", [dict(blackThreshold=50),
                                dict(blackThreshold=50, extraMargin=3),
                                dict(blackThreshold=50, extraMargin=1000),
                                dict(blackThreshold=50, extraMargin=-5),
                                dict(blackThreshold=20, whiteThreshold=230),
                                dict(blackThreshold=255)])
def test_compute_roi_equal(kw):
    img = np.zeros((60, 80), np.uint8)
    img[10:50, 20:70] = 200
    img[52:55, 2:5] = 240   # a smaller bright component
    img[10:30, 20] = 0      # a ragged border
    assert tss.active.computeROI(img, **kw) == jss.active.computeROI(img, **kw)
    rgb = np.repeat(img[:, :, None], 3, axis=2)
    assert tss.active.computeROI(rgb, **kw) == jss.active.computeROI(rgb, **kw)


# -- decode ------------------------------------------------------------------

def test_decode_identity_and_float():
    pats, nx, ny = tss.active.graycode_patterns((64, 32))
    for stack in (pats, pats.astype(np.float32) / 255.0):
        thr = 5 if stack.dtype == np.uint8 else 5 / 255.0
        a = tss.active.decode_graycode(stack, nx, ny, white_thr=thr,
                                       device="cpu")
        b = jss.active.decode_graycode(stack, nx=nx, ny=ny, white_thr=thr)
        for x, y in zip(a, b):
            assert x.dtype == torch.int32 or x.dtype == torch.bool
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    gx, gy = np.meshgrid(np.arange(64), np.arange(32))
    assert (a[0].numpy() == gx).all() and (a[1].numpy() == gy).all()


@pytest.mark.parametrize("shadow", [False, True])
def test_decode_scene_equal(scene, shadow):
    kw = dict(black=scene["black"], white=scene["white"]) if shadow else {}
    a = tss.active.GrayCode(scene["port_rig"], device="cpu").decode(
        scene["caps"], **kw)
    b = jss.active.GrayCode(scene["rig"]).decode(scene["caps"], **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[2].mean() > 0.5


# -- clouds ------------------------------------------------------------------

CLOUD_CASES = {
    "plain": {},
    "roi": dict(roi=(10, 7, 90, 70)),
    "shadow": dict(shadow=True),
    "float16": dict(out_dtype=np.float16),
}


@pytest.mark.parametrize("case", list(CLOUD_CASES))
def test_graycode_cloud_equal(scene, case):
    kw = dict(CLOUD_CASES[case])
    if kw.pop("shadow", False):
        kw.update(black=scene["black"], white=scene["white"])
    a = tss.active.GrayCode(scene["port_rig"], device="cpu").getCloud(
        scene["caps"], **kw)
    b = jss.active.GrayCode(scene["rig"]).getCloud(scene["caps"], **kw)
    assert a.dtype == b.dtype and a.shape == b.shape
    if case == "float16":
        _close_points(a.astype(np.float64), b.astype(np.float64), 2e-3)
    else:
        _close_points(a, b)
    pts = a.reshape(-1, 3).astype(np.float64)
    pts = pts[np.isfinite(pts).all(1)]
    quant = 500.0 ** 2 / (40.0 * 140.0)
    assert np.median(np.abs(pts[:, 2] - 500.0)) < 0.5 * quant


def test_graycode_shadow_and_float_captures(scene):
    """A shadowed band (ambient flicker, black and white near equal) and a
    float capture stack normalized to [0, 1]: the same valid sets and
    clouds as JAX."""
    rng = np.random.default_rng(3)
    sx = slice(30, 50)
    caps = [c.copy() for c in scene["caps"]]
    for c in caps:
        c[:, sx] = rng.integers(0, 120, (CAM_RES[1], 20), np.uint8)
    white, black = scene["white"].copy(), scene["black"].copy()
    white[:, sx], black[:, sx] = 60, 55
    port = tss.active.GrayCode(scene["port_rig"], black_thr=40.5,
                               device="cpu")
    jax_gc = jss.active.GrayCode(scene["rig"], black_thr=40.5)
    kw = dict(black=black, white=white)
    for x, y in zip(port.decode(caps, **kw), jax_gc.decode(caps, **kw)):
        np.testing.assert_array_equal(x, y)
    _close_points(port.getCloud(caps, **kw), jax_gc.getCloud(caps, **kw))

    capsf = [c.astype(np.float32) / 255.0 for c in scene["caps"]]
    port = tss.active.GrayCode(scene["port_rig"], white_thr=5 / 255.0,
                               device="cpu")
    jax_gc = jss.active.GrayCode(scene["rig"], white_thr=5 / 255.0)
    for x, y in zip(port.decode(capsf), jax_gc.decode(capsf)):
        np.testing.assert_array_equal(x, y)
    _close_points(port.getCloud(capsf), jax_gc.getCloud(capsf))


def test_graycode_paths_and_colour(tmp_path, scene):
    """Captures given as PNG paths (read by the port's imgio) and as BGR
    images decode as the arrays do."""
    paths = []
    for i, c in enumerate(scene["caps"]):
        paths.append(str(tmp_path / f"{i}.png"))
        imgio.imwrite(paths[-1], c)
    port = tss.active.GrayCode(scene["port_rig"], device="cpu")
    for x, y in zip(port.decode(paths), port.decode(scene["caps"])):
        np.testing.assert_array_equal(x, y)
    bgr = [np.repeat(c[:, :, None], 3, axis=2) for c in scene["caps"]]
    for x, y in zip(port.decode(bgr),
                    jss.active.GrayCode(scene["rig"]).decode(bgr)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="size"):
        port.decode([c[:-1] for c in scene["caps"]])


def test_graycode_distorted_camera():
    """A distorted camera: the stack is undistorted in one remap before
    the decode; the projector's distortion enters the triangulation."""
    d1 = np.array([0.05, -0.02, 0.001, -0.001, 0.0])
    d2 = np.array([-0.03, 0.01, 0.0005, 0.0, 0.0])
    rig = _make_rig(d1, d2)
    caps, black, white = _scene(rig)
    port = tss.active.GrayCode(convert.rig_from_jax(rig, device="cpu"),
                               device="cpu")
    jax_gc = jss.active.GrayCode(rig)
    a = port.decode(caps, black=black, white=white)
    b = jax_gc.decode(caps, black=black, white=white)
    same = (a[2] == b[2]) & ((a[0] == b[0]) & (a[1] == b[1]) | ~a[2])
    assert same.mean() >= 0.999, same.mean()
    assert a[2].mean() > 0.5


def test_graycode_double_equal(scene):
    rig = scene["rig"]
    K1 = np.asarray(rig.intrinsic1, float)
    K2 = np.asarray(rig.intrinsic2, float)
    R = np.asarray(rig.R, float)
    T = np.asarray(rig.T, float)

    def cam_to_proj(Kc, Rc, Tc, z0=500.0):
        w, h = CAM_RES
        xs, ys = np.meshgrid(np.arange(w, dtype=float),
                             np.arange(h, dtype=float))
        d = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(Kc).T @ Rc
        C = -(Rc.T @ Tc).ravel()
        P = C + ((z0 - C[2]) / d[..., 2])[..., None] * d
        q = P @ K1.T
        return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]

    pats, _, _ = jss.active.graycode_patterns(PROJ_RES)
    m1 = cam_to_proj(K1, np.eye(3), np.zeros((3, 1)))
    m2 = cam_to_proj(K2, R, T)
    caps1 = [_capture(p, *m1) for p in pats]
    caps2 = [_capture(p, *m2) for p in pats]
    port = convert.graycode_from_jax(jss.active.GrayCodeDouble(rig, PROJ_RES),
                                     device="cpu")
    assert isinstance(port, tss.active.GrayCodeDouble)
    for roi in (None, (5, 5, 100, 80)):
        a = port.getCloud(caps1, caps2, roi=roi)
        b = jss.active.GrayCodeDouble(rig, PROJ_RES).getCloud(caps1, caps2,
                                                              roi=roi)
        np.testing.assert_array_equal(a, b)  # host float64 on both sides
    pts = a.reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(1)]
    assert len(pts) > 1000 and abs(np.median(pts[:, 2]) - 500) < 50


def test_graycode_from_jax(scene):
    port = convert.graycode_from_jax(
        jss.active.GrayCode(scene["rig"], black_thr=33, white_thr=7),
        device="cpu")
    assert isinstance(port, tss.active.GrayCode)
    assert (port.black_thr, port.white_thr, port.num_patterns) == (33, 7, 28)
    np.testing.assert_array_equal(port.R_inv, jss.active.GrayCode(
        scene["rig"]).R_inv)
    assert port.device.type == "cpu" and tgc.GrayCodeSingle is tgc.GrayCode
