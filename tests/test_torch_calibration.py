"""PyTorch port: calibration against the JAX package, on the CPU.

- ``ba``: a numpy copy, exactly equal to the original on the synthetic
  views of tests/test_calibration.py (``calibrate_camera``,
  ``stereo_calibrate``, the complex-step Jacobian, the Zhang init).
- ``corner_response``: within rtol 1e-5 of JAX's (against the map's scale;
  the convolution sums in another order), with an equal peak mask.
- ``find_chessboard_corners``: the same corners within 1e-6 px on
  anti-aliased renders (tests/test_procam.py's renderer, copied here with
  the camera as a parameter).
- ``chessboardStereo`` on 10 rendered pairs (256x192, a pinhole pair, so
  no distortion is fitted): the truth within tests/test_calibration.py's
  bounds (RMS < 0.12, |R - R_true| < 2e-3, |T - T_true| < 0.5), and the
  calibrated rig equal, matrix by matrix, to the JAX package's.
- ``calibrate_camera_sharded`` on one card's path (here the CPU): the
  16 views of tests/test_calibration.py within that test's bounds
  (RMS < 0.25, |K - K_true| < 5), and against the JAX package's on the
  same views, K0 and 25 iterations on an 8-device CPU mesh: |rms| within
  5e-6, K within 1e-3 px, dist within 1e-3, pose rotations within 5e-6
  rad and translations within 2e-3. Both run in float32 and sum in
  another order; the measured gap (5.3e-7, 1.2e-4 px, 6.7e-5, 8.4e-7
  rad, 1.2e-4) is what the JAX package shows between its own 8- and
  1-device meshes (1.3e-6, 1.2e-4 px, 1.5e-4, 4.5e-7 rad, 1.4e-4). A
  mesh that is not a DeviceMesh raises TypeError (the mesh form is
  tested in tests/test_torch_parallel_sgm_ftp.py).
- The helpers (object grid, SVG, F from projections, grey loading) equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import simplestereo_tpu as jss
from simplestereo_tpu.calibration import ba as jba
from simplestereo_tpu.calibration import chessboard as jcb
from simplestereo_tpu_torch import StereoRig
from simplestereo_tpu_torch import calibration as tcal
from simplestereo_tpu_torch.calibration import ba as tba
from simplestereo_tpu_torch.calibration import chessboard as tcb
from simplestereo_tpu_torch.calibration import sharded as tsh
from simplestereo_tpu_torch.imgio import imwrite

CB = (7, 6)
SQ = 20.0
RES = (256, 192)
K1 = np.array([[240., 0, 127.5], [0, 240., 95.5], [0, 0, 1]])
K2 = np.array([[250., 0, 125.5], [0, 250., 97.5], [0, 0, 1]])
R_REL = jba._rodrigues(np.array([0.01, -0.03, 0.005]))
T_REL = np.array([-40.0, 2.0, 3.0])


# -- rendered boards (tests/test_procam.py's renderer, any camera) -----------

def _board_xy(K, Rb, tb, scale):
    """Board (x, y) of each supersampled pixel's ray, and the hit mask;
    subpixel i is at pixel coordinate (i + 0.5)/scale - 0.5."""
    w, h = RES
    xs = (np.arange(w * scale, dtype=float) + 0.5) / scale - 0.5
    ys = (np.arange(h * scale, dtype=float) + 0.5) / scale - 0.5
    xs, ys = np.meshgrid(xs, ys)
    d = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K).T
    n = Rb[:, 2]
    s = (n @ tb) / (d @ n)
    Xb = (s[..., None] * d - tb) @ Rb
    return Xb[..., 0], Xb[..., 1], s > 0


def _render(K, Rb, tb, scale=3):
    """Anti-aliased chessboard render (supersample + box filter)."""
    bx, by, ok = _board_xy(K, Rb, tb, scale)
    cols, rows = CB
    inside = ((bx > -SQ) & (bx < cols * SQ) & (by > -SQ)
              & (by < rows * SQ) & ok)
    parity = (np.floor(bx / SQ) + np.floor(by / SQ)) % 2 == 0
    img = np.where(inside & parity, 20.0, 235.0)
    return img.reshape(RES[1], scale, RES[0], scale).mean((1, 3)).astype(
        np.uint8)


def _in_view(K, R, t, margin=3):
    cols, rows = CB
    c = np.array([[-SQ, -SQ, 0], [cols * SQ, -SQ, 0], [-SQ, rows * SQ, 0],
                  [cols * SQ, rows * SQ, 0]])
    q = (c @ R.T + t) @ K.T
    uv = q[:, :2] / q[:, 2:]
    return (uv[:, 0].min() > margin and uv[:, 0].max() < RES[0] - margin
            and uv[:, 1].min() > margin and uv[:, 1].max() < RES[1] - margin)


@pytest.fixture(scope="module")
def pairs():
    """10 rendered pairs: board poses tilted up to ~0.4 rad, the whole
    board inside both views."""
    rng = np.random.default_rng(5)
    poses = []
    while len(poses) < 10:
        R = jba._rodrigues(rng.normal(0, 0.4, 3))
        t = np.array([rng.normal(-50, 10), rng.normal(-45, 8),
                      rng.normal(400, 40)])
        if _in_view(K1, R, t) and _in_view(K2, R_REL @ R, R_REL @ t + T_REL):
            poses.append((R, t))
    return [(_render(K1, R, t), _render(K2, R_REL @ R, R_REL @ t + T_REL))
            for R, t in poses]


# -- ba: the copy -------------------------------------------------------------

@pytest.fixture(scope="module")
def synth():
    """tests/test_calibration.py's synthetic views."""
    rng = np.random.default_rng(1)
    K = np.array([[800., 0, 640], [0, 790, 360], [0, 0, 1]])
    dist = np.array([-0.12, 0.03, 0.001, -0.0005, 0.01])
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30., yy.ravel() * 30., np.zeros(42)], 1)
    views, imgs = [], []
    for _ in range(10):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-90, 30), rng.normal(-75, 30),
                         rng.normal(600, 100)])
        pts = jba.project_points(obj, rvec, tvec, K[0, 0], K[1, 1],
                                 K[0, 2], K[1, 2], dist)
        views.append((rvec, tvec))
        imgs.append(pts + rng.normal(0, 0.05, pts.shape))
    return dict(K=K, dist=dist, obj=obj, views=views, imgs=imgs, rng=rng)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ba_calibrate_camera_equal(synth):
    args = ([synth["obj"]] * 10, synth["imgs"], (1280, 720))
    got = tba.calibrate_camera(*args)
    _equal(got, jba.calibrate_camera(*args))
    assert got[0] < 0.12 and np.abs(got[1] - synth["K"]).max() < 5.0


def test_ba_stereo_calibrate_equal(synth):
    rng = np.random.default_rng(2)
    R2, T2 = R_REL, np.array([-120., 2., 3.])
    K2s = np.array([[810., 0, 630], [0, 805, 355], [0, 0, 1]])
    dist2 = np.array([-0.10, 0.02, -0.0005, 0.001, 0.0])
    imgs2 = []
    for rvec, tvec in synth["views"]:
        pts = jba.project_points(synth["obj"], R2 @ jba._rodrigues(rvec),
                                 R2 @ tvec + T2, K2s[0, 0], K2s[1, 1],
                                 K2s[0, 2], K2s[1, 2], dist2)
        imgs2.append(pts + rng.normal(0, 0.05, pts.shape))
    args = ([synth["obj"]] * 10, synth["imgs"], imgs2, (1280, 720))
    got = tba.stereo_calibrate(*args)
    _equal(got, jba.stereo_calibrate(*args))
    assert np.abs(got[5] - R2).max() < 2e-3


def test_ba_jacobian_and_init_equal(synth):
    f = lambda x: np.array([x[0] ** 2 * x[1], np.sin(x[0]) + x[1] ** 3])
    x = np.array([0.7, -1.3])
    _equal(tba.complex_step_jacobian(f, x), jba.complex_step_jacobian(f, x))
    Hs = [tba._homography_dlt(synth["obj"][:, :2], i) for i in synth["imgs"]]
    _equal(Hs, [jba._homography_dlt(synth["obj"][:, :2], i)
                for i in synth["imgs"]])
    _equal(tba._zhang_intrinsics(Hs, (1280, 720)),
           jba._zhang_intrinsics(Hs, (1280, 720)))
    r = np.random.default_rng(6).normal(0, 1, 3)
    _equal(tba._rodrigues_inv(tba._rodrigues(r)),
           jba._rodrigues_inv(jba._rodrigues(r)))
    with pytest.raises(ValueError):
        tba.calibrate_camera([np.zeros((4, 3))], [np.zeros((4, 2))],
                             (10, 10), num_coeffs=3)


# -- the chessboard ---------------------------------------------------------------

@pytest.mark.parametrize("i", [0, 3])
def test_corner_response_matches_jax(pairs, i):
    img = pairs[i][0].astype(np.float32)
    jr, jp = jcb.corner_response(jnp.asarray(img))
    tr, tp = tcb.corner_response(torch.tensor(img))
    jr = np.asarray(jr)
    assert tr.dtype == torch.float32 and tp.dtype == torch.bool
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0,
                               atol=1e-5 * np.abs(jr).max())
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("i", [1, 6])
def test_find_chessboard_corners_matches_jax(pairs, i):
    found = []
    for img in pairs[i]:
        fj, cj = jcb.find_chessboard_corners(img, CB)
        ft, ct = tcb.find_chessboard_corners(img, CB, device="cpu")
        assert fj and ft and ct.shape == (42, 2)
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-6)
        found.append(ct)
    # a tensor image computes on its device
    ft, ct = tcb.find_chessboard_corners(torch.tensor(pairs[i][0]), CB)
    assert ft
    np.testing.assert_array_equal(ct, found[0])


def test_corner_subpix_and_no_board_equal():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 256, (40, 50)).astype(np.float64)
    pts = rng.uniform(8, 30, (6, 2))
    _equal(tcb.corner_subpix(g, pts, (4, 4)),
           jcb.corner_subpix(g, pts, (4, 4)))
    blank = np.full(RES[::-1], 128, np.uint8)
    assert tcb.find_chessboard_corners(blank, CB, device="cpu") == (False,
                                                                    None)


def test_find_chessboard_corners_needs_a_card_by_default(pairs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        tcb.find_chessboard_corners(pairs[0][0], CB)


def test_chessboard_stereo_recovers_truth_and_equals_jax(pairs, tmp_path):
    # two pairs through files (the port's PNG writer and reader)
    files = []
    for k, (l, r) in enumerate(pairs[:2]):
        pl, pr = tmp_path / f"{k}_L.png", tmp_path / f"{k}_R.png"
        imwrite(str(pl), l)
        imwrite(str(pr), r)
        files.append((str(pl), str(pr)))
    images = files + list(pairs[2:])
    rig = tcal.chessboardStereo(images, CB, SQ, distCoeffsNumber=0,
                                device="cpu")
    jrig = jss.calibration.chessboardStereo(pairs, CB, SQ,
                                            distCoeffsNumber=0)
    assert isinstance(rig, StereoRig) and rig.device.type == "cpu"
    assert rig.reprojectionError < 0.12
    assert np.abs(np.asarray(rig.R) - R_REL).max() < 2e-3
    assert np.abs(np.asarray(rig.T).ravel() - T_REL).max() < 0.5
    assert rig.reprojectionError == jrig.reprojectionError
    for name in ("intrinsic1", "intrinsic2", "distCoeffs1", "distCoeffs2",
                 "R", "T", "F", "E"):
        np.testing.assert_array_equal(np.asarray(getattr(rig, name)),
                                      np.asarray(getattr(jrig, name)),
                                      err_msg=name)
    assert tuple(rig.res1) == tuple(jrig.res1) == RES


def test_chessboard_single_equals_jax(pairs):
    lefts = [l for l, _ in pairs[:6]]
    got = tcal.chessboardSingle(lefts, CB, SQ, distCoeffsNumber=0,
                                device="cpu")
    _equal(got, jss.calibration.chessboardSingle(lefts, CB, SQ,
                                                 distCoeffsNumber=0))
    with pytest.raises(ValueError):
        tcal.chessboardSingle(lefts[:1], CB, SQ, device="cpu")


# -- helpers ------------------------------------------------------------------------

def test_helpers_equal(tmp_path):
    from simplestereo_tpu.calibration import _object_grid as jgrid
    _equal(tcal._object_grid((7, 6), 2.5), jgrid((7, 6), 2.5))
    a, b = tmp_path / "a.svg", tmp_path / "b.svg"
    tcal.generateChessboardSVG((7, 6), str(a), squareSize=15, border=5)
    jss.calibration.generateChessboardSVG((7, 6), str(b), squareSize=15,
                                          border=5)
    assert a.read_bytes() == b.read_bytes()
    rng = np.random.default_rng(4)
    P1, P2 = rng.normal(0, 1, (3, 4)), rng.normal(0, 1, (3, 4))
    _equal(tcal.getFundamentalMatrixFromProjections(P1, P2),
           jss.calibration.getFundamentalMatrixFromProjections(P1, P2))
    bgr = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    from simplestereo_tpu.calibration import _load_gray as jload
    _equal(tcal._load_gray(bgr), jload(bgr))
    assert tcal.DEFAULT_CHESSBOARD_SIZE == (7, 6)


# -- the one-card Gauss-Newton --------------------------------------------------------

def test_sharded_gauss_newton_meets_bounds(synth):
    """tests/test_calibration.py::test_sharded_ba_matches_truth's views and
    bounds, on one device, and the JAX package's result on its 8-device
    mesh within the module docstring's float32 gates."""
    from simplestereo_tpu import parallel
    from simplestereo_tpu.calibration.sharded import \
        calibrate_camera_sharded as jax_gn
    V = 16
    rng = np.random.default_rng(11)
    obj, K, dist = synth["obj"], synth["K"], synth["dist"]
    imgs = []
    for _ in range(V):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-90, 30), rng.normal(-75, 30),
                         rng.normal(600, 100)])
        pts = jba.project_points(obj, rvec, tvec, K[0, 0], K[1, 1],
                                 K[0, 2], K[1, 2], dist)
        imgs.append(pts + rng.normal(0, 0.1, pts.shape))
    Hs = [jba._homography_dlt(obj[:, :2], i) for i in imgs[:6]]
    fx, fy, cx, cy = jba._zhang_intrinsics(Hs, (1280, 720))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    objs = np.tile(obj[None], (V, 1, 1))
    rms, Ke, de, poses = tsh.calibrate_camera_sharded(
        objs, np.stack(imgs), K0, np.zeros(5), iterations=25, device="cpu")
    assert rms < 0.25
    assert np.abs(Ke - K).max() < 5.0
    assert poses.shape == (V, 6) and de.shape == (5,)
    j_rms, j_K, j_d, j_poses = jax_gn(
        objs, np.stack(imgs), K0, np.zeros(5),
        parallel.make_mesh({"views": 8}), axis="views", iterations=25)
    assert abs(rms - j_rms) <= 5e-6
    assert np.abs(Ke - j_K).max() <= 1e-3
    assert np.abs(de - j_d).max() <= 1e-3
    assert np.abs(poses[:, :3] - j_poses[:, :3]).max() <= 5e-6
    assert np.abs(poses[:, 3:] - j_poses[:, 3:]).max() <= 2e-3
    with pytest.raises(TypeError):
        tsh.calibrate_camera_sharded(objs, np.stack(imgs), K0, np.zeros(5),
                                     mesh=object(), device="cpu")
