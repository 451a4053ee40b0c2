"""PyTorch port: camera-projector calibration against the JAX package, on
the CPU, on tests/test_procam.py's synthetic scenes (its renderer copied
here).

- ``wrapped_phase_4step`` and ``heterodyne_unwrap``: host numpy copies,
  exactly equal.
- ``_decode_set``: the Gray-code decode on the device, integer-equal to
  JAX's (its maps and validity).
- ``solvePnP`` and the white-square centres: host copies, exactly equal.
- ``chessboardProCam`` and ``phaseShift`` at 256x192 (8 views): the
  projector pose within tests/test_procam.py's ``_check_rig`` bounds, and
  the rig equal, matrix by matrix, to the JAX package's (the corners and
  the decoded maps are equal, the bundle adjustment is the same numpy).
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu.active import graycode_patterns
from simplestereo_tpu.calibration import ba
from simplestereo_tpu.calibration import procam as jprocam
from simplestereo_tpu_torch import StereoRig
from simplestereo_tpu_torch.calibration import procam

CAM_RES = (256, 192)
PROJ_RES = (256, 192)
KC = np.array([[240., 0, 127.5], [0, 240., 95.5], [0, 0, 1]])
KP = np.array([[300., 0, 127.5], [0, 300., 95.5], [0, 0, 1]])
SQ = 20.0
CB = (7, 6)


def _gt_projector():
    R = ba._rodrigues(np.array([0.02, -0.06, 0.01]))
    T = np.array([-60.0, 3.0, 10.0])
    return R, T


def _view_poses():
    rng = np.random.default_rng(7)
    poses = []
    while len(poses) < 8:
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-15, 8), rng.normal(-45, 8),
                         rng.normal(430, 30)])
        R = ba._rodrigues(rvec)
        cols, rows = CB
        corners = np.array([[-SQ, -SQ, 0], [cols * SQ, -SQ, 0],
                            [-SQ, rows * SQ, 0],
                            [cols * SQ, rows * SQ, 0]])
        Rp, Tp = _gt_projector()
        q = ((corners @ R.T + tvec) @ Rp.T + Tp) @ KP.T
        uv = q[:, :2] / q[:, 2:]
        qc = (corners @ R.T + tvec) @ KC.T
        uvc = qc[:, :2] / qc[:, 2:]
        if (uv[:, 0].min() > 2 and uv[:, 0].max() < PROJ_RES[0] - 2
                and uv[:, 1].min() > 2 and uv[:, 1].max() < PROJ_RES[1] - 2
                and uvc[:, 0].min() > 2 and uvc[:, 0].max() < CAM_RES[0] - 2
                and uvc[:, 1].min() > 2
                and uvc[:, 1].max() < CAM_RES[1] - 2):
            poses.append((R, tvec))
    return poses


def _board_geometry(Rb, tb, scale=1):
    w, h = CAM_RES
    xs = (np.arange(w * scale, dtype=float) + 0.5) / scale - 0.5
    ys = (np.arange(h * scale, dtype=float) + 0.5) / scale - 0.5
    xs, ys = np.meshgrid(xs, ys)
    p = np.stack([xs, ys, np.ones_like(xs)], -1)
    d = p @ np.linalg.inv(KC).T
    n = Rb[:, 2]
    s = (n @ tb) / (d @ n)
    Xc = s[..., None] * d
    Xb = (Xc - tb) @ Rb
    return Xc, Xb[..., 0], Xb[..., 1], s > 0


def _render_board(Rb, tb, scale=4):
    _, bx, by, ok = _board_geometry(Rb, tb, scale=scale)
    cols, rows = CB
    inside = ((bx > -SQ) & (bx < cols * SQ)
              & (by > -SQ) & (by < rows * SQ) & ok)
    parity = (np.floor(bx / SQ) + np.floor(by / SQ)) % 2 == 0
    img = np.where(inside & parity, 20.0, 235.0)
    img = img.reshape(CAM_RES[1], scale, CAM_RES[0], scale).mean((1, 3))
    return img.astype(np.uint8)


def _proj_pixel_of_cam(Rb, tb):
    Rp, Tp = _gt_projector()
    Xc, _, _, ok = _board_geometry(Rb, tb)
    q = (Xc @ Rp.T + Tp) @ KP.T
    return q[..., 0] / q[..., 2], q[..., 1] / q[..., 2], ok


@pytest.fixture(scope="module")
def graycode_sets():
    pats, _, _ = graycode_patterns(PROJ_RES)
    sets = []
    for Rb, tb in _view_poses():
        pu, pv, ok = _proj_pixel_of_cam(Rb, tb)
        ui = np.round(pu).astype(int)
        vi = np.round(pv).astype(int)
        lit = ok & (ui >= 0) & (ui < PROJ_RES[0]) \
            & (vi >= 0) & (vi < PROJ_RES[1])
        uis = np.clip(ui, 0, PROJ_RES[0] - 1)
        vis = np.clip(vi, 0, PROJ_RES[1] - 1)
        caps = [np.where(lit, p[vis, uis], 0).astype(np.uint8)
                for p in pats]
        black = np.zeros(CAM_RES[::-1], np.uint8)
        white = np.where(lit, 255, 0).astype(np.uint8)
        sets.append(caps + [black, _render_board(Rb, tb), white])
    return sets


def _phaseshift_sets(periods):
    sets = []
    for Rb, tb in _view_poses():
        pu, pv, ok = _proj_pixel_of_cam(Rb, tb)
        imgs = []
        for v, coord in ((0, pu), (1, pv)):
            for T in periods[v]:
                for i in range(4):
                    th = 2 * np.pi * coord / T + i * np.pi / 2
                    imgs.append((127.5 * (1 + np.cos(th))))
        imgs.append(_render_board(Rb, tb).astype(float))
        sets.append(imgs)
    return sets


def _check_rig(rig, t_tol=3.0, r_tol=2e-2):
    Rp, Tp = _gt_projector()
    assert np.abs(np.asarray(rig.R) - Rp).max() < r_tol
    assert np.abs(np.asarray(rig.T).ravel() - Tp).max() < t_tol
    assert rig.reprojectionError < 1.0


def _same_rig(rig, jrig):
    assert isinstance(rig, StereoRig) and rig.device.type == "cpu"
    assert rig.reprojectionError == jrig.reprojectionError
    for name in ("intrinsic1", "intrinsic2", "distCoeffs1", "distCoeffs2",
                 "R", "T", "F", "E"):
        np.testing.assert_array_equal(np.asarray(getattr(rig, name)),
                                      np.asarray(getattr(jrig, name)),
                                      err_msg=name)


def test_phase_math_equal():
    rng = np.random.default_rng(0)
    I = [rng.uniform(0, 255, (7, 9)) for _ in range(4)]
    np.testing.assert_array_equal(procam.wrapped_phase_4step(*I),
                                  jprocam.wrapped_phase_4step(*I))
    x = np.linspace(0, 127, 500)
    th0 = 2 * np.pi * x / 128.0 + 0.03
    th1 = np.mod(2 * np.pi * x / 16.0, 2 * np.pi)
    got = procam.heterodyne_unwrap(th0, th1, 128.0, 16.0)
    np.testing.assert_array_equal(got, jprocam.heterodyne_unwrap(
        th0, th1, 128.0, 16.0))
    np.testing.assert_allclose(got, th0 - 0.03, atol=1e-9)


def test_decode_set_integer_equal(graycode_sets):
    for s in graycode_sets[:2]:
        grays = [procam._load_gray_f(p) for p in s[:-3]]
        got = procam._decode_set(grays, PROJ_RES, 5, "cpu")
        want = jprocam._decode_set(grays, PROJ_RES, 5)
        for g, w in zip(got, want):
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
        assert got[2].mean() > 0.2


def test_solve_pnp_and_white_centres_equal():
    rng = np.random.default_rng(1)
    obj = procam._object_grid(CB, SQ)
    rvec, tvec = rng.normal(0, 0.2, 3), np.array([-50.0, -40.0, 420.0])
    img = ba.project_points(obj, rvec, tvec, 240., 240., 127.5, 95.5,
                            np.zeros(5))
    got = procam.solvePnP(obj, img, KC, np.zeros(5))
    for g, w in zip(got, jprocam.solvePnP(obj, img, KC, np.zeros(5))):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], rvec, atol=1e-6)
    a = procam._white_centers([img], KC, np.zeros(5), CB, SQ)
    b = jprocam._white_centers([img], KC, np.zeros(5), CB, SQ)
    np.testing.assert_array_equal(a[0][0], b[0][0])
    np.testing.assert_array_equal(a[1], b[1])


def test_chessboard_procam_recovers_and_equals_jax(graycode_sets):
    rig = procam.chessboardProCam(graycode_sets, PROJ_RES,
                                  chessboardSize=CB, squareSize=SQ,
                                  device="cpu")
    _check_rig(rig, t_tol=6.0, r_tol=2e-2)
    _same_rig(rig, jprocam.chessboardProCam(graycode_sets, PROJ_RES,
                                            chessboardSize=CB,
                                            squareSize=SQ))
    with pytest.raises(ValueError):
        procam.chessboardProCam([graycode_sets[0][:-1]], PROJ_RES,
                                chessboardSize=CB, squareSize=SQ,
                                device="cpu")


def test_phase_shift_recovers_and_equals_jax():
    periods = [[256.0, 32.0], [192.0, 24.0]]
    sets = _phaseshift_sets(periods)
    rig = procam.phaseShift(periods, PROJ_RES, sets, chessboardSize=CB,
                            squareSize=SQ, device="cpu")
    _check_rig(rig)
    _same_rig(rig, jprocam.phaseShift(periods, PROJ_RES, sets,
                                      chessboardSize=CB, squareSize=SQ))


def test_procam_needs_a_card_by_default(graycode_sets):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        procam.chessboardProCam(graycode_sets[:1], PROJ_RES,
                                chessboardSize=CB, squareSize=SQ)
