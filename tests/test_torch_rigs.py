"""PyTorch port: rectification (a copy), rigs, points and
``convert.rig_from_jax`` against the JAX package on seeded random rigs.

Tolerances: the rectification copy and the rig algebra are numpy float64
on both sides, so homographies, ``Rcommon``, K1/K2, Q and triangulated
points are equal exactly; JSON files are equal byte for byte; maps within
1e-3 px (float32 maps; the JAX map builder is one fused XLA program,
which contracts products and sums into FMAs); images equal but for pixels
at most 1 apart, at most 0.1% of them; reprojected points within rtol
1e-6 of the output's scale (see tests/test_torch_geometry.py) on finite
points, with the same non-finite pattern; PLY files byte-identical.
"""

import json

import numpy as np
import pytest
import torch

import simplestereo_tpu as jss
from simplestereo_tpu.geometry.npgeom import rodrigues_to_matrix
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch.convert import rig_from_jax

ALGOS = ["directRectify", "fusielloRectify", "loopRectify", "stereoRectify"]
MAP_TOL = 1e-3
CPU = torch.device("cpu")


def _rig_args(seed, scale=1.0):
    """A random 1280x720 rig as tests/test_rectification.py draws it
    (modest rotation, mostly-x baseline, small distortion), intrinsics and
    resolution scaled by ``scale``."""
    rng = np.random.default_rng(seed)
    f1 = rng.uniform(700, 1500)
    f2 = f1 * rng.uniform(0.9, 1.1)
    K1 = np.array([[f1, 0, rng.uniform(600, 680)],
                   [0, f1 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    K2 = np.array([[f2, 0, rng.uniform(600, 680)],
                   [0, f2 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    R = rodrigues_to_matrix(rng.normal(0, 0.06, 3))
    T = np.array([[-rng.uniform(60, 220)],
                  [rng.normal(0, 5)], [rng.normal(0, 8)]])
    d1 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    d2 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    K1[:2] *= scale
    K2[:2] *= scale
    res = (int(1280 * scale), int(720 * scale))
    return res, res, K1, K2, d1, d2, R, T


def _maps_close(t, j):
    for name in ("mapx1", "mapy1", "mapx2", "mapy2"):
        got = getattr(t, name)
        assert got.device == t.device and got.dtype == torch.float32
        np.testing.assert_allclose(got.cpu().numpy(),
                                   np.asarray(getattr(j, name)), rtol=0,
                                   atol=MAP_TOL)


def _equal_state(a, b, rectified=False):
    names = ["intrinsic1", "intrinsic2", "distCoeffs1", "distCoeffs2", "R",
             "T", "F", "E"]
    if rectified:
        names += ["Rcommon", "rectHomography1", "rectHomography2", "K1",
                  "K2"]
    assert tuple(a.res1) == tuple(b.res1) and tuple(a.res2) == tuple(b.res2)
    assert a.reprojectionError == b.reprojectionError
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        assert (x is None) == (y is None), n
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=n)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rectification_copy_equal(seed, algo):
    args = _rig_args(seed)
    j = getattr(jss.rectification, algo)(jss.StereoRig(*args))
    t = getattr(tss.rectification, algo)(tss.StereoRig(*args, device="cpu"))
    assert isinstance(t, tss.RectifiedStereoRig) and t.device == CPU
    _equal_state(t, j, rectified=True)
    np.testing.assert_array_equal(t.getQMatrix(), j.getQMatrix())
    for a, b in zip(t.getRectifiedProjectionMatrices(),
                    j.getRectifiedProjectionMatrices()):
        np.testing.assert_array_equal(a, b)
    _maps_close(t, j)


def test_rectification_helpers_equal():
    args = _rig_args(3)
    j, t = jss.StereoRig(*args), tss.StereoRig(*args, device="cpu")
    for a, b in zip(tss.rectification._lowLevelRectify(t),
                    jss.rectification._lowLevelRectify(j)):
        np.testing.assert_array_equal(a, b)
    H = jss.rectification.directRectify(j).rectHomography1
    np.testing.assert_array_equal(
        tss.rectification.getBestXShearingTransformation(H, args[0]),
        jss.rectification.getBestXShearingTransformation(H, args[0]))
    for alpha in (1, 0.5, 0):
        np.testing.assert_array_equal(
            tss.rectification.getFittingMatrix(args[2], args[3], H, H,
                                               args[0], args[1], args[4],
                                               args[5], (640, 360), alpha),
            jss.rectification.getFittingMatrix(args[2], args[3], H, H,
                                               args[0], args[1], args[4],
                                               args[5], (640, 360), alpha))


def test_derived_geometry_equal():
    args = _rig_args(4)
    j, t = jss.StereoRig(*args), tss.StereoRig(*args, device="cpu")
    np.testing.assert_array_equal(t.getFundamentalMatrix(),
                                  j.getFundamentalMatrix())
    np.testing.assert_array_equal(t.getEssentialMatrix(),
                                  j.getEssentialMatrix())
    for a, b in zip(t.getCenters(), j.getCenters()):
        np.testing.assert_array_equal(a, b)
    assert t.getBaseline() == j.getBaseline()
    np.testing.assert_array_equal(tss.utils.getCrossProductMatrix(args[7]),
                                  jss.utils.getCrossProductMatrix(args[7]))


@pytest.mark.parametrize("rectified", [False, True])
def test_save_load_both_ways(tmp_path, rectified):
    args = _rig_args(5)
    j = jss.StereoRig(*args, reprojectionError=0.25)
    t = tss.StereoRig(*args, reprojectionError=0.25, device="cpu")
    j.getFundamentalMatrix(), t.getFundamentalMatrix()
    if rectified:
        j = jss.rectification.fusielloRectify(j)
        t = tss.rectification.fusielloRectify(t)
    jcls = type(j)
    tcls = tss.RectifiedStereoRig if rectified else tss.StereoRig
    pj, pt = tmp_path / "j.json", tmp_path / "t.json"
    j.save(pj)
    t.save(pt)
    assert pj.read_bytes() == pt.read_bytes()
    back_t = tcls.fromFile(pj, device="cpu")
    back_j = jcls.fromFile(pt)
    assert back_t.device == CPU
    _equal_state(back_t, j, rectified)
    _equal_state(back_j, t, rectified)
    assert set(json.loads(pt.read_text())) >= {"res1", "R", "T", "F"}


@pytest.mark.parametrize("kind", ["plain", "rectified", "structured"])
def test_rig_from_jax(kind):
    args = _rig_args(6, scale=0.25)
    j = jss.StereoRig(*args)
    if kind == "rectified":
        j = jss.rectification.directRectify(j)
    elif kind == "structured":
        j = jss.StructuredLightRig(j)
    t = rig_from_jax(j, device="cpu")
    want = {"plain": tss.StereoRig, "rectified": tss.RectifiedStereoRig,
            "structured": tss.StructuredLightRig}[kind]
    assert type(t) is want and t.device == CPU
    _equal_state(t, j, rectified=kind == "rectified")
    if kind == "rectified":
        _maps_close(t, j)
        np.testing.assert_array_equal(t.getQMatrix(), j.getQMatrix())
    if kind == "structured":
        for n in ("R1", "R2", "Rcommon", "R_inv"):
            np.testing.assert_array_equal(getattr(t, n), getattr(j, n))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            rig_from_jax(j)  # default device "cuda"


def test_structured_light_triangulate_equal():
    args = _rig_args(7)
    j = jss.StructuredLightRig(jss.StereoRig(*args))
    t = tss.StructuredLightRig(tss.StereoRig(*args, device="cpu"))
    rng = np.random.default_rng(70)
    cam = rng.uniform(0, 1280, (40, 2))
    proj = cam + rng.uniform(20, 80, (40, 2)) * [1, 0]
    np.testing.assert_array_equal(t.triangulate(cam, proj),
                                  j.triangulate(cam, proj))
    same = t.triangulate(cam[:3], cam[:3])  # zero disparity: inf, no crash
    assert same.shape == (3, 1, 3)


def test_undistort_images_and_camera_image():
    args = _rig_args(8, scale=0.1)
    j = jss.StructuredLightRig(jss.StereoRig(*args))
    t = tss.StructuredLightRig(tss.StereoRig(*args, device="cpu"))
    rng = np.random.default_rng(80)
    img1 = rng.integers(0, 256, (72, 128, 3), np.uint8)
    img2 = rng.integers(0, 256, (72, 128), np.uint8)

    def close(a, b):
        d = np.abs(a.astype(np.int64) - b.astype(np.int64))
        assert a.dtype == b.dtype and d.max() <= 1 and (d > 0).mean() <= 1e-3

    for a, b in zip(t.undistortImages(img1, img2),
                    j.undistortImages(img1, img2)):
        close(a, np.asarray(b))
    got = t.undistortImages(img1, img2, changeCameras=True, alpha=0.5)
    want = j.undistortImages(img1, img2, changeCameras=True, alpha=0.5)
    assert len(got) == len(want) == 4
    close(got[0], np.asarray(want[0]))
    close(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    close(t.undistortCameraImage(img1), j.undistortCameraImage(img1))


def _points_close(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                               atol=1e-6 * scale)


def test_reproject_image_to_3d():
    args = _rig_args(9)
    j = jss.rectification.directRectify(jss.StereoRig(*args))
    t = tss.rectification.directRectify(tss.StereoRig(*args, device="cpu"))
    rng = np.random.default_rng(90)
    disp = rng.integers(-2, 40, (36, 64)).astype(np.int16)
    _points_close(t.get3DPoints(disp), j.get3DPoints(disp))
    dispf = (rng.random((36, 64)) * 30).astype(np.float32)
    _points_close(t.get3DPoints(dispf), j.get3DPoints(dispf))
    _points_close(tss.points.reprojectImageTo3D(torch.tensor(disp),
                                                j.getQMatrix()),
                  jss.points.reprojectImageTo3D(disp, j.getQMatrix()))


def test_adimensional_points():
    rng = np.random.default_rng(91)
    disp = rng.integers(0, 20, (30, 50)).astype(np.int16)
    _points_close(tss.points.getAdimensional3DPoints(disp, device="cpu"),
                  jss.points.getAdimensional3DPoints(disp))


def test_distort_points_copy():
    rng = np.random.default_rng(92)
    pts = rng.uniform(-0.5, 0.5, (20, 1, 2))
    for n in (4, 5, 8):
        d = rng.normal(0, 0.01, n)
        np.testing.assert_array_equal(tss.points.distortPoints(pts, d),
                                      jss.points.distortPoints(pts, d))
    with pytest.raises(ValueError):
        tss.points.distortPoints(pts, np.zeros(6))


@pytest.mark.parametrize("mode", ["xyz", "bgr", "gray_int", "gray_float"])
def test_export_ply_byte_identical(tmp_path, mode):
    rng = np.random.default_rng(93)
    pts = (rng.normal(0, 1, (6, 7, 3)) * [300, 200, 900]).astype(np.float32)
    pts[0, 0] = np.inf
    ref = {"xyz": None,
           "bgr": rng.integers(0, 256, (6, 7, 3), np.uint8),
           "gray_int": rng.integers(0, 256, (6, 7), np.uint8),
           "gray_float": rng.random((6, 7)).astype(np.float32)}[mode]
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jss.points.exportPLY(pts, pj, referenceImage=ref)
    tss.points.exportPLY(pts, pt, referenceImage=ref)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    cols = 3 if ref is None else (6 if mode == "bgr" else 4)
    for props in ((), tuple(range(cols)), (2, 0)):
        np.testing.assert_array_equal(tss.points.importPLY(pt, *props),
                                      jss.points.importPLY(pj, *props))
