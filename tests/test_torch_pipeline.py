"""PyTorch port: the README pipeline end to end on the CPU against the JAX
package, at 96x64.

rig -> ``rectification.directRectify`` -> ``rectifyImages`` ->
``StereoASW(winSize=7, minDisparity=1, maxDisparity=6, consistent=True)``
-> ``get3DPoints`` -> ``points.exportPLY``.

The rig is drawn as tests/test_rectification.py draws its random rigs,
with its intrinsics scaled to 96x64. The scene is a plane covered in
noise, rendered in numpy through both distorted cameras, placed so that
its rectified disparity is 3 px at every pixel.

Tolerances: rectified images equal but for pixels at most 1 apart, at most
0.1% of them; the two matchers, fed the same rectified pair (JAX's), differ
on at most 1.2% of pixels (the ASW budget of tests/test_torch_slice.py)
where both rectification maps sample inside their source images (outside,
one view is black, every TAD hits its cap of 40 and the costs tie to the
last ulp, so the argmin there is noise in either package);
from the same disparity, points within rtol 1e-6 of the output's scale
with the same non-finite pattern, and PLY files byte-identical.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import simplestereo_tpu as jss
from simplestereo_tpu.geometry import npgeom
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch.convert import asw_from_jax
from simplestereo_tpu_torch.passive import asw_cuda

W, H = 96, 64
MISMATCH = 0.012
ASW = dict(winSize=7, minDisparity=1, maxDisparity=6, consistent=True)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rig_args(seed=30):
    """A random 1280x720 rig (tests/test_rectification.py:64-81), its
    intrinsics scaled to W x H."""
    rng = np.random.default_rng(seed)
    f1 = rng.uniform(700, 1500)
    f2 = f1 * rng.uniform(0.9, 1.1)
    K1 = np.array([[f1, 0, rng.uniform(600, 680)],
                   [0, f1 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    K2 = np.array([[f2, 0, rng.uniform(600, 680)],
                   [0, f2 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    R = npgeom.rodrigues_to_matrix(rng.normal(0, 0.06, 3))
    T = np.array([[-rng.uniform(60, 220)],
                  [rng.normal(0, 5)], [rng.normal(0, 8)]])
    d1 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    d2 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    for K in (K1, K2):
        K[0] *= W / 1280
        K[1] *= H / 720
    return (W, H), (W, H), K1, K2, d1, d2, R, T


def _disparity_plane(rect, target):
    """(n, c, p0): the plane n . X = c (camera-1 frame) whose rectified
    disparity is ``target`` at every pixel, and a point p0 on it. The
    rectified views share their rows, so the points of one disparity form
    a plane; three of them, triangulated, fix it."""
    P1, P2 = rect.getRectifiedProjectionMatrices()
    pts = []
    for u, v in ((0.25 * W, 0.25 * H), (0.75 * W, 0.25 * H),
                 (0.5 * W, 0.75 * H)):
        A = np.stack([u * P1[2] - P1[0], v * P1[2] - P1[1],
                      (u - target) * P2[2] - P2[0], v * P2[2] - P2[1]])
        X = np.linalg.svd(A)[2][-1]
        pts.append(X[:3] / X[3])
    n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    n /= np.linalg.norm(n)
    return n, float(n @ pts[0]), pts[0]


def _render(rig, plane, seed=31):
    """The two views of ``plane`` covered in noise (about 2 px per texel),
    uint8 BGR: each pixel's ray is undistorted, meets the plane, and the
    texture is sampled bilinearly in the plane's own coordinates."""
    n, c, p0 = plane
    tex = np.random.default_rng(seed).integers(
        0, 256, (200, 200, 3)).astype(np.float64)
    texel = 2.0 * p0[2] / rig.intrinsic1[0, 0]
    e1 = np.cross([0.0, 1.0, 0.0], n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    pix = np.stack([u, v], -1).reshape(-1, 2)
    R, T = rig.R, rig.T.ravel()
    views = []
    for K, d, Rw, C in ((rig.intrinsic1, rig.distCoeffs1, np.eye(3),
                         np.zeros(3)),
                        (rig.intrinsic2, rig.distCoeffs2, R, -R.T @ T)):
        ray = np.concatenate([npgeom.undistort_points(pix, K, d),
                              np.ones((len(pix), 1))], 1) @ Rw
        P = C + ray * ((c - n @ C) / (ray @ n))[:, None]
        tx = (P - p0) @ e1 / texel + 100
        ty = (P - p0) @ e2 / texel + 100
        x0 = np.clip(np.floor(tx).astype(int), 0, 198)
        y0 = np.clip(np.floor(ty).astype(int), 0, 198)
        fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
        val = ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
               + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)
        views.append(np.clip(np.round(val), 0, 255).astype(np.uint8)
                     .reshape(H, W, 3))
    return views


@pytest.fixture(scope="module")
def scene():
    args = _rig_args()
    jrig = jss.StereoRig(*args)
    jrect = jss.rectification.directRectify(jrig)
    trect = tss.rectification.directRectify(
        tss.StereoRig(*args, device="cpu"))
    left, right = _render(jrect, _disparity_plane(jrect, 3.0))
    return jrect, trect, left, right


def _inside(mapx, mapy):
    mapx, mapy = np.asarray(mapx), np.asarray(mapy)
    return (mapx >= 0) & (mapx <= W - 1) & (mapy >= 0) & (mapy <= H - 1)


def _uint8_close(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_rectified_images(scene):
    jrect, trect, left, right = scene
    for got, want in zip(trect.rectifyImages(left, right),
                         jrect.rectifyImages(left, right)):
        _uint8_close(got, want)


def test_disparity_on_the_same_rectified_pair(scene):
    jrect, _, left, right = scene
    l, r = jrect.rectifyImages(left, right)
    jm = jss.passive.StereoASW(**ASW)
    want = jm.compute(l, r)
    before = asw_cuda.launches
    got = asw_from_jax(jm, device="cpu").compute(l, r)
    assert asw_cuda.launches == before
    assert got.dtype == want.dtype == np.int16
    valid = _inside(jrect.mapx1, jrect.mapy1) & _inside(jrect.mapx2,
                                                        jrect.mapy2)
    assert valid.mean() > 0.75
    assert (got != want)[valid].mean() <= MISMATCH
    # the plane is found: the valid interior within 1 px of 3
    inner = got[4:-4, 10:-4][valid[4:-4, 10:-4]]
    assert (np.abs(inner - 3.0) <= 1.0).mean() > 0.9


def test_cloud_and_ply(scene, tmp_path):
    jrect, trect, left, right = scene
    l, r = jrect.rectifyImages(left, right)
    disp = jss.passive.StereoASW(**ASW).compute(l, r)
    want = jrect.get3DPoints(disp)
    got = trect.get3DPoints(disp)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (H, W, 3)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                               atol=1e-6 * np.abs(want[fin]).max())
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jss.points.exportPLY(want, pj, referenceImage=l)
    tss.points.exportPLY(want, pt, referenceImage=l)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    tss.points.exportPLY(got, pt, referenceImage=l)
    back = tss.points.importPLY(pt, 0, 1, 2, 3, 4, 5)
    assert back.shape == (H * W, 6)
    np.testing.assert_array_equal(back[:, 3:], l.reshape(-1, 3)[:, ::-1])
    fin = np.isfinite(back[:, 0])
    np.testing.assert_allclose(back[fin, :3], got.reshape(-1, 3)[fin],
                               rtol=0, atol=1e-6)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    args = _rig_args()
    with pytest.raises(RuntimeError, match="cuda"):
        tss.StereoRig(*args)
    cpu_rig = tss.StereoRig(*args, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.RectifiedStereoRig(np.eye(3), np.eye(3), np.eye(3), cpu_rig,
                               device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.points.reprojectImageTo3D(np.zeros((4, 4)), np.eye(4))
    with pytest.raises(RuntimeError, match="cuda"):
        tss.warp.init_undistort_rectify_map(np.eye(3), None, None,
                                            np.eye(3), (4, 4))


def test_pipeline_runs_with_jax_blocked(tmp_path):
    """The whole chain, on the CPU, in a process where jax cannot be
    imported, as on the GPU machine."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import simplestereo_tpu_torch as tss
        from simplestereo_tpu_torch.geometry import npgeom
        rng = np.random.default_rng(0)
        K = np.array([[80.0, 0, 48], [0, 80, 32], [0, 0, 1]])
        rig = tss.StereoRig((96, 64), (96, 64), K, K, None, None,
                            npgeom.rodrigues_to_matrix([0, 0.02, 0]),
                            [[-10.0], [0], [0]], device="cpu")
        rect = tss.rectification.directRectify(rig)
        img = rng.integers(0, 256, (64, 96, 3), np.uint8)
        l, r = rect.rectifyImages(img, np.roll(img, -3, axis=1))
        d = tss.passive.StereoASW(7, 6, 1, consistent=True,
                                  device="cpu").compute(l, r)
        pts = rect.get3DPoints(d)
        tss.points.exportPLY(pts, {str(tmp_path / "c.ply")!r},
                             referenceImage=l)
        back = tss.points.importPLY({str(tmp_path / "c.ply")!r})
        assert back.shape == (64 * 96, 3)
        assert "simplestereo_tpu" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
