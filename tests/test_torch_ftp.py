"""PyTorch port: Fourier Transform Profilometry against the JAX package, on
tests/test_active.py's 128x96 synthetic scene (a red-striped fringe on a
plane at z0 = 520), on the CPU.

Tolerances: the same finite pattern, and each point within 1e-4 of the
JAX point's distance from the camera, with the same fringe order k. Both
packages run the FFTs in complex64 and the triangulation in float32, with
sums in other orders; the phases agree to about 1e-5 rad, which moves z
by a few thousandths at z ~ 520 (a relative 1e-5), far below the bound.
The Mapping variant is float64 numpy on both sides after a float32
undistortion: within 1e-9. ``getCloudBatch`` runs the same code as
``getCloud`` with a frame axis: equal to per-frame calls.
"""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import simplestereo_tpu as jss
from simplestereo_tpu.geometry import npgeom
from simplestereo_tpu.geometry.npgeom import rodrigues_to_matrix
from simplestereo_tpu import unwrapping as junw
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch import convert
from simplestereo_tpu_torch import unwrapping as unw

CAM_RES = (128, 96)
PROJ_RES = (128, 96)
RTOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_rig():
    K = np.array([[140., 0, 63.5], [0, 140., 47.5], [0, 0, 1]])
    R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    T = np.array([[-40.], [1.0], [6.0]])
    return jss.StereoRig(CAM_RES, PROJ_RES, K, K, None, None, R, T)


def _render(rig, fringe, z0):
    """The fringe projected on the plane z = z0, seen by the camera
    (bilinear, as tests/test_active.py renders it)."""
    w, h = rig.res1
    K1 = np.asarray(rig.intrinsic1, float)
    xs, ys = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    P = z0 * (np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K1).T)
    q = (P @ np.asarray(rig.R, float).T + np.asarray(rig.T, float).ravel()) \
        @ np.asarray(rig.intrinsic2, float).T
    return np.asarray(jss.warp.remap(
        jnp.asarray(fringe), jnp.asarray(q[..., 0] / q[..., 2], jnp.float32),
        jnp.asarray(q[..., 1] / q[..., 2], jnp.float32),
        interpolation="linear"))


def _close(a, b, rtol=RTOL):
    a = np.asarray(a, np.float64).reshape(-1, 3)
    b = np.asarray(b, np.float64).reshape(-1, 3)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    ok = np.isfinite(a).all(1)
    assert ok.mean() > 0.9
    err = np.abs(a[ok] - b[ok]).max(1) / np.linalg.norm(a[ok], axis=1)
    assert err.max() <= rtol, err.max()


@pytest.fixture(scope="module")
def scene():
    rig = _make_rig()
    fringe = jss.active.buildFringe(16.0, dims=PROJ_RES, stripeColor="red")
    cam = _render(rig, fringe, 520.0)
    jftp = jss.active.StereoFTP(rig, fringe, 16.0)
    jdump = {}
    jcloud = jftp.getCloud(cam, dump=jdump)
    return dict(rig=rig, port_rig=convert.rig_from_jax(rig, device="cpu"),
                fringe=fringe, cam=cam, jftp=jftp, jcloud=jcloud,
                jdump=jdump)


@pytest.fixture(scope="module")
def ftp(scene):
    return tss.active.StereoFTP(scene["port_rig"], scene["fringe"], 16.0,
                                device="cpu")


def test_cloud_matches_jax(scene, ftp):
    dump = {}
    cloud = ftp.getCloud(scene["cam"], dump=dump)
    assert cloud.shape == (CAM_RES[1], CAM_RES[0], 3)
    assert cloud.dtype == np.float64
    _close(cloud, scene["jcloud"])
    jd = scene["jdump"]
    assert float(dump["k"]) == float(jd["k"])
    assert set(dump) == set(jd)
    for key in ("phase", "phase_unwrapped"):
        np.testing.assert_allclose(dump[key], jd[key], rtol=0, atol=1e-4)
    np.testing.assert_allclose(dump["spectrum"], jd["spectrum"], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(dump["fmin"], jd["fmin"], rtol=1e-12)
    center = cloud[20:-20, 20:-20, 2]
    center = center[np.isfinite(center)]
    assert abs(np.median(center) - 520.0) < 0.02 * 520.0


def test_state_matches_jax(scene, ftp):
    j = scene["jftp"]
    for name in ("fringe", "F", "Rectify1", "Rectify2", "ep", "R_inv"):
        np.testing.assert_array_equal(getattr(ftp, name), getattr(j, name))
    assert ftp.fringeDims == j.fringeDims and ftp.fp == j.fp
    assert ftp.stripeCentralPeak == j.stripeCentralPeak
    assert ftp._fringe_row_inv == j._fringe_row_inv
    pc, vr = ftp._getProjectorMapping(520.0)
    jpc, jvr = j._getProjectorMapping(520.0)
    # float32 coordinates within 1e-4 px; the virtual reference moves by
    # at most the fringe's slope (255 * 2 pi / 16 grey levels a pixel)
    # times that
    np.testing.assert_allclose(pc.numpy(), np.asarray(jpc), rtol=0, atol=1e-4)
    np.testing.assert_allclose(vr.numpy(), np.asarray(jvr), rtol=0,
                               atol=1e-4 * 255 * 2 * np.pi / 16)


@pytest.mark.parametrize("case", ["roi", "float16"])
def test_cloud_options(scene, ftp, case):
    kw = (dict(roi=(6, 4, CAM_RES[0] - 14, CAM_RES[1] - 10))
          if case == "roi" else dict(out_dtype=np.float16))
    a = ftp.getCloud(scene["cam"], **kw)
    b = scene["jftp"].getCloud(scene["cam"], **kw)
    assert a.shape == b.shape and a.dtype == b.dtype
    _close(a, b, RTOL if case == "roi" else 2e-3)


def test_batch_equals_per_frame(scene, ftp):
    rng = np.random.default_rng(3)
    cam = scene["cam"]
    noisy = np.clip(cam.astype(np.int16) + rng.integers(-2, 3, cam.shape),
                    0, 255).astype(cam.dtype)
    imgs = np.stack([cam, noisy, np.roll(cam, 1, axis=0)])
    for roi in (None, (6, 4, CAM_RES[0] - 14, CAM_RES[1] - 10)):
        batch = ftp.getCloudBatch(imgs, roi=roi)
        jbatch = scene["jftp"].getCloudBatch(imgs, roi=roi)
        for b in range(len(imgs)):
            np.testing.assert_array_equal(batch[b],
                                          ftp.getCloud(imgs[b], roi=roi))
            _close(batch[b], jbatch[b])
    with pytest.raises(ValueError):
        ftp.getCloudBatch(cam)
    mapping = tss.active.StereoFTP_Mapping(scene["port_rig"],
                                           scene["fringe"], 16.0,
                                           device="cpu")
    with pytest.raises(TypeError):
        mapping.getCloudBatch(imgs)


@pytest.mark.parametrize("method", ["numpy", "iir"])
def test_unwrapping_method(scene, ftp, method):
    """The staged path: the phase comes to the host, the callback unwraps
    it, the cloud is triangulated on the device. ``iir`` is the port's
    S1 twin against the JAX scans."""
    if method == "numpy":
        port_fn = jax_fn = lambda p: np.unwrap(np.unwrap(p, axis=1), axis=0)
    else:
        port_fn = functools.partial(unw.infiniteImpulseResponse, tau=1.0,
                                    device="cpu")
        jax_fn = functools.partial(junw.infiniteImpulseResponse, tau=1.0)
    dump, jdump = {}, {}
    a = ftp.getCloud(scene["cam"], unwrappingMethod=port_fn, dump=dump)
    b = scene["jftp"].getCloud(scene["cam"], unwrappingMethod=jax_fn,
                               dump=jdump)
    _close(a, b)
    assert float(dump["k"]) == float(jdump["k"])
    np.testing.assert_allclose(dump["phase_unwrapped"],
                               jdump["phase_unwrapped"], rtol=0, atol=1e-4)
    if method == "numpy":
        _close(a, ftp.getCloud(scene["cam"]), 5e-3)


def test_plot_and_errors(scene, ftp, tmp_path):
    pytest.importorskip("matplotlib")
    p = tmp_path / "ftp.png"
    ftp.getCloud(scene["cam"], plot=str(p))
    assert p.exists() and p.stat().st_size > 0
    with pytest.raises(ValueError, match="color"):
        ftp.getCloud(scene["cam"][:, :, 0])
    with pytest.raises(ValueError, match="stripe"):
        ftp.getCloud(np.zeros_like(scene["cam"]))


def test_anaglyph(scene):
    fringe = jss.active.buildAnaglyphFringe(16.0, dims=PROJ_RES)
    cam = _render(scene["rig"], fringe, 520.0)
    a = tss.active.StereoFTPAnaglyph(scene["port_rig"], fringe, 16.0,
                                     stripeColor="green", device="cpu")
    b = jss.active.StereoFTPAnaglyph(scene["rig"], fringe, 16.0,
                                     stripeColor="green")
    np.testing.assert_allclose(a.fringe, b.fringe, rtol=1e-15)
    _close(a.getCloud(cam), b.getCloud(cam))
    batch = a.getCloudBatch(np.stack([cam, cam]))
    np.testing.assert_array_equal(batch[1], a.getCloud(cam))


def test_mapping_variant(scene):
    a = tss.active.StereoFTP_Mapping(scene["port_rig"], scene["fringe"], 16.0,
                                     device="cpu")
    b = jss.active.StereoFTP_Mapping(scene["rig"], scene["fringe"], 16.0)
    dump = {}
    cloud = a.getCloud(scene["cam"], dump=dump)
    _close(cloud, b.getCloud(scene["cam"]), 1e-9)
    assert dump["spectrum"].shape == (CAM_RES[1], CAM_RES[0])


def test_phase_only_variant(scene):
    a = tss.active.StereoFTP_PhaseOnly(scene["port_rig"], scene["fringe"],
                                       16.0, device="cpu")
    b = jss.active.StereoFTP_PhaseOnly(scene["rig"], scene["fringe"], 16.0)
    pa, pb = a.getPhase(scene["cam"]), np.asarray(b.getPhase(scene["cam"]))
    assert pa.shape == pb.shape == (CAM_RES[1], CAM_RES[0])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-4)
    assert np.nanstd(pa[20:-20, 20:-20]) < 0.5


# Lens distortion on camera and projector: the coefficients of the card's
# 1280x720 scan rig (chip_smoke.py SCAN_D1/SCAN_D2); at this size they move
# the frame's edge by under a pixel. Five times them leave a border of
# black and noise wide enough for the separable unwrap to lose the fringe
# order.
DIST1 = np.array([0.04, -0.02, 0.0005, -0.0005, 0.0])
DIST2 = np.array([-0.02, 0.01, 0.0, 0.0003, 0.0])
ROI8 = (8, 8, CAM_RES[0] - 16, CAM_RES[1] - 16)


@functools.lru_cache(maxsize=None)
def _distorted_scene(scale):
    """The scene with DIST1/DIST2 times ``scale``: the JAX rig and scanner,
    the port's, and the capture (each camera pixel's ray undistorted, met
    with the plane z = 520, and sent to the projector pixel that emits
    towards it)."""
    d1, d2 = scale * DIST1, scale * DIST2
    K = np.array([[140., 0, 63.5], [0, 140., 47.5], [0, 0, 1]])
    rig = jss.StereoRig(CAM_RES, PROJ_RES, K, K, d1, d2,
                        rodrigues_to_matrix(np.array([0.0, -0.05, 0.0])),
                        np.array([[-40.], [1.0], [6.0]]))
    w, h = CAM_RES
    u, v = np.meshgrid(np.arange(w, dtype=float), np.arange(h, dtype=float))
    ray = npgeom.undistort_points(np.stack([u, v], -1).reshape(-1, 2), K, d1)
    P = 520.0 * np.concatenate([ray, np.ones((len(ray), 1))], 1)
    q = P @ np.asarray(rig.R, float).T + np.asarray(rig.T, float).ravel()
    xd = npgeom.distort_normalized(q[:, :2] / q[:, 2:], d2)
    fringe = jss.active.buildFringe(16.0, dims=PROJ_RES, stripeColor="red")
    cam = np.asarray(jss.warp.remap(
        jnp.asarray(fringe),
        jnp.asarray((K[0, 0] * xd[:, 0] + K[0, 2]).reshape(h, w), jnp.float32),
        jnp.asarray((K[1, 1] * xd[:, 1] + K[1, 2]).reshape(h, w), jnp.float32),
        interpolation="linear"))
    return dict(cam=cam, jftp=jss.active.StereoFTP(rig, fringe, 16.0),
                ftp=tss.active.StereoFTP(
                    convert.rig_from_jax(rig, device="cpu"), fringe, 16.0,
                    device="cpu"))


def _plane_p80(cloud):
    """80th percentile of |z - 520| over the cloud's centre."""
    z = cloud[..., 2]
    m = z.shape[0] // 4
    z = z[m:-m, m:-m]
    return float(np.percentile(np.abs(z[np.isfinite(z)] - 520.0), 80))


def _same_order_and_phase(port, jax_, cam, roi):
    dump, jdump = {}, {}
    a = port.getCloud(cam, roi=roi, dump=dump)
    b = np.asarray(jax_.getCloud(cam, roi=roi, dump=jdump))
    assert float(dump["k"]) == float(jdump["k"])
    np.testing.assert_allclose(dump["phase_unwrapped"],
                               jdump["phase_unwrapped"], rtol=0, atol=1e-4)
    return a, b


@pytest.mark.parametrize("roi", [None, ROI8], ids=["full", "roi"])
def test_distorted_cloud_matches_jax(roi):
    """Camera and projector distortion: the undistortion of the capture
    and of the stripe centroids, and the projector's distortion in the
    dense cloud, against the JAX package, with and without an ROI; the
    batch path (its own centroid undistortion) too."""
    sc = _distorted_scene(1)
    cam = sc["cam"]
    a, b = _same_order_and_phase(sc["ftp"], sc["jftp"], cam, roi)
    _close(a, b)
    assert _plane_p80(a) < 0.05 * 520.0
    imgs = np.stack([cam, np.roll(cam, 1, axis=0)])
    batch = sc["ftp"].getCloudBatch(imgs, roi=roi)
    jbatch = np.asarray(sc["jftp"].getCloudBatch(imgs, roi=roi))
    for i in range(len(imgs)):
        np.testing.assert_array_equal(batch[i],
                                      sc["ftp"].getCloud(imgs[i], roi=roi))
        _close(batch[i], jbatch[i])


def test_distorted_border_loses_order_in_both_packages():
    """With five times the distortion, the full frame's border of black
    and noise makes the separable unwrap lose the fringe order in both
    packages alike (same k, same unwrapped phase); an ROI inside the
    border recovers the plane in both. Off the plane, points reach
    z ~ 65,000, where the two rays are near parallel and the float32
    triangulation's differences grow: within 1e-3 there."""
    sc = _distorted_scene(5)
    a, b = _same_order_and_phase(sc["ftp"], sc["jftp"], sc["cam"], None)
    _close(a, b, 1e-3)
    assert _plane_p80(a) > 0.1 * 520.0 and _plane_p80(b) > 0.1 * 520.0
    a, b = _same_order_and_phase(sc["ftp"], sc["jftp"], sc["cam"], ROI8)
    _close(a, b)
    assert _plane_p80(a) < 0.05 * 520.0


def _user_classes(base):
    """Subclasses that override only the host hook or only the device hook
    (tests/test_active.py's two grayscale-override cases)."""

    class HostOnly(base):
        @staticmethod
        def convertGrayscale(img):
            img = np.asarray(img)
            if img.ndim == 2:
                return img.astype(np.float64)
            d = (img[:, :, 0].astype(np.float64)
                 - img[:, :, 2].astype(np.float64))
            ptp = np.ptp(d)
            return (d - d.min()) / (ptp if ptp > 0 else 1.0)

    class DeviceOnly(base):
        @staticmethod
        def convertGrayscaleDevice(img):
            if img.ndim == 2:
                return img.astype(jnp.float32) if hasattr(img, "astype") \
                    and not isinstance(img, torch.Tensor) \
                    else img.to(torch.float32)
            if isinstance(img, torch.Tensor):
                d = img[:, :, 0].float() - img[:, :, 2].float()
                ptp = d.max() - d.min()
                return (d - d.min()) / torch.where(ptp > 0, ptp,
                                                   torch.ones_like(ptp))
            d = (img[:, :, 0].astype(jnp.float32)
                 - img[:, :, 2].astype(jnp.float32))
            ptp = jnp.ptp(d)
            return (d - jnp.min(d)) / jnp.where(ptp > 0, ptp, 1.0)

    return HostOnly, DeviceOnly


@pytest.mark.parametrize("which", ["host", "device"])
def test_grayscale_overrides(scene, which):
    fringe = jss.active.buildAnaglyphFringe(16.0, dims=PROJ_RES)
    cam = _render(scene["rig"], fringe, 520.0)
    port_cls = _user_classes(tss.active.StereoFTP)[which == "device"]
    jax_cls = _user_classes(jss.active.StereoFTP)[which == "device"]
    user = port_cls(scene["port_rig"], fringe, 16.0, stripeColor="green",
                    device="cpu")
    builtin = tss.active.StereoFTPAnaglyph(scene["port_rig"], fringe, 16.0,
                                           stripeColor="green", device="cpu")
    assert user._grayscale_plan() == which
    assert builtin._grayscale_plan() == "mode"
    c_user = user.getCloud(cam)
    _close(c_user, jax_cls(scene["rig"], fringe, 16.0,
                           stripeColor="green").getCloud(cam))
    s = np.s_[20:-20, 20:-20, 2]
    a, b = builtin.getCloud(cam)[s], c_user[s]
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.mean() > 0.9
    np.testing.assert_allclose(a[ok], b[ok], rtol=1e-3)
    np.testing.assert_array_equal(
        user.getCloudBatch(np.stack([cam]))[0], c_user)


@pytest.mark.parametrize("cls", ["StereoFTP", "StereoFTPAnaglyph",
                                 "StereoFTP_Mapping", "StereoFTP_PhaseOnly"])
def test_ftp_from_jax(scene, cls):
    j = getattr(jss.active, cls)(scene["rig"], scene["fringe"], 16.0,
                                 shift=2.0, stripeSensitivity=0.4)
    p = convert.ftp_from_jax(j, device="cpu")
    assert type(p) is getattr(tss.active, cls)
    direct = getattr(tss.active, cls)(scene["port_rig"], scene["fringe"],
                                      16.0, shift=2.0, stripeSensitivity=0.4,
                                      device="cpu")
    for name in ("fringe", "fringeDims", "fp", "stripeCentralPeak", "F",
                 "Rectify1", "Rectify2", "ep", "R_inv", "stripeColor",
                 "stripeSensitivity", "_fringe_row_inv"):
        np.testing.assert_array_equal(getattr(p, name), getattr(direct, name))

    class Custom(jss.active.StereoFTP):
        pass

    with pytest.raises(TypeError):
        convert.ftp_from_jax(Custom(scene["rig"], scene["fringe"], 16.0))


def test_scan_runs_without_jax_pil_matplotlib(tmp_path):
    """A Gray-code scan read from PNG files and an FTP cloud written to a
    PLY file, on the CPU, in a process where jax, PIL and matplotlib
    cannot be imported, as on the GPU machine."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "PIL", "matplotlib"):
            sys.modules[name] = None
        import numpy as np
        import simplestereo_tpu_torch as tss
        from simplestereo_tpu_torch.geometry import npgeom
        K = np.array([[140., 0, 63.5], [0, 140., 47.5], [0, 0, 1]])
        rig = tss.StereoRig((128, 96), (128, 96), K, K, None, None,
                            npgeom.rodrigues_to_matrix([0, -0.05, 0]),
                            [[-40.], [1.], [6.]], device="cpu")
        xs, ys = np.meshgrid(np.arange(128.), np.arange(96.))
        P = 500 * (np.stack([xs, ys, np.ones_like(xs)], -1)
                   @ np.linalg.inv(K).T)
        q = (P @ rig.R.T + rig.T.ravel()) @ K.T
        u, v = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
        ui, vi = np.round(u).astype(int), np.round(v).astype(int)
        lit = (ui >= 0) & (ui < 128) & (vi >= 0) & (vi < 96)
        n = tss.active.generateGrayCodeImgs({str(tmp_path)!r}, (128, 96))
        paths = []
        for i in range(n):
            pat = tss.imgio.imread({str(tmp_path)!r} + f"/{{i}}.png", True)
            cap = np.where(lit, pat[vi.clip(0, 95), ui.clip(0, 127)], 0)
            paths.append({str(tmp_path)!r} + f"/cap{{i}}.png")
            tss.imgio.imwrite(paths[-1], cap.astype(np.uint8))
        pts = tss.active.GrayCode(rig, device="cpu").getCloud(paths)
        assert len(pts) > 0.5 * 128 * 96
        assert abs(np.median(pts[:, 0, 2]) - 500) < 25
        fringe = tss.active.buildFringe(16, dims=(128, 96), stripeColor="r")
        q = (P * 520 / 500 @ rig.R.T + rig.T.ravel()) @ K.T
        cam = tss.warp.remap(fringe, q[..., 0] / q[..., 2],
                             q[..., 1] / q[..., 2]).numpy()
        cloud = tss.active.StereoFTP(rig, fringe, 16, device="cpu"
                                     ).getCloud(cam)
        tss.points.exportPLY(cloud, {str(tmp_path / "c.ply")!r})
        back = tss.points.importPLY({str(tmp_path / "c.ply")!r})
        assert abs(np.nanmedian(back[:, 2]) - 520) < 10
        for name in ("simplestereo_tpu", "jax", "PIL", "matplotlib"):
            assert sys.modules.get(name) is None, name
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
