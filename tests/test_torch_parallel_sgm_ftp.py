"""PyTorch port: row-tiled SGM and GSW, the row-sharded FTP cloud and the
Gauss-Newton calibration on a mesh, on torch.distributed, on the CPU.

The JAX functions run on the conftest's 8-device virtual mesh; the port
runs in one world of 8 gloo processes spawned for the module
(``parallel.dryrun.spawn``, 240 s at most), a mesh of 2 or 4 on its first
ranks, on the same numpy inputs made from a seed. JAX's tiled programs
take 40-100 s each to compile here, so the JAX side is its tiled SGM on
8 devices once and otherwise its single-device functions, which its own
tests (tests/test_parallel_sgm_ftp.py) hold equal to its tiled ones (SGM
and GSW bit for bit, FTP at the gate below).

Gates:
- tiled SGM (rows 2, 4, 8; BT and census; min_disp -4 with the LR check;
  4 paths): ``np.array_equal`` to JAX's ``tiled_sgm_disparity`` (rows 8,
  BT) or JAX's single-device ``_sgm_disparity`` (the others), and to the
  port's own single-card matcher;
- tiled GSW (consistent or not; normalize): bit-equal to the port's own
  single-card matcher, as JAX's is to its own, and against JAX's map at
  tests/test_torch_gsw.py's rule: at most 1% of pixels differ, each a
  near-tie (relative gap <= 1e-5) in the twin's cost volume;
- sharded FTP (plain, anaglyph "br", a ROI): JAX's own sharded-vs-single
  gate against the JAX package's ``getCloud`` (>= 90% finite in both, max
  |dz| < 1e-2, the plane's median within 2% of z0), and equal to the
  port's single-card cloud (the y-unwrap sums its corrections in float64,
  so the distributed prefix sum is exact);
- the Gauss-Newton on meshes of 2, 4 and 8 ranks: against JAX's result
  on 8 devices at tests/test_torch_calibration.py's one-card gates
  (|rms| 5e-6, K 1e-3 px, dist 1e-3, rotations 5e-6 rad, translations
  2e-3);
- rows that do not divide the mesh raise ValueError; the fringe-order
  variants that have no sharded form raise TypeError.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from simplestereo_tpu import parallel as jparallel
from simplestereo_tpu import warp as jwarp
from simplestereo_tpu.active import (StereoFTPAnaglyph as JAnaglyph,
                                     buildAnaglyphFringe, buildFringe)
from simplestereo_tpu.active import StereoFTP as JFTP
from simplestereo_tpu.calibration import ba as jba
from simplestereo_tpu.calibration.sharded import \
    calibrate_camera_sharded as jax_gn
from simplestereo_tpu.passive.gsw import gsw_disparity as jax_gsw
from simplestereo_tpu.passive.sgm import _sgm_disparity as _jax_sgm
from simplestereo_tpu_torch import convert
from simplestereo_tpu_torch import active as tactive
from simplestereo_tpu_torch.parallel import dryrun
from simplestereo_tpu_torch.passive.gsw import gsw_disparity, _gsw_cost
from simplestereo_tpu_torch.passive.sgm import _sgm_disparity
from tests.test_active import _make_rig, _proj_coords_for_plane
from tests.test_torch_gsw import _assert_flips_are_ties


def _pair(seed, h=32, w=48, shift=3):
    img1 = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, -shift, axis=1)


SGM_DEFAULTS = dict(min_disp=0, num_disp=8, block_size=3, P1=72, P2=288,
                    paths=8, prefilter_cap=63.0, uniqueness=10.0,
                    disp12_max_diff=-1, subpixel=True, cost_method="bt",
                    census_window=5)
# name: (ranks, image pair, options)
SGM = {
    "bt2": (2, _pair(1), {}),
    "bt4": (4, _pair(1), {}),
    "bt8": (8, _pair(1), {}),
    "census8": (8, _pair(2, h=40), dict(cost_method="census", P1=120,
                                         P2=480)),
    "negmin4": (4, _pair(3), dict(min_disp=-4, num_disp=12,
                                  disp12_max_diff=1, subpixel=False)),
    "paths4": (8, _pair(4), dict(paths=4)),
}
GSW_KW = dict(gamma=10.0, f_max=60.0)
GSW = {
    "sd": (_pair(5, h=40, w=40), dict(win_size=7, max_disp=5,
                                     consistent=False)),
    "consistent": (_pair(5, h=40, w=40), dict(win_size=7, max_disp=5,
                                             consistent=True)),
    "normalize": (_pair(6, h=24, w=40), dict(win_size=5, max_disp=4,
                                            consistent=True,
                                            normalize=True)),
}
Z0 = 520.0
FTP_ROI = (8, 8, 112, 80)  # 80 rows over 8 ranks


def _ftp_scene(anaglyph):
    rig = _make_rig()
    fringe = (buildAnaglyphFringe(16.0, dims=tuple(rig.res2)) if anaglyph
              else buildFringe(16.0, dims=tuple(rig.res2),
                               stripeColor="red"))
    mapu, mapv, _ = _proj_coords_for_plane(rig, Z0)
    cam = np.asarray(jwarp.remap(
        jnp.asarray(fringe), jnp.asarray(mapu, jnp.float32),
        jnp.asarray(mapv, jnp.float32), interpolation="linear"))
    port_rig = convert.rig_from_jax(rig, device="cpu")
    if anaglyph:
        return (JAnaglyph(rig, fringe, 16.0, stripeColor="green"),
                tactive.StereoFTPAnaglyph(port_rig, fringe, 16.0,
                                          stripeColor="green",
                                          device="cpu"), cam)
    return (JFTP(rig, fringe, 16.0),
            tactive.StereoFTP(port_rig, fringe, 16.0, device="cpu"), cam)


FTP = {"plain": (False, None), "anaglyph": (True, None),
       "roi": (False, FTP_ROI)}


def _gn_views():
    """tests/test_torch_calibration.py's 16 views and start values."""
    rng = np.random.default_rng(1)
    K = np.array([[800., 0, 640], [0, 790, 360], [0, 0, 1]])
    dist = np.array([-0.12, 0.03, 0.001, -0.0005, 0.01])
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30., yy.ravel() * 30., np.zeros(42)], 1)
    rng = np.random.default_rng(11)
    imgs = []
    for _ in range(16):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-90, 30), rng.normal(-75, 30),
                         rng.normal(600, 100)])
        pts = jba.project_points(obj, rvec, tvec, K[0, 0], K[1, 1],
                                 K[0, 2], K[1, 2], dist)
        imgs.append(pts + rng.normal(0, 0.1, pts.shape))
    Hs = [jba._homography_dlt(obj[:, :2], i) for i in imgs[:6]]
    fx, fy, cx, cy = jba._zhang_intrinsics(Hs, (1280, 720))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    return (np.tile(obj[None], (16, 1, 1)), np.stack(imgs), K0,
            np.zeros(5))


GN = _gn_views()


def _jobs(scenes):
    """{name: job} of every case; a mesh of n ranks takes ranks 0..n-1."""
    jobs = {}
    for name, (n, pair, kw) in SGM.items():
        jobs[f"sgm_{name}"] = dict(
            fn="parallel.tiled_sgm_disparity", mesh={"rows": n},
            devices=range(n), args=pair, kwargs={**SGM_DEFAULTS, **kw})
    for n in (2, 4, 8):
        jobs[f"gn{n}"] = dict(
            fn="calibration.sharded.calibrate_camera_sharded",
            mesh={"views": n}, devices=range(n), args=GN,
            kwargs=dict(iterations=25))
    for name, (pair, kw) in GSW.items():
        jobs[f"gsw_{name}"] = dict(
            fn="parallel.tiled_gsw_disparity", mesh={"rows": 8},
            args=pair, kwargs={**GSW_KW, **kw})
    for name, (anaglyph, roi) in FTP.items():
        jobs[f"ftp_{name}"] = dict(
            fn="parallel.sharded_ftp_cloud", mesh={"rows": 8},
            args=(scenes[anaglyph][1], scenes[anaglyph][2]),
            kwargs=dict(roi=roi))
    jobs.update(
        bad_sgm_rows=dict(fn="parallel.tiled_sgm_disparity",
                          mesh={"rows": 8}, args=_pair(7, h=30)),
        bad_gsw_rows=dict(fn="parallel.tiled_gsw_disparity",
                          mesh={"rows": 8}, args=_pair(7, h=30)),
        bad_ftp_rows=dict(fn="parallel.sharded_ftp_cloud",
                          mesh={"rows": 8},
                          args=(scenes[False][1], scenes[False][2]),
                          kwargs=dict(roi=(0, 0, 128, 90))))
    return jobs


@pytest.fixture(scope="module")
def scenes():
    return {False: _ftp_scene(False), True: _ftp_scene(True)}


@pytest.fixture(scope="module")
def results(scenes):
    jobs = _jobs(scenes)
    return dict(zip(jobs, dryrun.spawn(list(jobs.values()), 8,
                                       timeout=240)))


def _ok(res):
    assert res[0] == "ok", res[1:]
    return res[1]


def _jmesh(n, axis="rows"):
    return jparallel.make_mesh({axis: n}, devices=jax.devices()[:n])


@pytest.mark.parametrize("name", sorted(SGM))
def test_tiled_sgm_equals_jax_and_single(results, name):
    n, (img1, img2), kw = SGM[name]
    kw = {**SGM_DEFAULTS, **kw}
    tiled = _ok(results[f"sgm_{name}"])
    if name == "bt8":
        want = jparallel.tiled_sgm_disparity(img1, img2, _jmesh(n), **kw)
    else:
        want = _jax_sgm(jnp.asarray(img1), jnp.asarray(img2),
                        aggregator="scan", **kw)
    np.testing.assert_array_equal(tiled, np.asarray(want))
    single = _sgm_disparity(torch.tensor(img1), torch.tensor(img2), **kw)
    np.testing.assert_array_equal(tiled, single.numpy())


@pytest.mark.parametrize("name", sorted(GSW))
def test_tiled_gsw_equals_single_and_matches_jax(results, name):
    (img1, img2), kw = GSW[name]
    kw = {**GSW_KW, **kw}
    tiled = _ok(results[f"gsw_{name}"])
    single = gsw_disparity(torch.tensor(img1), torch.tensor(img2),
                           iterations=1, **kw)
    np.testing.assert_array_equal(tiled, single.numpy())
    want = np.asarray(jax_gsw(img1, img2, iterations=1, **kw))
    cost = _gsw_cost(torch.tensor(img1), torch.tensor(img2), min_disp=0,
                     **{k: v for k, v in kw.items() if k != "consistent"})
    _assert_flips_are_ties(tiled, want, cost.numpy(), 0)


@pytest.mark.parametrize("name", sorted(FTP))
def test_sharded_ftp_matches_jax_and_single(results, scenes, name):
    anaglyph, roi = FTP[name]
    jftp, tftp, cam = scenes[anaglyph]
    cloud = _ok(results[f"ftp_{name}"])
    np.testing.assert_array_equal(cloud, tftp.getCloud(cam, roi=roi))
    want = jftp.getCloud(cam, roi=roi)
    assert cloud.shape == want.shape and cloud.dtype == np.float64
    both = np.isfinite(cloud[..., 2]) & np.isfinite(want[..., 2])
    assert both.mean() > 0.9
    assert np.abs(cloud[..., 2] - want[..., 2])[both].max() < 1e-2
    center = cloud[20:-20, 20:-20, 2]
    center = center[np.isfinite(center)]
    assert abs(np.median(center) - Z0) < 0.02 * Z0


@pytest.fixture(scope="module")
def jax_gn_result():
    return jax_gn(*GN, _jmesh(8, "views"), axis="views", iterations=25)


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_mesh_gauss_newton_matches_jax(results, jax_gn_result, ranks):
    rms, K, d, poses = _ok(results[f"gn{ranks}"])
    j_rms, j_K, j_d, j_poses = jax_gn_result
    assert abs(rms - j_rms) <= 5e-6
    assert np.abs(K - j_K).max() <= 1e-3
    assert np.abs(d - j_d).max() <= 1e-3
    assert poses.shape == (16, 6)
    assert np.abs(poses[:, :3] - j_poses[:, :3]).max() <= 5e-6
    assert np.abs(poses[:, 3:] - j_poses[:, 3:]).max() <= 2e-3


@pytest.mark.parametrize("job", ["bad_sgm_rows", "bad_gsw_rows",
                                 "bad_ftp_rows"])
def test_indivisible_rows_raise(results, job):
    res = results[job]
    assert res[:2] == ("error", "ValueError"), res[:3]
    assert "not divisible" in res[2]


@pytest.mark.parametrize("cls", ["StereoFTP_PhaseOnly", "StereoFTP_Mapping"])
def test_ftp_variants_without_a_sharded_form_raise(scenes, cls):
    from simplestereo_tpu_torch.parallel import sharded_ftp_cloud
    _, tftp, cam = scenes[False]
    ftp = getattr(tactive, cls)(tftp.stereoRig, buildFringe(
        16.0, dims=(128, 96), stripeColor="red"), 16.0, device="cpu")
    with pytest.raises(TypeError):
        sharded_ftp_cloud(ftp, cam, mesh=None)
