"""PyTorch port: geometry (npgeom copy, distortion, rotations, projection)
against the JAX package on the same seeded inputs.

Tolerances: the npgeom copy is numpy on both sides, so equal exactly.
The torch functions against the (eager) JAX ones: float32 within rtol
1e-6, atol 1e-7 (a few ulps: sin, cos and sums of three run in other
libraries); float64 within 1e-12. Pixel-domain outputs (``*_points``,
``perspective_transform``) are held to the same rtol against the scale of
the output, max |value|: a float32 step such as (u - cx) / f cancels, so
an ulp upstream is an absolute error of about 1e-4 px on any pixel, and a
pixel near 0 would fail any per-element relative bound.
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu.geometry import distortion as jdist
from simplestereo_tpu.geometry import npgeom as jnpgeom
from simplestereo_tpu.geometry import projection as jproj
from simplestereo_tpu.geometry import rotations as jrot
from simplestereo_tpu_torch import geometry as tgeom
from simplestereo_tpu_torch.geometry import npgeom as tnpgeom

LENGTHS = [0, 4, 5, 8, 12, 14]
DTYPES = [np.float32, np.float64]
TOL = {np.float32: dict(rtol=1e-6, atol=1e-7),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


def _coeffs(n, seed=0):
    """n distortion coefficients of plausible size; tilt included at 14."""
    if n == 0:
        return None
    rng = np.random.default_rng(seed + n)
    scale = np.array([0.05, 0.02, 0.002, 0.002, 0.01, 0.01, 0.005, 0.005,
                      0.002, 0.002, 0.002, 0.002, 0.01, 0.01])[:n]
    return rng.normal(0, 1, n) * scale


def _K(seed=1):
    rng = np.random.default_rng(seed)
    f = rng.uniform(700, 1500)
    return np.array([[f, rng.uniform(-2, 2), rng.uniform(600, 680)],
                     [0, f * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                     [0, 0, 1.0]])


def _rot(seed=2):
    return jnpgeom.rodrigues_to_matrix(
        np.random.default_rng(seed).normal(0, 0.1, 3))


def _close(got, want, dtype, scaled=False):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype == dtype
    tol = dict(TOL[dtype])
    if scaled:
        tol["atol"] = max(tol["atol"], tol["rtol"] * np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)


# -- npgeom: a copy, exactly equal -----------------------------------------

@pytest.mark.parametrize("n", LENGTHS)
def test_npgeom_copy_equal(n):
    rng = np.random.default_rng(3)
    d = _coeffs(n)
    K = _K()
    norm = rng.uniform(-0.5, 0.5, (50, 2))
    pix = rng.uniform(0, 1280, (50, 2))
    X = rng.uniform(-1, 1, (50, 3)) * [300, 300, 200] + [0, 0, 1500]
    rvec = rng.normal(0, 0.1, 3)
    pairs = [
        (lambda m: m.pad_dist_coeffs(d)),
        (lambda m: m.distort_normalized(norm, d)),
        (lambda m: m.undistort_normalized(norm, d)),
        (lambda m: m.undistort_points(pix, K, d, R=_rot(), P=K)),
        (lambda m: m.distort_points(pix, K, d, P=K)),
        (lambda m: m.project_points(X, rvec, [10, -5, 3], K, d)),
        (lambda m: m.perspective_transform(pix, _rot())),
        (lambda m: m.rodrigues_to_matrix(rvec)),
        (lambda m: m.matrix_to_rodrigues(_rot())),
    ]
    for f in pairs:
        np.testing.assert_array_equal(f(tnpgeom), f(jnpgeom))


def test_npgeom_copy_special_angles():
    for r in (np.zeros(3), np.array([1e-14, 0, 0]),
              np.array([np.pi, 0, 0]), np.array([0, 0, np.pi - 1e-9])):
        R = jnpgeom.rodrigues_to_matrix(r)
        np.testing.assert_array_equal(tnpgeom.rodrigues_to_matrix(r), R)
        np.testing.assert_array_equal(tnpgeom.matrix_to_rodrigues(R),
                                      jnpgeom.matrix_to_rodrigues(R))


# -- distortion ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_distort_normalized(n, dtype):
    pts = np.random.default_rng(4).uniform(-0.6, 0.6, (7, 9, 2)).astype(dtype)
    d = _coeffs(n)
    _close(tgeom.distort_normalized(torch.tensor(pts), d),
           jdist.distort_normalized(pts, d), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_undistort_normalized(n, dtype):
    pts = np.random.default_rng(5).uniform(-0.6, 0.6, (64, 2)).astype(dtype)
    d = _coeffs(n)
    _close(tgeom.undistort_normalized(torch.tensor(pts), d),
           jdist.undistort_normalized(pts, d), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_undistort_points(n, dtype):
    rng = np.random.default_rng(6)
    pix = rng.uniform(0, 1280, (40, 2)).astype(dtype)
    d = _coeffs(n)
    K = _K()
    P = np.hstack([_K(7), np.zeros((3, 1))])
    for kw in (dict(), dict(R=_rot()), dict(R=_rot(), P=P), dict(P=K)):
        _close(tgeom.undistort_points(torch.tensor(pix), K, d, **kw),
               jdist.undistort_points(pix, K, d, **kw), dtype,
               scaled="P" in kw)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", LENGTHS)
def test_distort_points(n, dtype):
    pix = np.random.default_rng(8).uniform(0, 1280, (40, 2)).astype(dtype)
    d = _coeffs(n)
    K = _K()
    for kw in (dict(), dict(P=_K(9))):
        _close(tgeom.distort_points(torch.tensor(pix), K, d, **kw),
               jdist.distort_points(pix, K, d, **kw), dtype, scaled=True)


def test_pad_dist_coeffs():
    from simplestereo_tpu_torch.geometry.distortion import pad_dist_coeffs
    assert torch.equal(pad_dist_coeffs(None), torch.zeros(14))
    p = pad_dist_coeffs([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    assert p.dtype == torch.float64 and p.shape == (14,)
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jdist.pad_dist_coeffs([1.0, 2.0, 3.0, 4.0],
                                                    dtype=np.float64)))
    with pytest.raises(ValueError):
        pad_dist_coeffs(np.zeros(15))


# -- rotations and projection -------------------------------------------------

RVECS = [np.array([0.1, -0.2, 0.05]), np.array([1e-9, 0, 0]), np.zeros(3),
         np.array([0, 3.0, 0.5]), np.array([np.pi - 1e-6, 0, 0])]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("i", range(len(RVECS)))
def test_rodrigues_both_ways(i, dtype):
    """The matrix is held to JAX's against its scale, max |R|: an entry
    made by cancelling O(1) terms (r = (0, 3, 0.5)) is off by an ulp of
    1.0 in either package, which no per-element rtol of 1e-6 holds on an
    entry of 0.1. The float64 matrix of the same vector keeps it sharp:
    the port's float32 matrix lies within 2 float32 ulps of 1.0 of it."""
    r = RVECS[i].astype(dtype)
    R = np.asarray(jrot.rodrigues_to_matrix(r))
    got = tgeom.rodrigues_to_matrix(torch.tensor(r))
    _close(got, R, dtype, scaled=True)
    exact = jnpgeom.rodrigues_to_matrix(r.astype(np.float64))
    ulps = 2 * np.finfo(dtype).eps
    assert np.abs(got.numpy().astype(np.float64) - exact).max() <= ulps
    Rn = jnpgeom.rodrigues_to_matrix(RVECS[i]).astype(dtype)
    _close(tgeom.matrix_to_rodrigues(torch.tensor(Rn)),
           jrot.matrix_to_rodrigues(Rn), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_homogeneous_and_cross(dtype):
    rng = np.random.default_rng(10)
    p = rng.normal(0, 1, (6, 3)).astype(dtype)
    _close(tgeom.to_homogeneous(torch.tensor(p)), jproj.to_homogeneous(p),
           dtype)
    _close(tgeom.from_homogeneous(torch.tensor(p)),
           jproj.from_homogeneous(p), dtype)
    v = rng.normal(0, 1, 3).astype(dtype)
    _close(tgeom.cross_product_matrix(torch.tensor(v)),
           jproj.cross_product_matrix(v), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 3])
def test_perspective_transform(n, dtype):
    rng = np.random.default_rng(11)
    p = rng.uniform(-100, 100, (5, 4, n)).astype(dtype)
    M = np.eye(n + 1) + rng.normal(0, 0.01, (n + 1, n + 1))
    _close(tgeom.perspective_transform(torch.tensor(p), M),
           jproj.perspective_transform(p, M), dtype, scaled=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [0, 5, 14])
def test_project_points(n, dtype):
    rng = np.random.default_rng(12)
    X = (rng.uniform(-1, 1, (30, 3)) * [300, 300, 200]
         + [0, 0, 1500]).astype(dtype)
    rvec = rng.normal(0, 0.1, 3)
    d = _coeffs(n)
    K = _K()
    for r in (rvec, jnpgeom.rodrigues_to_matrix(rvec)):
        _close(tgeom.project_points(torch.tensor(X), r, [10.0, -5.0, 3.0], K,
                                    d),
               jproj.project_points(X, r, [10.0, -5.0, 3.0], K, d), dtype,
               scaled=True)
