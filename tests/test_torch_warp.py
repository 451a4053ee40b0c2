"""PyTorch port: warp (remap, row-invariant remap, rectification maps,
undistortion, optimal camera matrix, map_coordinates) against the JAX
package on the same seeded inputs.

Tolerances: float remaps within atol 1e-4 on a 0-255 scale (the JAX
remap is one fused XLA program, which contracts products and sums into
FMAs; the port rounds each step); integer remaps equal but for pixels at
most 1 apart, at most 0.1% of them (a float32 ulp can move a value across
a rounding boundary); "nearest" equal; the row-invariant remap within
rtol 1e-6; maps within 1e-3 px; get_optimal_new_camera_matrix, a numpy
copy, equal.
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu import warp as jwarp
from simplestereo_tpu.geometry.npgeom import rodrigues_to_matrix
from simplestereo_tpu_torch import warp as twarp

MODES = ["nearest", "linear", "cubic"]
MAP_TOL = 1e-3


def _image(shape, dtype, seed=20):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 256, shape).astype(dtype)
    return (rng.random(shape) * 255).astype(dtype)


def _maps(h, w, ho=23, wo=31, seed=21):
    """Source coordinates reaching up to 3 pixels outside the image."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-3, w + 3, (ho, wo)).astype(np.float32),
            rng.uniform(-3, h + 3, (ho, wo)).astype(np.float32))


def _assert_uint8_close(got, want):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_remap_float(mode, chan):
    shape = (19, 27, 3) if chan else (19, 27)
    img = _image(shape, np.float32)
    mx, my = _maps(19, 27)
    want = np.asarray(jwarp.remap(img, mx, my, interpolation=mode))
    got = twarp.remap(torch.tensor(img), torch.tensor(mx), torch.tensor(my),
                      interpolation=mode).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("chan", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_remap_uint8(mode, chan):
    shape = (40, 56, 3) if chan else (40, 56)
    img = _image(shape, np.uint8)
    mx, my = _maps(40, 56, 48, 64)
    want = np.asarray(jwarp.remap(img, mx, my, interpolation=mode))
    got = twarp.remap(torch.tensor(img), mx, my, interpolation=mode).numpy()
    assert got.dtype == want.dtype == np.uint8
    if mode == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_uint8_close(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_remap_border_value_and_int16(mode):
    img = (_image((15, 22), np.float32) * 100 - 12000).astype(np.int16)
    mx, my = _maps(15, 22)
    want = np.asarray(jwarp.remap(img, mx, my, interpolation=mode,
                                  border_value=-500.0))
    got = twarp.remap(torch.tensor(img), mx, my, interpolation=mode,
                      border_value=-500.0).numpy()
    assert got.dtype == want.dtype == np.int16
    assert np.abs(got.astype(np.int64) - want).max() <= 1
    assert (got != want).mean() <= 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_remap_row_invariant(mode):
    row = _image((1, 33), np.float32)[0]
    img = np.tile(row, (17, 1))
    mx, my = _maps(17, 33)
    want = np.asarray(jwarp.remap_row_invariant(img, mx, my,
                                                interpolation=mode,
                                                border_value=7.0))
    got = twarp.remap_row_invariant(torch.tensor(img), mx, my,
                                    interpolation=mode,
                                    border_value=7.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    full = twarp.remap(torch.tensor(img), mx, my, interpolation=mode,
                       border_value=7.0).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-4)


def test_remap_rejects():
    img = torch.zeros((4, 5))
    with pytest.raises(ValueError):
        twarp.remap(img, np.zeros((2, 2)), np.zeros((2, 2)),
                    interpolation="lanczos")
    with pytest.raises(ValueError):
        twarp.remap_row_invariant(torch.zeros((4, 5, 3)), np.zeros((2, 2)),
                                  np.zeros((2, 2)))


def _rig_params(seed, scale=0.25):
    """One camera of a random 1280x720 rig (as tests/test_rectification.py
    draws them), intrinsics scaled by ``scale``."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(700, 1500)
    K = np.array([[f, 0, rng.uniform(600, 680)],
                  [0, f * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                  [0, 0, 1.0]])
    K[:2] *= scale
    d = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    R = rodrigues_to_matrix(rng.normal(0, 0.06, 3))
    size = (int(1280 * scale), int(720 * scale))
    return K, d, R, size


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_r", [False, True])
def test_init_undistort_rectify_map(seed, with_r):
    K, d, R, size = _rig_params(seed)
    newK = K.copy()
    newK[0, 1] = 0.3  # a shear term, as a rectified K carries
    R = R if with_r else None
    wx, wy = (np.asarray(m) for m in jwarp.init_undistort_rectify_map(
        K, d, R, newK, size))
    tx, ty = twarp.init_undistort_rectify_map(K, d, R, newK, size,
                                              device="cpu")
    assert tx.dtype == torch.float32 and tx.shape == (size[1], size[0])
    np.testing.assert_allclose(tx.numpy(), wx, rtol=0, atol=MAP_TOL)
    np.testing.assert_allclose(ty.numpy(), wy, rtol=0, atol=MAP_TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_undistort_image(seed):
    K, d, _, size = _rig_params(seed, scale=0.1)
    img = _image((size[1], size[0], 3), np.uint8, seed)
    newK, _ = jwarp.get_optimal_new_camera_matrix(K, d, size, 0.5)
    for nk in (None, newK):
        want = np.asarray(jwarp.undistort_image(img, K, d, nk))
        got = twarp.undistort_image(torch.tensor(img), K, d, nk).numpy()
        _assert_uint8_close(got, want)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("center", [False, True])
def test_get_optimal_new_camera_matrix(alpha, center):
    K, d, _, size = _rig_params(5, scale=1.0)
    want = jwarp.get_optimal_new_camera_matrix(K, d, size, alpha, (640, 360),
                                               center)
    got = twarp.get_optimal_new_camera_matrix(K, d, size, alpha, (640, 360),
                                              center)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("order", [0, 1, 3])
def test_map_coordinates(order):
    img = _image((21, 30), np.float32)
    rng = np.random.default_rng(22)
    coords = np.stack([rng.uniform(-2, 23, 50),
                       rng.uniform(-2, 32, 50)]).astype(np.float32)
    want = np.asarray(jwarp.map_coordinates(img, coords, order=order))
    got = twarp.map_coordinates(torch.tensor(img), torch.tensor(coords),
                                order=order).numpy()
    assert got.shape == (50,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
