"""PyTorch port: the median post-filter against the JAX package, on the
CPU.

The window count is odd, so the median is one of the window's values:
the port's maps are exactly equal to JAX's (``np.array_equal``, dtype
included) for int16 and float32, single maps and stacks, windows 1, 3 and
5, with NaN (which propagates in both) and with the matchers' invalid
markers (-1, and (min_disp - 1) * 16 of SGM's fixed point).
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu.passive import median_disparity as jmedian
from simplestereo_tpu_torch.passive import median_disparity


def _map(rng, shape, dtype):
    if dtype == np.int16:
        d = rng.integers(0, 64 * 16, shape).astype(np.int16)
        d[rng.random(shape) < 0.1] = -1
        d[rng.random(shape) < 0.05] = (-3 - 1) * 16
        return d
    d = rng.normal(10, 4, shape).astype(np.float32)
    d[rng.random(shape) < 0.05] = -1.0
    return d


def _same(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("size", [1, 3, 5])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
@pytest.mark.parametrize("shape", [(13, 17), (3, 9, 11), (1, 6), (4, 1)])
def test_median_equal_to_jax(shape, dtype, size):
    d = _map(np.random.default_rng(size), shape, dtype)
    _same(median_disparity(d, size, device="cpu"), jmedian(d, size))


def test_median_nan_propagates_like_jax():
    d = _map(np.random.default_rng(7), (2, 12, 15), np.float32)
    d[0, 5, 5] = np.nan
    d[1, 0, :3] = np.nan
    got = median_disparity(d, 3, device="cpu")
    _same(got, jmedian(d, 3))
    assert np.isnan(got[0, 4:7, 4:7]).all()


def test_median_removes_isolated_markers():
    d = np.full((9, 9), 80, np.int16)
    d[4, 4] = -1
    d[0, 0] = -64
    out = median_disparity(torch.tensor(d), 3)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int16
    assert (out.numpy() == 80).all()


def test_median_validates_like_jax():
    d = np.zeros((4, 5), np.float32)
    for bad in (0, 2, -1):
        with pytest.raises(ValueError):
            median_disparity(d, bad, device="cpu")
        with pytest.raises(ValueError):
            jmedian(d, bad)
    with pytest.raises(ValueError):
        median_disparity(np.zeros((2, 3, 4, 5)), 3, device="cpu")
    with pytest.raises(ValueError):
        median_disparity(np.zeros(5), 3, device="cpu")


def test_median_numpy_input_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError):
        median_disparity(np.zeros((4, 5), np.float32))
