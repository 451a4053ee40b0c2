"""PyTorch port: bgr_to_lab against the JAX package's.

The cube root is torch.pow(t, 1/3) in the port and jnp.cbrt in JAX; they
differ by a few float32 ulps, which Lab's scale (L up to 100, a/b up to
~100) turns into at most a few 1e-5 absolute: atol 1e-4.
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu.passive.lab import bgr_to_lab as jax_bgr_to_lab
from simplestereo_tpu_torch.passive.lab import bgr_to_lab

ATOL = 1e-4


def _colours(seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 256, (4096, 3), np.uint8)
    # Branch edges of both piecewise functions: 10/11 straddle the sRGB
    # 0.04045 knee; 0 and 255 are the range ends (the Lab knee at
    # t = 0.008856 lies between 0 and the dark greys).
    levels = np.array([0, 1, 2, 10, 11, 20, 128, 254, 255], np.uint8)
    edges = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                     -1).reshape(-1, 3)
    return np.concatenate([rand, edges])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_bgr_to_lab_matches_jax(dtype):
    img = _colours(0).astype(dtype).reshape(-1, 1, 3)
    want = np.asarray(jax_bgr_to_lab(img))
    got = bgr_to_lab(torch.tensor(img))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_bgr_to_lab_batched_shape_and_device():
    imgs = _colours(1)[:24].reshape(2, 3, 4, 3)
    got = bgr_to_lab(torch.tensor(imgs))
    assert tuple(got.shape) == (2, 3, 4, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bgr_to_lab(imgs)),
                               rtol=0, atol=ATOL)
