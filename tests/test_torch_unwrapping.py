"""PyTorch port: phase unwrapping against the JAX package, on the CPU.

- ``wrap_to_pi`` is bit-equal to JAX's (both are fmod-based floor modulo),
  odd multiples of pi included.
- ``unwrap``/``unwrap2D``: equal where the corrections sum exactly in any
  order (at most one 2*pi jump a line, and steps of exactly +-pi, which
  ``jnp.unwrap`` leaves alone); on random phases within 1e-12 (float64)
  and 1e-5 rad (float32). JAX's cumulative sum adds in a tree and in the
  input's precision; the port adds float32 corrections in float64.
- ``infiniteImpulseResponse``: the S1 kernel's twin (the CPU path) against
  the JAX scans at 24x32, 1x40 and 40x1, tau in {0, 0.3, 1}, float64
  within 1e-12 and float32 within 1e-5 rad. The differences are XLA's:
  it contracts ``u + tau * W`` into one fused multiply-add, the twin
  rounds twice (at tau 0 and 1 both are exact and the maps are equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from simplestereo_tpu import unwrapping as junw
from simplestereo_tpu_torch import unwrapping as unw

DTYPES = {"float64": (np.float64, 1e-12), "float32": (np.float32, 1e-5)}


def _wrapped(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    phi = (np.cumsum(rng.normal(0, 0.8, shape), axis=-1)
           + np.cumsum(rng.normal(0, 0.8, shape[:-1] + (1,)), axis=0))
    return np.angle(np.exp(1j * phi)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wrap_to_pi_bit_equal(dtype):
    pi = dtype(np.pi)
    x = np.concatenate([
        np.array([0, pi, -pi, 3 * pi, -3 * pi, 2 * pi, -2 * pi, 1e-30,
                  -1e-30, 7.5, -7.5, 1e6, -1e6], dtype),
        np.linspace(-20, 20, 1001, dtype=dtype)])
    port = unw.wrap_to_pi(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(port, np.asarray(junw.wrap_to_pi(
        jnp.asarray(x))))
    assert port.dtype == dtype


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_unwrap_exact_cases(dtype):
    """Steps of exactly +-pi stay; at most one jump a line sums exactly."""
    pi = dtype(np.pi)
    rows = np.array([[0, pi, 0, -pi, 0, pi, 2 * pi, pi],
                     [0, 3.0, -3.0, 3.0, 2.0, 1.0, 0.5, 0.0],
                     [1.0, -pi, pi, -pi, pi, 0.5, 0.25, 0.0]], dtype)
    t = torch.as_tensor(rows)
    for axis in (0, 1, -1):
        np.testing.assert_array_equal(
            unw.unwrap(t, axis=axis).numpy(),
            np.asarray(jnp.unwrap(jnp.asarray(rows), axis=axis)))
    np.testing.assert_array_equal(unw.unwrap2D(t).numpy(),
                                  np.asarray(junw.unwrap2D(rows)))


@pytest.mark.parametrize("name", list(DTYPES))
def test_unwrap_random(name):
    dtype, tol = DTYPES[name]
    w = _wrapped((23, 41), 3, dtype)
    t = torch.as_tensor(w)
    for axis in (0, 1):
        np.testing.assert_allclose(unw.unwrap(t, axis=axis).numpy(),
                                   np.asarray(junw.unwrap(w, axis=axis)),
                                   rtol=0, atol=tol * 10)
    out = unw.unwrap2D(w, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == t.dtype
    np.testing.assert_allclose(out.numpy(), np.asarray(junw.unwrap2D(w)),
                               rtol=0, atol=tol * 10)


@pytest.mark.parametrize("tau", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("shape", [(24, 32), (1, 40), (40, 1)])
@pytest.mark.parametrize("name", list(DTYPES))
def test_iir_twin_matches_jax(name, shape, tau):
    dtype, tol = DTYPES[name]
    w = _wrapped(shape, 7, dtype)
    port = unw.infiniteImpulseResponse(w, tau, device="cpu")
    ref = np.asarray(junw.infiniteImpulseResponse(w, tau))
    assert port.dtype == ref.dtype == dtype and port.shape == shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)
    if tau in (0.0, 1.0):
        np.testing.assert_array_equal(port, ref)


def test_iir_tensor_stays_and_small_shapes():
    for shape in ((1, 1), (2, 5), (5, 2), (3, 3)):
        w = _wrapped(shape, 11, np.float64)
        t = torch.as_tensor(w)
        out = unw.infiniteImpulseResponse(t, 0.6)
        assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
        np.testing.assert_allclose(
            out.numpy(), np.asarray(junw.infiniteImpulseResponse(w, 0.6)),
            rtol=0, atol=1e-12)
    assert unw.launches == 0  # CPU tensors never launch the kernel


def test_iir_idempotent_and_ramp():
    """A pure function (the reference warns a second call may not work),
    and a noiseless ramp is recovered up to a constant."""
    w = _wrapped((10, 20), 0, np.float64)
    a = unw.infiniteImpulseResponse(w, 0.5, device="cpu")
    b = unw.infiniteImpulseResponse(w, 0.5, device="cpu")
    np.testing.assert_array_equal(a, b)
    xs, ys = np.meshgrid(np.arange(48), np.arange(24))
    phi = 0.25 * xs + 0.1 * ys
    out = unw.infiniteImpulseResponse(np.angle(np.exp(1j * phi)), 1.0,
                                      device="cpu")
    d = out - phi
    assert np.abs(d - d.mean()).max() < 1e-3


def test_iir_errors():
    with pytest.raises(ValueError, match="tau"):
        unw.infiniteImpulseResponse(np.zeros((4, 4)), -1.0, device="cpu")
    with pytest.raises(ValueError, match="dimensions"):
        unw.infiniteImpulseResponse(np.zeros(4), 0.5, device="cpu")
    with pytest.raises(ValueError, match="float32 or float64"):
        unw.infiniteImpulseResponse(torch.zeros(4, 4, dtype=torch.float16),
                                    0.5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            unw.infiniteImpulseResponse(np.zeros((4, 4)), 0.5)


@pytest.mark.parametrize("H,W,itemsize", [(720, 1280, 4), (720, 1280, 8),
                                          (1100, 64, 4), (1, 40, 8),
                                          (40, 1, 4)])
def test_plan(H, W, itemsize):
    """The kernel's launch plan: threads a multiple of 32 up to 1,024, and
    a ring wide enough that two rows sharing a slot are never live
    together (row y is live over steps [2y, 2y + W + 1])."""
    plan = unw._plan(H, W, itemsize)
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    assert plan["ring_rows"] == H  # a slot per row where that fits
    assert plan["smem"] == H * 3 * itemsize <= unw.SMEM_MAX
    need = min(H, W // 2 + 2)
    small = unw._plan(H, W, itemsize, ring_rows=need)
    assert small["smem"] == need * 3 * itemsize
    assert need == H or 2 * need > W + 1
    if need > 1:
        with pytest.raises(ValueError, match="live together"):
            unw._plan(H, W, itemsize, ring_rows=need - 1)
    big = unw._plan(30_000, 64, 8)  # too many rows for a slot each
    assert big["ring_rows"] == 34 and big["threads"] == 1024
    with pytest.raises(ValueError, match="shared memory"):
        unw._plan(20_000, 20_000, 8)


def _raster(phase, tau):
    """The recursion in the JAX scans' raster order, one numpy scalar at a
    time in the phase's precision, each operation rounded on its own."""
    dt = phase.dtype.type
    pi, two_pi, tau, zero = dt(np.pi), dt(2 * np.pi), dt(tau), dt(0)

    def C(u, p):
        r = np.fmod(p - u + pi, two_pi)
        return u + tau * ((r + two_pi if r < 0 else r) - pi)

    H, W = phase.shape
    fwd = [phase[0, 0]]
    for x in range(1, W):
        fwd.append((zero + C(fwd[-1], phase[0, x]) + zero + zero) / dt(1))
    up, carry = list(fwd), None
    for x in range(W - 1, 0, -1):
        right = x < W - 1
        total = (zero + C(fwd[x - 1], phase[0, x]) + C(fwd[x], phase[0, x])
                 + (C(carry, phase[0, x]) if right else zero))
        carry = total / dt(3 if right else 2)
        up[x] = carry
    out = np.empty_like(phase)
    for y in range(H):
        for x in range(W):
            p = phase[y, x]
            total = zero + (C(out[y, x - 1], p) if x else zero)
            total = total + C(up[x], p)
            total = total + (C(up[x + 1], p) if x < W - 1 else zero)
            out[y, x] = total / dt(1 + (x > 0) + (x < W - 1))
        up = out[y]
    return out


@pytest.mark.parametrize("shape", [(7, 9), (9, 2), (1, 6), (6, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_wavefront_equals_raster_order(dtype, shape):
    """The twin's wavefront (all pixels with x + 2y = t at step t) gives
    bit for bit what the raster order of the JAX scans gives when every
    operation is rounded on its own, as on the card."""
    w = _wrapped(shape, 5, dtype)
    np.testing.assert_array_equal(
        unw.infiniteImpulseResponse(w, 0.3, device="cpu"), _raster(w, 0.3))
