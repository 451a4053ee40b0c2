"""
rotate
======

Kernel K4, the port of the dynamic-rotate hardware probe
(``benchmarks/probe_dynamic_rotate.py``): roll each plane of a volume
along its last axis by an amount read at run time.

- :func:`roll_planes` is the wrapper of the hand-written CUDA kernel
  (``csrc/rotate_kernel.cu``). A CUDA tensor launches the kernel and adds
  one to :data:`launches`; a CPU tensor runs the plain twin
  :func:`_roll_planes_plain` (a stack of ``torch.roll``); any other device
  raises.
- :func:`probe` is the probe itself: the (17, 8, 384) block rolled with
  each of the TPU probe's three amount forms, each compared with
  ``np.roll(x[d], -d, axis=1)``. On the card all three must be exact.
- :func:`right_map` is what the probe guards: the right-reference argmin
  map of an ASW cost volume, cost_R(x, d) = cost(x + d, d), computed by
  rolling each plane with K4. It equals the ASW select kernel's ``dispR``
  bit for bit.
"""

import numpy as np
import torch

from .. import _build
from .._device import resolve_device

# Kernel launches made by roll_planes (CPU calls of the twin do not
# count): lets a caller prove that a run went through the kernel.
launches = 0

# (D, TH, W) of the TPU probe: W spans three 128-lane tiles.
PROBE_SHAPE = (17, 8, 384)
MODES = ("pos", "neg", "rem")


def _check(x, shifts):
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (N, R, W) volume, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    s = torch.as_tensor(shifts, dtype=torch.int32).reshape(-1)
    if s.numel() != x.shape[0]:
        raise ValueError(f"{s.numel()} shifts for {x.shape[0]} planes")
    return s


def _roll_planes_plain(x, shifts):
    """Plain twin of :func:`roll_planes`: one ``torch.roll`` per plane."""
    return torch.stack([torch.roll(x[n], s, dims=-1)
                        for n, s in enumerate(shifts.tolist())])


def roll_planes(x, shifts):
    """out[n] = torch.roll(x[n], shifts[n], dims=-1) for an (N, R, W)
    float32 volume and N int32 amounts (any sign and size: the result is
    x[n, r, (c - s) mod W] with the remainder in [0, W)).

    A CUDA tensor launches the kernel; a CPU tensor runs the twin; any
    other device raises.
    """
    global launches
    s = _check(x, shifts)
    if x.device.type == "cpu":
        return _roll_planes_plain(x, s)
    if x.device.type != "cuda":
        raise ValueError(f"no roll kernel for device {x.device}")

    N, R, W = x.shape
    s = s.to(x.device).contiguous()
    out = torch.empty_like(x)
    lib = _build.load_library("rotate_kernel")
    err = lib.rotate_planes(x.data_ptr(), s.data_ptr(), out.data_ptr(), N, R,
                            W, x.device.index,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError("roll kernel launch failed: "
                           + lib.rotate_error_string(err).decode())
    launches += 1
    return out


def probe_amounts(mode, D, W):
    """The TPU probe's amount for plane d in each form: W - d ("pos", the
    ASW kernel's), -d ("neg", the form that broke on the TPU) and
    rem(W - d, W) ("rem", C remainder as ``jax.lax.rem``). All three roll
    plane d by -d modulo W."""
    d = np.arange(D)
    if mode == "pos":
        return W - d
    if mode == "neg":
        return -d
    if mode == "rem":
        return np.fmod(W - d, W)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def probe_input(shape=PROBE_SHAPE):
    """The probe's block: x[d, r, c] = c + 1000 d, float32 numpy."""
    D, TH, W = shape
    return (np.tile(np.arange(W, dtype=np.float32)[None, None, :], (D, TH, 1))
            + 1000 * np.arange(D, dtype=np.float32)[:, None, None])


def probe(device="cuda", shape=PROBE_SHAPE):
    """Run the probe on ``device``: {mode: exact} for the three amount
    forms, each held to ``np.roll(x[d], -d, axis=1)``."""
    xn = probe_input(shape)
    D, _, W = shape
    expect = np.stack([np.roll(xn[d], -d, axis=1) for d in range(D)])
    x = torch.as_tensor(xn, device=resolve_device(device))
    return {mode: bool(np.array_equal(
        roll_planes(x, probe_amounts(mode, D, W)).cpu().numpy(), expect))
        for mode in MODES}


def right_map(cost, min_disp):
    """Right-reference map of a (B, D, H, W) float32 left cost volume.

    Plane k (disparity d = min_disp + k) is rolled by -d with
    :func:`roll_planes`, so column x holds cost(x + d, d); columns where
    x + d leaves [0, W-1] become inf; the first argmin over d (the
    smallest disparity wins ties, an all-inf column gives min_disp) plus
    min_disp. Returns (B, H, W) int32.
    """
    B, D, H, W = cost.shape
    ds = torch.arange(min_disp, min_disp + D, device=cost.device)
    shifted = roll_planes(cost.reshape(B * D, H, W),
                          (-ds).repeat(B)).reshape(B, D, H, W)
    src = torch.arange(W, device=cost.device)[None, :] + ds[:, None]
    ok = (src >= 0) & (src <= W - 1)
    vol = torch.where(ok[None, :, None, :], shifted, torch.inf)
    return (torch.argmin(vol, dim=1) + min_disp).to(torch.int32)
