"""
unwrapping
==========

Phase unwrapping on tensors: the port of :mod:`simplestereo_tpu.unwrapping`.

- :func:`wrap_to_pi`, :func:`unwrap` and :func:`unwrap2D` are elementwise
  torch with the JAX package's semantics (``jnp.mod``'s floor modulo,
  ``jnp.unwrap``'s discontinuity rule and its correction at exactly +-pi).
- :func:`infiniteImpulseResponse` is the Estrada et al. (2011) recursion
  ("Noise robust linear dynamic system for phase unwrapping and
  smoothing"). The JAX package writes it as nested ``lax.scan``s (H*W
  dependent steps); here a CUDA tensor launches the hand-written kernel
  S1 (``csrc/iir_unwrap_kernel.cu``) and adds one to :data:`launches`, a
  CPU tensor runs the plain twin :func:`_iir_unwrap_plain`, and any other
  device raises.

The recursion, as the JAX package computes it (``_iir_row_pass``): every
estimate is the mean, over a pixel's visited causal neighbours n, of
``u_n + tau * W(phi - u_n)``, summed in slot order. Row 0 first gets a
forward pass (neighbour: x-1) and a backward pass (x-1 and x of the
forward values, then x+1 of the backward ones; x = 0 keeps its forward
value). Then every row y, row 0 included, is scanned left to right with
the slots (y, x-1), (y-1, x), (y-1, x+1), where row "-1" is row 0's
backward result. Only those three: the JAX scan replaces its x-1 slot of
the row above by the carry, so (y-1, x-1) is not a neighbour.

Pixel (y, x) then needs only (y, x-1) and (y-1, x..x+1), so all pixels
with x + 2y = t can be computed together at step t: W + 2(H-1) steps
instead of H*W. The twin and the kernel both walk that wavefront, with
the same operations in the same order, so on the card the two agree bit
for bit.
"""

import math

import numpy as np
import torch

from . import _build
from ._device import resolve_device

# S1 kernel launches made by infiniteImpulseResponse (CPU calls of the
# twin do not count): lets a caller prove a run went through the kernel.
launches = 0

# Shared memory a block may use on the H100 (227 KB): the kernel's ring of
# each live row's last three estimates must fit.
SMEM_MAX = 232_448


def _float_tensor(x, device):
    """``x`` as a floating tensor: a tensor stays where it is (an integer
    tensor becomes the default float type); anything else goes to
    ``device``, float64 unless it already is floating, as ``jnp.asarray``
    promotes it with x64 on."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.get_default_dtype())
    arr = np.asarray(x)
    if not np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float64)
    return torch.as_tensor(arr, device=resolve_device(device))


def _const(v, like):
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _floor_mod(x, m):
    """``jnp.mod(x, m)``: C's truncating ``fmod``, plus ``m`` where the
    remainder is nonzero and its sign differs from ``m``'s."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def wrap_to_pi(angle, *, device="cuda"):
    """Wrap angles to [-pi, pi): the W operator of Estrada et al.

    A tensor runs where it is; anything else goes to ``device``.
    """
    a = _float_tensor(angle, device)
    pi = _const(math.pi, a)
    m = _floor_mod(a + pi, _const(2 * math.pi, a))
    return torch.where(m >= 0, m - pi, m + pi)


def unwrap(phase, axis=-1, *, device="cuda"):
    """1D unwrap along an axis (``numpy.unwrap``/``jnp.unwrap``).

    The corrections (multiples of 2*pi, one per jump) are summed along the
    axis in float64 for a float32 phase: every partial sum is then exact,
    whatever order the device sums in, and is rounded once. A tensor runs
    where it is; anything else goes to ``device``.
    """
    p = _float_tensor(phase, device)
    n = p.shape[axis]
    if n == 0:
        return p
    period = _const(2 * math.pi, p)
    interval = period / 2
    dd = torch.diff(p, dim=axis)
    ddmod = _floor_mod(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    correct = torch.where(dd.abs() < interval, torch.zeros_like(dd),
                          ddmod - dd)
    acc = torch.float64 if p.dtype == torch.float32 else p.dtype
    total = torch.cumsum(correct.to(acc), dim=axis).to(p.dtype)
    return torch.cat([p.narrow(axis, 0, 1), p.narrow(axis, 1, n - 1) + total],
                     dim=axis)


def unwrap2D(phase, *, device="cuda"):
    """Separable 2D unwrap: along x (axis 1), then along y (axis 0), the
    reference FTP pipeline's default."""
    return unwrap(unwrap(phase, axis=1, device=device), axis=0)


# -- the IIR recursion: plain twin ----------------------------------------

def _contrib(u, phi, c):
    """u + tau * W(phi - u), W as the kernel computes it: the floor modulo
    of a positive divisor is fmod plus the divisor where fmod < 0, and it
    is never negative, so :func:`wrap_to_pi`'s branch is always ``- pi``."""
    r = torch.fmod(phi - u + c["pi"], c["two_pi"])
    w = torch.where(r < 0, r + c["two_pi"], r) - c["pi"]
    return u + c["tau"] * w


def _mean(phi, slots, c):
    """The mean of ``_contrib`` over the valid slots, summed in slot order
    from 0 with 0 added for an invalid slot, as the JAX scan sums them. A
    slot is (value, valid) with valid a Python bool, at least one True."""
    total, count = c["zero"], 0
    for val, valid in slots:
        total = total + (_contrib(val, phi, c) if valid else c["zero"])
        count += bool(valid)
    return total / c["count"][count]


def _transient_row0(phi0, c):
    """Row 0's forward then backward pass: the row the main scan of row 0
    reads as its row above. One pixel at a time."""
    W = phi0.shape[0]
    col = [phi0[x:x + 1] for x in range(W)]
    fwd = [col[0]]
    for x in range(1, W):
        fwd.append(_mean(col[x], ((fwd[x - 1], True), (None, False),
                                  (None, False)), c))
    out = list(fwd)
    carry = None
    for x in range(W - 1, 0, -1):
        carry = _mean(col[x], ((fwd[x - 1], True), (fwd[x], True),
                               (carry, x < W - 1)), c)
        out[x] = carry
    return torch.cat(out)


def _iir_unwrap_plain(phase, tau):
    """Plain twin of the S1 kernel: the wavefront of the module docstring,
    one vectorised step per t, on an (H, W) float tensor.

    Estimates live in an (H+1, W+1) buffer U: row 0 is row 0's transient
    (the row above row 0), U[y+1, x] is pixel (y, x), and the last column
    is padding. The pixels of step t, x + 2y = t, lie W-1 apart in U's
    flat storage, so each step's cells and their neighbours are strided
    views of it; the three predictions of a step are one stacked
    computation, summed in slot order.
    """
    H, W = phase.shape
    dt, dev = phase.dtype, phase.device
    c = {k: torch.tensor(v, dtype=dt, device=dev) for k, v in
         (("pi", math.pi), ("two_pi", 2 * math.pi), ("zero", 0.0),
          ("tau", tau))}
    c["count"] = {n: torch.tensor(float(n), dtype=dt, device=dev)
                  for n in (1, 2, 3)}
    Wp = W + 1
    U = torch.zeros((H + 1) * Wp, dtype=dt, device=dev)
    U[:W] = _transient_row0(phase[0], c)
    P = torch.zeros(H, Wp, dtype=dt, device=dev)
    P[:, :W] = phase
    P = P.reshape(-1)
    xs = torch.arange(Wp, device=dev).repeat(H + 1)
    # Slot validity (x-1 only for x > 0, x+1 only for x < W-1) and count.
    ok = torch.stack([xs > 0, torch.ones_like(xs, dtype=torch.bool),
                      xs < W - 1])
    count = ok.to(dt).sum(0)
    for t in range(W + 2 * (H - 1)):
        y0 = max(0, (t - W + 2) // 2)
        y1 = min(H - 1, t // 2)
        if y1 < y0:
            continue
        n = y1 - y0 + 1
        cell = Wp * (y0 + 1) + t - 2 * y0

        def at(buf, off):
            """The step's n cells of buf (..., size) at offset off."""
            return buf.as_strided(buf.shape[:-1] + (n,),
                                  buf.stride()[:-1] + (W - 1,), off)

        phi = at(P, cell - Wp)
        # neighbours in slot order: (y, x-1), (y-1, x), (y-1, x+1)
        nb = torch.stack([at(U, cell - 1), at(U, cell - Wp),
                          at(U, cell - W)])
        pred = torch.where(at(ok, cell), _contrib(nb, phi, c), c["zero"])
        total = c["zero"] + pred[0] + pred[1] + pred[2]
        at(U, cell).copy_(total / at(count, cell))
    return U.reshape(H + 1, Wp)[1:, :W].clone()


# -- the IIR recursion: kernel wrapper ------------------------------------

def _plan(H, W, itemsize, ring_rows=None):
    """Launch plan of the S1 kernel: one block of ``threads`` (each owns
    rows threads apart) and a ring of ``ring_rows`` rows x 3 estimates in
    ``smem`` bytes of shared memory.

    The ring holds every row (a slot per row, no modulo) where that fits;
    otherwise row y takes slot y % ring_rows. Row y computes at steps
    [2y, 2y+W-1] and is read by row y+1 until step 2y+W+1, so rows at most
    (W+1)/2 apart are live together: W//2 + 2 ring rows never hand one
    row's slot to another while it is live. ``ring_rows`` forces a size
    (at least that minimum), so the modulo path can be tested on any
    shape."""
    need = min(H, W // 2 + 2)
    if ring_rows is None:
        ring_rows = H if H * 3 * itemsize <= SMEM_MAX else need
    if ring_rows < need:
        raise ValueError(f"a ring of {ring_rows} rows is too small for "
                         f"{H}x{W}: {need} rows are live together")
    threads = min(1024, max(32, -(-H // 32) * 32))
    smem = ring_rows * 3 * itemsize
    if smem > SMEM_MAX:
        raise ValueError(f"a {H}x{W} phase map needs a {smem}-byte ring of "
                         f"row estimates; one block has {SMEM_MAX} bytes of "
                         "shared memory (rows of at most "
                         f"{2 * (SMEM_MAX // (3 * itemsize) - 2)} pixels)")
    return dict(threads=threads, ring_rows=ring_rows, smem=smem)


def _iir_unwrap(phase, tau, plan=None):
    """S1 on an (H, W) float32/float64 tensor: the kernel for a CUDA
    tensor (with ``plan``, default :func:`_plan`'s), the twin for a CPU
    tensor; raises for any other device."""
    global launches
    if phase.dim() != 2 or phase.numel() == 0:
        raise ValueError("Wrong phase dimensions!")
    if phase.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"phase must be float32 or float64, got "
                         f"{phase.dtype}")
    if phase.device.type == "cpu":
        return _iir_unwrap_plain(phase, tau)
    if phase.device.type != "cuda":
        raise ValueError(f"no IIR kernel for device {phase.device}")
    H, W = phase.shape
    if plan is None:
        plan = _plan(H, W, phase.element_size())
    phase = phase.contiguous()
    out = torch.empty_like(phase)
    work = torch.empty(W, dtype=phase.dtype, device=phase.device)
    lib = _build.load_library("iir_unwrap_kernel")
    err = lib.iir_unwrap(phase.data_ptr(), out.data_ptr(), work.data_ptr(),
                         H, W, float(tau), int(phase.dtype == torch.float64),
                         plan["threads"], plan["ring_rows"], plan["smem"],
                         phase.device.index,
                         torch.cuda.current_stream(phase.device).cuda_stream)
    if err != 0:
        raise RuntimeError("IIR unwrap kernel launch failed: "
                           + lib.iir_error_string(err).decode())
    launches += 1
    return out


def infiniteImpulseResponse(phase, tau, *, device="cuda"):
    """Noise-robust IIR phase unwrapping (Estrada et al. 2011).

    Parameters
    ----------
    phase : array or torch.Tensor
        2D wrapped phase map (radians).
    tau : float
        Noise-rejection parameter in [0, 1]: smaller tau smooths more.
    device : str or torch.device
        Where a non-tensor ``phase`` is unwrapped (default ``"cuda"``).

    Returns
    -------
    numpy.ndarray or torch.Tensor
        Unwrapped (and smoothed) phase, same shape and dtype: a tensor on
        the input's device for a tensor, else a numpy array.
    """
    if not (0 <= tau <= 1):
        raise ValueError("Wrong tau value!")
    if isinstance(phase, torch.Tensor):
        if phase.dim() != 2:
            raise ValueError("Wrong phase dimensions!")
        return _iir_unwrap(phase, tau)
    arr = np.asarray(phase)
    if arr.ndim != 2:
        raise ValueError("Wrong phase dimensions!")
    t = _float_tensor(arr, device)
    return _iir_unwrap(t, tau).cpu().numpy()
