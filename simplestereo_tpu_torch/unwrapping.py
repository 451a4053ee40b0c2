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
instead of H*W. The twin walks that wavefront a step at a time; the
kernel runs bands of 32 rows on warps, each band a wavefront of its own a
few steps behind the band above (:func:`_plan`). Every pixel sees the same
operations in the same order either way, so on the card the two agree bit
for bit.
"""

import ctypes
import math

import numpy as np
import torch

from . import _build
from ._device import resolve_device

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = _build.Library("iir_unwrap_kernel", {
    # phase, out, H, W, tau, double, warps_per_cta, ctas, chunk, slots,
    # smem, device, stream
    "iir_unwrap": ([_P] * 2 + [_I] * 2 + [ctypes.c_double] + [_I] * 7
                   + [_P], _I),
    # mismatches (uint64[2]), device, stream: div3 against the IEEE
    # division (every float in range, 2^30 doubles)
    "iir_div3_check": ([_P, _I, _P], _I),
    "iir_error_string": ([_I], ctypes.c_char_p),
})

# S1 kernel launches made by infiniteImpulseResponse (CPU calls of the
# twin do not count): lets a caller prove a run went through the kernel.
launches = 0

# Shared memory a block may use on the H100 (227 KB).
SMEM_MAX = 232_448
# CTAs of a cluster the H100 schedules together (16 with the non-portable
# size allowed; 8 portable).
CLUSTER_MAX = 16
# Rows a band: the lanes of the warp that runs it.
LANES = 32
# Compute warps a CTA at most (each with an I/O warp: the kernel's launch
# bounds).
MAX_WARPS = 8
# A warp's ring of phase tiles: 8 tiles of 16 columns, a row padded by 1.
TILES = 8
TILE_STRIDE = TILES * 16 + 1


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

def _align16(n):
    return -(-n // 16) * 16


def _smem_bytes(W, itemsize, wpc, chunk, slots):
    """Shared memory a CTA of the S1 kernel takes (its ``layout``): a
    barrier (8 bytes) a chunk slot and two a tile slot (loaded, passed),
    a read count (4) a warp, each warp's ring of ``slots`` x ``chunk``
    estimates, row 0's transient r0 (W), and the warps' phase tiles (32
    rows x TILE_STRIDE), which CTA 0 first lends to row 0's phase and the
    transient's sums (2W)."""
    n = _align16(wpc * slots * 8)
    n = _align16(n + wpc * 2 * TILES * 8)
    n = _align16(n + wpc * 4)
    n = _align16(n + wpc * slots * chunk * itemsize)
    n = _align16(n + W * itemsize)
    return _align16(n + max(wpc * LANES * TILE_STRIDE * itemsize,
                            2 * W * itemsize))


def _plan(H, W, itemsize, cluster=CLUSTER_MAX, warps_per_cta=MAX_WARPS,
          chunk=16, slots=16):
    """Launch plan of the S1 kernel: one cluster of ``ctas`` CTAs of
    ``warps_per_cta`` compute warps (``warps`` in all; each CTA also has
    as many I/O warps, which stage the compute warps' phase tiles), rings
    of ``slots`` chunks of ``chunk`` columns (``ring`` columns; both
    powers of two), ``smem`` bytes of shared memory a CTA.

    A warp runs a band of 32 rows; warp w takes bands w, w + warps, ....
    With up to ``cluster`` CTAs and ``warps_per_cta`` warps each, the plan
    gives every band a warp of its own where it can, on as many SMs as it
    can (two bands a CTA at 720p: 12 CTAs), at least two CTAs wherever
    there are two bands (a band hands its last row to a warp of another
    CTA). Where shared memory holds fewer warps, bands wrap round, and
    then a ring holds a whole row: a band may have to write all of its
    last row before the warp below is free to read it. The arguments
    force a smaller plan (the tests' and ``chip_smoke.py``'s other rings).
    Raises for a shape whose CTA needs more shared memory than a block
    has."""
    if not 2 <= cluster <= CLUSTER_MAX:
        raise ValueError(f"cluster must be in [2, {CLUSTER_MAX}], got "
                         f"{cluster}")
    if chunk < 2 or chunk & (chunk - 1) or slots < 2 or slots & (slots - 1):
        raise ValueError(f"chunk and slots must be powers of two >= 2, got "
                         f"{chunk}, {slots}")
    bands = -(-H // LANES)
    row_slots = 1 << (-(-W // chunk) - 1).bit_length()

    def fit(wpc):
        ctas = 1 if bands == 1 else min(cluster, max(2, -(-bands // wpc)))
        n = max(slots, row_slots) if bands > ctas * wpc else slots
        return ctas, n, _smem_bytes(W, itemsize, wpc, chunk, n)

    wpc = 1 if bands == 1 else min(warps_per_cta, -(-bands // cluster),
                                   MAX_WARPS)
    ctas, n, smem = fit(wpc)
    while smem > SMEM_MAX and wpc > 1:
        wpc -= 1
        ctas, n, smem = fit(wpc)
    if smem > SMEM_MAX:
        most = (SMEM_MAX - _smem_bytes(0, itemsize, 1, chunk, slots)
                + LANES * TILE_STRIDE * itemsize) // (3 * itemsize)
        raise ValueError(
            f"a {H}x{W} phase map needs {smem} bytes of shared memory a "
            f"CTA (row 0's transient takes 3W values); one block has "
            f"{SMEM_MAX} (rows of at most about {most} pixels)")
    return dict(warps=ctas * wpc, warps_per_cta=wpc, ctas=ctas,
                cluster=ctas, chunk=chunk, slots=n, ring=chunk * n,
                smem=smem)


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
    LIBRARY.launch("iir_unwrap", phase.device, phase.data_ptr(),
                   out.data_ptr(), H, W, float(tau),
                   int(phase.dtype == torch.float64), plan["warps_per_cta"],
                   plan["ctas"], plan["chunk"], plan["slots"], plan["smem"],
                   what="IIR unwrap kernel launch failed")
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
