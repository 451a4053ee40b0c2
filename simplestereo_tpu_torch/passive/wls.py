"""
wls
===

Edge-aware disparity smoothing, the port of
:mod:`simplestereo_tpu.passive.wls`: the Fast Global Smoother of Min et
al. 2014, the algorithm behind OpenCV's ``DisparityWLSFilter``.

The objective ``min_u sum (u - d)^2 + lambda * sum w_ij (u_i - u_j)^2``
(weights from guide-image colour gradients) is solved by alternating exact
1-D tridiagonal solves along rows and columns, with the iteration-varying
``lambda_t = 1.5 * lambda * 4^(T-t) / (4^T - 1)``. Each 1-D solve is the
Thomas algorithm along every line. The JAX package writes it as two
``lax.scan``s; here a CUDA stack launches the hand-written kernel S2
(``csrc/thomas_kernel.cu``, one launch a solve for every line of the
stack, either axis) and adds one to :data:`launches`, a CPU stack runs the
plain twin :func:`_solve_plain`, and any other device raises.

S2 solves a line with a warp: the line is cut into 32 segments, one a
lane, and solved by the partition method (:func:`_thomas_partitioned_plain`
is its twin, operation for operation); :func:`_thomas_plain`, the exact
sequential Thomas of the JAX scans, stays as the yardstick of its
accuracy.

A stack of frames is solved together: the frame axis is written out, where
the JAX package vmaps over it. Entry points take tensors (run on their
device) or arrays (run on ``device``, default ``"cuda"``; a missing card
raises), and return what they were given: a tensor or a numpy array.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .._device import resolve_device

__all__ = ["fast_global_smoother", "wls_filter_disparity"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = _build.Library("thomas_kernel", {
    # conf, w, u, out, B, H, W, along_y, lam, eps, segment, lines,
    # stride, smem, device, stream
    "thomas_solve": ([_P] * 4 + [_I] * 4 + [_F] * 2 + [_I] * 5 + [_P], _I),
    "thomas_error_string": ([_I], ctypes.c_char_p),
})

# S2 kernel calls made by the solves (a stack cut into several launches by
# the grid limit counts one call; CPU calls of the twin do not count).
launches = 0

# Keeps zero-confidence lines non-singular (wls._fgs's eps).
EPS = 1e-5

# Shared memory a block may use on the H100 (227 KB): a warp's line of
# conf, u and w must fit.
SMEM_MAX = 232_448


# -- the line solve: plain twin ---------------------------------------------

def _thomas_plain(d, lo, up, rhs):
    """Tridiagonal solves along the last axis: the JAX package's
    ``_thomas_rows``, exact and sequential (the yardstick of
    :func:`_thomas_partitioned_plain`'s accuracy).

    d, rhs : (..., L) diagonals and right-hand sides; lo, up : (..., L-1)
    sub- and super-diagonals. One step a line position, every line at
    once, with the JAX scans' operations in their order: the forward
    elimination ``c'_i = up_i / (d_i - lo_{i-1} c'_{i-1})``,
    ``r'_i = (rhs_i - lo_{i-1} r'_{i-1}) / (...)`` from a zero carry, then
    the back substitution ``u_i = r'_i - c'_i u_{i+1}`` from zero.
    """
    L = d.shape[-1]
    zero = d.new_zeros(d.shape[:-1] + (1,))
    up_p = torch.cat([up, zero], dim=-1)
    lo_p = torch.cat([zero, lo], dim=-1)
    cs = torch.empty_like(d)
    rs = torch.empty_like(d)
    c_prev = r_prev = zero[..., 0]
    for i in range(L):
        li = lo_p[..., i]
        denom = d[..., i] - li * c_prev
        c_prev = up_p[..., i] / denom
        r_prev = (rhs[..., i] - li * r_prev) / denom
        cs[..., i] = c_prev
        rs[..., i] = r_prev
    out = torch.empty_like(d)
    u_next = zero[..., 0]
    for i in range(L - 1, -1, -1):
        u_next = rs[..., i] - cs[..., i] * u_next
        out[..., i] = u_next
    return out


# Segments a line: the lanes of the warp that solves it.
LANES = 32


def _segment(L):
    """Positions a segment of a line of L: ceil(L / 32), made odd so that
    the 32 lanes reading position ``lane * m + i`` of a line in shared
    memory hit 32 different banks."""
    m = -(-L // LANES)
    return m if m % 2 else m + 1


def _thomas_partitioned_plain(d, lo, up, rhs):
    """Tridiagonal solves along the last axis by the partition method, the
    twin of the S2 kernel: every operation in the kernel's order, each
    rounded on its own (no fused multiply-add), so the two agree bit for
    bit.

    d, rhs : (..., L); lo, up : (..., L-1), as :func:`_thomas_plain`. The
    line is padded to 32 segments of m = :func:`_segment` (L) positions
    (identity rows: d 1, no coupling, rhs 0). In segment s the first m-1
    positions are its interior and the last, b, its separator S_s.

    1. Each segment eliminates its interior top down, as Thomas does, with
       three right-hand sides: its rhs (y), the coupling lo_a to the
       separator on its left (v) and up_{b-1} to its own (w, whose
       forward values are the c' themselves). Then interior position i is
       ``y_i - v_i S_{s-1} - w_i S_s``.
    2. A back substitution of the three gives their values at the first
       interior position; the last one's are the forward values.
    3. The separator rows, with the interior neighbours put in, form a
       tridiagonal system of 32 unknowns (one a lane); parallel cyclic
       reduction solves it in 5 steps of strides 1, 2, 4, 8, 16 (out of
       range: the identity row).
    4. Each segment fills its interior by a back substitution from its
       separator and the one on its left.

    The error against the exact solution is that of the sequential Thomas
    (the tests hold both to the JAX scans)."""
    L = d.shape[-1]
    m = _segment(L)
    P = LANES * m
    batch = d.shape[:-1]

    def zeros(n):
        return d.new_zeros(batch + (n,))

    def seg(t):
        return t.reshape(batch + (LANES, m))

    D = seg(torch.cat([d, d.new_ones(batch + (P - L,))], -1))
    LO = seg(torch.cat([zeros(1), lo, zeros(P - L)], -1))
    UP = seg(torch.cat([up, zeros(P - L + 1)], -1))
    R = seg(torch.cat([rhs, zeros(P - L)], -1))
    zero = zeros(LANES)
    n = m - 1
    # 1. Forward elimination of the interiors (c', and y', v' of two of
    # the right-hand sides).
    cs, ys, vs = [], [], []
    for i in range(n):
        if i == 0:
            den, yn, vn = D[..., 0], R[..., 0], LO[..., 0]
        else:
            den = D[..., i] - LO[..., i] * cs[-1]
            yn = R[..., i] - LO[..., i] * ys[-1]
            vn = -(LO[..., i] * vs[-1])
        cs.append(UP[..., i] / den)
        ys.append(yn / den)
        vs.append(vn / den)
    # 2. (y, v, w) at the last (E) and the first (F) interior position;
    # with no interior, the neighbours of a separator are separators.
    if n:
        yE, vE, wE = ys[-1], vs[-1], cs[-1]
        yF, vF, wF = yE, vE, wE
        for i in range(n - 2, -1, -1):
            yF = ys[i] - cs[i] * yF
            vF = vs[i] - cs[i] * vF
            wF = -(cs[i] * wF)
    else:
        yE, vE, wE = zero, zero - 1, zero
        yF, vF, wF = zero, zero, zero - 1

    def from_next(t):
        return torch.cat([t[..., 1:], zero[..., :1]], -1)

    # 3. The separators' system, then PCR.
    yF1, vF1, wF1 = from_next(yF), from_next(vF), from_next(wF)
    lob, upb = LO[..., m - 1], UP[..., m - 1]
    A = -(lob * vE)
    B = (D[..., m - 1] - lob * wE) - upb * vF1
    C = -(upb * wF1)
    Dv = (R[..., m - 1] - lob * yE) - upb * yF1
    one = zero + 1
    for delta in (1, 2, 4, 8, 16):
        def left(t, fill):
            return torch.cat([fill[..., :delta], t[..., :-delta]], -1)

        def right(t, fill):
            return torch.cat([t[..., delta:], fill[..., :delta]], -1)

        Am, Bm, Cm, Dm = (left(A, zero), left(B, one), left(C, zero),
                          left(Dv, zero))
        Ap, Bp, Cp, Dp = (right(A, zero), right(B, one), right(C, zero),
                          right(Dv, zero))
        k1 = A / Bm
        k2 = C / Bp
        A, B, C, Dv = (-(Am * k1), (B - Cm * k1) - Ap * k2, -(Cp * k2),
                       (Dv - Dm * k1) - Dp * k2)
    S = Dv / B
    # 4. The fill.
    S_left = torch.cat([zero[..., :1], S[..., :-1]], -1)
    xs = [None] * m
    xs[m - 1] = S
    if n:
        x = (ys[n - 1] - vs[n - 1] * S_left) - cs[n - 1] * S
        xs[n - 1] = x
        for i in range(n - 2, -1, -1):
            x = (ys[i] - vs[i] * S_left) - cs[i] * x
            xs[i] = x
    return torch.stack(xs, -1).reshape(batch + (P,))[..., :L].contiguous()


def _solve_plain(conf, w, u, lam_t, along_y):
    """One WLS line solve of a (B, H, W) stack, ``(C + lam_t L) x = C u +
    eps u`` along x (w: (B, H, W-1)) or along y (w: (B, H-1, W)), built as
    the JAX package's ``_fgs`` builds it and solved by
    :func:`_thomas_partitioned_plain`. The twin of the S2 kernel."""
    if along_y:
        conf, w, u = (t.transpose(-1, -2) for t in (conf, w, u))
    lo = -lam_t * w
    d = conf + EPS + lam_t * (F.pad(w, (1, 0)) + F.pad(w, (0, 1)))
    x = _thomas_partitioned_plain(d, lo, lo, conf * u + EPS * u)
    return x.transpose(-1, -2).contiguous() if along_y else x


# -- the line solve: kernel wrapper -----------------------------------------

def _plan(B, H, W, along_y):
    """Launch plan of the S2 kernel for a (B, H, W) stack: launches of at
    most ``frames`` frames (grid y, 65,535 at most), the stack cut into
    ``pieces`` of them; blocks of ``lines`` warps, a line each, whose
    conf, u and w arrays take ``stride`` floats a line in ``smem`` bytes
    of shared memory; segments of ``segment`` positions (one a lane).

    A column solve's block reads row segments of its ``lines`` columns
    (8: a 32-byte sector a row), a row solve's warp its own row (4 rows a
    block). ``stride`` is the line rounded up to 32 floats plus
    32 / ``lines``, so that the threads staging a column block write 32
    banks. Raises for a line too long for one warp's arrays."""
    count, length = (W, H) if along_y else (H, W)
    lines = 8 if along_y else 4

    def stride_of(n):
        return -(-length // 32) * 32 + 32 // n

    while lines > 1 and 3 * lines * stride_of(lines) * 4 > SMEM_MAX:
        lines //= 2
    stride = stride_of(lines)
    smem = 3 * lines * stride * 4
    if smem > SMEM_MAX:
        raise ValueError(
            f"a line of {length} positions needs {smem} bytes of shared "
            f"memory for its conf, u and w; a block has {SMEM_MAX} (lines "
            f"of at most {SMEM_MAX // 12 - 64} positions)")
    frames = min(B, _build.GRID_YZ_MAX)
    return dict(frames=frames, pieces=_build.frame_pieces(B, frames),
                segment=_segment(length), lines=lines, stride=stride,
                smem=smem)


def _check_stack(conf, w, u, along_y):
    if conf.dim() != 3 or u.shape != conf.shape:
        raise ValueError(f"conf and u must be one (B, H, W) shape, got "
                         f"{tuple(conf.shape)} and {tuple(u.shape)}")
    B, H, W = conf.shape
    want = (B, H - 1, W) if along_y else (B, H, W - 1)
    if tuple(w.shape) != want:
        raise ValueError(f"w must be {want} for a solve along "
                         f"{'y' if along_y else 'x'}, got {tuple(w.shape)}")
    for name, t in (("conf", conf), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != conf.device:
            raise ValueError(f"{name} is on {t.device}, conf on "
                             f"{conf.device}")
    if conf.numel() == 0:
        raise ValueError("the stack must not be empty")


def _solve(conf, w, u, lam_t, along_y):
    """One WLS line solve of a (B, H, W) float32 stack along x or y (see
    :func:`_solve_plain`). A CUDA stack launches S2 (one call; a stack of
    more than 65,535 frames runs in pieces) and adds one to
    :data:`launches`; a CPU stack runs the twin; any other device raises.
    ``lam_t`` is a float holding a float32 value."""
    global launches
    _check_stack(conf, w, u, along_y)
    if conf.device.type == "cpu":
        return _solve_plain(conf, w, u, lam_t, along_y)
    if conf.device.type != "cuda":
        raise ValueError(f"no WLS kernel for device {conf.device}")
    B, H, W = conf.shape
    plan = _plan(B, H, W, along_y)
    conf, w, u = conf.contiguous(), w.contiguous(), u.contiguous()
    out = torch.empty_like(u)
    frame = H * W * 4
    wframe = w[0].numel() * 4
    for b0, b1 in plan["pieces"]:
        LIBRARY.launch(
            "thomas_solve", conf.device,
            conf.data_ptr() + b0 * frame, w.data_ptr() + b0 * wframe,
            u.data_ptr() + b0 * frame, out.data_ptr() + b0 * frame,
            b1 - b0, H, W, int(along_y), float(lam_t), EPS, plan["segment"],
            plan["lines"], plan["stride"], plan["smem"],
            what="WLS line-solve kernel launch failed")
    launches += 1
    return out


# -- the smoother -------------------------------------------------------------

def _lam_schedule(lam, num_iter, t):
    """lambda_t of iteration t (1-based) in float32, as the JAX package's
    jitted ``1.5 * lam * 4.0**(T-t) / (4.0**T - 1.0)`` computes it with
    ``lam`` a float32 scalar: XLA folds the constants into one float32
    factor, the division becoming a product by the float32 reciprocal,
    and multiplies ``lam`` by it once (held equal to JAX on 1,500 values
    of lam and T in the tests). Returned as a Python float (the float32
    value)."""
    f = np.float32
    factor = f(f(1.5 * 4.0 ** (num_iter - t))
               * (f(1.0) / f(4.0 ** num_iter - 1.0)))
    return float(f(lam) * factor)


def _edge_weights(guide, sigma_color):
    """w(p, q) = exp(-||I(p) - I(q)||_1 / sigma) for the horizontal and
    vertical neighbour pairs of a (B, H, W[, C]) guide stack: (B, H, W-1)
    and (B, H-1, W) float32. The channel sum runs in channel order and the
    division is IEEE on every device (sigma is a tensor on the guide's
    device, not a host scalar)."""
    g = guide.to(torch.float32)
    if g.dim() == 3:
        g = g[..., None]
    sigma = torch.tensor(sigma_color, dtype=torch.float32, device=g.device)

    def l1(a):
        acc = a[..., 0]
        for k in range(1, a.shape[-1]):
            acc = acc + a[..., k]
        return acc

    dx = l1((g[:, :, 1:] - g[:, :, :-1]).abs())
    dy = l1((g[:, 1:, :] - g[:, :-1, :]).abs())
    return torch.exp(-dx / sigma), torch.exp(-dy / sigma)


def _fgs(src, conf, wx, wy, lam, num_iter):
    """Alternating 1-D WLS solves of (C + lam_t L) u = C u_prev on a
    (B, H, W) stack: a row solve and a column solve an iteration.

    conf is the per-pixel data-term weight (1 = trust the source, 0 =
    fill purely from neighbours); eps keeps zero-confidence lines
    non-singular."""
    u = src
    for t in range(1, num_iter + 1):
        lam_t = _lam_schedule(lam, num_iter, t)
        u = _solve(conf, wx, u, lam_t, along_y=False)
        u = _solve(conf, wy, u, lam_t, along_y=True)
    return u


def _wls_stack(d, guide, lam, sigma, invalid, disp_scale, num_iter):
    """A (B, H, W) stack and its guide, on their device: confidence from
    the invalid marker, the scale, the weights, then :func:`_fgs`."""
    d = d.to(torch.float32)
    if invalid is None:
        conf = torch.ones_like(d)
    else:
        conf = (d != float(np.float32(invalid))).to(torch.float32)
    d = d * float(np.float32(disp_scale))
    wx, wy = _edge_weights(guide, sigma)
    return _fgs(d * conf, conf, wx, wy, lam, num_iter)


def _wls_dispatch(disparity, guide, lambda_, sigma_color, num_iter,
                  invalid, disp_scale, device):
    is_tensor = isinstance(disparity, torch.Tensor)
    if is_tensor:
        d = disparity
    else:
        d = torch.tensor(np.asarray(disparity), device=resolve_device(device))
    g = (guide.to(d.device) if isinstance(guide, torch.Tensor)
         else torch.tensor(np.asarray(guide), device=d.device))
    if d.dim() not in (2, 3) or g.dim() - d.dim() not in (0, 1) \
            or tuple(g.shape[:d.dim()]) != tuple(d.shape):
        raise ValueError(
            "disparity must be (H, W) or (B, H, W) with a guide of "
            "matching leading shape (plus an optional channel axis)!")
    single = d.dim() == 2
    if single:
        d, g = d[None], g[None]
    out = _wls_stack(d, g, float(np.float32(lambda_)),
                     float(np.float32(sigma_color)), invalid, disp_scale,
                     int(num_iter))
    if single:
        out = out[0]
    return out if is_tensor else out.cpu().numpy()


def fast_global_smoother(src, guide, lambda_=128.0, sigma_color=8.0,
                         num_iter=3, *, device="cuda"):
    """Edge-aware WLS smoothing of ``src`` guided by ``guide``.

    Min et al. 2014 / cv2.ximgproc.createFastGlobalSmootherFilter
    semantics: alternating exact 1-D WLS solves with the paper's lambda
    schedule. ``lambda_`` is the smoothing strength at the SOURCE value
    scale; ``sigma_color`` the guide-gradient falloff (L1 over channels,
    0..255 scale). ``src`` may be (H, W) or a (B, H, W) batch (guide
    batched alike, optional channel axis). A tensor runs on its device;
    anything else on ``device``.

    Returns float32 of ``src``'s shape: a tensor for a tensor, else numpy.
    """
    return _wls_dispatch(src, guide, lambda_, sigma_color, num_iter,
                         None, 1.0, device)


def wls_filter_disparity(disparity, guide, lambda_=128.0, sigma_color=8.0,
                         num_iter=3, invalid=None, disp_scale=1.0, *,
                         device="cuda"):
    """WLS post-filter for a disparity map (DisparityWLSFilter analog).

    Invalid pixels (marker ``invalid``, before ``disp_scale``) get zero
    data-term confidence: they receive purely propagated values from their
    neighbourhood. ``disparity`` may be (H, W) or a (B, H, W) batch (guide
    batched alike, optional channel axis). A tensor runs on its device;
    anything else on ``device``.

    Returns float32 disparity at the ``disp_scale``-applied scale: a
    tensor for a tensor, else numpy.
    """
    return _wls_dispatch(disparity, guide, lambda_, sigma_color,
                         num_iter, invalid, disp_scale, device)
