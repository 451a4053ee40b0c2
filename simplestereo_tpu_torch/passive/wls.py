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

A stack of frames is solved together: the frame axis is written out, where
the JAX package vmaps over it. Entry points take tensors (run on their
device) or arrays (run on ``device``, default ``"cuda"``; a missing card
raises), and return what they were given: a tensor or a numpy array.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .._device import resolve_device

__all__ = ["fast_global_smoother", "wls_filter_disparity"]

# S2 kernel calls made by the solves (a stack cut into several launches by
# the grid limit counts one call; CPU calls of the twin do not count).
launches = 0

# Keeps zero-confidence lines non-singular (wls._fgs's eps).
EPS = 1e-5


# -- the line solve: plain twin ---------------------------------------------

def _thomas_plain(d, lo, up, rhs):
    """Tridiagonal solves along the last axis (the twin of S2, and of the
    JAX package's ``_thomas_rows``).

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


def _solve_plain(conf, w, u, lam_t, along_y):
    """One WLS line solve of a (B, H, W) stack, ``(C + lam_t L) x = C u +
    eps u`` along x (w: (B, H, W-1)) or along y (w: (B, H-1, W)), built as
    the JAX package's ``_fgs`` builds it and solved by
    :func:`_thomas_plain`. The twin of the S2 kernel."""
    if along_y:
        conf, w, u = (t.transpose(-1, -2) for t in (conf, w, u))
    lo = -lam_t * w
    d = conf + EPS + lam_t * (F.pad(w, (1, 0)) + F.pad(w, (0, 1)))
    x = _thomas_plain(d, lo, lo, conf * u + EPS * u)
    return x.transpose(-1, -2).contiguous() if along_y else x


# -- the line solve: kernel wrapper -----------------------------------------

def _plan(B, H, W, along_y):
    """What the S2 wrapper asks for a (B, H, W) stack: launches of at most
    ``frames`` frames (grid y, 65,535 at most), the stack cut into
    ``pieces`` of them, and a workspace of ``work_bytes`` for c' and r'
    of one launch's frames (two floats a line position). The kernel works
    out its own block grid from the shape it is given."""
    lines, length = (W, H) if along_y else (H, W)
    frames = min(B, _build.GRID_YZ_MAX)
    return dict(frames=frames, pieces=_build.frame_pieces(B, frames),
                work_bytes=frames * 2 * length * lines * 4)


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
    work = torch.empty(plan["work_bytes"] // 4, dtype=torch.float32,
                       device=conf.device)
    frame = H * W * 4
    wframe = w[0].numel() * 4
    lib = _build.load_library("thomas_kernel")
    stream = torch.cuda.current_stream(conf.device).cuda_stream
    for b0, b1 in plan["pieces"]:
        err = lib.thomas_solve(
            conf.data_ptr() + b0 * frame, w.data_ptr() + b0 * wframe,
            u.data_ptr() + b0 * frame, out.data_ptr() + b0 * frame,
            work.data_ptr(), b1 - b0, H, W, int(along_y), float(lam_t), EPS,
            conf.device.index, stream)
        if err != 0:
            raise RuntimeError("WLS line-solve kernel launch failed: "
                               + lib.thomas_error_string(err).decode())
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
