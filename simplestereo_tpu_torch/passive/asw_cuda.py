"""
asw_cuda
========

ASW matcher front end on the hand-written CUDA kernel
(``csrc/asw_kernel.cu``), the port of
:mod:`simplestereo_tpu.passive.asw_pallas`.

Pipeline, per frame stack:

1. :func:`_build_planes`: Lab planes padded with a 1e6 sentinel (so an
   out-of-image window pixel gets support weight exactly 0) and BGR planes
   padded with zeros, wide enough that every window and candidate read of
   the kernel is in bounds.
2. :func:`_asw_pass`: the kernel wrapper. A CUDA tensor goes to the
   kernel, launched as :func:`_plan` lays it out (the shared-memory tile
   kernel, or the L1 kernel for a window too wide for any tile); a CPU
   tensor goes to the plain twin :func:`_asw_pass_plain`; any other device
   raises. It returns the masked cost volume, the left map,
   the right map derived from the same volume (cost_R(x, d) =
   cost_L(x + d, d)) and the sub-pixel neighbourhood of the winner.
3. :func:`_finish`: empty candidate range, left-right check, occlusion
   fill and the equiangular sub-pixel fit, in plain PyTorch.

Steps 1 and 3 run in the spans ``asw.planes`` and ``asw.finish``
(:class:`..profiling.annotate`).

A candidate whose matched column leaves ``[0, W-1]`` costs ``inf`` in both
directions (see :mod:`.asw_ref` for where that differs from the JAX
package at negative ``min_disp``).
"""

import torch
import torch.nn.functional as F

from .. import _build
from ..profiling import annotate
from .asw_ref import _cost_volume, lr_check, occlusion_fill  # noqa: F401
from .lab import bgr_to_lab

TAD_CAP = 40.0
LAB_SENTINEL = 1.0e6  # exp(-sentinel/gammaC) underflows to exactly 0.0

# Kernel launches made by _asw_pass (CPU calls of the plain twin do not
# count): lets a caller prove that a run went through the kernel.
launches = 0

# The cost kernel's output tile (one thread a pixel) and the disparities a
# tile block keeps in registers: the kernel is compiled for these counts
# (csrc/asw_kernel.cu: kTW, kTH, asw_cost_tile_kernel<ND>).
TILE_W, TILE_H = 32, 8
CHUNKS = (4, 8, 12)
# Dynamic shared memory a tile block may take so that 3, 2 or 1 blocks
# fit one H100 SM: 228 KB an SM, 1 KB of it reserved by each block, and
# 227 KB (232,448 bytes) at most a block. Tried in this order.
SMEM_BUDGETS = (76_800, 115_712, 232_448)


def _plan(win_size, step, D, B, H, W, budgets=SMEM_BUDGETS):
    """Launch plan of the cost kernel for one ``_asw_pass``.

    Returns a dict: ``path`` "tile" (shared-memory tile kernel) or "l1"
    (the kernel that reads device memory through L1, for a window too
    wide for any tile), ``chunk`` (disparities a block: 4, 8 or 12 on the
    tile path, the grid's last chunk padded with disparities that are
    never written; 16 a walk on the L1 path), ``dcp`` (floats a tad row of
    one window pixel takes: 4, or 12 = 4 x an odd number, so 16-byte
    loads of a quarter-warp hit distinct banks), ``jg`` (window columns
    whose e2 one shared-memory group holds), ``smem`` (dynamic shared
    memory bytes a block, 0 on the L1 path), ``frames`` (frames a launch:
    grid z holds frames x chunks, at most 65,535; a larger stack runs in
    pieces) and ``grid`` (of one launch of ``frames`` frames).

    The first budget of ``budgets`` that a tile fits wins, with the
    smallest chunk that holds D (at most 12) first, then a chunk of 4;
    ``jg`` fills the rest of the budget, evened out over the lattice's
    columns. Raises ValueError when an image's own rows (or D's chunks)
    exceed CUDA's grid limits.
    """
    pad = win_size // 2
    nl = 2 * (pad // step) + 1
    cw = TILE_W + 2 * pad
    plan = None
    for budget in budgets:
        fit = next(c for c in CHUNKS if c >= min(D, CHUNKS[-1]))
        for chunk in dict.fromkeys((fit, CHUNKS[0])):
            dcp = 4 if chunk <= 4 else 12
            sw = TILE_W + chunk - 1
            # tad, Lab1 and Lab2 rings of TILE_H rows; Lab2 at the
            # centres; the BGR1 and BGR2 rows being staged; prox of one
            # window row
            fixed = (TILE_H * (cw * dcp + 3 * cw + 3 * (sw + 2 * pad))
                     + 3 * TILE_H * sw + 3 * cw + 3 * (cw + chunk - 1) + nl)
            per_j = TILE_H * sw  # e2 of one window column
            jg = min((budget // 4 - fixed) // per_j, nl)
            if jg < 1:
                continue
            jg = -(-nl // -(-nl // jg))
            nchunks = -(-D // chunk)
            frames = min(B, max(1, _build.GRID_YZ_MAX // nchunks))
            plan = dict(path="tile", chunk=chunk, dcp=dcp, jg=jg,
                        smem=4 * (fixed + jg * per_j), frames=frames,
                        grid=(-(-W // TILE_W), -(-H // TILE_H),
                              frames * nchunks))
            break
        if plan is not None:
            break
    if plan is None:
        frames = min(B, _build.GRID_YZ_MAX)
        plan = dict(path="l1", chunk=16, dcp=0, jg=0, smem=0, frames=frames,
                    grid=(-(-W // TILE_W), -(-H // TILE_H), frames))
    gx, gy, gz = plan["grid"]
    if (gx > _build.GRID_X_MAX or gy > _build.GRID_YZ_MAX
            or gz > _build.GRID_YZ_MAX):
        raise ValueError(f"ASW kernel grid {plan['grid']} exceeds CUDA's "
                         f"limits (B={B}, D={D}, {H}x{W})")
    return plan


def occupancy(plan, device=None):
    """(registers a thread, spill bytes a thread, blocks resident per SM)
    of the cost kernel that ``plan`` launches, from the CUDA runtime."""
    import ctypes
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    info = (ctypes.c_int * 3)()
    lib = _build.load_library("asw_kernel")
    err = lib.asw_occupancy(plan["chunk"], plan["smem"], idx,
                             ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError("ASW occupancy query failed: "
                           + lib.asw_error_string(err).decode())
    return tuple(info)


def _pads(win_size, min_disp, max_disp):
    """(rows above and below, columns left, columns right) of the planes."""
    pad = win_size // 2
    return pad, pad + max(max_disp, 0), pad + max(-min_disp, 0)


def _build_planes(imgs1, imgs2, win_size, min_disp, max_disp, row_valid=None,
                  context=False):
    """(B, H, W, 3) BGR pairs -> (B, 12, Hp, Wp) float32 planes.

    Channels: [0:3] Lab(left), [3:6] Lab(right), [6:9] BGR(left),
    [9:12] BGR(right). Image pixel (y, x) sits at plane (y + pad,
    x + left) with ``(pad, left, _) = _pads(...)``.

    ``row_valid``: optional (B, H) bool; a row marked False is filled like
    the padding (Lab sentinel, BGR 0), so its window pixels weigh exactly
    0, as an out-of-image row's do. ``context``: the first and last
    ``pad`` rows of the input are window sources only; they take the place
    of the top and bottom padding (image row y sits at plane row y), and
    the pass is run for the ``H - 2 * pad`` rows between them. Both serve
    the row-tiled matcher of :mod:`simplestereo_tpu_torch.parallel`.
    """
    pad, left, right = _pads(win_size, min_disp, max_disp)
    rows = 0 if context else pad

    def pack(arr, fill):
        a = arr.permute(0, 3, 1, 2)
        if row_valid is not None:
            a = torch.where(row_valid[:, None, :, None], a, fill)
        return F.pad(a, (left, right, rows, rows), value=fill)

    return torch.cat([
        pack(bgr_to_lab(imgs1), LAB_SENTINEL),
        pack(bgr_to_lab(imgs2), LAB_SENTINEL),
        pack(imgs1.to(torch.float32), 0.0),
        pack(imgs2.to(torch.float32), 0.0)], dim=1).contiguous()


def _prox(win_size, gamma_p, device):
    """(win, win) float32 proximity weights exp(-2*sqrt(di^2+dj^2)/gammaP)."""
    offs = torch.arange(win_size, dtype=torch.float32,
                        device=device) - win_size // 2
    dist = torch.sqrt(offs[:, None] ** 2 + offs[None, :] ** 2)
    return torch.exp(-2.0 * dist / gamma_p)


def _check_planes(planes, want, win_size, min_disp, max_disp, step):
    """Raise ValueError unless the pass parameters are valid and
    ``planes`` is a contiguous float32 (B, *want) stack."""
    if win_size <= 0 or win_size % 2 == 0:
        raise ValueError(f"win_size must be a positive odd number, got "
                         f"{win_size}")
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    if max_disp < min_disp:
        raise ValueError(f"max_disp {max_disp} < min_disp {min_disp}")
    if planes.dim() != 4 or tuple(planes.shape[1:]) != want:
        raise ValueError(f"planes must be (B, {want[0]}, {want[1]}, "
                         f"{want[2]}), got {tuple(planes.shape)}")
    if planes.dtype != torch.float32:
        raise ValueError(f"planes must be float32, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")


def _asw_pass(planes, *, H, W, win_size, min_disp, max_disp, gamma_c,
              gamma_p, step=1, consistent=True, subpixel=False, context=False,
              plan=None):
    """Matching pass over a frame stack of planes (B, 12, Hp, Wp).

    Returns ``(cost, dispL, dispR, csub)``: the masked cost volume
    (B, D, H, W) float32; the left-reference argmin map (B, H, W) int32
    (first minimum, so the smallest disparity wins ties); the right map
    from the same volume (None unless ``consistent``); and
    (B, 3, H, W) float32 [c(best-1), c(best), c(best+1)], 0 where the
    neighbour does not exist (None unless ``subpixel``).

    ``context``: the planes' top and bottom ``pad`` rows hold image rows
    (window sources) instead of padding (:func:`_build_planes`). The kernel
    reads plane rows ``[y, y + win)`` for output row ``y`` either way; the
    twin needs to know.

    A CUDA tensor launches the kernel as ``plan`` lays it out (default
    :func:`_plan` of this call's shapes; a stack of more frames than a
    launch takes runs in pieces, counted as one call); a CPU tensor runs
    :func:`_asw_pass_plain`; any other device raises.
    """
    global launches
    pad, left, right = _pads(win_size, min_disp, max_disp)
    _check_planes(planes, (12, H + 2 * pad, W + left + right), win_size,
                  min_disp, max_disp, step)
    kw = dict(H=H, W=W, win_size=win_size, min_disp=min_disp,
              max_disp=max_disp, gamma_c=gamma_c, gamma_p=gamma_p, step=step,
              consistent=consistent, subpixel=subpixel)
    if planes.device.type == "cpu":
        return _asw_pass_plain(planes, context=context, **kw)
    if planes.device.type != "cuda":
        raise ValueError(f"no ASW kernel for device {planes.device}")

    dev = planes.device
    B, _, Hp, Wp = planes.shape
    D = max_disp - min_disp + 1
    if plan is None:
        plan = _plan(win_size, step, D, B, H, W)
    prox = _prox(win_size, gamma_p, dev)
    cost = torch.empty((B, D, H, W), dtype=torch.float32, device=dev)
    dispL = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    dispR = (torch.empty((B, H, W), dtype=torch.int32, device=dev)
             if consistent else None)
    csub = (torch.empty((B, 3, H, W), dtype=torch.float32, device=dev)
            if subpixel else None)

    lib = _build.load_library("asw_kernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    hw = H * W * 4  # bytes of one (H, W) float32 or int32 map
    for b0, b1 in _build.frame_pieces(B, plan["frames"]):
        err = lib.asw_pass(
            planes.data_ptr() + b0 * 12 * Hp * Wp * 4, prox.data_ptr(),
            cost.data_ptr() + b0 * D * hw, dispL.data_ptr() + b0 * hw,
            None if dispR is None else dispR.data_ptr() + b0 * hw,
            None if csub is None else csub.data_ptr() + b0 * 3 * hw,
            b1 - b0, H, W, Hp, Wp, left, win_size, step, min_disp, D,
            1.0 / float(gamma_c), plan["chunk"], plan["jg"], plan["smem"],
            dev.index, stream)
        if err != 0:
            raise RuntimeError("ASW kernel launch failed: "
                               + lib.asw_error_string(err).decode())
    launches += 1
    return cost, dispL, dispR, csub


def _right_volume(cost, min_disp):
    """Right-reference volume of a (B, D, H, W) left volume:
    cost_R(x, d) = cost(x + d, d), inf where x + d leaves the image."""
    D, W = cost.shape[1], cost.shape[3]
    xs = torch.arange(W, device=cost.device)
    ds = torch.arange(min_disp, min_disp + D, device=cost.device)
    src = xs[None, :] + ds[:, None]                           # (D, W)
    ok = (src >= 0) & (src <= W - 1)
    idx = src.clamp(0, W - 1)[None, :, None, :].expand(cost.shape)
    return torch.where(ok[None, :, None, :], torch.gather(cost, 3, idx),
                       torch.inf)


def _select_plain(cost, min_disp, consistent, subpixel):
    """Plain twin of the kernel's selection step on a (B, D, H, W) volume."""
    D = cost.shape[1]
    best = torch.argmin(cost, dim=1, keepdim=True)
    dispL = (best[:, 0] + min_disp).to(torch.int32)

    csub = None
    if subpixel:
        cm = torch.where(best >= 1,
                         torch.gather(cost, 1, (best - 1).clamp(min=0)), 0.0)
        cp = torch.where(best <= D - 2,
                         torch.gather(cost, 1, (best + 1).clamp(max=D - 1)),
                         0.0)
        c0 = torch.gather(cost, 1, best)
        csub = torch.cat([cm, c0, cp], dim=1)

    dispR = None
    if consistent:
        dispR = (torch.argmin(_right_volume(cost, min_disp), dim=1)
                 + min_disp).to(torch.int32)
    return dispL, dispR, csub


def _asw_pass_plain(planes, *, H, W, win_size, min_disp, max_disp, gamma_c,
                    gamma_p, step=1, consistent=True, subpixel=False,
                    context=False):
    """Plain PyTorch version of :func:`_asw_pass`, on any device: the
    twin's cost volume (:func:`.asw_ref._cost_volume`) per frame, then the
    same selection. Same returns.

    With ``context`` the volume is taken over all plane rows, the context
    rows included, and its middle ``H`` rows are kept. A window pixel on a
    sentinel row then weighs exactly 0 through the exponential, where the
    whole image's twin masks it out: both add 0.0 to the same sums."""
    pad, left, _ = _pads(win_size, min_disp, max_disp)
    rows = slice(None) if context else slice(pad, pad + H)
    img = planes[:, :, rows, left:left + W].permute(0, 2, 3, 1)
    costs = []
    for fr in img:
        c, _ = _cost_volume(fr[..., 6:9], fr[..., 9:12], fr[..., 0:3],
                            fr[..., 3:6], win_size, gamma_c, gamma_p,
                            min_disp, max_disp, +1, step)
        if context:
            c = c[pad:pad + H]
        costs.append(c.permute(2, 0, 1))
    cost = torch.stack(costs).contiguous()
    return (cost,) + _select_plain(cost, min_disp, consistent, subpixel)


def _finish(dispL, dispR, csub, *, W, min_disp, max_disp, consistent,
            subpixel):
    """Post-kernel passes on (B, H, W) maps: empty candidate range, LR
    check, occlusion fill and the optional equiangular sub-pixel fit.
    Every step is per row, so a stack gives the per-frame results."""
    raw = dispL  # kernel argmin map, before the empty-range substitution
    xs = torch.arange(W, device=dispL.device)
    # Empty candidate range (x < min_disp): the reference outputs the
    # pixel's own column index.
    dispL = torch.where(xs < min_disp, xs, dispL)

    if consistent:
        # Empty range on the right pass: matched left column 0, disp -x.
        dispR = torch.where((W - 1 - xs) < min_disp, -xs, dispR)
        out_i = lr_check(dispL, dispR, min_disp).to(torch.int16)
    else:
        out_i = dispL.to(torch.int16)

    if not subpixel:
        return out_i

    # Equiangular (V-shaped) fit through the winner's cost neighbourhood;
    # only pixels whose final value is still the kernel argmin are refined
    # (the invalid marker is below every legal argmin, so it stays integer).
    cm, c0, cp = csub[:, 0], csub[:, 1], csub[:, 2]
    interior = (raw > min_disp) & (raw < max_disp)
    finite = torch.isfinite(cm) & torch.isfinite(cp) & torch.isfinite(c0)
    denom = torch.maximum(cm, cp) - c0
    delta = torch.where(interior & finite & (denom > 1e-6),
                        (cm - cp) / (2.0 * denom), 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    refine = out_i == raw
    return out_i.to(torch.float32) + torch.where(refine, delta, 0.0)


def asw_disparity_batch(imgs1, imgs2, win_size=35, max_disp=16, min_disp=0,
                        gamma_c=5.0, gamma_p=17.5, consistent=False, step=1,
                        subpixel=False, row_valid=None, context=False):
    """ASW disparity of a frame stack on the stack's device.

    imgs1, imgs2 : (B, H, W, 3) BGR tensors, uint8 or float in [0, 255].
    One kernel launch covers the whole stack; the result is bit-identical
    to per-frame :func:`asw_disparity`.

    row_valid : optional (B, H) bool tensor: rows marked False are treated
        exactly like out-of-image rows (the row-tiled matcher marks the
        halo rows it received at the image's true boundary so).
    context : the first and last ``win_size // 2`` rows are window sources
        only: no disparity is computed for them, and the output has
        ``H - 2 * (win_size // 2)`` rows.

    Returns (B, H_out, W) int16, or float32 when ``subpixel``.
    """
    if imgs1.dim() != 4 or imgs1.shape[3] != 3 or imgs1.shape != imgs2.shape:
        raise ValueError(
            "Batches must be (B, H, W, 3) BGR with identical shapes!")
    if imgs1.device != imgs2.device:
        raise ValueError(f"images on different devices: {imgs1.device} "
                         f"and {imgs2.device}")
    B, H, W = imgs1.shape[:3]
    if row_valid is not None:
        row_valid = torch.as_tensor(row_valid, dtype=torch.bool,
                                    device=imgs1.device)
        if tuple(row_valid.shape) != (B, H):
            raise ValueError(f"row_valid must be (B, H) = {(B, H)}, got "
                             f"{tuple(row_valid.shape)}")
    h_out = H - 2 * (win_size // 2) if context else H
    if h_out < 1:
        raise ValueError(f"context mode needs more than 2 * (win_size // 2)"
                         f" = {H - h_out} rows, got {H}")
    with annotate("asw.planes"):
        planes = _build_planes(imgs1, imgs2, win_size, min_disp, max_disp,
                               row_valid=row_valid, context=bool(context))
    _, dispL, dispR, csub = _asw_pass(
        planes, H=h_out, W=W, win_size=win_size, min_disp=min_disp,
        max_disp=max_disp, gamma_c=float(gamma_c), gamma_p=float(gamma_p),
        step=int(step), consistent=bool(consistent),
        subpixel=bool(subpixel), context=bool(context))
    with annotate("asw.finish"):
        return _finish(dispL, dispR, csub, W=W, min_disp=min_disp,
                       max_disp=max_disp, consistent=bool(consistent),
                       subpixel=bool(subpixel))


def asw_disparity(img1, img2, win_size=35, max_disp=16, min_disp=0,
                  gamma_c=5.0, gamma_p=17.5, consistent=False, step=1,
                  subpixel=False, row_valid=None, context=False):
    """ASW disparity map of one (H, W, 3) BGR pair on the pair's device.

    Parameters mirror :func:`simplestereo_tpu.passive.asw_disparity`;
    ``row_valid`` is (H,) here. Returns (H_out, W) int16 (float32 when
    ``subpixel``), ``H_out = H - 2 * (win_size // 2)`` with ``context``.
    """
    if img1.dim() != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
        raise ValueError(
            "Images must be 3-channel BGR with identical shapes!")
    if row_valid is not None:
        row_valid = torch.as_tensor(row_valid, dtype=torch.bool,
                                    device=img1.device)[None]
    return asw_disparity_batch(
        img1[None], img2[None], win_size=win_size, max_disp=max_disp,
        min_disp=min_disp, gamma_c=gamma_c, gamma_p=gamma_p,
        consistent=consistent, step=step, subpixel=subpixel,
        row_valid=row_valid, context=context)[0]
