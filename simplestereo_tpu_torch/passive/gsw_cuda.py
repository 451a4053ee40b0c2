"""
gsw_cuda
========

GSW matcher front end on the hand-written CUDA kernel
(``csrc/gsw_kernel.cu``), the port of
:mod:`simplestereo_tpu.passive.gsw_pallas`.

Pipeline, per frame stack:

1. :func:`_build_planes`: BGR(ref) padded with a 1e6 sentinel and
   BGR(tgt) padded with zeros, ``win_size // 2`` on every side, so every
   window read of the kernel is in bounds. In consistent mode the
   mirrored right-reference problem is stacked after the left one on the
   frame axis (:func:`_directions`): both directions run in one launch,
   since GSW's one-sided weights have no ASW-style cost symmetry.
2. :func:`_gsw_pass`: the kernel wrapper. A CUDA tensor goes to the
   kernel, a CPU tensor to the plain twin :func:`_gsw_pass_plain`; any
   other device raises. It returns the first-argmin map and, on request,
   the masked cost volume.
3. :func:`_empty_range` and :func:`_lr_finish`: the empty candidate range,
   the left-right check and the occlusion fill, in plain PyTorch.

The MI cost (:func:`gsw_mi_disparity_cuda_batch`) builds its volume from
the joint histogram of the previous matching (:mod:`.gsw`) and hands it
to the same kernel (``ext_vol``): only the window aggregation runs there.
"""

import torch
import torch.nn.functional as F

from .. import _build
from .asw_cuda import _check_planes
from .asw_ref import lr_check
from .gsw import _argmin_disp, _gsw_cost, _mi_volume, _quantize_gray

BGR_SENTINEL = 1.0e6  # exp(-||sentinel - c|| / gamma) underflows to 0.0

# Calls of _gsw_pass that launched the kernel, one per call: one tile
# kernel launch (the volume is built inside it), or on the L1 path a
# volume + aggregation pair (the aggregation alone with ext_vol). CPU calls
# of the twin do not count. Lets a caller prove that a run went through
# the kernel.
launches = 0

# The tile kernel (csrc/gsw_kernel.cu: gsw_tile_kernel<ND>): a block of
# 32 x 8 threads computes 32 x 32 pixels (four rows a thread), and is
# compiled for these disparity chunks.
TILE_W, TILE_H = 32, 32
CHUNKS = (4, 8, 12, 16)
CHUNK_L1 = 16  # disparities a walk on the L1 path
# Dynamic shared memory a block may take: 227 KB (232,448 bytes) on an
# H100.
SMEM_MAX = 232_448


def _plan(win_size, step, D, B, H, W, ext_vol=False, budgets=(SMEM_MAX,)):
    """Launch plan of the GSW kernels for one ``_gsw_pass``.

    Returns a dict: ``path`` "tile" (the shared-memory tile kernel, the
    volume built inside it) or "l1" (a volume launch into device memory
    and the kernel that reads its windows through L1, for a window whose
    tile does not fit), ``nd`` (disparities a chunk: 4, 8, 12 or 16 on the
    tile path; a walk of 16 on the L1 path), ``chunks``, ``smem`` (dynamic
    shared memory bytes a block: BGR(ref) and ``nd`` volume planes of the
    tile; 0 on the L1 path), ``frames`` (frames a launch: grid z holds
    65,535 frames, or 65,535 frames x D for the L1 path's volume launch)
    and ``grid`` (of one launch of ``frames`` frames).

    The weights cost most and are computed once a chunk, so the plan takes
    the fewest chunks that fit the first budget of ``budgets`` that any
    chunk fits, then the smallest such chunk (less shared memory, more
    blocks an SM). Raises ValueError when an image's own rows exceed the
    grid, or D exceeds the volume launch's grid z.
    """
    pad = win_size // 2
    tile_plane = 4 * (TILE_H + 2 * pad) * (TILE_W + 2 * pad)
    plan = None
    for budget in budgets:
        fits = [nd for nd in CHUNKS if (3 + nd) * tile_plane <= budget]
        if fits:
            nd = min(fits, key=lambda c: (-(-D // c), c))
            frames = min(B, _build.GRID_YZ_MAX)
            plan = dict(path="tile", nd=nd, chunks=-(-D // nd),
                        smem=(3 + nd) * tile_plane, frames=frames,
                        grid=(-(-W // TILE_W), -(-H // TILE_H), frames))
            break
    if plan is None:
        per = 1 if ext_vol else D  # grid z of the volume launch a frame
        if per > _build.GRID_YZ_MAX:
            raise ValueError(f"GSW volume grid exceeds CUDA's limits (D={D})")
        frames = min(B, _build.GRID_YZ_MAX // per)
        plan = dict(path="l1", nd=CHUNK_L1, chunks=-(-D // CHUNK_L1), smem=0,
                    frames=frames, grid=(-(-W // 32), -(-H // 8), frames))
    gx, gy, _ = plan["grid"]
    volume_gy = -(-(H + 2 * pad) // 8)  # the L1 path's volume launch
    if gx > _build.GRID_X_MAX or gy > _build.GRID_YZ_MAX or (
            plan["path"] == "l1" and volume_gy > _build.GRID_YZ_MAX):
        raise ValueError(f"GSW kernel grid {plan['grid']} exceeds CUDA's "
                         f"limits ({H}x{W})")
    return plan


def occupancy(plan, normalize=False, device=None):
    """(registers a thread, spill bytes a thread, blocks resident per SM)
    of the tile kernel that ``plan`` launches, from the CUDA runtime."""
    import ctypes
    if plan["path"] != "tile":
        raise ValueError("occupancy is reported for the tile path only")
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    info = (ctypes.c_int * 3)()
    lib = _build.load_library("gsw_kernel")
    err = lib.gsw_occupancy(plan["nd"], int(bool(normalize)), plan["smem"],
                            idx, ctypes.cast(info, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError("GSW occupancy query failed: "
                           + lib.gsw_error_string(err).decode())
    return tuple(info)


def _pack_planes(chw, win_size, fill):
    """(B, C, H, W) -> (B, C, H + 2*pad, W + 2*pad) float32, padded with
    ``fill``; image pixel (y, x) sits at plane (y + pad, x + pad)."""
    pad = win_size // 2
    return F.pad(chw.to(torch.float32), (pad, pad, pad, pad), value=fill)


def _build_planes(refs, tgts, win_size):
    """(B, H, W, 3) BGR reference and target stacks -> (B, 6, Hp, Wp)
    float32 planes: [0:3] BGR(ref) padded with the sentinel, [3:6]
    BGR(tgt) padded with zeros (an out-of-range target read is masked in
    the volume, so its fill never matters)."""
    return torch.cat([
        _pack_planes(refs.permute(0, 3, 1, 2), win_size, BGR_SENTINEL),
        _pack_planes(tgts.permute(0, 3, 1, 2), win_size, 0.0)],
        dim=1).contiguous()


def _directions(imgs1, imgs2, consistent):
    """(reference, target) stacks of the matching problems: the
    left-reference one and, when ``consistent``, the mirrored
    right-reference one stacked after it."""
    if not consistent:
        return imgs1, imgs2
    return (torch.cat([imgs1, imgs2.flip(2)]),
            torch.cat([imgs2, imgs1.flip(2)]))


def _gsw_pass(planes, *, H, W, win_size, min_disp, max_disp, gamma, f_max,
              step=1, normalize=False, ext_vol=False, return_cost=False,
              plan=None):
    """Matching pass over a frame stack of planes.

    planes : (B, 6, Hp, Wp) from :func:`_build_planes`, or with
        ``ext_vol`` (B, 3 + D, Hp, Wp): BGR(ref) padded with the sentinel
        and a prebuilt cost volume padded with zeros (the MI path; the
        volume must be 0 where the candidate column leaves the image).

    Returns ``(disp, cost)``: the first-argmin map (B, H, W) int32 (the
    smallest disparity wins ties; ``min_disp`` where every candidate is
    off the image) and the masked cost volume (B, D, H, W) float32, inf
    where column ``x - d`` leaves the image (None unless
    ``return_cost``).

    A CUDA tensor launches the kernel as ``plan`` lays it out (default
    :func:`_plan` of this call's shapes; a stack of more frames than a
    launch takes runs in pieces) and adds one to ``launches``; a CPU
    tensor runs :func:`_gsw_pass_plain`; any other device raises.
    """
    global launches
    pad = win_size // 2
    _check_planes(planes, (3 + max_disp - min_disp + 1 if ext_vol else 6,
                           H + 2 * pad, W + 2 * pad),
                  win_size, min_disp, max_disp, step)
    kw = dict(H=H, W=W, win_size=win_size, min_disp=min_disp,
              max_disp=max_disp, gamma=gamma, f_max=f_max, step=step,
              normalize=normalize, ext_vol=ext_vol, return_cost=return_cost)
    if planes.device.type == "cpu":
        return _gsw_pass_plain(planes, **kw)
    if planes.device.type != "cuda":
        raise ValueError(f"no GSW kernel for device {planes.device}")

    dev = planes.device
    B, C, Hp, Wp = planes.shape
    D = max_disp - min_disp + 1
    if plan is None:
        plan = _plan(win_size, step, D, B, H, W, ext_vol=ext_vol)
    vol = (torch.empty((plan["frames"], D, Hp, Wp), dtype=torch.float32,
                       device=dev)
           if plan["path"] == "l1" and not ext_vol else None)
    disp = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    cost = (torch.empty((B, D, H, W), dtype=torch.float32, device=dev)
            if return_cost else None)

    lib = _build.load_library("gsw_kernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b0, b1 in _build.frame_pieces(B, plan["frames"]):
        err = lib.gsw_pass(
            planes.data_ptr() + b0 * C * Hp * Wp * 4,
            None if vol is None else vol.data_ptr(),
            disp.data_ptr() + b0 * H * W * 4,
            None if cost is None else cost.data_ptr() + b0 * D * H * W * 4,
            b1 - b0, C, H, W, Hp, Wp, win_size, step, min_disp, D,
            float(gamma), float(f_max), int(bool(normalize)),
            int(bool(ext_vol)), plan["nd"], plan["smem"], dev.index, stream)
        if err != 0:
            raise RuntimeError("GSW kernel launch failed: "
                               + lib.gsw_error_string(err).decode())
    launches += 1
    return disp, cost


def _gsw_pass_plain(planes, *, H, W, win_size, min_disp, max_disp, gamma,
                    f_max, step=1, normalize=False, ext_vol=False,
                    return_cost=False):
    """Plain PyTorch version of :func:`_gsw_pass`, on any device: the
    twin's cost volume (:func:`.gsw._gsw_cost`) per frame, then its first
    argmin. Same returns."""
    pad = win_size // 2
    img = planes[:, :, pad:pad + H, pad:pad + W]
    kw = dict(win_size=win_size, min_disp=min_disp, max_disp=max_disp,
              gamma=gamma, f_max=f_max, normalize=normalize, step=step)
    costs = []
    for fr in img:
        ref = fr[0:3].permute(1, 2, 0)
        if ext_vol:
            costs.append(_gsw_cost(ref, None, vol=fr[3:], **kw))
        else:
            costs.append(_gsw_cost(ref, fr[3:6].permute(1, 2, 0), **kw))
    cost = torch.stack(costs)
    return (_argmin_disp(cost, min_disp),
            cost.contiguous() if return_cost else None)


def _empty_range(disp, W, min_disp):
    """Empty candidate range (x < min_disp): the pixel's own column."""
    xs = torch.arange(W, device=disp.device)
    return torch.where(xs < min_disp, xs, disp)


def _lr_finish(dispL, dispR, *, W, min_disp):
    """LR invalidation + occlusion fill of (..., H, W) maps, int16. An
    empty right range (x > W-1-min_disp) matches left column 0."""
    xs = torch.arange(W, device=dispR.device)
    dispR = torch.where((W - 1 - xs) < min_disp, -xs, dispR)
    return lr_check(dispL, dispR, min_disp).to(torch.int16)


def _finish(disp, B, W, min_disp, consistent):
    """Kernel maps of the stacked directions -> (B, H, W) int16."""
    disp = _empty_range(disp, W, min_disp)
    if not consistent:
        return disp.to(torch.int16)
    return _lr_finish(disp[:B], disp[B:].flip(-1), W=W, min_disp=min_disp)


def _check_stacks(imgs1, imgs2):
    if imgs1.dim() != 4 or imgs1.shape[3] != 3 or imgs1.shape != imgs2.shape:
        raise ValueError(
            "Batches must be (B, H, W, 3) BGR with identical shapes!")
    if imgs1.device != imgs2.device:
        raise ValueError(f"images on different devices: {imgs1.device} "
                         f"and {imgs2.device}")


def gsw_disparity_cuda_batch(imgs1, imgs2, win_size=11, max_disp=16,
                             min_disp=0, gamma=10.0, f_max=120.0,
                             consistent=False, step=1, normalize=False):
    """GSW disparity ("sd" cost) of a (B, H, W, 3) BGR stack on its
    device: (B, H, W) int16, one kernel call for the stack and both
    matching directions, bit-identical to per-frame calls.

    Parameters as :func:`simplestereo_tpu.passive.gsw_pallas.
    gsw_disparity_pallas_batch` without ``interpret``. ``normalize``
    divides each window cost by the summed weight of its candidate-valid
    pixels (float ratios: expect rare near-tie flips against other
    engines).
    """
    _check_stacks(imgs1, imgs2)
    B, H, W = imgs1.shape[:3]
    refs, tgts = _directions(imgs1, imgs2, consistent)
    disp, _ = _gsw_pass(
        _build_planes(refs, tgts, win_size), H=H, W=W, win_size=win_size,
        min_disp=min_disp, max_disp=max_disp, gamma=float(gamma),
        f_max=float(f_max), step=int(step), normalize=bool(normalize))
    return _finish(disp, B, W, min_disp, consistent)


def gsw_disparity_cuda(img1, img2, **kw):
    """:func:`gsw_disparity_cuda_batch` of one (H, W, 3) pair -> (H, W)."""
    return gsw_disparity_cuda_batch(img1[None], img2[None], **kw)[0]


def _mi_iter_steps(mi_iterations, coarse_step):
    """Per-iteration window-walk strides: intermediate matchings only feed
    the global joint histogram, so they may take the subsampled walk; the
    final aggregation is always exact (step 1)."""
    if mi_iterations < 1:
        raise ValueError("mi_iterations must be >= 1!")
    return [coarse_step] * (mi_iterations - 1) + [1]


def _bootstrap(H, W, min_disp, max_disp):
    """The default MI bootstrap field (H, W) int32, uniform over the
    candidates, from a CPU ``torch.Generator`` seeded 0 (the same field
    on every device)."""
    g = torch.Generator().manual_seed(0)
    return torch.randint(min_disp, max_disp + 1, (H, W), generator=g,
                         dtype=torch.int32)


def _gsw_mi_step(ref_planes, q1, q2, disp_prev, *, H, W, win_size, min_disp,
                 max_disp, gamma, bins, step=1):
    """One MI refinement of a frame stack (port of
    :func:`simplestereo_tpu.passive.gsw._gsw_mi_step`): the cost table
    from the previous matching, its volume, the kernel's aggregation and
    first argmin (``ext_vol``), the empty range. ``ref_planes`` is the
    sentinel-padded BGR(ref) stack (B, 3, Hp, Wp)."""
    vol = _mi_volume(q1, q2, disp_prev, min_disp=min_disp,
                     max_disp=max_disp, bins=bins)
    planes = torch.cat([ref_planes, _pack_planes(vol, win_size, 0.0)],
                       dim=1)
    disp, _ = _gsw_pass(planes, H=H, W=W, win_size=win_size,
                        min_disp=min_disp, max_disp=max_disp, gamma=gamma,
                        f_max=0.0, step=step, ext_vol=True)
    return _empty_range(disp, W, min_disp)


def gsw_mi_disparity_cuda_batch(imgs1, imgs2, win_size=11, max_disp=16,
                                min_disp=0, gamma=10.0, bins=20,
                                mi_iterations=2, consistent=False,
                                coarse_step=1, disp0=None):
    """GSW disparity with the mutual-information cost, (B, H, W, 3) BGR
    stack -> (B, H, W) int16 on its device: one kernel call per MI
    iteration for the stack and both matching directions, bit-identical
    to per-frame calls.

    ``disp0``: the (H, W) bootstrap disparity field shared by every frame
    and direction; default :func:`_bootstrap`. ``coarse_step`` > 1
    subsamples the window walk of the intermediate iterations only.
    """
    _check_stacks(imgs1, imgs2)
    B, H, W = imgs1.shape[:3]
    steps = _mi_iter_steps(mi_iterations, coarse_step)
    if disp0 is None:
        disp0 = _bootstrap(H, W, min_disp, max_disp)
    if tuple(disp0.shape) != (H, W):
        raise ValueError(f"disp0 must be ({H}, {W}), got "
                         f"{tuple(disp0.shape)}")
    refs, tgts = _directions(imgs1, imgs2, consistent)
    q1 = _quantize_gray(refs, bins)
    q2 = _quantize_gray(tgts, bins)
    rp = _pack_planes(refs.permute(0, 3, 1, 2), win_size, BGR_SENTINEL)
    disp = disp0.to(refs.device).expand(refs.shape[:3])
    for st in steps:
        disp = _gsw_mi_step(rp, q1, q2, disp, H=H, W=W, win_size=win_size,
                            min_disp=min_disp, max_disp=max_disp,
                            gamma=float(gamma), bins=bins, step=st)
    return _finish(disp, B, W, min_disp, consistent)


def gsw_mi_disparity_cuda(img1, img2, **kw):
    """:func:`gsw_mi_disparity_cuda_batch` of one (H, W, 3) pair ->
    (H, W)."""
    return gsw_mi_disparity_cuda_batch(img1[None], img2[None], **kw)[0]
