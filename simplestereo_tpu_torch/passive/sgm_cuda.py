"""
sgm_cuda
========

SGM path aggregation: the wrapper :func:`aggregate` of the hand-written
CUDA kernel (``csrc/sgm_kernel.cu``), the port of
:func:`simplestereo_tpu.passive.sgm_pallas.aggregate_pallas`, and beside it
the plain PyTorch twin :func:`_aggregate`, the port of
:func:`simplestereo_tpu.passive.sgm._aggregate`.

Both compute, for each of the 4 or 8 directions r,

    L_r(p, d) = C(p, d) + min(L_r(p-r, d), min(L_r(p-r, d-1), L_r(p-r, d+1)) + P1,
                              m + P2) - m,        m = min_d' L_r(p-r, d')

with ``d-1``/``d+1`` clamped to ``[0, D-1]`` and ``L_r = 0`` before the
first pixel of every scan line (so ``L_r = C`` there, at the image border
of a diagonal path too), and return ``S = sum_r L_r`` summed in
``_aggregate``'s order: horizontal forward, horizontal backward, then for
each column roll 0, +1, -1 (roll 0 only with 4 paths) the downward and the
upward scan. The recurrence is min and add only, with no multiply that a
compiler could fuse, so the kernel and the twin agree bit for bit.

For the row-tiled matcher (:mod:`simplestereo_tpu_torch.parallel.sgm`)
both also run one family of directions at a time (``directions``
"horizontal", "down" or "up"), each direction's L into its own buffer of a
workspace (``out``, one buffer a direction, numbered in the summation
order above), the vertical and diagonal ones from a carried row
(``carry``, the row before the tile's first row; :func:`carry_of` cuts it
from the tile before). :func:`sum_paths` then sums the buffers in that
order.

The census cost volume C that the aggregation reads comes from the same
library: :func:`census_cost` launches ``census_words_kernel`` and
``census_cost_kernel`` (``csrc/sgm_kernel.cu``), whose twin is the torch
code of :mod:`.sgm` (``_census_cost``, ``_edge_fill_rows`` and
``_box_sum``), and :func:`bt_cost` launches ``bt_prefilter_kernel`` and
``bt_cost_kernel``, whose twin is ``_xsobel``, ``_interval``,
``_bt_cost``, ``_edge_fill_rows`` and ``_box_sum``. So does the post pass
over S: :func:`post` launches ``sgm_post_kernel``, whose twin is
``sgm._sgm_post_plain``.
"""

import ctypes
import math

import torch

from .. import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
LIBRARY = _build.Library("sgm_kernel", {
    # C, S, work, B, H, W, D, P1, P2, paths, mode, npl, group, vec,
    # device, stream
    "sgm_aggregate": ([_P] * 3 + [_I] * 4 + [_F] * 2 + [_I] * 6 + [_P], _I),
    # C, L, carry, B, H, W, D, P1, P2, dir0, ndir, dir_step,
    # slot_stride, npl, group, vec, device, stream
    "sgm_scan": ([_P] * 3 + [_I] * 4 + [_F] * 2 + [_I] * 3 + [_L]
                 + [_I] * 4 + [_P], _I),
    # L, S, vol, stride, nbuf, device, stream
    "sgm_sum": ([_P] * 2 + [_L] * 2 + [_I] * 2 + [_P], _I),
    # gray1, gray2, rows, codes, C, B, H, W, min_disp, D, win, block,
    # device, stream
    "sgm_census_cost": ([_P] * 5 + [_I] * 8 + [_P], _I),
    # gray1, gray2, rows, planes, C, B, H, W, min_disp, D, block, cap,
    # device, stream
    "sgm_bt_cost": ([_P] * 5 + [_I] * 6 + [_F, _I, _P], _I),
    # S, out, keys, disps, B, H, W, D, min_disp, uniq_factor, uniq,
    # lr_max, subpixel, nj, group, device, stream
    "sgm_post": ([_P] * 4 + [_I] * 5 + [_F] + [_I] * 6 + [_P], _I),
    "sgm_error_string": ([_I], ctypes.c_char_p),
})

# Calls of aggregate that launched the kernel, one per call: a call
# launches one kernel per direction (4 or 8), or one for all directions and
# a sum, counted once as a set. CPU calls of the twin do not count. Lets a
# caller prove that a run went through the kernel.
launches = 0

# The line kernel (csrc/sgm_kernel.cu: sgm_lines_kernel<NPL>) is compiled
# for these disparities a lane; a line takes a group of at most 32 lanes,
# so it holds D <= 256. A larger D runs the first version ("generic").
NPL = (1, 2, 4, 8)
LINES_D_MAX = 32 * NPL[-1]
WARPS = 4  # warps a block (kWarps)
# Workspace the concurrent mode may take (one L buffer a direction): 4 GiB.
# A 384x288 D = 16 frame needs 56.6 MB at 8 paths, so sgm_batch8 fits
# whole; 1280x720 at D = 128 needs 3.8 GB a frame, one frame a launch.
WORKSPACE_CAP = 4 << 30
MODES = ("sequential", "concurrent", "generic")

# Calls of census_cost (each launches the census kernels: a words and a
# cost launch, or one pair a piece of 65,535 frames).
census_launches = 0

CENSUS_WINDOWS = (3, 5, 7)
# The largest block the census kernels take (kCensusBlockMax): a box sum,
# at most 48 k * k, stays below 2**24, so exact in float32 in any order.
CENSUS_BLOCK_MAX = 591

# Calls of bt_cost (each launches the BT kernels: a prefilter and a cost
# launch, or one pair a piece of 65,535 frames).
bt_launches = 0

# The largest block the BT kernels take (kBtBlockMax): the cost kernel
# keeps the box's rows in a ring of 4 * block registers a thread, one
# compiled kernel a block, and at 32 candidates a block the box's halo
# takes block - 1 of the 32 columns it stages. OpenCV's usual blocks are 3
# to 11; a larger one runs the torch code.
BT_BLOCK_MAX = 11

# Calls of post (each launches sgm_post_kernel once, or once a piece of
# 65,535 frames).
post_launches = 0

# The post kernel holds a lane's candidates in registers, NJ of them
# (csrc/sgm_kernel.cu: sgm_post_kernel<NJ>), a pixel taking a group of 8,
# 16 or 32 lanes: D <= 32 * 16. A larger D reads them from S (NJ 0).
# The least NJ that holds D: fewer registers, more blocks an SM (on the
# H100 at 720p NJ 4 takes 0.110 ms at D = 16 and NJ 8 0.160 at D = 40,
# where NJ 12 takes 0.208).
POST_NJ = (4, 8, 12, 16)
POST_D_MAX = 32 * POST_NJ[-1]
# A row's right-view keys (8 bytes), winners (4) and map (2) a column in
# shared memory up to the H100's opt-in 227 KB a block; a wider row keeps
# them in device memory.
POST_SMEM_MAX = 232_448


def _plan(B, H, W, D, paths, mode=None):
    """Launch plan of the path-aggregation kernels for one ``aggregate``.

    Returns a dict: ``mode`` "sequential" (one line-kernel launch a
    direction, summing into S as it goes), "concurrent" (one launch of
    every direction into a workspace of L buffers, then their sum) or
    "generic" (the first version; D > 256 takes it); ``npl`` (disparities a
    lane: 1, 2, 4 or 8; 0 on the generic path), ``group`` (lanes a scan
    line, a power of two with group * npl >= D), ``vec`` (16-byte loads
    and stores: D % 4 == 0 and npl >= 4), ``depth`` (steps of C and S
    fetched ahead), ``frames`` (frames a launch: the grid's y holds at
    most 65,535, and the concurrent workspace at most ``WORKSPACE_CAP``
    bytes), ``workspace`` (bytes of L buffers) and ``grid`` (of one launch
    of ``frames`` frames; x covers the direction with the most lines).

    ``mode`` None picks concurrent where one frame's workspace fits
    ``WORKSPACE_CAP`` (it was faster at every main shape on the H100),
    else sequential. Raises ValueError for a shape or mode that no kernel
    takes.
    """
    ndirs = 8 if paths >= 8 else 4
    vol = H * W * D * 4  # bytes of one frame's volume
    if mode not in (None,) + MODES:
        raise ValueError(f"unknown SGM mode {mode!r}")
    if D > LINES_D_MAX or mode == "generic":
        if mode not in (None, "generic"):
            raise ValueError(f"mode {mode!r} needs D <= {LINES_D_MAX}, "
                             f"got D={D}")
        mode, npl, group = "generic", 0, 32
    else:
        npl = next(n for n in NPL if 32 * n >= D)
        group = 32 if npl > 1 else 1 << (D - 1).bit_length()
        if mode is None:
            mode = ("concurrent" if ndirs * vol <= WORKSPACE_CAP
                    else "sequential")
    frames = min(B, _build.GRID_YZ_MAX)
    workspace = 0
    if mode == "concurrent":
        frames = min(frames, max(1, WORKSPACE_CAP // (ndirs * vol)))
        workspace = ndirs * -(-frames * vol // 16) * 16
    per_block = WARPS if mode == "generic" else WARPS * 32 // group
    most = W + H - 1 if ndirs == 8 else max(H, W)
    grid = (-(-most // per_block), frames,
            ndirs if mode == "concurrent" else 1)
    if grid[0] > _build.GRID_X_MAX:
        raise ValueError(f"SGM kernel grid {grid} exceeds CUDA's limits "
                         f"({H}x{W})")
    return dict(mode=mode, npl=npl, group=group,
                vec=mode != "generic" and D % 4 == 0 and npl >= 4,
                depth=(8 if npl <= 4 else 4) if npl else 0, frames=frames,
                workspace=workspace, grid=grid)


def _family(directions, paths):
    """(first direction, directions, step between them) of a family, in the
    kernel's numbering (csrc/sgm_kernel.cu: direction): 0, 1 horizontal;
    2 + 2j down and 3 + 2j up with column roll (0, +1, -1)[j]."""
    k = 3 if paths >= 8 else 1
    if directions == "horizontal":
        return 0, 2, 1
    if directions == "down":
        return 2, k, 2
    if directions == "up":
        return 3, k, 2
    raise ValueError(f"directions must be None, 'horizontal', 'down' or "
                     f"'up', got {directions!r}")


def _sgm_step(L_prev, C_cur, P1, P2):
    """One SGM recurrence step, vectorized over (..., D)."""
    m = torch.amin(L_prev, dim=-1, keepdim=True)
    up = torch.cat([L_prev[..., 1:], L_prev[..., -1:]], dim=-1)
    dn = torch.cat([L_prev[..., :1], L_prev[..., :-1]], dim=-1)
    best = torch.minimum(
        torch.minimum(L_prev, torch.minimum(up, dn) + P1), m + P2)
    return C_cur + best - m


def _roll_cols(a, dx):
    """Shift (..., W, D) along W with zero fill (predecessor off-image)."""
    if dx > 0:
        return torch.cat([torch.zeros_like(a[..., :dx, :]), a[..., :-dx, :]],
                         dim=-2)
    if dx < 0:
        return torch.cat([a[..., -dx:, :], torch.zeros_like(a[..., :-dx, :])],
                         dim=-2)
    return a


def _horizontal(C, P1, P2, out):
    """Both horizontal scans into out[0] (forward) and out[1] (backward):
    column x of the forward scan and column W-1-x of the backward one in
    the same step; carry (2, ..., H, D)."""
    W, D = C.shape[-2:]
    L = C.new_zeros((2,) + C.shape[:-2] + (D,))
    for x in range(W):
        L = _sgm_step(L, torch.stack([C[..., x, :], C[..., W - 1 - x, :]]),
                      P1, P2)
        out[0, ..., x, :] = L[0]
        out[1, ..., W - 1 - x, :] = L[1]


def _vertical(C, P1, P2, comps, carry, out):
    """Vertical and diagonal scans, stacked: ``comps`` lists (buffer,
    column roll, upward) of each scan; step i takes row i of the downward
    scans and row H-1-i of the upward ones. ``carry`` (len(comps), ...,
    W, D) is the row before each scan's first row, rolled like every
    later carry (zero start when None)."""
    H = C.shape[-3]
    L = (C.new_zeros((len(comps),) + C.shape[:-3] + C.shape[-2:])
         if carry is None else carry)
    for i in range(H):
        rolled = torch.stack([_roll_cols(L[j], roll)
                              for j, (_, roll, _) in enumerate(comps)])
        c = torch.stack([C[..., H - 1 - i if up else i, :, :]
                         for _, _, up in comps])
        L = _sgm_step(rolled, c, P1, P2)
        for j, (slot, _, up) in enumerate(comps):
            out[slot, ..., H - 1 - i if up else i, :, :] = L[j]


def _sum_plain(L):
    """L[0] + L[1] + ... + L[n-1], left to right."""
    S = L[0] + L[1]
    for j in range(2, L.shape[0]):
        S = S + L[j]
    return S


def _aggregate(C, P1, P2, paths, directions=None, carry=None, out=None):
    """Sum of SGM path aggregations over 4 or 8 directions (plain twin).

    C : (..., H, W, D) float32 cost volume, any leading frame axes.

    The scans of one axis run stacked, as in the JAX function: the
    horizontal forward and backward scans share one loop over columns, the
    vertical and diagonal ones one loop over rows (a diagonal is a vertical
    scan whose carry is rolled by one column each step). Each path's L is
    kept whole, so the sum is taken in ``_aggregate``'s order.

    ``directions`` "horizontal", "down" or "up" runs that family only,
    each direction's L into its buffer of ``out`` ((4 or 8, ...) + C's
    shape, made when None) and returns ``out``; ``carry`` (directions of
    the family, ..., W, D) starts the downward or upward scans from a
    carried row (see the module's docstring).
    """
    rolls = (0, 1, -1) if paths >= 8 else (0,)
    k = len(rolls)
    if directions is None:
        if carry is not None:
            raise ValueError("a carry needs directions='down' or 'up'")
        L = C.new_empty((2 + 2 * k,) + C.shape)
        _horizontal(C, P1, P2, L)
        _vertical(C, P1, P2, [(2 + 2 * j + up, rolls[j], up)
                              for j in range(k) for up in (0, 1)], None, L)
        return _sum_plain(L)
    dir0, _, _ = _family(directions, paths)
    if out is None:
        out = C.new_empty((2 + 2 * k,) + C.shape)
    if directions == "horizontal":
        if carry is not None:
            raise ValueError("the horizontal scans take no carry")
        _horizontal(C, P1, P2, out)
    else:
        _vertical(C, P1, P2, [(dir0 + 2 * j, rolls[j], dir0 == 3)
                              for j in range(k)], carry, out)
    return out


def carry_of(L, directions, paths):
    """The rows a family's scans hand the next tile: each downward
    direction's L at the tile's last row, or each upward one's at its first
    row. (directions of the family, ..., W, D), contiguous."""
    dir0, n, step = _family(directions, paths)
    if directions == "horizontal":
        raise ValueError("the horizontal scans carry nothing across tiles")
    row = L.shape[-3] - 1 if directions == "down" else 0
    return L[dir0:dir0 + n * step:step, ..., row, :, :].clone(
        memory_format=torch.contiguous_format)


def _check_volume(C):
    if C.dim() not in (3, 4):
        raise ValueError(f"C must be (H, W, D) or (B, H, W, D), got shape "
                         f"{tuple(C.shape)}")
    if C.numel() == 0:
        raise ValueError(f"C must not be empty, got shape {tuple(C.shape)}")
    if C.dtype != torch.float32:
        raise ValueError(f"C must be float32, got {C.dtype}")
    if not C.is_contiguous():
        raise ValueError("C must be contiguous")


def _check_family(C, paths, directions, carry, out):
    """Validate (and make) the workspace ``out`` and the ``carry`` of a
    family call; returns ``out``."""
    _, n, _ = _family(directions, paths)
    shape = ((8 if paths >= 8 else 4),) + tuple(C.shape)
    if out is None:
        out = torch.empty(shape, dtype=C.dtype, device=C.device)
    if (tuple(out.shape) != shape or out.dtype != torch.float32
            or not out.is_contiguous() or out.device != C.device):
        raise ValueError(f"out must be a contiguous float32 {shape} tensor "
                         f"on {C.device}")
    if carry is not None:
        want = (n,) + tuple(C.shape[:-3]) + tuple(C.shape[-2:])
        if (tuple(carry.shape) != want or carry.dtype != torch.float32
                or not carry.is_contiguous() or carry.device != C.device):
            raise ValueError(f"carry must be a contiguous float32 {want} "
                             f"tensor on {C.device}")
    return out


def aggregate(C, P1, P2, paths, plan=None, *, directions=None, carry=None,
              out=None):
    """SGM path sum S of the cost volume C, the same shape as C.

    C : (H, W, D) or (B, H, W, D) float32, contiguous, D innermost.
    P1, P2 : float penalties. paths : 8 for 8 directions, fewer for 4.

    ``directions`` "horizontal", "down" or "up": that family's L, each
    direction into its buffer of ``out`` (a contiguous (4 or 8,) + C.shape
    workspace, made when None), which is returned; ``carry`` (k, ...,
    W, D), the row before the first row of the downward (upward) scans. See
    the module's docstring and :func:`sum_paths`.

    A CUDA tensor launches the kernels as ``plan`` lays them out (default
    :func:`_plan` of this call's shapes; a stack of more frames than a
    launch takes runs in pieces) and adds one to ``launches`` for the
    whole call; a CPU tensor runs the twin :func:`_aggregate`; any other
    device raises.
    """
    global launches
    _check_volume(C)
    if directions is not None:
        out = _check_family(C, paths, directions, carry, out)
    elif carry is not None:
        raise ValueError("a carry needs directions='down' or 'up'")
    if C.device.type == "cpu":
        return _aggregate(C, P1, P2, paths, directions, carry, out)
    if C.device.type != "cuda":
        raise ValueError(f"no SGM kernel for device {C.device}")

    dev = C.device
    B = C.shape[0] if C.dim() == 4 else 1
    H, W, D = C.shape[-3:]
    if directions is not None:
        return _scan_family(C, P1, P2, paths, plan, directions, carry, out)
    if plan is None:
        plan = _plan(B, H, W, D, paths)
    S = torch.empty_like(C)
    work = (torch.empty(plan["workspace"] // 4, dtype=torch.float32,
                        device=dev) if plan["workspace"] else None)
    vec = plan["vec"] and C.data_ptr() % 16 == 0
    mode = MODES.index(plan["mode"])
    frame = H * W * D * 4
    for b0, b1 in _build.frame_pieces(B, plan["frames"]):
        LIBRARY.launch(
            "sgm_aggregate", dev,
            C.data_ptr() + b0 * frame, S.data_ptr() + b0 * frame,
            None if work is None else work.data_ptr(), b1 - b0, H, W, D,
            float(P1), float(P2), 8 if paths >= 8 else 4, mode,
            plan["npl"], plan["group"], int(vec),
            what="SGM kernel launch failed")
    launches += 1
    return S


def _scan_family(C, P1, P2, paths, plan, directions, carry, out):
    """The kernel side of ``aggregate(..., directions=...)``: one launch of
    the line kernel for the family's directions (the first version, one
    launch a direction, for D > 256), frames in pieces of 65,535."""
    global launches
    dev = C.device
    B = C.shape[0] if C.dim() == 4 else 1
    H, W, D = C.shape[-3:]
    if plan is None:
        plan = _plan(B, H, W, D, paths,
                     mode=None if D <= LINES_D_MAX else "generic")
    dir0, n, step = _family(directions, paths)
    vec = (plan["vec"] and C.data_ptr() % 16 == 0
           and out.data_ptr() % 16 == 0)
    frame = H * W * D
    for b0, b1 in _build.frame_pieces(B, _build.GRID_YZ_MAX):
        LIBRARY.launch(
            "sgm_scan", dev,
            C.data_ptr() + b0 * frame * 4,
            out.data_ptr() + (dir0 * B + b0) * frame * 4,
            None if carry is None else carry.data_ptr() + b0 * n * W * D * 4,
            b1 - b0, H, W, D, float(P1), float(P2), dir0, n, step,
            step * B * frame, plan["npl"], plan["group"], int(vec),
            what="SGM kernel launch failed")
    launches += 1
    return out


def sum_paths(L):
    """S = L[0] + L[1] + ... + L[n-1], left to right: the path sum of a
    workspace that :func:`aggregate` filled family by family, in
    ``_aggregate``'s order. A CUDA tensor runs the kernel's sum (one
    launch, counted in ``launches``); a CPU tensor the plain sum."""
    global launches
    if (L.dim() < 4 or L.shape[0] < 2 or L.dtype != torch.float32
            or not L.is_contiguous()):
        raise ValueError(f"L must be a contiguous float32 (n >= 2, ..., H, "
                         f"W, D) tensor, got {L.dtype} {tuple(L.shape)}")
    if L.device.type == "cpu":
        return _sum_plain(L)
    if L.device.type != "cuda":
        raise ValueError(f"no SGM kernel for device {L.device}")
    dev = L.device
    S = torch.empty_like(L[0])
    vol = L[0].numel()
    LIBRARY.launch("sgm_sum", dev, L.data_ptr(), S.data_ptr(), vol, vol,
                   L.shape[0], what="SGM kernel launch failed")
    launches += 1
    return S


def _check_grays(gray1, gray2, num_disp, block_size, block_max, kernels,
                 rows):
    """Raise ValueError for what a cost kernel pair does not take: gray
    images that are not two non-empty float32 (..., H, W) tensors of one
    shape on one CUDA card, a block size that is even or above
    ``block_max``, num_disp below 1, and ``rows`` other than None or a (2,)
    int32 tensor on the card. ``kernels`` names the pair."""
    if gray1.shape != gray2.shape or gray1.dim() < 2 or gray1.numel() == 0:
        raise ValueError(f"gray images must be two non-empty (..., H, W) "
                         f"tensors of one shape, got {tuple(gray1.shape)} "
                         f"and {tuple(gray2.shape)}")
    if gray1.dtype != torch.float32 or gray2.dtype != torch.float32:
        raise ValueError(f"gray images must be float32, got {gray1.dtype} "
                         f"and {gray2.dtype}")
    if not (1 <= block_size <= block_max and block_size % 2 == 1
            and num_disp >= 1):
        raise ValueError(f"block size must be odd, 1 to {block_max}, "
                         f"and num_disp positive, got {block_size}, "
                         f"{num_disp}")
    dev = gray1.device
    if dev.type != "cuda" or gray2.device != dev:
        raise ValueError(f"the {kernels} kernels take CUDA tensors on one "
                         f"card, got {dev} and {gray2.device}")
    if rows is not None and (rows.shape != (2,) or rows.dtype != torch.int32
                             or rows.device != dev):
        raise ValueError(f"rows must be a (2,) int32 tensor on {dev}, got "
                         f"{tuple(rows.shape)} {rows.dtype} on {rows.device}")


def census_cost(gray1, gray2, min_disp, num_disp, census_window,
                block_size, rows=None):
    """Box-summed census Hamming cost of two (..., H, W) float32 gray
    stacks on a CUDA card: (..., H, W, num_disp) float32, contiguous, D
    innermost, equal bit for bit to ``sgm._box_sum(sgm._census_cost(gray1,
    gray2, min_disp, num_disp, census_window), block_size)``.

    ``rows``: None, or a (2,) int32 tensor on the card holding the first
    and last row the box may read; a row outside them reads the nearest of
    the two, as ``sgm._edge_fill_rows`` fills the cost's rows outside a
    row-tiled block's valid rows.

    Launches the census kernels and adds one to ``census_launches``.
    Raises ValueError for tensors off the card, of other shapes or types,
    a window other than 3, 5 or 7, and a block size that is even or above
    ``CENSUS_BLOCK_MAX``.
    """
    global census_launches
    if census_window not in CENSUS_WINDOWS:
        raise ValueError(f"census window must be 3, 5 or 7, got "
                         f"{census_window}")
    _check_grays(gray1, gray2, num_disp, block_size, CENSUS_BLOCK_MAX,
                 "census", rows)
    dev = gray1.device
    lead, (H, W) = gray1.shape[:-2], gray1.shape[-2:]
    B, D = math.prod(lead), num_disp
    g1 = gray1.reshape(B, H, W).contiguous()
    g2 = gray2.reshape(B, H, W).contiguous()
    codes = torch.empty((B, 2, H, W), dtype=torch.int64, device=dev)
    C = torch.empty((B, H, W, D), dtype=torch.float32, device=dev)
    frame = H * W
    for b0, b1 in _build.frame_pieces(B, _build.GRID_YZ_MAX):
        LIBRARY.launch(
            "sgm_census_cost", dev,
            g1.data_ptr() + b0 * frame * 4, g2.data_ptr() + b0 * frame * 4,
            None if rows is None else rows.data_ptr(),
            codes.data_ptr() + b0 * 2 * frame * 8,
            C.data_ptr() + b0 * frame * D * 4, b1 - b0, H, W, min_disp, D,
            census_window, block_size, what="census kernel launch failed")
    census_launches += 1
    return C.reshape(*lead, H, W, D)


def bt_cost(gray1, gray2, min_disp, num_disp, prefilter_cap, block_size,
            rows=None):
    """Box-summed Birchfield-Tomasi cost of two (..., H, W) float32 gray
    stacks on a CUDA card: (..., H, W, num_disp) float32, contiguous, D
    innermost, equal bit for bit to ``sgm._box_sum(sgm._bt_cost(
    sgm._xsobel(gray1, cap), sgm._xsobel(gray2, cap), min_disp,
    num_disp), block_size)`` with cap ``prefilter_cap`` (see
    ``csrc/sgm_kernel.cu`` for the float order that keeps it so).

    ``rows``: as :func:`census_cost`'s, the rows the box may read
    (``sgm._edge_fill_rows`` before the box).

    Launches the BT kernels and adds one to ``bt_launches`` once the
    launches have succeeded. Raises ValueError for tensors off the card,
    of other shapes or types, and a block size that is even or above
    ``BT_BLOCK_MAX``.
    """
    global bt_launches
    _check_grays(gray1, gray2, num_disp, block_size, BT_BLOCK_MAX, "BT",
                 rows)
    dev = gray1.device
    lead, (H, W) = gray1.shape[:-2], gray1.shape[-2:]
    B, D = math.prod(lead), num_disp
    g1 = gray1.reshape(B, H, W).contiguous()
    g2 = gray2.reshape(B, H, W).contiguous()
    planes = torch.empty((B, 2, 3, H, W), dtype=torch.float32, device=dev)
    C = torch.empty((B, H, W, D), dtype=torch.float32, device=dev)
    frame = H * W
    for b0, b1 in _build.frame_pieces(B, _build.GRID_YZ_MAX):
        LIBRARY.launch(
            "sgm_bt_cost", dev,
            g1.data_ptr() + b0 * frame * 4, g2.data_ptr() + b0 * frame * 4,
            None if rows is None else rows.data_ptr(),
            planes.data_ptr() + b0 * 6 * frame * 4,
            C.data_ptr() + b0 * frame * D * 4, b1 - b0, H, W, min_disp, D,
            block_size, float(prefilter_cap),
            what="BT kernel launch failed")
    bt_launches += 1
    return C.reshape(*lead, H, W, D)


def _post_plan(D):
    """(nj, group) of the post kernel for D candidates: ``group`` lanes a
    pixel (8 up to D = 128, then 16 and 32) and ``nj`` candidates a lane in
    registers, the least of ``POST_NJ`` with group * nj >= D; nj 0 (read
    from S at each use, 32 lanes) above ``POST_D_MAX``."""
    if D > POST_D_MAX:
        return 0, 32
    group = 8 if D <= 8 * POST_NJ[-1] else 16 if D <= 16 * POST_NJ[-1] else 32
    return next(n for n in POST_NJ if group * n >= D), group


def post(S, min_disp, num_disp, uniqueness, disp12_max_diff, subpixel):
    """Winner-take-all, uniqueness, subpixel and the left-right check of a
    (..., H, W, D) float32 path sum S on a CUDA card: the (..., H, W)
    int16 map x16 of ``sgm._sgm_post``, equal to its twin
    ``sgm._sgm_post_plain`` bit for bit, from one launch that reads S once
    (see ``csrc/sgm_kernel.cu``).

    Adds one to ``post_launches`` once the launches have succeeded; an
    empty map launches nothing and counts nothing. Raises ValueError for
    S off the card, of another type, of fewer than 3 axes or with D other
    than ``num_disp``.
    """
    global post_launches
    if S.dtype != torch.float32 or S.dim() < 3 or S.shape[-1] != num_disp:
        raise ValueError(f"S must be a float32 (..., H, W, {num_disp}) "
                         f"tensor, got {S.dtype} {tuple(S.shape)}")
    if S.device.type != "cuda":
        raise ValueError(f"the post kernel takes a CUDA tensor, got "
                         f"{S.device}")
    dev = S.device
    lead, (H, W, D) = S.shape[:-3], S.shape[-3:]
    B = math.prod(lead)
    out = torch.empty((*lead, H, W), dtype=torch.int16, device=dev)
    if out.numel() == 0:
        return out
    S = S.contiguous()
    lr = disp12_max_diff >= 0
    # |dr - d| <= disp12_max_diff of whole numbers, as a C int
    lr_max = min(math.floor(disp12_max_diff), 2**31 - 1) if lr else -1
    keys = disps = None
    if W * (2 + 12 * lr) > POST_SMEM_MAX:
        keys = torch.empty(min(B, _build.GRID_YZ_MAX) * H * W,
                           dtype=torch.int64, device=dev)
        disps = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    nj, group = _post_plan(D)
    frame = H * W
    for b0, b1 in _build.frame_pieces(B, _build.GRID_YZ_MAX):
        LIBRARY.launch(
            "sgm_post", dev,
            S.data_ptr() + b0 * frame * D * 4, out.data_ptr() + b0 * frame * 2,
            None if keys is None else keys.data_ptr(),
            None if disps is None else disps.data_ptr(), b1 - b0, H, W, D,
            min_disp, 100.0 + uniqueness, int(uniqueness > 0), lr_max,
            int(subpixel), nj, group, what="SGM post kernel launch failed")
    post_launches += 1
    return out
