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
"""

import torch

from .. import _build

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


def _aggregate(C, P1, P2, paths):
    """Sum of SGM path aggregations over 4 or 8 directions (plain twin).

    C : (..., H, W, D) float32 cost volume, any leading frame axes.

    The scans of one axis run stacked, as in the JAX function: the
    horizontal forward and backward scans share one loop over columns, the
    vertical and diagonal ones one loop over rows (a diagonal is a vertical
    scan whose carry is rolled by one column each step). Each path's L is
    kept whole, so the sum is taken in ``_aggregate``'s order.
    """
    H, W, D = C.shape[-3:]
    # Horizontal: column x of the forward scan and column W-1-x of the
    # backward one in the same step; carry (2, ..., H, D).
    L = C.new_zeros((2,) + C.shape[:-2] + (D,))
    oh = C.new_empty((2,) + C.shape)
    for x in range(W):
        L = _sgm_step(L, torch.stack([C[..., x, :], C[..., W - 1 - x, :]]),
                      P1, P2)
        oh[0, ..., x, :] = L[0]
        oh[1, ..., W - 1 - x, :] = L[1]
    S = oh[0] + oh[1]
    del oh

    # Vertical and diagonal: row i of the downward scans and row H-1-i of
    # the upward ones; carry (2k, ..., W, D), component j rolled by
    # rolls[j % k] columns before each step.
    rolls = (0, 1, -1) if paths >= 8 else (0,)
    k = len(rolls)
    L = C.new_zeros((2 * k,) + C.shape[:-3] + (W, D))
    ov = C.new_empty((2 * k,) + C.shape)
    for i in range(H):
        rolled = torch.stack([_roll_cols(L[j], rolls[j % k])
                              for j in range(2 * k)])
        c = torch.stack([C[..., i, :, :]] * k + [C[..., H - 1 - i, :, :]] * k)
        L = _sgm_step(rolled, c, P1, P2)
        ov[:k, ..., i, :, :] = L[:k]
        ov[k:, ..., H - 1 - i, :, :] = L[k:]
    for j in range(k):
        S = S + ov[j]
        S = S + ov[k + j]
    return S


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


def aggregate(C, P1, P2, paths, plan=None):
    """SGM path sum S of the cost volume C, the same shape as C.

    C : (H, W, D) or (B, H, W, D) float32, contiguous, D innermost.
    P1, P2 : float penalties. paths : 8 for 8 directions, fewer for 4.

    A CUDA tensor launches the kernels as ``plan`` lays them out (default
    :func:`_plan` of this call's shapes; a stack of more frames than a
    launch takes runs in pieces) and adds one to ``launches`` for the
    whole call; a CPU tensor runs the twin :func:`_aggregate`; any other
    device raises.
    """
    global launches
    _check_volume(C)
    if C.device.type == "cpu":
        return _aggregate(C, P1, P2, paths)
    if C.device.type != "cuda":
        raise ValueError(f"no SGM kernel for device {C.device}")

    dev = C.device
    B = C.shape[0] if C.dim() == 4 else 1
    H, W, D = C.shape[-3:]
    if plan is None:
        plan = _plan(B, H, W, D, paths)
    S = torch.empty_like(C)
    work = (torch.empty(plan["workspace"] // 4, dtype=torch.float32,
                        device=dev) if plan["workspace"] else None)
    vec = plan["vec"] and C.data_ptr() % 16 == 0
    mode = MODES.index(plan["mode"])
    frame = H * W * D * 4
    lib = _build.load_library("sgm_kernel")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b0, b1 in _build.frame_pieces(B, plan["frames"]):
        err = lib.sgm_aggregate(
            C.data_ptr() + b0 * frame, S.data_ptr() + b0 * frame,
            None if work is None else work.data_ptr(), b1 - b0, H, W, D,
            float(P1), float(P2), 8 if paths >= 8 else 4, mode,
            plan["npl"], plan["group"], int(vec), dev.index, stream)
        if err != 0:
            raise RuntimeError("SGM kernel launch failed: "
                               + lib.sgm_error_string(err).decode())
    launches += 1
    return S
