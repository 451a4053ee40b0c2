"""k2_roofline: K2's bound over K2's device time a call, in %.

K2 is the port's SGM path aggregation (``sgm_cuda.aggregate`` ->
``csrc/sgm_kernel.cu``): the kernels in :data:`KERNELS`. Its bound (the
count of the port's ``chip_smoke.py``, frozen here): the cost volume C
read once and the path sum S written once, float32, and per (path,
pixel, candidate) the recurrence's 7 min and add operations and 1 add
into S, at the card's float32 and memory peaks.
"""

from portbench.harness import roofline

KERNELS = ("sgm_lines_kernel", "sgm_sum_kernel", "sgm_path_kernel")
OPS_PER_PATH_PIXEL_CAND = 8


def count(params, H, W, frames):
    """(operations, bytes) of K2 on ``frames`` volumes of H x W."""
    D = params["numDisparities"]
    paths = 8 if params.get("paths", 8) >= 8 else 4
    ops = OPS_PER_PATH_PIXEL_CAND * paths * H * W * D
    nbytes = 2 * H * W * D * 4
    return frames * ops, frames * nbytes


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.kernel_s(KERNELS) / t.calls
    if not seconds:
        return None
    H, W = ctx.cell.shape
    ops, nbytes = count(ctx.cell.config["params"], H, W,
                        ctx.cell.pairs_per_call)
    return roofline.share_pct(ops, nbytes, ctx.kind, seconds)
