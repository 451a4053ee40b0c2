"""k1_roofline: K1's bound over K1's device time a call, in %.

K1 is the port's ASW kernel (``asw_cuda._asw_pass`` ->
``csrc/asw_kernel.cu``): cost and select of the kernels in
:data:`KERNELS`. Its bound is the work that Yoon and Kweon's definition
needs on the call's pairs, whatever implements it (see :func:`count`),
at the card's float32 and memory peaks.
"""

from portbench.harness import roofline

KERNELS = ("asw_cost_tile_kernel", "asw_cost_l1_kernel",
           "asw_select_kernel")

# Operations per (pixel, window offset): the Lab distance of the window
# pixel to the centre in each image (3 sub, 3 mul, 2 add, 1 sqrt; 9 each,
# the target's shared by every candidate that lands on that pixel), its
# scale and exponential in each image (2 each), the proximity weight (1).
PER_OFFSET = 9 + 9 + 2 + 2 + 1
# Per (pixel, window offset, candidate): the weight's product (1), the
# weighted difference's multiply-add into the numerator (2), the weight
# into the denominator (1).
PER_OFFSET_CAND = 4
# Per (pixel, candidate): the truncated colour difference (3 sub, 3 abs,
# 2 add, 1 min), the division (1), the left map's compare (1), and with
# the right map its compare (1).
PER_CAND = 11
# float32 Lab and BGR of both images read once, int32 maps written once.
IN_BYTES_PER_PIXEL = 4 * 12
MAP_BYTES = 4


def count(params, H, W, frames):
    """(operations, bytes) of K1 on ``frames`` pairs of H x W."""
    pad, step = params["winSize"] // 2, params.get("step", 1)
    offsets = (2 * (pad // step) + 1) ** 2
    D = params["maxDisparity"] - params["minDisparity"] + 1
    maps = 2 if params.get("consistent", False) else 1
    ops = H * W * (offsets * (PER_OFFSET + PER_OFFSET_CAND * D)
                   + D * (PER_CAND + maps - 1))
    nbytes = H * W * (IN_BYTES_PER_PIXEL + maps * MAP_BYTES)
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
