"""speckle_roofline: the speckle filter's bound over its kernels' device
time a call, in %.

The kernels are the port's speckle filter on the card
(``speckle_cuda.filter_speckles`` -> ``csrc/speckle_kernel.cu``), the
names in :data:`NAMES`. Its bound: the int16 map read once and the
int16 map written once, at the card's memory peak (the labels and counts
are the design's workspace, and its operations are integer compares and
links, none of them float32): 3.69 MB, 1.10 us a 1280x720 frame.

The names are not declared as ``KERNELS``, which would add them to the
hand kernels that ``glue_device_ms`` leaves out: the accepted benchmark
pins that set to K1's and K2's, so ``glue_device_ms`` counts these
kernels in the cells that run them.
"""

from portbench.harness import roofline

NAMES = ("speckle_local_kernel", "speckle_border_kernel",
         "speckle_roots_kernel", "speckle_write_kernel")


def count(params, H, W, frames):
    """(operations, bytes) of the speckle filter on ``frames`` maps of
    H x W."""
    return 0, frames * 2 * H * W * 2


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.kernel_s(NAMES) / t.calls
    if not seconds:
        return None
    H, W = ctx.cell.shape
    ops, nbytes = count(ctx.cell.config["params"], H, W,
                        ctx.cell.pairs_per_call)
    return roofline.share_pct(ops, nbytes, ctx.kind, seconds)
