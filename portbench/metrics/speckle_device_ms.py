"""speckle_device_ms: device time a call, in ms, of the speckle filter's
kernels (``speckle_roofline.NAMES``), where SGM filters on the card
(``speckle_cuda.filter_speckles``). None where the trace holds none of
them: a program that filters on the host, or not at all."""

from portbench.metrics.speckle_roofline import NAMES


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.kernel_s(NAMES) / t.calls
    return seconds * 1e3 if seconds else None
