"""glue_device_ms: device time a call, in ms, of the kernels that are
neither a hand-written kernel (the names every roofline metric declares)
nor a copy: the torch operations around the hand kernels."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels():
        return None
    return t.kernel_s(ctx.hand_kernels, others=True) * 1e3 / t.calls
