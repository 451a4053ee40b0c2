"""launches_per_call: device kernels in the profiled calls, divided by the
calls (copies and memsets are not kernels)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels():
        return None
    return len(t.kernels()) / t.calls
