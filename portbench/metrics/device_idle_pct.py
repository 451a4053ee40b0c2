"""device_idle_pct: 100 minus the share of the profiled calls' wall time
in which the device ran a kernel, a copy or a memset (the union of their
intervals). None where the trace holds no device activity."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
