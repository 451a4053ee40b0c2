"""idle_in_match_ms: device idle time a call, in ms, while the host is
inside the span ``match`` (the matcher's launches, from its numpy entry):
the gaps of the union of kernel, copy and memset intervals, as
``device_idle_pct`` takes them, that fall inside ``match``. It is what a
CUDA graph or a fusion of the glue could take back; the idle time outside
``match`` (the upload, the readback, the client) is not. None where the
trace holds no ``match`` span or no device work."""

from portbench.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.idle_in_ms(ctx.trace, "match")
