"""readback_wait_ms: host time a call, in ms, inside the span ``readback``:
the call's wait for the device to finish its maps, plus their copy to the
host. None where the trace holds no ``readback`` span."""

from portbench.harness import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.host_ms(ctx.trace, "readback")
