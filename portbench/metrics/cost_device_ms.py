"""cost_device_ms: device time a call, in ms, of the kernels launched in
the matcher's cost glue: the spans ``asw.planes`` (ASW's Lab and BGR
planes before K1) and ``sgm.cost`` (SGM's luma, census cost and box sum
before K2). A kernel belongs to the innermost of the matchers' spans over
its launch (``harness/spans.py``). None where the trace holds neither
span."""

from portbench.harness import spans

SPANS = ("asw.planes", "sgm.cost")


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.kernel_ms(ctx.trace, SPANS)
