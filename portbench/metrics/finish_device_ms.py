"""finish_device_ms: device time a call, in ms, of the kernels launched in
the matcher's glue after its kernel: the spans ``asw.finish`` (ASW's
empty range, LR check, occlusion fill and subpixel fit after K1) and
``sgm.post`` (SGM's winner, uniqueness, subpixel and LR check after K2).
A kernel belongs to the innermost of the matchers' spans over its launch
(``harness/spans.py``). None where the trace holds neither span."""

from portbench.harness import spans

SPANS = ("asw.finish", "sgm.post")


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.kernel_ms(ctx.trace, SPANS)
