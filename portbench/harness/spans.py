"""The port's own spans in a traced run, read from the same trace as the
device's events and on the same clock.

``simplestereo_tpu_torch.profiling.annotate`` opens a span as a
``record_function`` range (``cat == "user_annotation"``) on the calling
thread; the matchers' spans nest, so the innermost one that covers an
instant is the last of them to start before it that has not ended. A
device event is put down to the span its launch was issued in: its
``args.correlation`` names the runtime or driver call that launched it,
and the innermost span of :data:`HOT` that covers that call's start is
its span. A launch that no span of :data:`HOT` covers belongs to none.

Every reader returns ``None`` where the trace holds none of the spans it
reads: the program that is measured may have none (the readers then say
nothing rather than 0).
"""

import bisect

from .trace import gaps

# The spans of the matchers' calls (the port's ``profiling`` docstring):
# per call, upload, match and readback; inside match, the glue before the
# matcher's kernel and after it.
HOT = ("upload", "match", "readback", "asw.planes", "asw.finish",
       "sgm.cost", "sgm.post")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def spans(trace, names=HOT):
    """Host spans named in ``names``, sorted by start."""
    return [e for e in trace.host
            if e["cat"] == "user_annotation" and e["name"] in names]


def intervals(trace, name):
    """[(start, end)] (us) of the spans ``name``, clipped to the window."""
    return [(max(e["ts"], trace.lo), min(e["ts"] + e["dur"], trace.hi))
            for e in spans(trace, (name,))]


def innermost(hot, starts, t):
    """The innermost span of ``hot`` (sorted by start, ``starts`` their
    starts) that covers ``t``, or None."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if hot[i]["ts"] + hot[i]["dur"] > t:
            return hot[i]
    return None


def kernel_ms(trace, names):
    """Device ms a call of the kernels launched inside a span of
    ``names`` (the innermost span of :data:`HOT` over the launch), or None
    where the trace holds no span of ``names`` or no kernel."""
    if not trace.kernels() or not spans(trace, names):
        return None
    hot = spans(trace)
    starts = [e["ts"] for e in hot]
    launches = {e["args"]["correlation"]: e for e in trace.host
                if e["cat"] in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    us = 0.0
    for k in trace.kernels():
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None:
            continue
        span = innermost(hot, starts, launch["ts"])
        if span is not None and span["name"] in names:
            us += (min(k["ts"] + k["dur"], trace.hi)
                   - max(k["ts"], trace.lo))
    return us / 1e3 / trace.calls


def overlap_us(a, b):
    """Total length (us) shared by two sorted lists of disjoint
    intervals."""
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            total += min(hi, b[k][1]) - max(lo, b[k][0])
            k += 1
    return total


def idle_in_ms(trace, name):
    """Device idle ms a call while the host is inside a span ``name``: the
    gaps of the busy union (as ``device_idle_pct`` takes them) inside the
    spans, or None where the trace holds no such span or no device
    work."""
    inside = intervals(trace, name)
    if not inside or not trace.device:
        return None
    idle = gaps(trace.busy(), trace.lo, trace.hi)
    return overlap_us(idle, inside) / 1e3 / trace.calls


def host_ms(trace, name):
    """Host ms a call inside a span ``name``, or None where the trace
    holds none."""
    inside = intervals(trace, name)
    if not inside:
        return None
    return sum(b - a for a, b in inside) / 1e3 / trace.calls
