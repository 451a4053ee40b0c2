"""The profiled calls of a ``--trace 1`` run, reduced to what the
per-layer metrics and the breakdown read.

The events are those of ``torch.profiler``'s Chrome trace (complete
events, ``ph == "X"``, times in microseconds). Each profiled call is a
``record_function`` range named :data:`CALL_RANGE`; the window is the
first call's start to the last call's end. The device is busy where a
kernel, copy or memset runs: the union of those intervals (the arithmetic
of the port's ``chip_smoke.trace_summary``, copied). An idle gap is
labelled by the innermost host event that covers its middle.
"""

import bisect
import json
import os
import re
import tempfile

CALL_RANGE = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
BETWEEN_CALLS = "harness, between calls"
IN_CALL = "python, inside the call"
TOP = 10


def short(name):
    """A device event's name cut to its function and template arguments."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void ", "", n).replace("at::native::", "")
    return n.split("(", 1)[0].strip()[:80]


def union(intervals, lo, hi):
    """Merged, sorted [(a, b)] of ``intervals`` clipped to [lo, hi]."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps(busy, lo, hi):
    """The parts of [lo, hi] that the merged intervals ``busy`` leave."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


class Trace:
    """Events of the profiled calls. ``events``: dicts with ``cat``,
    ``name``, ``ts`` and ``dur`` (us)."""

    def __init__(self, events):
        calls = [e for e in events if e.get("cat") == "user_annotation"
                 and e["name"] == CALL_RANGE]
        if not calls:
            raise ValueError(f"the trace holds no {CALL_RANGE!r} range")
        self.calls = len(calls)
        self.lo = min(e["ts"] for e in calls)
        self.hi = max(e["ts"] + e["dur"] for e in calls)
        inside = lambda e: e["ts"] < self.hi and e["ts"] + e["dur"] > self.lo  # noqa: E731
        self.device = [e for e in events
                       if e.get("cat") in DEVICE_CATS and inside(e)]
        self.host = sorted((e for e in events
                            if e.get("cat") in HOST_CATS and inside(e)),
                           key=lambda e: e["ts"])
        self._host_ts = [e["ts"] for e in self.host]

    def _clipped_us(self, e):
        return min(e["ts"] + e["dur"], self.hi) - max(e["ts"], self.lo)

    @property
    def window_s(self):
        return (self.hi - self.lo) / 1e6

    def busy(self):
        """Merged intervals (us) in which the device ran something."""
        return union([(e["ts"], e["ts"] + e["dur"]) for e in self.device],
                     self.lo, self.hi)

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy()) / 1e6

    def kernels(self):
        return [e for e in self.device if e["cat"] == "kernel"]

    def kernel_s(self, names, others=False):
        """Seconds of the kernels whose name holds one of ``names`` (with
        ``others``, of the kernels whose name holds none of them)."""
        return sum(self._clipped_us(e) for e in self.kernels()
                   if any(n in e["name"] for n in names) != others) / 1e6

    def copy_s(self):
        """Seconds of host-to-device and device-to-host copies."""
        return sum(self._clipped_us(e) for e in self.device
                   if e["cat"] == "gpu_memcpy"
                   and ("HtoD" in e["name"] or "DtoH" in e["name"])) / 1e6

    def label(self, t):
        """What the host was doing at ``t``: the innermost host event
        that covers it. Host events nest, so that is the last one to
        start before ``t`` that has not ended."""
        for i in range(bisect.bisect_right(self._host_ts, t) - 1, -1, -1):
            e = self.host[i]
            if e["ts"] + e["dur"] > t:
                return IN_CALL if e["name"] == CALL_RANGE else e["name"]
        return BETWEEN_CALLS

    def breakdown(self):
        """{"device_ops": [[name, s]], "idle_gaps": [[label, s]]}: the
        device operations that took most time, and the idle time summed
        by what the host was doing, the largest first."""
        ops = {}
        for e in self.device:
            k = short(e["name"])
            ops[k] = ops.get(k, 0.0) + self._clipped_us(e) / 1e6
        idle = {}
        for a, b in gaps(self.busy(), self.lo, self.hi):
            k = self.label((a + b) / 2)
            idle[k] = idle.get(k, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def from_profiler(prof):
    """:class:`Trace` of a finished ``torch.profiler.profile``: its
    Chrome trace is written under the temporary directory, read and
    deleted."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace([e for e in events if e.get("ph") == "X"])
