"""
profiling
=========

Observability for the dense pipelines, the port of
:mod:`simplestereo_tpu.profiling` on ``torch.profiler``:

- :func:`trace` - context manager around ``torch.profiler.profile`` (CPU
  and, on a CUDA device, CUDA activities) writing a TensorBoard-loadable
  trace (kernel-level timeline, copies, host ranges) and a standalone
  Chrome/Perfetto JSON.
- :class:`annotate` - a span: labels a host region in the profiler's
  timeline and, with a card, as an NVTX range for Nsight Systems. While no
  profiler records it is a flag check (and the NVTX pair with a card): it
  enters no ``record_function`` and makes no dispatcher call.
- :func:`setup_spans` - the spans kept in memory that no profiler sees,
  because none runs then: the package's ``import``.
- :class:`Throughput` - wall-clock throughput meter; time *full host
  readbacks* of each result inside :meth:`Throughput.measure`, so the time
  covers the device's work and not only its dispatch.
- :func:`device_memory` - current per-device allocation stats.

Example
-------
>>> meter = Throughput("asw", unit="Mpix*disp")
>>> for left, right in frames:
...     with meter.measure(H * W * D / 1e6):
...         out = matcher.compute(left, right)   # numpy out: a readback
>>> print(meter.report())   # {"median_s": ..., "Mpix*disp_per_s": ...}

Spans of the matchers' calls, nested on the calling thread: each
``compute``/``computeBatch`` of ``StereoASW`` and ``StereoSGM`` opens
``upload``, ``match`` and ``readback``; inside ``match`` the glue before
and after the matcher's kernel runs in ``asw.planes`` and ``asw.finish``
(ASW) or ``sgm.cost`` and ``sgm.post`` (SGM).
"""

import contextlib
import functools
import os
import shutil
import socket
import time

import numpy as np
import torch

from ._device import resolve_device

# The Chrome/Perfetto JSON that trace(perfetto=True) writes into logdir.
PERFETTO_FILE = "perfetto_trace.json"


@contextlib.contextmanager
def trace(logdir, perfetto=True, *, device="cuda"):
    """Profile the enclosed block with ``torch.profiler.profile``.

    Writes ``<host>_<pid>.<ms>.pt.trace.json`` into ``logdir``, the name
    ``torch.profiler.tensorboard_trace_handler`` gives a trace, so
    TensorBoard's profiler plugin loads it (``tensorboard --logdir
    <logdir>``); with ``perfetto=True`` (default) also ``logdir/``
    :data:`PERFETTO_FILE`, the same events as a standalone JSON for
    ui.perfetto.dev or chrome://tracing. :class:`annotate` ranges are
    recorded. ``device`` decides the activities: CUDA ones for a CUDA
    device, which raises without a card, as the matchers do.

    Yields the ``torch.profiler.profile`` object (``key_averages()``,
    ``events()``), which holds the events once the block has ended.
    """
    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = os.path.join(
        str(logdir), f"{socket.gethostname()}_{os.getpid()}."
        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    if perfetto:
        shutil.copyfile(path, os.path.join(str(logdir), PERFETTO_FILE))


@functools.cache
def _nvtx():
    """Whether spans also push NVTX ranges: decided once, at the first
    span, as whether a card is present."""
    return torch.cuda.is_available()


class annotate:
    """Span: ``with annotate(name):`` labels the enclosed host code region
    as a ``torch.profiler.record_function`` range while a profiler
    records on this thread, and, with a card, always as an NVTX range for
    Nsight Systems. Spans nest: the enclosing span is the parent.

    While no profiler records, entering and leaving costs one flag check
    (``torch._C._autograd._profiler_enabled``), plus the NVTX push and pop
    with a card: no ``record_function`` is made, so no dispatcher call and
    no allocation.
    """

    __slots__ = ("name", "_range")

    def __init__(self, name):
        self.name = name
        self._range = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if _nvtx():
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc):
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


# Finished set-up spans, (name, start, end) in time.perf_counter seconds.
_setup_spans = []


def setup_spans():
    """Set-up spans kept in memory: ``[(name, start_s, end_s)]`` on
    ``time.perf_counter``'s clock. Today one, ``"import"``: the package's
    ``__init__`` from its first statement to its last, which holds
    ``import torch`` unless the caller imported it first. No profiler runs
    while the package is imported, so these spans are in no profiler
    trace."""
    return list(_setup_spans)


class Throughput:
    """Throughput meter: median wall-clock over measured units of work."""

    def __init__(self, name, unit="items"):
        self.name = name
        self.unit = unit
        self.samples = []  # (seconds, units)

    @contextlib.contextmanager
    def measure(self, units=1.0):
        t0 = time.perf_counter()
        yield
        self.samples.append((time.perf_counter() - t0, float(units)))

    def report(self):
        if not self.samples:
            return {"name": self.name, "samples": 0}
        ts = np.array([s for s, _ in self.samples])
        us = np.array([u for _, u in self.samples])
        med = float(np.median(ts))
        return {
            "name": self.name,
            "samples": len(ts),
            "median_s": round(med, 6),
            f"{self.unit}_per_s": round(float(np.median(us / ts)), 3),
            "total_s": round(float(ts.sum()), 6),
        }


def device_memory():
    """Per-device memory stats: one entry per CUDA device (``bytes_in_use``
    from ``memory_allocated``, ``peak_bytes_in_use`` from
    ``max_memory_allocated``, ``bytes_limit`` the card's total from
    ``mem_get_info``), or, with no card, one ``"cpu"`` entry of ``None``s
    (the host's allocator keeps no such counts)."""
    if not torch.cuda.is_available():
        return {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None,
                        "bytes_limit": None}}
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out


__all__ = ["trace", "annotate", "setup_spans", "Throughput", "device_memory"]
