"""
profiling
=========

Observability for the dense pipelines, the port of
:mod:`simplestereo_tpu.profiling` on ``torch.profiler``:

- :func:`trace` - context manager around ``torch.profiler.profile`` (CPU
  and, on a CUDA device, CUDA activities) writing a TensorBoard-loadable
  trace (kernel-level timeline, copies, host ranges) and a standalone
  Chrome/Perfetto JSON.
- :func:`annotate` - labels a host region in the profiler's timeline and,
  with a card, as an NVTX range for Nsight Systems.
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
"""

import contextlib
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
    ui.perfetto.dev or chrome://tracing. :func:`annotate` ranges are
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


@contextlib.contextmanager
def annotate(name):
    """Label the enclosed host code region in profiler timelines
    (``torch.profiler.record_function``) and, with a card, as an NVTX
    range."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


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


__all__ = ["trace", "annotate", "Throughput", "device_memory"]
