"""One run of one cell: set-up, the measured window, the trace, the check.

The client is a closed loop: it hands the entry one call's inputs (numpy
BGR, one pair or a stack) and waits for the numpy maps before it sends
the next call. Consecutive calls take consecutive inputs of a pool drawn
at set-up from the seed, so no two consecutive calls see the same pair.

``setup_s`` runs from the process's start to the first timed call: the
imports, the card's context, the scenes, the matcher, and one call on
each of the first two inputs (the first loads the cell's kernel, and
builds it in a fresh checkout). The window then runs for ``seconds``:
every call in it is timed on the host clock, from the call to the numpy
maps in hand. With ``trace`` a fixed count of steady calls inside the
window runs under ``torch.profiler``.

Once the window has closed, the peak memory read and the program's
objects dropped, the plain reference recomputes the maps of a sample of
the window's calls (reservoir-sampled with the seed) from the same
inputs, and the worst map's share of differing pixels is held to the
configuration's limit.
"""

import gc
import sys
import time
import traceback
import types

import numpy as np
import torch

from . import scenes
from . import trace as tracing


def rngs(seed):
    """(scene rng, sample rng): two streams of one seed."""
    scene, sample = np.random.SeedSequence(int(seed) % 2**64).spawn(2)
    return np.random.default_rng(scene), np.random.default_rng(sample)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn with ``rng``
    (Algorithm R): the sample does not depend on how many calls the
    window turns out to hold."""

    def __init__(self, k, rng):
        self.k, self.rng, self.items = k, rng, []

    def offer(self, i, item):
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = item


def worst_map_mismatch_pct(got, want):
    """Largest share (%) of pixels in which a map of ``got`` differs from
    the same map of ``want``; 100 where the shapes or dtypes differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return 100.0
    return float(max((g != w).mean() for g, w in zip(got, want)) * 100.0)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell, seed, seconds, trace, device, t0, log=None):
    """One run of ``cell``; ``t0`` is the process's start
    (``time.perf_counter``). Returns the result's fields: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` (``platform`` and
    ``kind`` left to the caller), ``breakdown`` (traced runs) and
    ``checks``."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    traffic = cell.traffic
    per_call = cell.pairs_per_call
    H, W = cell.shape
    stamps = [time.perf_counter()]
    scene_rng, sample_rng = rngs(seed)
    pool = scenes.pool(scene_rng, W, H, traffic["scene"],
                       int(traffic["pool_pairs"]), per_call)
    stamps.append(time.perf_counter())
    compute, compute_batch = cell.entry().make(cell.config, dev)
    call = compute if per_call == 1 else compute_batch

    for left, right in pool[:2]:  # every shape the window uses
        call(left, right)
    _sync(dev)
    if trace:  # the profiler's own first start stays out of the window
        with torch.profiler.profile(activities=_activities(dev)):
            call(*pool[0])
            _sync(dev)
    stamps.append(time.perf_counter())
    gc.collect()
    gc.freeze()  # the set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s: before the cell {stamps[0] - t0:.3f}, "
        f"scenes {stamps[1] - stamps[0]:.3f}, matcher and warm calls "
        f"{stamps[2] - stamps[1]:.3f}")

    skip = int(traffic["trace_skip"]) if trace else -1
    n_traced = int(traffic["trace_calls"])
    kept = Reservoir(int(traffic["check_calls"]), sample_rng)
    lat, failed, traced, prof = [], 0, None, None
    start = time.perf_counter()
    i = 0
    while True:
        if i == skip:
            prof = torch.profiler.profile(activities=_activities(dev))
            prof.__enter__()
        left, right = pool[i % len(pool)]
        with torch.profiler.record_function(tracing.CALL_RANGE):
            ta = time.perf_counter()
            try:
                out = call(left, right)
            except Exception:  # a map that never comes: counted, judged
                out = None
                if not failed:
                    log(traceback.format_exc())
            tb = time.perf_counter()
        lat.append(tb - ta)
        if out is None:
            failed += per_call
        else:
            kept.offer(i, (i % len(pool), out))
        i += 1
        if prof is not None and i == skip + n_traced:
            _sync(dev)
            prof.__exit__(None, None, None)
            traced, prof = tracing.from_profiler(prof), None
        if tb - start >= seconds and (not trace or traced is not None):
            break
    window_s = tb - start
    gc.unfreeze()

    _sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del call, compute, compute_batch, out
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = types.SimpleNamespace(
        cell=cell, kind=_kind(dev), trace=traced,
        hand_kernels=cell.bench.hand_kernels(),
        window=types.SimpleNamespace(
            calls=i, results=(i * per_call - failed), window_s=window_s,
            latencies_s=lat, setup_s=setup_s))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.bench.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    value = check(cell, pool, kept.items, dev)
    limit = float(cell.config["limits"]["mismatch_pct"])
    checks = {"mismatch_pct": {"value": value, "limit": limit},
              "failed_maps": {"value": failed, "limit": 0}}
    result = {
        "correct": bool(failed == 0 and kept.items and value <= limit),
        "attempted": i * per_call,
        "failed": failed,
        "metrics": metrics,
        "device": {"count": 1, "memory_peak_bytes": int(peak)},
    }
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    result["checks"] = checks
    return result


def check(cell, pool, kept, dev):
    """Worst map's mismatch (%) between the kept calls' maps and the
    reference's maps of the same inputs."""
    if not kept:
        return 100.0
    lefts, rights, got = stack_kept(cell, pool, kept)
    want = cell.reference().disparity(cell.config, lefts, rights, dev)
    return worst_map_mismatch_pct(got, want)


def stack_kept(cell, pool, kept):
    """(lefts, rights, maps) of the kept calls as (N, H, W[, 3]) arrays,
    in pool order."""
    kept = sorted(kept, key=lambda kv: kv[0])
    one = cell.pairs_per_call == 1
    lefts = np.concatenate([pool[j][0][None] if one else pool[j][0]
                            for j, _ in kept])
    rights = np.concatenate([pool[j][1][None] if one else pool[j][1]
                             for j, _ in kept])
    got = np.concatenate([np.asarray(o)[None] if one else np.asarray(o)
                          for _, o in kept])
    return lefts, rights, got


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _kind(dev):
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
