#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels of ``simplestereo_tpu_torch/csrc/`` and the host
libraries of ``simplestereo_tpu_torch/native/`` (one compiler per source,
all started together) and drives the port's main paths:

- ASW: checks the ASW kernel against its plain PyTorch twin on the card
  (and a stack too deep for one launch's grid against the same stack in
  pieces), drives ``StereoASW(35, 14, 4, 15, 17.5, consistent=True).compute`` (the
  Tsukuba-size headline configuration) on synthetic 384x288 and 1280x720
  pairs with a known shift of 5, and times kernel and twin;
- SGM: checks the path-aggregation kernels against their twin on option
  cases and random volumes, in every mode of the launch plan (S
  bit-equal; 70,000 frames too), drives ``StereoSGM(device="cuda").compute`` and
  ``computeBatch`` in the Tsukuba-size census configuration at 384x288 and
  the full-width BT row at 1280x720 with D = 128 on the same synthetic
  pairs, and times kernel (each mode, and the first version), twin and
  ``compute()``;
- GSW: checks the support-weight kernel against its twin on option cases
  (SD, mirrored consistent stack, step, D > 16, negative min_disp, win 1,
  D = 1, normalize, an MI volume, B = 2, a window too large for shared
  memory, every compiled chunk), each on the shared-memory tile path and
  the L1 path, and a 512-frame stack against the same stack in pieces;
  prints the tile kernel's occupancy; drives ``StereoGSW(23, 14, 4, 12.5, 20,
  consistent=True).compute`` and ``computeBatch`` (the tuned Tsukuba-size
  point) at 384x288 and 1280x720, drives the MI cost on a gamma-0.5 pair,
  times kernel, twin and ``compute()``, and profiles ``compute()`` (device
  time against wall time, SD and MI);
- K4, the dynamic-rotate probe: runs the probe's three amount forms at
  (17, 8, 384) on the per-plane roll kernel (all must be exact, "neg"
  included), holds it against numpy, its twin and a ragged shape, checks
  that the ASW kernel's right map equals the argmin of its volume shifted
  by the roll kernel at 384x288 and 1280x720, and times kernel, twin and
  ``torch.gather``;
- the README pipeline at 1280x720: a seeded random rig, a plane of
  constant rectified disparity 9 covered in noise and rendered through
  both distorted cameras, then ``directRectify`` -> ``rectifyImages`` ->
  ``StereoASW(35, 14, 4, 15, 17.5, consistent=True).compute`` ->
  ``get3DPoints`` -> ``exportPLY``/``importPLY``, checked against the CPU
  path, the plane and a float64 reprojection, and timed stage by stage
  (``exportPLY`` through the native writer);
- the native PLY writer and parser on that 1280x720 cloud in four forms,
  byte-identical to ``numpy.savetxt``'s file and equal to
  ``numpy.loadtxt``'s reading, with both timed on the card's host;
- S1, the IIR phase-unwrapping kernel: ``torch.equal`` to its twin on
  five shapes (one row, one column, 33x47, 720p, 1,100 rows), both
  precisions and three taus, and timed against the chain of dependent
  steps; on the FTP phase below, what the main path's launch returned
  ``torch.equal`` to the twin, and both timed there;
- 3-D scanning at 1280x720 on a fixed camera-projector rig with lens
  distortion: a Gray-code scan (42 captures, black and white) rendered
  through a plane on the card, its decode integer-equal to the CPU path,
  the plane recovered, ``GrayCodeDouble`` once and the scan's stages
  timed; FTP on a rendered fringe plane (``getCloud``, ``getCloudBatch``
  against per-frame calls, the IIR unwrapping through S1, the three
  subclasses), timed;
- S2, the WLS smoother's line-solve kernel: ``torch.equal`` to its twin,
  row and column solves, on one line, a one-pixel-wide image, 33x47,
  720p, a stack of 8 and 70,000 frames (two launches; against the stack
  in pieces), with and without invalid markers, lambda 2 and 128; timed
  against the bound and the chain of one line;
- the post-filters at 384x288 and 1280x720: ``quality_disparity``'s SGM
  leg (census 7, D = 128 on K2, then the WLS fill on S2) and ASW leg with
  WLS (K1, then S2), checked against the shift, S2's 6 launches a WLS
  call counted, what K2, K1 and S2 returned on that path held against
  their twins (K1 on the whole map at 384x288, on three bands of rows at
  1280x720), the median equal to the CPU path, and timed by stage;
- calibration at 1280x720: ten chessboard pairs rendered on the card
  through a distorted rig, ``chessboardStereo`` on the card recovering
  it (its detection and BA timed inside that one call), the card's
  corners equal to the CPU path's, the one-card Gauss-Newton on 16
  synthetic views, timed.

Every kernel's JSON record carries ``bound_ms``, the least time the card
could take for the kernel's work at the timed shape: the larger of its
operations over the float32 peak and its bytes (each input read once,
each output written once) over the memory rate.

Every phase prints one line, then a line gives each phase's wall time;
any failed check raises, so the exit code is nonzero and no result line
is printed. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Needs a CUDA card, nvcc, g++ and the repository checkout; imports no
JAX, Pillow or matplotlib.
"""

import contextlib
import inspect
import json
import re
import statistics
import subprocess
import sys
import time

# The port must run without JAX, Pillow and matplotlib.
for _name in ("jax", "PIL", "matplotlib"):
    sys.modules[_name] = None

import numpy as np
import torch

SEED = 0
SHIFT = 5
MAIN = dict(winSize=35, maxDisparity=14, minDisparity=4, gammaC=15,
            gammaP=17.5, consistent=True)
# SGM main path: the Tsukuba-size census configuration (bench.py:402-404)
# at 384x288 and the full-width BT row (bench.py:489-492) at 1280x720.
SGM_MAIN = [
    ((288, 384), dict(minDisparity=0, numDisparities=16, blockSize=3, P1=120,
                      P2=480, uniquenessRatio=0, costMethod="census",
                      censusWindow=7)),
    ((720, 1280), dict(numDisparities=128, blockSize=3, P1=36, P2=144,
                       preFilterCap=15, uniquenessRatio=0)),
]
# bench.py:441-444, a stack of 8 frames at 384x288.
SGM_BATCH8 = dict(minDisparity=0, numDisparities=16, blockSize=3, P1=36,
                  P2=144, preFilterCap=15, uniquenessRatio=0)
# Option cases of the SGM kernel at a size that is not a multiple of 32 in
# any axis. Kernel and twin do the same min/add steps in the same order,
# so S must be bit-equal.
SGM_CASES = [
    dict(numDisparities=3, blockSize=1, paths=4),
    dict(numDisparities=11, blockSize=5, costMethod="census", censusWindow=7),
    dict(minDisparity=-4, numDisparities=16, costMethod="bt+census",
         disp12MaxDiff=1),
    dict(numDisparities=40, uniquenessRatio=10),
    dict(numDisparities=16, paths=4, costMethod="census", censusWindow=7,
         disp12MaxDiff=1, uniquenessRatio=10),
    dict(numDisparities=11, costMethod="bt+census", censusWindow=7,
         disp12MaxDiff=1, B=2),
]
# Cases of the SGM kernels on random integer volumes (B, H, W, D, paths),
# each on every plan mode that takes it: one disparity a lane (D 1), two
# lines a warp (D 16), two and eight disparities a lane (D 40, 130; 130 is
# not a multiple of 4: scalar loads), four with 16-byte loads (D 100), B 2, the first
# version for D > 256, and a stack of 70,000 frames (past grid y's 65,535).
SGM_KERNEL_CASES = [
    (1, 45, 150, 1, 8), (1, 45, 150, 16, 8), (2, 45, 150, 16, 4),
    (1, 45, 150, 40, 8), (1, 37, 101, 100, 8), (1, 45, 150, 130, 8),
    (2, 45, 150, 300, 8), (70_000, 2, 3, 1, 8),
]
# Kernel vs plain twin: the same inf pattern; rtol on finite costs (the
# kernel multiplies two expf where the twin takes one exp of the sum, and
# sums in another order); argmin maps may flip on near-ties.
RTOL = 2e-5
MISMATCH = 0.01
# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet): float32 outside
# the tensor cores, and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# GSW main path: the tuned Tsukuba point of bench.py:513-514 (`gsw`); the
# MI stage of bench.py:553-555 (`gsw_mi`).
GSW_MAIN = dict(winSize=23, maxDisparity=14, minDisparity=4, gamma=12.5,
                fMax=20, iterations=1, consistent=True)
# The two frame sizes of the GSW phases: Tsukuba's and 720p.
GSW_SHAPES = [(288, 384), (720, 1280)]
GSW_MI = dict(winSize=23, maxDisparity=14, minDisparity=4, gamma=12.5,
              costMethod="mi", bins=24, miIterations=3, consistent=True)
# Share of the MI map's interior that must equal the shift on the
# gamma-0.5 pair at 384x288, and share of the card's map that must equal
# the CPU path's (same pair, same bootstrap field; near-ties may flip).
# The CPU path recovers 99.29% there; phase 13 prints its share beside
# the card's.
MI_BAR = 0.98
MI_AGREE = 0.99
# Option cases of the GSW kernel at 45x150; every range holds the pair's
# true shift (see CASES). "mi": the kernel aggregates a prebuilt MI volume
# (ext_vol). Window 111 does not fit a block's tile in shared memory, so
# its window reads go to device memory. The normalize case is not capped
# (fMax 500): capped noise costs normalize to fMax within a few ulps, and
# their order would be noise.
GSW_CASES = [
    dict(win_size=7, min_disp=1, max_disp=6),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True),
    dict(win_size=9, min_disp=1, max_disp=6, consistent=True, step=2),
    dict(win_size=5, min_disp=0, max_disp=20, consistent=True),
    dict(win_size=5, min_disp=-3, max_disp=16, consistent=True),
    dict(win_size=1, min_disp=1, max_disp=6, consistent=True),
    dict(win_size=5, min_disp=5, max_disp=5),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True,
         normalize=True, f_max=500.0),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True, mi=True),
    dict(win_size=7, min_disp=4, max_disp=14, consistent=True, B=2),
    dict(win_size=111, min_disp=1, max_disp=6, consistent=True),
    dict(win_size=7, min_disp=0, max_disp=15, consistent=True),
    dict(win_size=9, min_disp=2, max_disp=5, consistent=True, normalize=True,
         f_max=500.0),
    dict(win_size=5, min_disp=2, max_disp=14, consistent=True, mi=True),
]
# The grid-limit cases: a stack whose grid would pass CUDA's 65,535 blocks
# (GSW: 256 consistent frames = 512 on the stack, D = 128, so the L1
# path's volume launch would need 65,536 blocks in z; ASW: 6,000 frames x
# 11 chunks of 12 disparities = 66,000), at 8x140 and win 5. Each is held
# bit-equal to the same stack run in two pieces.
GSW_DEEP = dict(B=256, h=8, w=140, win_size=5, min_disp=0, max_disp=127)
ASW_DEEP = dict(B=6000, h=8, w=140, win_size=5, min_disp=0, max_disp=127)
# Option cases of the kernel, at a small ragged size (45x150, not a
# multiple of the (32, 8) tile, unless the case says otherwise): lattice
# step 2 and 3, D over one chunk of 12 disparities (18, 20, 41),
# negative min_disp, sub-pixel neighbourhood, a frame batch, a window of
# 111 (wider than the tile: a 142-column halo, the chunk drops to 4 to
# fit), B = 2 at 37x101. Every range holds the pair's true shift: without
# it every TAD of a noise pair hits the cap, all costs tie to the last ulp
# and the argmin is noise. Each case runs the shared-memory tile kernel
# and the L1 kernel (the path of a window too wide for any tile).
CASES = [
    dict(win_size=7, min_disp=1, max_disp=6, consistent=False),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True, step=2),
    dict(win_size=7, min_disp=0, max_disp=17, consistent=True),
    dict(win_size=5, min_disp=-3, max_disp=16, consistent=True),
    dict(win_size=5, min_disp=1, max_disp=6, consistent=False, subpixel=True),
    dict(win_size=9, min_disp=4, max_disp=14, consistent=True, subpixel=True,
         B=2),
    dict(win_size=111, min_disp=1, max_disp=6, consistent=True),
    dict(win_size=7, min_disp=0, max_disp=40, consistent=True),
    dict(win_size=9, min_disp=1, max_disp=6, consistent=True, step=3),
    dict(win_size=5, min_disp=2, max_disp=8, consistent=True, subpixel=True,
         B=2, h=37, w=101),
]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def calls_of(module, name):
    """Within the block, every call of ``module.name`` goes through and is
    kept in the list this yields, as (its arguments by parameter name,
    result, seconds on the host clock)."""
    real = getattr(module, name)
    bind = inspect.signature(real).bind
    seen = []

    def spy(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        seen.append((bind(*args, **kwargs).arguments, out,
                     time.perf_counter() - t0))
        return out

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def pair(h, w, seed=SEED):
    """Synthetic pair with true disparity SHIFT, as bench.py builds it."""
    left = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return left, np.roll(left, -SHIFT, axis=1)


def compare_pass(k, p, min_disp, where):
    """Kernel outputs k vs plain outputs p, both (cost, dispL, dispR, csub).
    Costs: the same inf pattern, RTOL on finite entries. Maps: at most
    MISMATCH differ, and each pixel that differs is a near-tie: the plain
    volume's cost at the kernel's pick is within 2*RTOL of its minimum.
    Returns (max abs err, max rel err, worst map mismatch)."""
    from simplestereo_tpu_torch.passive.asw_cuda import _right_volume
    kc, pc = k[0], p[0]
    check(torch.equal(torch.isinf(kc), torch.isinf(pc)),
          f"{where}: inf pattern differs")
    fin = torch.isfinite(pc)
    diff = (kc[fin] - pc[fin]).abs()
    abs_err = diff.max().item()
    rel_err = (diff / pc[fin].abs().clamp(min=1e-30)).max().item()
    check(rel_err <= RTOL, f"{where}: cost rel err {rel_err:.3g} > {RTOL}")
    mism = 0.0
    for km, pm, name in ((k[1], p[1], "dispL"), (k[2], p[2], "dispR")):
        check((km is None) == (pm is None), f"{where}: {name} presence")
        if km is None:
            continue
        bad = km != pm
        m = bad.double().mean().item()
        check(m <= MISMATCH, f"{where}: {name} mismatch {m:.2%}")
        mism = max(mism, m)
        if bad.any():
            vol = pc if name == "dispL" else _right_volume(pc, min_disp)
            at = lambda d: torch.gather(vol, 1, (d - min_disp).long()[:, None])
            ck, cp = at(km)[:, 0][bad], at(pm)[:, 0][bad]
            gap = ((ck - cp).abs() / cp.abs().clamp(min=1e-30)).max().item()
            check(gap <= 2 * RTOL, f"{where}: {name} flip with cost gap "
                  f"{gap:.3g}, not a near-tie")
    if k[3] is not None:
        agree = (k[1] == p[1])[:, None].expand_as(k[3])
        ks, ps = k[3][agree], p[3][agree]
        check(torch.equal(torch.isinf(ks), torch.isinf(ps)),
              f"{where}: csub inf pattern differs")
        f = torch.isfinite(ps)
        rel = ((ks[f] - ps[f]).abs() / ps[f].abs().clamp(min=1e-30)).max()
        check(rel.item() <= RTOL, f"{where}: csub rel err {rel.item():.3g}")
    return abs_err, rel_err, mism


def kernel_name(symbol):
    """'name<template args>' of a mangled kernel symbol: the first
    length-prefixed name that is not nvcc's anonymous namespace, and the
    integer and bool template arguments after it."""
    pos = 3 if symbol.startswith("_ZN") else 2
    while True:
        m = re.match(r"\d+", symbol[pos:])
        if m is None:
            return symbol
        n = int(m.group(0))
        name = symbol[pos + len(m.group(0)):pos + len(m.group(0)) + n]
        pos += len(m.group(0)) + n
        if not name.startswith("_GLOBAL__N"):
            break
    args = re.match(r"I((?:L[ib]\d+E)+)E", symbol[pos:])
    if args is None:
        return name
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', args.group(1)))}>"


def ptxas_summary(log):
    """'kernel<template args> registers/spill stores' for each kernel of an
    nvcc -Xptxas -v log."""
    out, name, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            out.append(f"{name} {m.group(1)}/{spill}")
            name, spill = None, "?"
    return ", ".join(out)


def short(kernel):
    """A device event's name cut to its function."""
    return re.sub(r"^void |\(anonymous namespace\)::|at::native::|\(.*$",
                  "", kernel)[:36].strip()


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of operations over the float32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, inputs):
    """Median CUDA-event ms of fn over inputs[1:] (inputs[0] warms up)."""
    fn(inputs[0])
    torch.cuda.synchronize()
    ts = []
    for x in inputs[1:]:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts), ts


def queued_ms(fn, inputs):
    """CUDA-event ms per call of fn over inputs[1:], all queued behind a
    sleep on the stream (inputs[0] warms up). The calls then run back to
    back, so this is the device's time for a call without the host's
    dispatch, which a lone call's events also hold (it dominates a call of
    a few microseconds)."""
    fn(inputs[0])
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms at the SM clock: the host queues
    a.record()
    for x in inputs[1:]:
        fn(x)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (len(inputs) - 1)


def host_ms(fn, inputs):
    """Median host-clock ms of fn(*x) over inputs[1:] (inputs[0] warms up),
    and the number of timed calls."""
    fn(*inputs[0])
    ts = []
    for x in inputs[1:]:
        t0 = time.perf_counter()
        fn(*x)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), len(ts)


def profile_ms(fn, inputs, top=3):
    """torch.profiler over fn(*x) for x in inputs[1:] (inputs[0] warms up).
    Per call: device ms (kernels and copies, summed), device events, wall
    ms of the profiled run; and the `top` device events by time, ms per
    call each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*inputs[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x in inputs[1:]:
            fn(*x)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = len(inputs) - 1
    by_name = {}
    events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
            events += 1
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return sum(by_name.values()), events / n, wall / n, heavy


def sgm_phases(dev, card):
    """Phases 7-10: the SGM kernel against its twin, the SGM main path in
    both configurations, and times. Returns the kernel's JSON record."""
    from simplestereo_tpu_torch.passive import StereoSGM, sgm, sgm_cuda

    def args(m, *keys):
        kw = m._kwargs(subpixel=True)
        return {k: kw[k] for k in keys}

    def volume(m, l, r):
        """Cost volume of (B, H, W, 3) uint8 stacks on the card."""
        return sgm._cost_from_gray(
            sgm._gray_frames(torch.tensor(l, device=dev)),
            sgm._gray_frames(torch.tensor(r, device=dev)),
            **args(m, "min_disp", "num_disp", "block_size", "prefilter_cap",
                   "cost_method", "census_window")).contiguous()

    def post(m, S):
        return sgm._sgm_post(S, **args(m, "min_disp", "num_disp",
                                       "uniqueness", "disp12_max_diff",
                                       "subpixel"))

    def plan_of(C, paths, mode):
        B = C.shape[0] if C.dim() == 4 else 1
        return sgm_cuda._plan(B, *C.shape[-3:], paths, mode=mode)

    # ---- phase 7: kernel vs twin, every option case ---------------------
    for case in SGM_CASES:
        kw = dict(case)
        B = kw.pop("B", 1)
        m = StereoSGM(device="cuda", **kw)
        rng = np.random.default_rng(SEED + 2)
        l = rng.integers(0, 256, (B, 45, 150, 3), np.uint8)
        C = volume(m, l, np.roll(l, -SHIFT, axis=2))
        if B == 1:
            C = C[0]  # the (H, W, D) form of the wrapper
        p = sgm_cuda._aggregate(C, float(m.P1), float(m.P2), m.paths)
        for mode in sgm_cuda.MODES:
            n0 = sgm_cuda.launches
            k = sgm_cuda.aggregate(C, m.P1, m.P2, m.paths, plan=plan_of(
                C, m.paths, mode))
            torch.cuda.synchronize()
            check(sgm_cuda.launches == n0 + 1, f"SGM case {case} {mode}: "
                  "launch not counted")
            check(torch.equal(k, p), f"SGM case {case} {mode}: S differs "
                  f"from the twin, max abs err "
                  f"{(k - p).abs().max().item():.3g}")
            check(torch.equal(post(m, k), post(m, p)),
                  f"SGM case {case} {mode}: final maps differ")
    rng = np.random.default_rng(SEED + 5)
    ran = set()
    for B, h, w, D, paths in SGM_KERNEL_CASES:
        C = torch.tensor(rng.integers(0, 200, (B, h, w, D)).astype(
            np.float32), device=dev)
        p = sgm_cuda._aggregate(C, 12.0, 40.0, paths)
        for mode in sgm_cuda.MODES if D <= sgm_cuda.LINES_D_MAX else (
                "generic",):
            plan = plan_of(C, paths, mode)
            k = sgm_cuda.aggregate(C, 12.0, 40.0, paths, plan=plan)
            torch.cuda.synchronize()
            check(torch.equal(k, p), f"SGM kernel case {(B, h, w, D)} "
                  f"{mode}: S differs from the twin, max abs err "
                  f"{(k - p).abs().max().item():.3g}")
            ran.add((mode, plan["npl"], plan["vec"], plan["frames"] < B))
        del C, p
    check({r[0] for r in ran} == set(sgm_cuda.MODES)
          and {r[1] for r in ran} == {0, *sgm_cuda.NPL}
          and any(r[2] for r in ran) and any(r[3] for r in ran),
          f"phase 7 ran {sorted(ran)}")
    print(f"phase 7 SGM kernel vs twin on {len(SGM_CASES)} option cases at "
          f"45x150 (paths 4/8, D 3/11/16/40, min_disp -4, blockSize 1/3/5, "
          f"bt/census 7/bt+census, LR 1, uniqueness 10, B 2) and "
          f"{len(SGM_KERNEL_CASES)} volume cases (D 1/16 packed/40/100/130/"
          f"300, B 2, 70,000 frames in two launches), each in every mode "
          f"(sequential, concurrent, generic): S torch.equal, maps equal, "
          f"launch count +1 per call | {card}")

    # ---- phases 8-9: the main path --------------------------------------
    launches_main = None
    e2e = {}
    for phase, ((h, w), cfg) in zip((8, 9), SGM_MAIN):
        m = StereoSGM(device="cuda", **cfg)
        left, right = pair(h, w)
        lefts = np.stack([np.roll(left, i, axis=0) for i in range(8)])
        rights = np.stack([np.roll(right, i, axis=0) for i in range(8)])
        sgm_cuda.launches = 0
        d = m.compute(left, right)
        batch = m.computeBatch(lefts, rights)
        per = [m.compute(lefts[i], rights[i]) for i in range(8)]
        n = sgm_cuda.launches
        check(d.shape == (h, w) and d.dtype == np.int16, f"SGM {h}x{w}: "
              "shape")
        interior = d[8:-8, 16:-8].astype(np.float32) / 16.0
        frac = float((np.abs(interior - SHIFT) <= 0.5).mean())
        check(frac >= 0.98, f"SGM {h}x{w}: only {frac:.2%} of interior "
              f"within 0.5 px of {SHIFT}")
        check(n == 10, f"SGM {h}x{w}: {n} kernel launches, expected 10")
        for i in range(8):
            check(np.array_equal(batch[i], per[i]),
                  f"SGM {h}x{w}: batch frame {i} differs from per-frame")
        if launches_main is None:
            launches_main = n
        del batch, per
        # end to end per frame: numpy in, numpy out, distinct inputs
        e2e[(h, w)], n_e2e = host_ms(m.compute, list(zip(lefts, rights)))
        D = cfg["numDisparities"]
        print(f"phase {phase} SGM main path {w}x{h} D={D} "
              f"{cfg.get('costMethod', 'bt')}: {frac:.2%} of interior within "
              f"0.5 px of {SHIFT}, launches {n}, batch of 8 bit-equal to "
              f"per-frame, compute() median {e2e[(h, w)]:.2f} ms/frame end "
              f"to end (host clock, n={n_e2e}) | {card}")
        torch.cuda.empty_cache()

    # ---- phase 10: times ------------------------------------------------
    def volumes(m, h, w, B, n):
        left, right = pair(h, w)
        out = []
        for i in range(n):
            rows = [i * B + j for j in range(B)]
            ls = np.stack([np.roll(left, r, axis=0) for r in rows])
            rs = np.stack([np.roll(right, r, axis=0) for r in rows])
            C = volume(m, ls, rs)
            out.append(C[0] if B == 1 else C)
        return out

    def rate(h, w, D, B, ms):
        return h * w * D * B / (ms * 1e-3) / 1e6

    times = {}
    for (h, w), cfg in SGM_MAIN:
        m = StereoSGM(device="cuda", **cfg)
        D = cfg["numDisparities"]
        vols = volumes(m, h, w, 1, 6)
        run_k = lambda C: sgm_cuda.aggregate(C, m.P1, m.P2, m.paths)
        run_p = lambda C: sgm_cuda._aggregate(C, float(m.P1), float(m.P2),
                                              m.paths)
        plan = sgm_cuda._plan(1, h, w, D, m.paths)
        k_ms, _ = cuda_ms(run_k, vols)
        p_ms, _ = cuda_ms(run_p, vols[:3])
        k, p = run_k(vols[0]), run_p(vols[0])
        err = (k - p).abs().max().item()
        check(torch.equal(k, p), f"SGM {w}x{h} D={D}: kernel S differs from "
              f"the twin at the main-path shape, max abs err {err:.3g}")
        del k, p
        # Each mode, in turns around the plan's (first version = PR 2's
        # kernel, the generic path).
        modes = {}
        for mode in ("generic", "sequential", "concurrent", "sequential",
                     "generic"):
            run = lambda C, mode=mode: sgm_cuda.aggregate(  # noqa: E731
                C, m.P1, m.P2, m.paths, plan=sgm_cuda._plan(
                    1, h, w, D, m.paths, mode=mode))
            modes[mode] = min(modes.get(mode, np.inf), cuda_ms(run, vols)[0])
            torch.cuda.empty_cache()
        # C read once, S written once; per (path, pixel, d) the
        # recurrence's 7 min/add operations and 1 add into S.
        bnd = bound(8 * 8 * h * w * D, 2 * h * w * D * 4)
        # What the plan's design must move: sequential, C 8 times and S
        # read 7 and written 8 times; concurrent, C 8, 8 L buffers written
        # and read, S written once.
        vols_moved = 23 if plan["mode"] == "sequential" else 25
        floor_ms = vols_moved * h * w * D * 4 / PEAK_BYTES * 1e3
        times[(h, w)] = (k_ms, p_ms, err, bnd)
        print(f"phase 10 SGM {w}x{h} D={D}: kernel {k_ms:.3f} ms "
              f"({rate(h, w, D, 1, k_ms):.1f} Mpix*disp/s; plan "
              f"{plan['mode']}, {plan['group']} lanes a line, "
              f"{plan['npl']} disparities a lane; sequential "
              f"{modes['sequential']:.3f}, concurrent "
              f"{modes['concurrent']:.3f}, first version "
              f"{modes['generic']:.3f} ms), twin {p_ms:.1f} ms "
              f"({rate(h, w, D, 1, p_ms):.2f} Mpix*disp/s), bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), the design's traffic floor "
              f"{floor_ms:.4f} ms ({vols_moved} volumes), kernel S "
              f"torch.equal to the twin's; compute() {e2e[(h, w)]:.2f} ms | "
              f"{card}")
        del vols
        torch.cuda.empty_cache()

    m = StereoSGM(device="cuda", **SGM_BATCH8)
    vols = volumes(m, 288, 384, 8, 6)
    b8_ms, _ = cuda_ms(lambda C: sgm_cuda.aggregate(C, m.P1, m.P2, m.paths),
                       vols)
    b8_seq, _ = cuda_ms(lambda C: sgm_cuda.aggregate(
        C, m.P1, m.P2, m.paths, plan=sgm_cuda._plan(
            8, 288, 384, 16, m.paths, mode="sequential")), vols)
    b8_mode = sgm_cuda._plan(8, 288, 384, 16, m.paths)["mode"]
    del vols
    left, right = pair(288, 384)
    stacks = [(np.stack([np.roll(left, i * 8 + j, axis=0) for j in range(8)]),
               np.stack([np.roll(right, i * 8 + j, axis=0)
                         for j in range(8)])) for i in range(6)]
    cb_ms, n_cb = host_ms(m.computeBatch, stacks)
    one_ms, n_one = host_ms(m.compute, [(ls[0], rs[0]) for ls, rs in stacks])
    print(f"phase 10 SGM sgm_batch8 384x288 D=16 bt B=8: kernel "
          f"{b8_ms:.3f} ms (plan {b8_mode}; sequential {b8_seq:.3f} ms; "
          f"{b8_ms / 8:.3f} ms/frame, "
          f"{rate(288, 384, 16, 8, b8_ms):.1f} Mpix*disp/s); computeBatch() "
          f"{cb_ms:.2f} ms ({cb_ms / 8:.3f} ms/frame end to end, host "
          f"clock, n={n_cb}); compute() of one frame {one_ms:.2f} ms "
          f"(n={n_one}) | {card}")

    # Where compute()'s time goes: device time (kernels and copies) against
    # the wall of the same profiled calls, both main configurations.
    parts = []
    for (h, w), cfg in SGM_MAIN:
        m = StereoSGM(device="cuda", **cfg)
        left, right = pair(h, w)
        dev_ms, ev, wall, heavy = profile_ms(m.compute, [
            (np.roll(left, i, axis=0), np.roll(right, i, axis=0))
            for i in range(5)])
        parts.append(
            f"{w}x{h}: device {dev_ms:.3f} ms of {wall:.3f} ms wall per frame "
            f"(busy {dev_ms / wall:.2f}), {ev:.0f} device events; top "
            + ", ".join(f"{short(k)} {v:.3f}" for k, v in heavy))
        torch.cuda.empty_cache()
    print("phase 10c SGM compute() profile (torch.profiler, 4 calls each) | "
          + " | ".join(parts) + f" | {card}")

    k_ms, p_ms, err, (bound_ms, bound_by) = times[SGM_MAIN[0][0]]
    return {"name": "sgm_aggregate", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/sgm_kernel.cu",
            "replaces": "simplestereo_tpu/passive/sgm_pallas.py:72",
            "launches": launches_main, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def gsw_phases(dev, card):
    """Phases 11-14: the GSW kernel against its twin, the GSW main path at
    both sizes, the MI cost, and times. Returns the kernel's JSON record."""
    from simplestereo_tpu_torch.passive import StereoGSW, gsw, gsw_cuda

    def t(a):
        return torch.tensor(a, device=dev)

    def gamma05(img):
        return np.clip(255.0 * (img / 255.0) ** 0.5, 0, 255).astype(np.uint8)

    def sd_planes(ls, rs, win, consistent=True):
        """Planes of (B, H, W, 3) uint8 stacks, mirrored stack included."""
        return gsw_cuda._build_planes(
            *gsw_cuda._directions(t(ls), t(rs), consistent), win)

    def mi_planes(ls, rs, win, min_disp, max_disp, bins, consistent=True):
        """ext_vol planes: BGR(ref) + the MI volume of the bootstrap field."""
        refs, tgts = gsw_cuda._directions(t(ls), t(rs), consistent)
        H, W = refs.shape[1:3]
        disp0 = gsw_cuda._bootstrap(H, W, min_disp, max_disp).to(dev)
        vol = gsw._mi_volume(gsw._quantize_gray(refs, bins),
                             gsw._quantize_gray(tgts, bins),
                             disp0.expand(refs.shape[:3]), min_disp=min_disp,
                             max_disp=max_disp, bins=bins)
        return torch.cat([
            gsw_cuda._pack_planes(refs.permute(0, 3, 1, 2), win,
                                  gsw_cuda.BGR_SENTINEL),
            gsw_cuda._pack_planes(vol, win, 0.0)], dim=1)

    def versus(planes, pkw, where, plain=None):
        """One kernel call against the twin (``plain``: its outputs, if
        computed already) on the same planes."""
        n0 = gsw_cuda.launches
        kd, kc = gsw_cuda._gsw_pass(planes, return_cost=True, **pkw)
        torch.cuda.synchronize()
        check(gsw_cuda.launches == n0 + 1, f"{where}: launch not counted")
        pkw = {k: v for k, v in pkw.items() if k != "plan"}
        pd, pc = plain or gsw_cuda._gsw_pass_plain(planes, return_cost=True,
                                                    **pkw)
        errs = compare_pass((kc, kd, None, None), (pc, pd, None, None),
                            pkw["min_disp"], where)
        return kd, pd, errs

    # ---- phase 11: kernel vs twin, every option case --------------------
    from simplestereo_tpu_torch import _build
    worst = [0.0, 0.0, 0.0]
    ran = set()
    for case in GSW_CASES:
        kw = dict(case)
        B = kw.pop("B", 1)
        cons = kw.pop("consistent", False)
        mi = kw.pop("mi", False)
        f_max = kw.pop("f_max", 20.0)
        h, w = 45, 150
        rng = np.random.default_rng(SEED + 3)
        l = rng.integers(0, 256, (B, h, w, 3), np.uint8)
        r = np.roll(l, -SHIFT, axis=2)
        if mi:
            planes = mi_planes(l, r, kw["win_size"], kw["min_disp"],
                               kw["max_disp"], 16, cons)
            pkw = dict(H=h, W=w, gamma=10.0, f_max=0.0, ext_vol=True, **kw)
        else:
            planes = sd_planes(l, r, kw["win_size"], cons)
            pkw = dict(H=h, W=w, gamma=10.0, f_max=f_max, **kw)
        D = kw["max_disp"] - kw["min_disp"] + 1
        pd, pc = gsw_cuda._gsw_pass_plain(planes, return_cost=True, **pkw)
        fp = gsw_cuda._finish(pd, B, w, kw["min_disp"], cons)
        for budgets in ((gsw_cuda.SMEM_MAX,), ()):
            plan = gsw_cuda._plan(kw["win_size"], kw.get("step", 1), D,
                                  planes.shape[0], h, w, ext_vol=mi,
                                  budgets=budgets)
            where = f"GSW case {case} {plan['path']} path"
            kd, _, errs = versus(planes, dict(pkw, plan=plan), where,
                                 plain=(pd, pc))
            fk = gsw_cuda._finish(kd, B, w, kw["min_disp"], cons)
            m = (fk != fp).double().mean().item()
            check(m <= MISMATCH, f"{where}: final map mismatch {m:.2%}")
            worst = [max(a, b) for a, b in zip(worst, errs)]
            ran.add((plan["path"], plan["nd"], mi))
    check({r[0] for r in ran} == {"tile", "l1"} and {
        r[1] for r in ran if r[0] == "tile"} == set(gsw_cuda.CHUNKS) and {
        (r[0], r[2]) for r in ran} == {("tile", True), ("tile", False),
                                       ("l1", True), ("l1", False)},
          f"phase 11 ran {sorted(ran)}")

    # The grid-limit case, on both paths: one call of the whole stack
    # against the same stack in two calls.
    deep = dict(GSW_DEEP)
    B, h, w = deep.pop("B"), deep.pop("h"), deep.pop("w")
    rng = np.random.default_rng(SEED + 6)
    l = rng.integers(0, 256, (B, h, w, 3), np.uint8)
    planes = sd_planes(l, np.roll(l, -SHIFT, axis=2), deep["win_size"])
    S = planes.shape[0]
    D = deep["max_disp"] - deep["min_disp"] + 1
    pkw = dict(H=h, W=w, gamma=10.0, f_max=20.0, return_cost=True, **deep)
    deep_pieces = []
    for budgets in ((gsw_cuda.SMEM_MAX,), ()):
        plan = gsw_cuda._plan(deep["win_size"], 1, D, S, h, w,
                              budgets=budgets)
        n0 = gsw_cuda.launches
        whole = gsw_cuda._gsw_pass(planes, plan=plan, **pkw)
        torch.cuda.synchronize()
        check(gsw_cuda.launches == n0 + 1, "GSW deep stack: launch not "
              "counted")
        half = [gsw_cuda._gsw_pass(planes[a:b].contiguous(), plan=plan, **pkw)
                for a, b in ((0, S // 2), (S // 2, S))]
        for i, name in enumerate(("map", "cost")):
            check(torch.equal(whole[i], torch.cat([p[i] for p in half])),
                  f"GSW deep stack {plan['path']} path: {name} differs from "
                  f"the stack in pieces")
        deep_pieces.append(f"{plan['path']} {len(_build.frame_pieces(S, plan['frames']))}")
        del whole, half
    del planes
    torch.cuda.empty_cache()

    # The main plan's occupancy.
    mplan = gsw_cuda._plan(GSW_MAIN["winSize"], 1, GSW_MAIN["maxDisparity"]
                           - GSW_MAIN["minDisparity"] + 1, 2, 288, 384)
    regs, spill, blocks = gsw_cuda.occupancy(mplan, device=dev)
    check(mplan["path"] == "tile" and spill == 0 and blocks >= 1,
          f"K3 main plan {mplan}: {regs} registers, {spill} B spilled, "
          f"{blocks} blocks an SM")
    print(f"phase 11 GSW kernel vs twin on {len(GSW_CASES)} option cases at "
          f"45x150 (SD, consistent stack, step 2, D 21, min_disp -3, win 1, "
          f"D 1, normalize, MI ext_vol, B 2, win 111, D 16, D 4 normalize, "
          f"MI D 13), each on the plan's path and the L1 path (tile chunks "
          f"{sorted({r[1] for r in ran if r[0] == 'tile'})}): ok | max abs "
          f"err {worst[0]:.3g}, max rel err {worst[1]:.3g} (rtol {RTOL}), "
          f"worst map mismatch {worst[2]:.4%} (limit {MISMATCH:.0%}), launch "
          f"count +1 per call | {GSW_DEEP['B']} consistent frames ({S} on "
          f"the stack) of {w}x{h}, D={D}: one call bit-equal to two "
          f"(launches a call: {', '.join(deep_pieces)}) | occupancy: main "
          f"plan chunk {mplan['nd']}, {mplan['smem']} B dynamic shared "
          f"memory a block, {regs} registers, {spill} B spilled, {blocks} "
          f"blocks = {blocks * 8} warps resident an SM | {card}")

    # ---- phase 12: the main path ----------------------------------------
    m = StereoGSW(device="cuda", **GSW_MAIN)
    win, lo, hi = (GSW_MAIN[k] for k in ("winSize", "minDisparity",
                                         "maxDisparity"))
    D = hi - lo + 1
    pad = win // 2
    pkw = dict(win_size=win, min_disp=lo, max_disp=hi,
               gamma=float(GSW_MAIN["gamma"]), f_max=float(GSW_MAIN["fMax"]))
    launches_main = None
    e2e = {}
    main_err = {}
    for h, w in GSW_SHAPES:
        left, right = pair(h, w)
        lefts = np.stack([np.roll(left, i, axis=0) for i in range(8)])
        rights = np.stack([np.roll(right, i, axis=0) for i in range(8)])
        gsw_cuda.launches = 0
        d = m.compute(left, right)
        batch = m.computeBatch(lefts, rights)
        per = [m.compute(lefts[i], rights[i]) for i in range(8)]
        n = gsw_cuda.launches
        check(d.shape == (h, w) and d.dtype == np.int16, f"GSW {h}x{w}: "
              "shape")
        frac = float((d[pad:-pad, hi + pad:-pad] == SHIFT).mean())
        check(frac >= 0.95, f"GSW {h}x{w}: only {frac:.2%} of interior is "
              f"{SHIFT}")
        check(n == 10, f"GSW {h}x{w}: {n} kernel calls, expected 10")
        for i in range(8):
            check(np.array_equal(batch[i], per[i]),
                  f"GSW {h}x{w}: batch frame {i} differs from per-frame")
        if launches_main is None:
            launches_main = n
        del batch, per
        e2e[(h, w)], n_e2e = host_ms(m.compute, list(zip(lefts, rights)))
        _, _, main_err[(h, w)] = versus(
            sd_planes(left[None], right[None], win), dict(H=h, W=w, **pkw),
            f"GSW main path {w}x{h}")
        a, r_, mm = main_err[(h, w)]
        print(f"phase 12 GSW main path {w}x{h} win {win} D={D} consistent: "
              f"{frac:.2%} of interior = {SHIFT}, calls {n}, batch of 8 "
              f"bit-equal to per-frame, kernel vs twin max abs err {a:.3g} "
              f"rel {r_:.3g} map mismatch {mm:.4%}, compute() median "
              f"{e2e[(h, w)]:.2f} ms/frame end to end (host clock, "
              f"n={n_e2e}) | {card}")
        torch.cuda.empty_cache()

    # ---- phase 13: the MI cost ------------------------------------------
    (th, tw), (hh, hw) = GSW_SHAPES
    left, right = pair(th, tw)
    g05 = gamma05(right)
    mm_ = StereoGSW(device="cuda", **GSW_MI)
    gsw_cuda.launches = 0
    d = mm_.compute(left, g05)
    n = gsw_cuda.launches
    frac = float((d[pad:-pad, hi + pad:-pad] == SHIFT).mean())
    check(mm_.lastCostMethod == "mi", "MI: cost method not recorded")
    check(n == GSW_MI["miIterations"], f"MI: {n} kernel calls, expected "
          f"{GSW_MI['miIterations']}")
    check(frac >= MI_BAR, f"MI: only {frac:.2%} of interior is {SHIFT} "
          f"(bar {MI_BAR:.0%})")
    cpu = StereoGSW(device="cpu", **GSW_MI).compute(left, g05)
    cpu_frac = float((cpu[pad:-pad, hi + pad:-pad] == SHIFT).mean())
    agree = float((d == cpu).mean())
    check(agree >= MI_AGREE, f"MI: only {agree:.2%} of the card's map "
          f"equals the CPU path's")
    auto = StereoGSW(device="cuda", **dict(GSW_MI, costMethod="auto"))
    auto.compute(left, g05)
    check(auto.lastCostMethod == "mi", "auto did not resolve to mi on the "
          "gamma-0.5 pair")
    auto.compute(left, right)
    check(auto.lastCostMethod == "sd", "auto did not resolve to sd on the "
          "matched pair")
    g05s = [(np.roll(left, i, axis=0), np.roll(g05, i, axis=0))
            for i in range(6)]
    mi_e2e, n_mi = host_ms(mm_.compute, g05s)
    print(f"phase 13 GSW MI {tw}x{th} bins 24, 3 iterations, consistent, "
          f"gamma-0.5 right image: {frac:.2%} of interior = {SHIFT} (bar "
          f"{MI_BAR:.0%}; the CPU path {cpu_frac:.2%}, its map {agree:.2%} equal "
          f"to the card's), calls {n}; auto "
          f"-> mi on it, sd on the matched pair; compute() median "
          f"{mi_e2e:.2f} ms/frame (host clock, n={n_mi}) | {card}")

    # ---- phase 14: times --------------------------------------------------
    def stacks(h, w, B, n, gamma=False):
        left, right = pair(h, w)
        if gamma:
            right = gamma05(right)
        return [(np.stack([np.roll(left, i * B + j, axis=0)
                           for j in range(B)]),
                 np.stack([np.roll(right, i * B + j, axis=0)
                           for j in range(B)])) for i in range(n)]

    def rate(h, w, B, ms):
        return h * w * D * B / (ms * 1e-3) / 1e6

    def run(h, w, **kw):
        return lambda p: gsw_cuda._gsw_pass(p, H=h, W=w, **dict(pkw, **kw))

    tsu = [sd_planes(ls, rs, win) for ls, rs in stacks(th, tw, 1, 11)]
    k_ms, _ = cuda_ms(run(th, tw), tsu)
    p_ms, _ = cuda_ms(lambda p: gsw_cuda._gsw_pass_plain(
        p, H=th, W=tw, **pkw), tsu[:4])
    # 2 frames (both directions) x pixels x lattice offsets x (10 + 2*D):
    # the Pallas cost estimate's count (gsw_pallas.py:318); planes read
    # once, both maps written once.
    bound_ms, bound_by = bound(
        2 * th * tw * win * win * (10 + 2 * D),
        tsu[0].numel() * 4 + 2 * th * tw * 4)
    del tsu
    abs_err, rel_err, mism = main_err[(th, tw)]
    print(f"phase 14a GSW {tw}x{th} win {win} D={D} consistent (2 frames): "
          f"kernel {k_ms:.3f} ms ({rate(th, tw, 1, k_ms):.1f} "
          f"Mpix*disp/s per frame pair), twin {p_ms:.1f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); compute() {e2e[(th, tw)]:.2f} "
          f"ms | {card}")
    hd = [sd_planes(ls, rs, win) for ls, rs in stacks(hh, hw, 1, 6)]
    hd_ms, _ = cuda_ms(run(hh, hw), hd)
    hd_bound, hd_by = bound(2 * hh * hw * win * win * (10 + 2 * D),
                            hd[0].numel() * 4 + 2 * hh * hw * 4)
    del hd
    b8 = [sd_planes(ls, rs, win) for ls, rs in stacks(th, tw, 8, 6)]
    b8_ms, _ = cuda_ms(run(th, tw), b8)
    del b8
    mi = [mi_planes(ls, rs, win, lo, hi, GSW_MI["bins"])
          for ls, rs in stacks(th, tw, 1, 6, gamma=True)]
    mi_ms, _ = cuda_ms(run(th, tw, f_max=0.0, ext_vol=True), mi)
    _, _, mi_err = versus(mi[0], dict(H=th, W=tw, f_max=0.0, ext_vol=True,
                                      **{k: v for k, v in pkw.items()
                                         if k != "f_max"}),
                          f"GSW MI ext_vol {tw}x{th}")
    del mi
    print(f"phase 14b GSW kernel {hw}x{hh} (2 frames): {hd_ms:.3f} ms "
          f"({rate(hh, hw, 1, hd_ms):.1f} Mpix*disp/s), bound "
          f"{hd_bound:.4f} ms ({hd_by}), compute() {e2e[(hh, hw)]:.2f} "
          f"ms; gsw_batch8 {tw}x{th} B=8 (16 frames, one call): {b8_ms:.3f} "
          f"ms ({b8_ms / 8:.3f} ms/frame pair); MI ext_vol {tw}x{th} (2 "
          f"frames): {mi_ms:.3f} ms, vs twin max rel err {mi_err[1]:.3g} map "
          f"mismatch {mi_err[2]:.4%} | {card}")

    # Where compute()'s time goes: device time (kernels and copies) against
    # the wall of the same profiled calls, for SD and MI at 384x288.
    parts = []
    for name, matcher, tgt in (("SD", m, right), ("MI", mm_, g05)):
        dev_ms, ev, wall, heavy = profile_ms(matcher.compute, [
            (np.roll(left, i, axis=0), np.roll(tgt, i, axis=0))
            for i in range(5)])
        parts.append(
            f"{name}: device {dev_ms:.3f} ms of {wall:.3f} ms wall per frame "
            f"(busy {dev_ms / wall:.2f}), {ev:.0f} device events; top "
            + ", ".join(f"{short(k)} {v:.3f}" for k, v in heavy))
    print(f"phase 14c GSW compute() profile {tw}x{th} (torch.profiler, 4 "
          f"calls each) | " + " | ".join(parts) + f" | {card}")

    return {"name": "gsw_pass", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/gsw_kernel.cu",
            "replaces": "simplestereo_tpu/passive/gsw_pallas.py:99",
            "launches": launches_main, "max_abs_err": abs_err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# Phase 16: the README pipeline on a seeded random 1280x720 rig, drawn as
# tests/test_rectification.py draws them, looking at a plane covered in
# noise whose rectified disparity is PLANE_DISP (inside 4..14) everywhere.
RIG_SEED = 40
PLANE_DISP = 9.0
PIPE_SHAPE = (720, 1280)
# Share of the valid interior whose disparity must lie within 1 px of the
# plane's true rectified disparity; bound on the card's cloud against a
# float64 numpy reprojection of the same map, relative to each point's
# distance from the camera (a coordinate near 0 has no relative error to
# speak of: x - cx cancels in float32).
PLANE_BAR = 0.90
CLOUD_RTOL = 1e-5


def random_rig_args(seed=RIG_SEED):
    """A random 1280x720 rig: modest rotation, mostly-x baseline, distinct
    intrinsics, small distortion on both cameras."""
    from simplestereo_tpu_torch.geometry import npgeom
    rng = np.random.default_rng(seed)
    f1 = rng.uniform(700, 1500)
    f2 = f1 * rng.uniform(0.9, 1.1)
    K1 = np.array([[f1, 0, rng.uniform(600, 680)],
                   [0, f1 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    K2 = np.array([[f2, 0, rng.uniform(600, 680)],
                   [0, f2 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    R = npgeom.rodrigues_to_matrix(rng.normal(0, 0.06, 3))
    T = np.array([[-rng.uniform(60, 220)],
                  [rng.normal(0, 5)], [rng.normal(0, 8)]])
    d1 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    d2 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    return (1280, 720), (1280, 720), K1, K2, d1, d2, R, T


def disparity_plane(rect, target):
    """(n, c, p0): the plane n . X = c (camera-1 frame, |n| = 1) whose
    rectified disparity is ``target`` at every pixel, and a point p0 on it.
    The rectified views share their rows, so the points of one disparity
    form a plane (with the two views' different x-shears it is not
    fronto-parallel); three of them, triangulated through the rectified
    projection matrices, fix it."""
    P1, P2 = rect.getRectifiedProjectionMatrices()
    w, h = rect.res1
    pts = []
    for u, v in ((0.25 * w, 0.25 * h), (0.75 * w, 0.25 * h),
                 (0.5 * w, 0.75 * h)):
        A = np.stack([u * P1[2] - P1[0], v * P1[2] - P1[1],
                      (u - target) * P2[2] - P2[0], v * P2[2] - P2[1]])
        X = np.linalg.svd(A)[2][-1]
        pts.append(X[:3] / X[3])
    n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    n /= np.linalg.norm(n)
    return n, float(n @ pts[0]), pts[0]


def render_plane(rig, plane, shape, seed=SEED):
    """The two distorted views of ``plane`` (from :func:`disparity_plane`)
    covered in noise, about 2 px per texel, uint8 BGR: each pixel's ray is
    undistorted, meets the plane, and the texture is sampled bilinearly
    there in the plane's own coordinates."""
    from simplestereo_tpu_torch.geometry import npgeom
    n, c, p0 = plane
    h, w = shape
    n_tex = w // 2 + 200
    tex = np.random.default_rng(seed).integers(
        0, 256, (n_tex, n_tex, 3)).astype(np.float64)
    texel = 2.0 * p0[2] / rig.intrinsic1[0, 0]
    e1 = np.cross([0.0, 1.0, 0.0], n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    pix = np.stack([u, v], -1).reshape(-1, 2)
    R, T = rig.R, rig.T.ravel()
    views = []
    for K, d, Rw, C in ((rig.intrinsic1, rig.distCoeffs1, np.eye(3),
                         np.zeros(3)),
                        (rig.intrinsic2, rig.distCoeffs2, R, -R.T @ T)):
        ray = np.concatenate([npgeom.undistort_points(pix, K, d),
                              np.ones((len(pix), 1))], 1) @ Rw
        P = C + ray * ((c - n @ C) / (ray @ n))[:, None]
        tx = (P - p0) @ e1 / texel + n_tex / 2
        ty = (P - p0) @ e2 / texel + n_tex / 2
        x0 = np.clip(np.floor(tx).astype(int), 0, n_tex - 2)
        y0 = np.clip(np.floor(ty).astype(int), 0, n_tex - 2)
        fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
        val = ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
               + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)
        views.append(np.clip(np.round(val), 0, 255).astype(np.uint8)
                     .reshape(h, w, 3))
    return views


def true_disparity(rect, plane, shape):
    """The plane's rectified disparity at every rectified left pixel: the
    pixel's ray through P1 meets the plane, P2 projects the point."""
    n, c, _ = plane
    h, w = shape
    P1, P2 = rect.getRectifiedProjectionMatrices()
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    ray = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(P1[:, :3]).T
    X = ray * (c / (ray @ n))[..., None]
    x2 = np.concatenate([X, np.ones_like(u)[..., None]], -1) @ P2.T
    return u - x2[..., 0] / x2[..., 2]


def uint8_close(a, b, where):
    """Equal but for pixels at most 1 apart, at most 0.1% of them.
    Returns the share of pixels that differ."""
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    share = float((d > 0).mean())
    check(a.shape == b.shape and a.dtype == b.dtype == np.uint8,
          f"{where}: shape or type")
    check(d.max() <= 1 and share <= 1e-3, f"{where}: max diff {d.max()}, "
          f"{share:.4%} of pixels differ")
    return share


def rotate_phase(dev, card):
    """Phase 15: K4 on the card. The probe's path (the three amount forms
    at (17, 8, 384), counted), each form and a ragged shape against numpy
    and the twin, K1's right map against the K4-shifted argmin at both ASW
    sizes, and times. Returns the kernel's JSON record."""
    from simplestereo_tpu_torch.passive import asw_cuda
    from simplestereo_tpu_torch.probes import rotate

    check(rotate.launches == 0, "K4 launched on a matcher's path")
    rotate.launches = 0
    exact = rotate.probe(device=dev)
    launches_main = rotate.launches
    check(all(exact.values()), f"K4 probe: not exact {exact}")
    check(launches_main == len(rotate.MODES), f"K4 probe: {launches_main} "
          "launches")

    D, TH, W = rotate.PROBE_SHAPE
    xn = rotate.probe_input()
    x = torch.tensor(xn, device=dev)
    expect = torch.tensor(np.stack([np.roll(xn[d], -d, axis=1)
                                    for d in range(D)]), device=dev)
    err = 0.0
    for mode in rotate.MODES:
        s = rotate.probe_amounts(mode, D, W)
        k = rotate.roll_planes(x, s)
        p = rotate._roll_planes_plain(x, torch.tensor(s, dtype=torch.int32))
        check(torch.equal(k, expect), f"K4 {mode}: differs from np.roll")
        check(torch.equal(k, p), f"K4 {mode}: differs from the twin")
        err = max(err, (k - p).abs().max().item())
    rng = np.random.default_rng(SEED + 4)
    xr = rng.standard_normal((5, 3, 37)).astype(np.float32)
    for shifts in ([0, -1, -36, 5, 36], [37, -37, 74, -75, 1000],
                   [2**31 - 1, -2**31, 38, -38, -1000003]):
        k = rotate.roll_planes(torch.tensor(xr, device=dev), shifts)
        want = np.stack([np.roll(xr[n], s, axis=1)
                         for n, s in enumerate(shifts)])
        check(np.array_equal(k.cpu().numpy(), want),
              f"K4 ragged {shifts}: differs from np.roll")
    # A ragged row at volume size (W = 1277: rows not 16-byte aligned, the
    # scalar path) and the volume's own width (the 16-byte path), amounts
    # that are not multiples of 4, negative, beyond W and at the int32 ends.
    amounts = [-4, -5, 1, 2, 3, 1281, -2558, 2**31 - 1, -2**31, 7, -1000003]
    for wd in (1277, 1280):
        xv = rng.standard_normal((11, 720, wd)).astype(np.float32)
        k = rotate.roll_planes(torch.tensor(xv, device=dev), amounts)
        p = rotate._roll_planes_plain(torch.tensor(xv, device=dev),
                                      torch.tensor(amounts, dtype=torch.int32))
        want = np.stack([np.roll(xv[n], s, axis=1)
                         for n, s in enumerate(amounts)])
        check(np.array_equal(k.cpu().numpy(), want) and torch.equal(k, p),
              f"K4 (11, 720, {wd}): differs from np.roll or the twin")
        del xv, k, p

    # What the probe guards: K1's dispR is the K4-shifted argmin.
    pkw = dict(win_size=MAIN["winSize"], min_disp=MAIN["minDisparity"],
               max_disp=MAIN["maxDisparity"], gamma_c=float(MAIN["gammaC"]),
               gamma_p=float(MAIN["gammaP"]), consistent=True)
    for h, w in ((288, 384), PIPE_SHAPE):
        left, right = pair(h, w)
        planes = asw_cuda._build_planes(
            torch.tensor(left[None], device=dev),
            torch.tensor(right[None], device=dev), pkw["win_size"],
            pkw["min_disp"], pkw["max_disp"])
        cost, _, dispR, _ = asw_cuda._asw_pass(planes, H=h, W=w, **pkw)
        check(torch.equal(rotate.right_map(cost, pkw["min_disp"]), dispR),
              f"K4 right map {w}x{h}: differs from K1's dispR")
        del planes, cost, dispR

    def times(shape, n, min_disp):
        N, R, Wd = shape
        s = torch.arange(min_disp, min_disp + N, dtype=torch.int32,
                         device=dev).neg()
        xs = [torch.randn(shape, device=dev) for _ in range(n)]
        idx = ((torch.arange(Wd, device=dev)[None, :] - s.long()[:, None])
               % Wd)[:, None, :].expand(shape)
        kernel = lambda t: rotate.roll_planes(t, s)  # noqa: E731
        gather = lambda t: torch.gather(t, 2, idx)  # noqa: E731
        k_ms, _ = cuda_ms(kernel, xs)
        p_ms, _ = cuda_ms(lambda t: rotate._roll_planes_plain(t, s), xs)
        lib_ms, _ = cuda_ms(gather, xs)
        check(torch.equal(gather(xs[0]), kernel(xs[0])),
              f"K4 {shape}: the gather disagrees with the kernel")
        # bytes: the volume read once and written once, plus the amounts
        bnd = bound(0, 2 * 4 * N * R * Wd + 4 * N)
        # Queued: kernel and gather in turns (kernel, gather, gather,
        # kernel), the better of each pair.
        kq1, lq1, lq2, kq2 = (queued_ms(f, xs)
                              for f in (kernel, gather, gather, kernel))
        kq, lq = min(kq1, kq2), min(lq1, lq2)
        check(kq <= lq, f"K4 {shape}: queued kernel {kq:.4f} ms slower than "
              f"the gather's {lq:.4f} ms")
        return k_ms, p_ms, lib_ms, bnd, kq, lq, 2 * 4 * N * R * Wd / kq / 1e9

    k_ms, p_ms, lib_ms, (bound_ms, bound_by), kq, lq, tb = times(
        rotate.PROBE_SHAPE, 21, 0)
    D720 = MAIN["maxDisparity"] - MAIN["minDisparity"] + 1
    hk, hp, hl, (hb, _), hkq, hlq, htb = times((D720,) + PIPE_SHAPE, 11,
                                               MAIN["minDisparity"])
    print(f"phase 15 K4 probe: pos/neg/rem exact on the card (torch.equal to "
          f"np.roll and to the twin), probe path launches {launches_main} "
          f"(0 on the matchers' and the pipeline's paths); ragged (5, 3, 37) "
          f"and (11, 720, 1277), and (11, 720, 1280), with amounts < 0, > W, "
          f"not multiples of 4 and INT_MIN/INT_MAX exact; K1 dispR "
          f"bit-equal to the K4-shifted argmin at 384x288 and 1280x720 | one "
          f"call each (queued behind a sleep: device time alone; the queued "
          f"kernel no slower than the queued gather at both shapes) | "
          f"(17, 8, 384): kernel {k_ms:.4f} ({kq:.4f}) ms, twin "
          f"{p_ms:.4f} ms, gather {lib_ms:.4f} ({lq:.4f}) ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}), queued {tb:.3f} TB/s | "
          f"(11, 720, 1280): kernel {hk:.4f} ({hkq:.4f}) ms, twin "
          f"{hp:.4f} ms, gather {hl:.4f} ({hlq:.4f}) ms, bound {hb:.4f} ms, "
          f"queued {htb:.3f} TB/s ({hb / hkq:.0%} of the memory rate) "
          f"| {card}")
    return {"name": "rotate_planes", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/rotate_kernel.cu",
            "replaces": "benchmarks/probe_dynamic_rotate.py:34",
            "launches": launches_main, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def pipeline_phase(dev, card):
    """Phase 16: the README pipeline at 1280x720 on the card: rig ->
    directRectify -> rectifyImages -> StereoASW(consistent) -> get3DPoints
    -> exportPLY/importPLY, checked against the CPU path, the plane's true
    disparity and a float64 reprojection, and timed stage by stage."""
    import os
    import tempfile

    import simplestereo_tpu_torch as tss
    from simplestereo_tpu_torch.passive import StereoASW, asw_cuda
    from simplestereo_tpu_torch.probes import rotate

    h, w = PIPE_SHAPE
    args = random_rig_args()
    rect = tss.rectification.directRectify(tss.StereoRig(*args, device=dev))
    check(rect.device == dev and rect.mapx1.device == dev,
          "pipeline: maps not on the card")
    plane = disparity_plane(rect, PLANE_DISP)
    left, right = render_plane(rect, plane, PIPE_SHAPE)
    lefts = [np.roll(left, i, axis=0) for i in range(3)]
    rights = [np.roll(right, i, axis=0) for i in range(3)]
    m = StereoASW(device="cuda", **MAIN)

    stages = ("rectifyImages", "compute", "get3DPoints", "exportPLY")
    times = {k: [] for k in stages + ("chain",)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cloud.ply")
        for i in range(len(lefts)):
            if i == 0:
                asw_cuda.launches = rotate.launches = 0
            t = [time.perf_counter()]
            l, r = rect.rectifyImages(lefts[i], rights[i])
            t.append(time.perf_counter())
            d = m.compute(l, r)
            t.append(time.perf_counter())
            pts = rect.get3DPoints(d)
            t.append(time.perf_counter())
            tss.points.exportPLY(pts, path, referenceImage=l)
            t.append(time.perf_counter())
            if i == 0:
                n, n4 = asw_cuda.launches, rotate.launches
                frame0 = (l, r, d, pts, tss.points.importPLY(path, *range(6)))
                continue  # the first chain warms up
            for k, a, b in zip(stages, t, t[1:]):
                times[k].append((b - a) * 1e3)
            times["chain"].append((t[-1] - t[0]) * 1e3)
    l, r, d, pts, back = frame0
    check(n == 1, f"pipeline: {n} ASW kernel launches, expected 1")
    check(n4 == 0, f"pipeline: {n4} K4 launches, expected 0")

    # The rectified pair against the CPU path's.
    cpu = tss.rectification.directRectify(tss.StereoRig(*args, device="cpu"))
    cl, cr = cpu.rectifyImages(left, right)
    shares = [uint8_close(l, cl, "rectified left"),
              uint8_close(r, cr, "rectified right")]
    map_err = max((getattr(rect, k).cpu() - getattr(cpu, k)).abs().max().item()
                  for k in ("mapx1", "mapy1", "mapx2", "mapy2"))

    # The disparity against the plane's, where both views see the plane
    # and the window and every candidate stay inside the image.
    truth = true_disparity(rect, plane, PIPE_SHAPE)

    def inside(mx, my):
        mx, my = mx.cpu().numpy(), my.cpu().numpy()
        return (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)

    from scipy.ndimage import binary_erosion
    pad = MAIN["winSize"] // 2
    valid = inside(rect.mapx1, rect.mapy1) & inside(rect.mapx2, rect.mapy2)
    valid = binary_erosion(valid, np.ones((2 * pad + 1, 2 * pad + 1)))
    valid[:, :MAIN["maxDisparity"] + pad] = False
    check(valid.mean() > 0.5, f"pipeline: valid interior {valid.mean():.2%}")
    lo, hi = truth[valid].min(), truth[valid].max()
    check(MAIN["minDisparity"] + 0.5 <= lo and hi <= MAIN["maxDisparity"]
          - 0.5, f"pipeline: plane disparity {lo:.2f}..{hi:.2f} leaves the "
          "search range")
    frac = float((np.abs(d[valid] - truth[valid]) <= 1.0).mean())
    check(frac >= PLANE_BAR, f"pipeline: only {frac:.2%} of the interior "
          f"within 1 px of the plane's disparity")

    # The cloud against a float64 reprojection through Q.
    check(pts.shape == (h, w, 3) and pts.dtype == np.float32,
          "pipeline: cloud shape")
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    hq = np.stack([u, v, d.astype(np.float64), np.ones_like(u)], -1) \
        @ rect.getQMatrix().T
    with np.errstate(divide="ignore", invalid="ignore"):
        ref = hq[..., :3] / hq[..., 3:]
    fin = np.isfinite(ref)
    check(np.array_equal(np.isfinite(pts), fin), "pipeline: the cloud's "
          "non-finite pattern differs from the reprojection's")
    ok = fin.all(-1)
    rel = float((np.abs(pts[ok] - ref[ok]).max(-1)
                 / np.linalg.norm(ref[ok], axis=-1)).max())
    check(rel <= CLOUD_RTOL, f"pipeline: cloud rel err {rel:.3g}")

    # The PLY round trip.
    flat = pts.reshape(-1, 3)
    rows = np.isfinite(flat).all(1)
    check(back.shape == (h * w, 6), "pipeline: PLY rows")
    check(np.array_equal(back[:, 3:], l.reshape(-1, 3)[:, ::-1]),
          "pipeline: PLY colours")
    ply_err = float(np.abs(back[rows, :3] - flat[rows]).max())
    check(ply_err <= 1e-6, f"pipeline: PLY coordinates off by {ply_err:.3g}")

    # Map build alone, on the card.
    torch.cuda.synchronize()
    build = []
    for _ in range(4):
        t0 = time.perf_counter()
        rect.computeRectificationMaps()
        torch.cuda.synchronize()
        build.append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 16 README pipeline {w}x{h}: rig seed {RIG_SEED}, plane at "
          f"disparity {lo:.2f}..{hi:.2f}; rectified pair vs the CPU path: "
          f"{shares[0]:.4%} / {shares[1]:.4%} of pixels 1 apart (maps within "
          f"{map_err:.3g} px); {frac:.2%} of the valid interior "
          f"({valid.mean():.1%} of pixels) within 1 px of the plane; cloud "
          f"vs float64 reprojection rel err {rel:.3g}; PLY round trip within "
          f"{ply_err:.3g}; ASW launches 1 | host clock, median of "
          f"{len(times['chain'])} frames: map build "
          f"{statistics.median(build[1:]):.2f} ms, rectifyImages "
          f"{med['rectifyImages']:.2f} ms, compute {med['compute']:.2f} ms, "
          f"get3DPoints {med['get3DPoints']:.2f} ms, exportPLY "
          f"{med['exportPLY']:.1f} ms, chain {med['chain']:.1f} ms | {card}")
    return pts, l


def host_name():
    """The CPU model (where /proc/cpuinfo names it), architecture and core
    count of the card's host."""
    import os
    import platform
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                if ln.split(":")[0].strip() in ("model name", "Model"):
                    model = ln.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return ", ".join(x for x in (model, platform.machine(),
                                 f"{os.cpu_count()} cores") if x)


def ply_phase(card, pts, img):
    """Phase 17: the native PLY writer and parser on phase 16's 1280x720
    cloud, in the xyz, xyz + colour, xyz + integer intensity and xyz +
    float intensity forms: the native file byte-identical to the
    numpy.savetxt writer's, importPLY equal to numpy.loadtxt's reading;
    seconds of both on the card's host."""
    import os
    import tempfile

    from simplestereo_tpu_torch import points

    forms = (("xyz", None), ("rgb", img), ("int", img[:, :, 1]),
             ("float", img[:, :, 1].astype(np.float32) / 255))
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.ply"), os.path.join(tmp, "b.ply")
        for name, ref in forms:
            t0 = time.perf_counter()
            points.exportPLY(pts, a, referenceImage=ref)
            t1 = time.perf_counter()
            points._export_ply_plain(pts, b, referenceImage=ref)
            t2 = time.perf_counter()
            with open(a, "rb") as fa, open(b, "rb") as fb:
                check(fa.read() == fb.read(),
                      f"PLY {name}: native file differs from savetxt's")
            cols = range({"xyz": 3, "rgb": 6}.get(name, 4))
            t3 = time.perf_counter()
            back = points.importPLY(a, *cols)
            t4 = time.perf_counter()
            plain = points._import_ply_plain(a, *cols)
            t5 = time.perf_counter()
            check(np.array_equal(back, plain, equal_nan=True),
                  f"PLY {name}: native read differs from loadtxt's")
            check(back.shape == (pts.shape[0] * pts.shape[1], len(cols)),
                  f"PLY {name}: {back.shape} rows read")
            out.append(f"{name} write {t1 - t0:.3f} s (savetxt "
                       f"{t2 - t1:.3f} s), read {t4 - t3:.3f} s (loadtxt "
                       f"{t5 - t4:.3f} s), {os.path.getsize(a) / 1e6:.1f} MB")
    h, w = pts.shape[:2]
    print(f"phase 17 PLY {w}x{h} cloud: native files byte-identical to "
          f"savetxt's, native reads equal to loadtxt's, in {len(forms)} "
          f"forms | "
          + "; ".join(out) + f" | host: {host_name()} | {card}")


# Phase 18: the S1 kernel against its twin, bit for bit, in both
# precisions, on a phase wrapped from a smooth field plus noise
# (probes.iir_variants.wrapped_phase). Shapes:
# one row, one column, a small ragged block, 720p, and more rows (1,100)
# than one block has threads (1,024).
IIR_SHAPES = ((1, 1280), (720, 1), (33, 47), (720, 1280), (1100, 64))
IIR_TAUS = (0.0, 0.5, 1.0)
IIR_TIMED = (720, 1280)


def iir_phase(dev, card):
    """Phase 18: S1 (the IIR unwrapping kernel) bit-equal to its twin on
    the card at every shape, precision and tau; CUDA-event times of
    kernel and twin at 720p against the chain and the bytes. Returns the
    largest |kernel - twin| measured."""
    from simplestereo_tpu_torch import unwrapping
    from simplestereo_tpu_torch.probes.iir_variants import wrapped_phase

    n_cases, max_err, p_ms = 0, 0.0, {}
    t0 = time.perf_counter()
    for h, w in IIR_SHAPES:
        for dtype in (np.float32, np.float64):
            t = torch.tensor(wrapped_phase(h, w, dtype), device=dev)
            # the plan's ring (a slot per row) and the smallest ring
            # that keeps live rows apart (slot y % ring_rows)
            plans = [unwrapping._plan(h, w, t.element_size()),
                     unwrapping._plan(h, w, t.element_size(),
                                      ring_rows=min(h, w // 2 + 2))]
            for tau in IIR_TAUS:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                p = unwrapping._iir_unwrap_plain(t, tau)
                b.record()
                b.synchronize()
                if (h, w) == IIR_TIMED and tau == 0.5:
                    p_ms[dtype] = a.elapsed_time(b)
                for plan in plans:
                    n0 = unwrapping.launches
                    k = unwrapping._iir_unwrap(t, tau, plan=plan)
                    torch.cuda.synchronize()
                    check(unwrapping.launches == n0 + 1,
                          f"S1 {h}x{w}: launch not counted")
                    err = (k - p).abs().max().item()
                    max_err = max(max_err, err)
                    check(k.dtype == t.dtype and torch.equal(k, p),
                          f"S1 {h}x{w} {dtype.__name__} tau {tau} ring "
                          f"{plan['ring_rows']}: kernel differs from twin, "
                          f"max abs {err:.3g}")
                n_cases += 1
    cases_s = time.perf_counter() - t0
    h, w = IIR_TIMED
    k_ms = {}
    for dtype in (np.float32, np.float64):
        ins = [torch.tensor(wrapped_phase(h, w, dtype, seed=i), device=dev)
               for i in range(6)]
        k_ms[dtype], _ = cuda_ms(lambda x: unwrapping._iir_unwrap(x, 0.5),
                                 ins)
    steps = w + 2 * (h - 1) + 2 * (w - 1)
    bound_ms, bound_by = s1_bound(h, w, 4)
    k32, k64 = k_ms[np.float32], k_ms[np.float64]
    print(f"phase 18 S1 IIR unwrap kernel vs twin: torch.equal on {n_cases} "
          f"cases ({', '.join(f'{a}x{b}' for a, b in IIR_SHAPES)}; float32 "
          f"and float64; tau {IIR_TAUS}), each with a slot per row and with "
          f"the smallest ring, max |kernel - twin| {max_err:g}, "
          f"{cases_s:.1f} s | {w}x{h}, tau 0.5: kernel "
          f"{k32:.3f} ms float32, {k64:.3f} ms float64; twin "
          f"{p_ms[np.float32]:.1f} / {p_ms[np.float64]:.1f} ms; chain "
          f"{steps} dependent steps ({k32 * 1e6 / steps:.0f} ns a step in "
          f"float32); bound {bound_ms:.4f} ms ({bound_by}) | {card}")
    return max_err


def s1_bound(h, w, itemsize):
    """(bound_ms, bound_by) of S1 on an h x w map: the phase read once and
    the map written once; some 30 operations a pixel (three predictions
    of 9 each, 2 adds, a division)."""
    return bound(30 * h * w, 2 * itemsize * h * w)


def s1_main_path(dev, phase, unwrapped, max_err):
    """S1 on the phase that FTP's getCloud gave infiniteImpulseResponse on
    the main path: what the main path's launch returned and a new launch,
    each torch.equal to the twin on the same input, CUDA-event times of
    kernel and twin there. Returns the kernels-line entry."""
    from simplestereo_tpu_torch import unwrapping

    t = torch.as_tensor(phase, device=dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    twin = unwrapping._iir_unwrap_plain(t, 1.0)
    b.record()
    b.synchronize()
    plain_ms = a.elapsed_time(b)
    main = torch.as_tensor(unwrapped, device=dev)
    again = unwrapping._iir_unwrap(t, 1.0)
    err = max((main - twin).abs().max().item(),
              (again - twin).abs().max().item())
    check(main.dtype == twin.dtype and torch.equal(main, twin)
          and torch.equal(again, twin),
          f"S1 on the FTP phase {tuple(t.shape)}: kernel differs from twin, "
          f"max abs {err:.3g}")
    ms, _ = cuda_ms(lambda x: unwrapping._iir_unwrap(x, 1.0), [t] * 6)
    bound_ms, bound_by = s1_bound(*t.shape, t.element_size())
    return {"name": "iir_unwrap", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/iir_unwrap_kernel.cu",
            "replaces": "simplestereo_tpu/unwrapping.py:142",
            "launches": None, "max_abs_err": max(err, max_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# Phases 19-20: 3-D scanning at 1280x720, camera and projector: the
# 128x96 scene of tests/test_active.py scaled ten times (focal length
# 1400, a 40-unit baseline, a fronto plane), with a little lens
# distortion on the camera and on the projector.
SCAN_RES = (1280, 720)
SCAN_K = np.array([[1400.0, 0, 639.5], [0, 1400.0, 359.5], [0, 0, 1]])
SCAN_D1 = np.array([0.04, -0.02, 0.0005, -0.0005, 0.0])
SCAN_D2 = np.array([-0.02, 0.01, 0.0, 0.0003, 0.0])
GC_Z0, FTP_Z0, FTP_PERIOD = 500.0, 520.0, 16.0


def scan_rig(dev):
    import simplestereo_tpu_torch as tss
    from simplestereo_tpu_torch.geometry import npgeom
    return tss.StereoRig(SCAN_RES, SCAN_RES, SCAN_K, SCAN_K, SCAN_D1,
                         SCAN_D2, npgeom.rodrigues_to_matrix([0, -0.05, 0]),
                         [[-40.0], [1.0], [6.0]], device=dev)


def pixel_rays(K, dist, res):
    """(h*w, 3) rays z = 1 of every pixel of a distorted camera."""
    from simplestereo_tpu_torch.geometry import npgeom
    w, h = res
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    ray = npgeom.undistort_points(np.stack([u, v], -1).reshape(-1, 2), K,
                                  dist)
    return np.concatenate([ray, np.ones((len(ray), 1))], 1)


def emitting_pixel(q, K, dist, res):
    """(mapu, mapv) float32 maps of the projector pixels that light the
    points q (projector frame, one per camera pixel): a projector emits
    towards a normalized point x from its pixel K * distort(x)."""
    from simplestereo_tpu_torch.geometry import npgeom
    w, h = res
    xd = npgeom.distort_normalized(q[:, :2] / q[:, 2:], dist)
    pu = K[0, 0] * xd[:, 0] + K[0, 1] * xd[:, 1] + K[0, 2]
    pv = K[1, 1] * xd[:, 1] + K[1, 2]
    return (pu.reshape(h, w).astype(np.float32),
            pv.reshape(h, w).astype(np.float32))


def plane_to_projector(rig, z0):
    """The projector pixel that lights each camera pixel of ``rig`` on the
    fronto plane z = z0."""
    P = z0 * pixel_rays(rig.intrinsic1, rig.distCoeffs1, rig.res1)
    return emitting_pixel(P @ rig.R.T + rig.T.ravel(), rig.intrinsic2,
                          rig.distCoeffs2, rig.res1)


def camera2_to_projector(rig, z0):
    """For each camera-2 pixel of ``rig``, the pixel of a projector at
    camera 1's pose with camera 1's optics that lights it on the plane
    z = z0 (camera-1 frame)."""
    d = pixel_rays(rig.intrinsic2, rig.distCoeffs2, rig.res2) @ rig.R
    C = -(rig.R.T @ rig.T).ravel()
    P = C + ((z0 - C[2]) / d[:, 2])[:, None] * d
    return emitting_pixel(P, rig.intrinsic1, rig.distCoeffs1, rig.res2)


def render_stack(pats, mapu, mapv, dev, interpolation="nearest"):
    """Camera captures of projected patterns, rendered on the card with the
    port's remap (black where the ray misses the projector), as numpy."""
    from simplestereo_tpu_torch import warp
    mu = torch.as_tensor(mapu, device=dev)
    mv = torch.as_tensor(mapv, device=dev)
    return [warp.remap(torch.as_tensor(np.ascontiguousarray(p), device=dev),
                       mu, mv, interpolation=interpolation).cpu().numpy()
            for p in pats]


def graycode_phase(dev, card):
    """Phase 19: a Gray-code scan at 1280x720 (nx 11, ny 10: 42 captures,
    black and white): decode integer-equal to the CPU path, the plane
    recovered, the cloud against the CPU path's, GrayCodeDouble once, and
    a scan's host-clock stages."""
    import simplestereo_tpu_torch as tss
    from simplestereo_tpu_torch.active import graycode as gc

    rig = scan_rig(dev)
    pats, nx, ny = tss.active.graycode_patterns(SCAN_RES)
    W, H = SCAN_RES
    full = [np.zeros((H, W), np.uint8), np.full((H, W), 255, np.uint8)]
    mapu, mapv = plane_to_projector(rig, GC_Z0)
    caps = render_stack(list(pats) + full, mapu, mapv, dev)
    black, white = caps[-2:]
    caps = caps[:-2]
    scanner = tss.active.GrayCode(rig, device=dev)
    cpu = tss.active.GrayCode(scan_rig("cpu"), device="cpu")
    check(scanner.num_patterns == len(caps) == 2 * (nx + ny),
          "Gray code: pattern count")
    dec = scanner.decode(caps, black=black, white=white)
    dec_cpu = cpu.decode(caps, black=black, white=white)
    for a, b, name in zip(dec, dec_cpu, ("proj_x", "proj_y", "valid")):
        check(np.array_equal(a, b), f"Gray code: {name} differs from the CPU "
              f"path on {(a != b).sum()} pixels")
    valid = dec[2].mean()
    check(valid >= 0.5, f"Gray code: only {valid:.1%} of pixels valid")
    pts = scanner.getCloud(caps, black=black, white=white)
    pts_cpu = cpu.getCloud(caps, black=black, white=white)
    check(pts.shape == pts_cpu.shape, "Gray code: cloud sizes differ")
    a, b = pts.reshape(-1, 3), pts_cpu.reshape(-1, 3)
    check(np.array_equal(np.isfinite(a), np.isfinite(b)),
          "Gray code: non-finite patterns differ")
    ok = np.isfinite(a).all(1)
    rel = float((np.abs(a[ok] - b[ok]).max(1)
                 / np.linalg.norm(b[ok], axis=1)).max())
    check(rel <= 1e-5, f"Gray code: cloud vs CPU path rel err {rel:.3g}")
    quant = GC_Z0 ** 2 / (40.0 * SCAN_K[0, 0])
    zerr = float(np.median(np.abs(a[ok, 2] - GC_Z0)))
    check(zerr < 0.5 * quant, f"Gray code: median |z - z0| {zerr:.3f} >= "
          f"half a step {0.5 * quant:.3f}")

    # GrayCodeDouble: an uncalibrated projector at camera 1's pose with
    # camera 1's optics (so camera 1 sees each projector pixel at its own
    # position); both cameras decode it.
    m1 = np.meshgrid(np.arange(W, dtype=np.float32),
                     np.arange(H, dtype=np.float32))
    m2 = camera2_to_projector(rig, GC_Z0)
    caps1 = render_stack(pats, *m1, dev)
    caps2 = render_stack(pats, *m2, dev)
    double = tss.active.GrayCodeDouble(rig, SCAN_RES, device=dev)
    t0 = time.perf_counter()
    dpts = double.getCloud(caps1, caps2).reshape(-1, 3)
    double_ms = (time.perf_counter() - t0) * 1e3
    dpts = dpts[np.isfinite(dpts).all(1)]
    dz = abs(float(np.median(dpts[:, 2])) - GC_Z0)
    check(len(dpts) > 0.1 * W * H and dz < 0.1 * GC_Z0,
          f"GrayCodeDouble: {len(dpts)} points, median z off by {dz:.1f}")

    # A scan's stages on the host clock, each ended by a synchronize.
    def stages():
        t = [time.perf_counter()]
        stack, shadow = gc._assemble_stack(caps, black, white, rig.res1,
                                           scanner.num_patterns)
        t.append(time.perf_counter())
        up = torch.as_tensor(stack, device=dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        und = gc._undistort_stack(up, rig.intrinsic1, rig.distCoeffs1)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        px, py, v = gc._decode_validity(und, shadow=shadow,
                                        **scanner._decode_kw(rig.res2))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        cloud = gc._graycode_cloud(px, py, *scanner._cloud_args())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = gc._gather_points(cloud, v, None)
        t.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])], out

    runs = [stages() for _ in range(4)][1:]
    check(np.array_equal(runs[-1][1], pts, equal_nan=True),
          "Gray code: staged scan differs from getCloud")
    names = ("stack assembly", "upload", "remap", "decode", "cloud", "gather")
    med = [statistics.median(r[0][i] for r in runs) for i in range(6)]
    scan_ms, _ = host_ms(lambda: scanner.getCloud(caps, black=black,
                                                  white=white), [()] * 4)
    print(f"phase 19 Gray code {W}x{H} camera and projector (nx {nx}, ny "
          f"{ny}: {len(caps)} captures + black, white; camera and projector "
          f"distorted): decode integer-equal to the CPU path, "
          f"{valid:.1%} valid, median |z - z0| {zerr:.3f} (half a step "
          f"{0.5 * quant:.3f}), {len(a)} points within rel {rel:.3g} of "
          f"the CPU path; GrayCodeDouble {len(dpts)} points, median z off "
          f"by {dz:.2f}, {double_ms:.0f} ms | host clock: getCloud "
          f"{scan_ms:.1f} ms a scan (median of 3); stages "
          + ", ".join(f"{n} {m:.1f} ms" for n, m in zip(names, med))
          + f" | {card}")



def ftp_phase(dev, card, s1_max_err):
    """Phase 20: FTP at 1280x720 on a rendered fringe plane: the plane
    recovered, getCloudBatch (B = 8) against per-frame calls, the IIR
    unwrapping (S1) as unwrappingMethod, and each subclass once. Returns
    S1's kernels-line entry: its launches on this main path (the IIR
    getCloud), the kernel against the twin on the phase it was given
    there, and their times on it (``s1_max_err``: phase 18's largest
    |kernel - twin|, folded into the entry's)."""
    import simplestereo_tpu_torch as tss
    from simplestereo_tpu_torch import unwrapping
    from simplestereo_tpu_torch.active import ftp as ftpm

    rig = scan_rig(dev)
    W, H = SCAN_RES
    # Undistorting the camera frame leaves a black border of up to ~8 px
    # (the rig's distortion at the corners), where the separable unwrap
    # would run through noise and lose the fringe order: the scan's ROI
    # leaves it out, as a user's computeROI would.
    roi = (16, 16, W - 32, H - 32)
    H, W = roi[3], roi[2]
    fringe = tss.active.buildFringe(FTP_PERIOD, dims=SCAN_RES,
                                    stripeColor="red")
    mapu, mapv = plane_to_projector(rig, FTP_Z0)
    cam = render_stack([fringe], mapu, mapv, dev, "linear")[0]
    ftp = tss.active.StereoFTP(rig, fringe, FTP_PERIOD, device=dev)

    m = H // 4  # the centre of tests/test_active.py's bound, scaled

    def z_ok(cloud, where, med_tol=0.02, p80_tol=0.05):
        c = cloud[m:-m, m:-m, 2]
        c = c[np.isfinite(c)]
        med = abs(float(np.median(c)) - FTP_Z0)
        p80 = float(np.percentile(np.abs(c - FTP_Z0), 80))
        check(c.size > 0.8 * (H - 2 * m) * (W - 2 * m)
              and med < med_tol * FTP_Z0
              and p80 < p80_tol * FTP_Z0, f"FTP {where}: median z off by "
              f"{med:.2f}, 80th percentile {p80:.2f}, {c.size} points")
        return med

    cloud = ftp.getCloud(cam, roi=roi)
    check(cloud.shape == (H, W, 3) and cloud.dtype == np.float64,
          "FTP: cloud shape")
    med = z_ok(cloud, "getCloud")

    frames = np.stack([np.roll(cam, 3 * i, axis=0) for i in range(8)])
    batch = ftp.getCloudBatch(frames, roi=roi)
    per = [ftp.getCloud(f, roi=roi) for f in frames]
    bit_equal = all(np.array_equal(batch[i], per[i], equal_nan=True)
                    for i in range(8))
    dzb = 0.0
    for i in range(8):
        both = np.isfinite(batch[i, ..., 2]) & np.isfinite(per[i][..., 2])
        check(both.mean() > 0.95, f"FTP batch frame {i}: finite share")
        dzb = max(dzb, float(np.abs(batch[i, ..., 2]
                                    - per[i][..., 2])[both].max()))
    check(dzb < 1e-2, f"FTP batch vs per-frame: max |dz| {dzb:.3g}")

    # The IIR unwrapping through S1, on its own main path. The callback
    # keeps the phase S1 is given and what it returns, to be held against
    # the twin after the launches are read.
    seen = {}

    def iir_method(p):
        seen["phase"] = p
        seen["out"] = unwrapping.infiniteImpulseResponse(p, 1.0, device=dev)
        return seen["out"]

    unwrapping.launches = 0
    iir = ftp.getCloud(cam, roi=roi, unwrappingMethod=iir_method)
    s1_launches = unwrapping.launches
    check(s1_launches == 1, f"FTP IIR: {s1_launches} S1 launches")
    med_iir = z_ok(iir, "IIR unwrapping")
    phase_h, phase_w = seen["phase"].shape
    check(seen["phase"].dtype == np.float32, "FTP IIR: phase dtype")
    s1 = s1_main_path(dev, seen["phase"], seen["out"], s1_max_err)
    s1["launches"] = s1_launches

    ana_fringe = tss.active.buildAnaglyphFringe(FTP_PERIOD, dims=SCAN_RES)
    ana_cam = render_stack([ana_fringe], mapu, mapv, dev, "linear")[0]
    ana = tss.active.StereoFTPAnaglyph(rig, ana_fringe, FTP_PERIOD,
                                       stripeColor="green", device=dev)
    med_ana = z_ok(ana.getCloud(ana_cam, roi=roi), "anaglyph", 0.03, 0.1)
    mapping = tss.active.StereoFTP_Mapping(rig, fringe, FTP_PERIOD,
                                           device=dev)
    mc = mapping.getCloud(cam, roi=roi)[H // 3:-(H // 3), H // 3:-(H // 3), 2]
    med_map = abs(float(np.nanmedian(mc)) - FTP_Z0)
    check(med_map < 0.1 * FTP_Z0, f"FTP Mapping: median z off by {med_map}")
    phase = tss.active.StereoFTP_PhaseOnly(rig, fringe, FTP_PERIOD,
                                           device=dev).getPhase(cam, roi=roi)
    pstd = float(np.nanstd(phase[m:-m, m:-m]))
    check(phase.shape == (H, W) and pstd < 0.5,
          f"FTP PhaseOnly: phase std {pstd:.3f}")

    one_ms, _ = host_ms(lambda: ftp.getCloud(cam, roi=roi), [()] * 4)
    b_ms, _ = host_ms(lambda: ftp.getCloudBatch(frames, roi=roi), [()] * 3)
    iir_ms, _ = host_ms(lambda: ftp.getCloud(
        cam, roi=roi, unwrappingMethod=lambda p:
        unwrapping.infiniteImpulseResponse(p, 1.0, device=dev)), [()] * 3)

    def split():
        t = [time.perf_counter()]
        prep = ftp._cloud_prep(cam, 0.5, roi)
        t.append(time.perf_counter())
        tt = ftp._rig_tensors()
        fc, r = prep["fc"], prep["radius"]
        out = ftpm._ftp_cloud_fused(
            prep["imgObj"][None], torch.tensor([prep["z_plane"]],
                                               device=dev),
            tt["M"], tt["T"], tt["K2"], tt["dist2"], tt["fringe_gray"],
            ftpm._f32(fc - r, dev)[None], ftpm._f32(fc + r, dev)[None],
            torch.as_tensor(prep["stripe_idx"], device=dev)[None], tt["peak"],
            tt["fp"], tt["ep"], tt["Rect1"], tt["Rect2"], tt["R_inv3"],
            tt["baseline"], res=SCAN_RES, roi=prep["roi"],
            gray_mode=prep["gray_mode"], row_inv=ftp._fringe_row_inv)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ftpm._cloud_out(out[0], None)
        t.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

    sp = [split() for _ in range(4)][1:]
    sp = [statistics.median(x[i] for x in sp) for i in range(3)]
    print(f"phase 20 FTP {SCAN_RES[0]}x{SCAN_RES[1]}, ROI {W}x{H} (period "
          f"{FTP_PERIOD:g}, plane z0 {FTP_Z0:g}, distorted camera and "
          f"projector): getCloud median z "
          f"off by {med:.3f}; getCloudBatch B=8 vs per-frame max |dz| "
          f"{dzb:.3g} ({'bit-equal' if bit_equal else 'not bit-equal'}); "
          f"IIR unwrapping (S1, {s1_launches} launch) median z off by "
          f"{med_iir:.3f}, S1 on its {phase_w}x{phase_h} float32 phase "
          f"torch.equal to the twin, kernel {s1['ms']:.3f} ms, twin "
          f"{s1['plain_ms']:.1f} ms, bound {s1['bound_ms']:.4f} ms; anaglyph {med_ana:.3f}, Mapping {med_map:.3f}, "
          f"PhaseOnly phase std {pstd:.4f} | host clock: getCloud "
          f"{one_ms:.1f} ms a cloud, getCloudBatch {b_ms:.1f} ms a batch of "
          f"8 ({b_ms / 8:.1f} ms a cloud), IIR getCloud {iir_ms:.1f} ms; "
          f"getCloud stages: preamble (upload, undistort, stripe, host "
          f"control plane) {sp[0]:.1f} ms, dense pipeline {sp[1]:.1f} ms, "
          f"readback {sp[2]:.1f} ms | {card}")
    return s1


# Phase 21: S2, the WLS line-solve kernel, against its twin, bit for bit:
# row and column solves on one line, a one-pixel-wide image, 33x47,
# 1280x720 and a stack of 8 frames, each in two regimes (invalid markers
# on a noise guide at lambda 2, sigma 8; no markers at lambda 128, sigma
# 2), lambda_t of the first of 3 iterations; and 70,000 frames of 4x5
# (past grid y's 65,535: two launches) against the same stack in pieces.
S2_SHAPES = ((1, 1, 1280), (1, 720, 1), (1, 33, 47), (1, 720, 1280),
             (8, 96, 128))
S2_REGIMES = (dict(lam=2.0, sigma=8.0, invalid=0.05),
              dict(lam=128.0, sigma=2.0, invalid=0.0))
S2_DEEP = (70_000, 4, 5)
S2_TIMED = (720, 1280)
# One line this long is one thread's chain: its time a position is the
# latency of a forward and a backward step.
S2_CHAIN = 16_384


def s2_inputs(B, H, W, sigma, invalid, dev, seed=SEED):
    """(conf, wx, wy, u) of a (B, H, W) stack as the smoother builds them:
    the weights of a noise BGR guide at ``sigma``, disparities around 20
    with a share ``invalid`` of markers (zero confidence, u = 0 there)."""
    from simplestereo_tpu_torch.passive import wls
    rng = np.random.default_rng(seed)
    d = rng.normal(20, 5, (B, H, W)).astype(np.float32)
    conf = torch.tensor((rng.random((B, H, W)) >= invalid).astype(
        np.float32), device=dev)
    g = torch.tensor(rng.integers(0, 256, (B, H, W, 3), np.uint8),
                     device=dev)
    wx, wy = wls._edge_weights(g, sigma)
    return conf, wx, wy, torch.tensor(d, device=dev) * conf


def s2_bound(B, H, W, along_y):
    """(bound_ms, bound_by) of one S2 solve: conf, w and u read once, u
    written once; some 20 operations a position (the diagonal and the
    right-hand side 7, the elimination 6 and two divisions, the back
    substitution 2)."""
    nw = B * (H - 1) * W if along_y else B * H * (W - 1)
    return bound(20 * B * H * W, 4 * (3 * B * H * W + nw))


def event_ms(fn):
    """CUDA-event ms of one call of fn()."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def s2_phase(dev, card):
    """Phase 21: S2 torch.equal to its twin on every case; CUDA-event times
    of kernel and twin at 1280x720 beside the bound and the chain.
    Returns the largest |kernel - twin| measured."""
    from simplestereo_tpu_torch import _build
    from simplestereo_tpu_torch.passive import wls

    n_cases, max_err = 0, 0.0
    t0 = time.perf_counter()

    def against_twin(conf, w, u, lam_t, along_y, where):
        nonlocal n_cases, max_err
        p = wls._solve_plain(conf, w, u, lam_t, along_y)
        n0 = wls.launches
        k = wls._solve(conf, w, u, lam_t, along_y)
        torch.cuda.synchronize()
        check(wls.launches == n0 + 1, f"S2 {where}: launch not counted")
        err = (k - p).abs().max().item()
        max_err = max(max_err, err)
        check(k.dtype == torch.float32 and torch.equal(k, p),
              f"S2 {where}: kernel differs from twin, max abs {err:.3g}")
        n_cases += 1
        return k

    for B, H, W in S2_SHAPES:
        for reg in S2_REGIMES:
            conf, wx, wy, u = s2_inputs(B, H, W, reg["sigma"],
                                        reg["invalid"], dev)
            lam_t = wls._lam_schedule(reg["lam"], 3, 1)
            for along_y, w in ((False, wx), (True, wy)):
                against_twin(conf, w, u, lam_t, along_y,
                             f"{B}x{H}x{W} along {'yx'[not along_y]} "
                             f"lambda {reg['lam']:g}")
    B, H, W = S2_DEEP
    conf, wx, wy, u = s2_inputs(B, H, W, 8.0, 0.05, dev)
    lam_t = wls._lam_schedule(2.0, 3, 1)
    for along_y, w in ((False, wx), (True, wy)):
        check(len(wls._plan(B, H, W, along_y)["pieces"]) == 2,
              "S2 deep stack: not two launches")
        whole = against_twin(conf, w, u, lam_t, along_y,
                             f"{B} frames of {W}x{H}")
        for a, b in ((0, B // 2), (B // 2, B)):
            part = wls._solve(conf[a:b].contiguous(), w[a:b].contiguous(),
                              u[a:b].contiguous(), lam_t, along_y)
            check(torch.equal(whole[a:b], part), f"S2 deep stack along "
                  f"{'yx'[not along_y]}: frames {a}..{b} differ from the "
                  "stack in pieces")
    del conf, wx, wy, u, whole, part
    cases_s = time.perf_counter() - t0

    h, w = S2_TIMED
    lam_t = wls._lam_schedule(2.0, 3, 1)
    ins = [s2_inputs(1, h, w, 8.0, 0.05, dev, seed=i) for i in range(6)]
    kx, _ = cuda_ms(lambda x: wls._solve(x[0], x[1], x[3], lam_t, False),
                    ins)
    ky, _ = cuda_ms(lambda x: wls._solve(x[0], x[2], x[3], lam_t, True),
                    ins)
    fgs, _ = cuda_ms(lambda x: wls._fgs(x[3], x[0], x[1], x[2], 2.0, 3),
                     ins)
    conf, wx, wy, u = ins[0]
    px, _ = event_ms(lambda: wls._solve_plain(conf, wx, u, lam_t, False))
    py, _ = event_ms(lambda: wls._solve_plain(conf, wy, u, lam_t, True))
    line = s2_inputs(1, 1, S2_CHAIN, 8.0, 0.0, dev)
    l_ms, _ = cuda_ms(lambda x: wls._solve(x[0], x[1], x[3], lam_t, False),
                      [line] * 4)
    step_ns = l_ms * 1e6 / S2_CHAIN
    bx = s2_bound(1, h, w, False)
    by = s2_bound(1, h, w, True)
    shapes = ", ".join(f"{b}x{c}x{d}" for b, c, d in S2_SHAPES)
    print(f"phase 21 S2 WLS line solve kernel vs twin: torch.equal on "
          f"{n_cases} cases ({shapes}, rows and columns, lambda 2 with 5% markers and 128; "
          f"{S2_DEEP[0]} frames of {S2_DEEP[2]}x{S2_DEEP[1]} in two "
          f"launches, equal to the stack in pieces), max |kernel - twin| "
          f"{max_err:g}, {cases_s:.1f} s | {w}x{h}: row solve {kx:.4f} ms, "
          f"column solve {ky:.4f} ms, 3 iterations (6 solves) {fgs:.3f} "
          f"ms; twin {px:.1f} / {py:.1f} ms; bound {bx[0]:.4f} / "
          f"{by[0]:.4f} ms ({bx[1]}); chain: one line of {S2_CHAIN} "
          f"positions {l_ms:.3f} ms = {step_ns:.1f} ns a position, so "
          f"{w * step_ns * 1e-6:.4f} / {h * step_ns * 1e-6:.4f} ms for a "
          f"row / column | registers/spill bytes: "
          f"{ptxas_summary(_build.compile_log('thomas_kernel'))} | {card}")
    return max_err


# Phase 22: the post-filter paths at full width on pair() (noise, true
# shift 5): quality_disparity's SGM leg (census 7, D = 128 on K2, LR check,
# uniqueness 10, then the WLS fill on S2) and its ASW leg with WLS (win 35,
# d 0..16 on K1, then S2), and the median (3 and 5) on the SGM map; at
# 384x288 and 1280x720.
POST_SHAPES = ((288, 384), (720, 1280))
POST_SGM = dict(min_disp=0, max_disp=127, matcher="sgm")
POST_ASW = dict(matcher="asw", wls_lambda=4.0)
POST_BAR = 0.95
POST_PAD = 17  # the ASW window's half width; the SGM leg's is smaller


def postfilter_phase(dev, card, s2_max_err):
    """Phase 22. Returns S2's kernels-line entry: its launches on the SGM
    leg's main path at 1280x720 (6: a row and a column solve in each of 3
    iterations), and the kernel against the twin, and both timed, on the
    first solve that path gave it."""
    from simplestereo_tpu_torch.passive import (
        asw_cuda, asw_disparity, median_disparity, quality_disparity, sgm,
        sgm_cuda, wls)
    from simplestereo_tpu_torch.passive.presets import _gray_guide

    entry = None
    for h, w in POST_SHAPES:
        left, right = pair(h, w)
        # The main path. Each kernel's calls on it are kept, to be held
        # against the twins after the counts are read.
        with calls_of(wls, "_solve") as s2_calls, \
                calls_of(sgm, "aggregate") as k2_calls:
            wls.launches = sgm_cuda.launches = 0
            d_sgm = quality_disparity(left, right, device=dev, **POST_SGM)
            n_sgm = (wls.launches, sgm_cuda.launches)
        with calls_of(asw_cuda, "_asw_pass") as k1_calls:
            wls.launches = asw_cuda.launches = 0
            d_asw = quality_disparity(left, right, device=dev, **POST_ASW)
            n_asw = (wls.launches, asw_cuda.launches)
        check(n_sgm == (6, 1), f"{w}x{h} SGM leg: (S2, K2) launches {n_sgm}"
              ", expected (6, 1)")
        check(n_asw == (6, 1), f"{w}x{h} ASW leg: (S2, K1) launches {n_asw}"
              ", expected (6, 1)")
        a, S, _ = k2_calls[0]
        C = a["C"]
        twin = sgm_cuda._aggregate(C, float(a["P1"]), float(a["P2"]),
                                   a["paths"])
        check(torch.equal(S, twin), f"{w}x{h} SGM leg: K2's S on the "
              f"preset's volume {tuple(C.shape)} differs from the twin, max "
              f"abs {(S - twin).abs().max().item():.3g}")
        del a, C, S, twin, k2_calls
        a, out, _ = k1_calls[0]
        k1_err = k1_on_path(a.pop("planes"), a, out, f"{w}x{h} ASW leg")
        del a, out, k1_calls
        share = {}
        for name, d in (("sgm", d_sgm), ("asw", d_asw)):
            check(d.shape == (h, w) and d.dtype == np.float32
                  and np.isfinite(d).all(),
                  f"{w}x{h} {name} leg: not a dense float32 map")
            inner = d[POST_PAD:-POST_PAD, 16 + POST_PAD:-POST_PAD]
            share[name] = float((np.abs(inner - SHIFT) <= 0.5).mean())
            check(share[name] >= POST_BAR, f"{w}x{h} {name} leg: only "
                  f"{share[name]:.2%} of the interior within 0.5 px of "
                  f"{SHIFT}")
        for size in (3, 5):
            got = median_disparity(torch.tensor(d_sgm, device=dev), size)
            cpu = median_disparity(torch.tensor(d_sgm), size)
            check(torch.equal(got.cpu(), cpu),
                  f"{w}x{h} median {size}: card differs from the CPU path")

        m = sgm.StereoSGM(minDisparity=0, numDisparities=128, blockSize=3,
                          P1=120, P2=480, uniquenessRatio=10,
                          disp12MaxDiff=1, costMethod="census",
                          censusWindow=7, device=dev)

        def stages(leg, l, r):
            t = [time.perf_counter()]
            t1 = torch.tensor(l, device=dev)
            t2 = torch.tensor(r, device=dev)
            if leg == "sgm":
                d = m.compute(t1, t2)
            else:
                d = asw_disparity(t1, t2, win_size=35, min_disp=0,
                                  max_disp=16, gamma_c=15.0, gamma_p=17.5,
                                  consistent=True).to(torch.float32)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            if leg == "sgm":
                f = wls.wls_filter_disparity(
                    d, _gray_guide(t1), lambda_=2.0, sigma_color=8.0,
                    invalid=-16, disp_scale=1 / 16.0)
            else:
                f = wls.wls_filter_disparity(d, _gray_guide(t1), lambda_=4.0,
                                             sigma_color=2.0)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            median_disparity(f, 3)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return [(b - a) * 1e3 for a, b in zip(t, t[1:])]

        ins = [(np.roll(left, i, axis=0), np.roll(right, i, axis=0))
               for i in range(5)]
        st, e2e = {}, {}
        for leg, kw in (("sgm", POST_SGM), ("asw", POST_ASW)):
            runs = [stages(leg, l, r) for l, r in ins][1:]
            st[leg] = [statistics.median(x[i] for x in runs)
                       for i in range(3)]
            e2e[leg], n = host_ms(
                lambda l, r, kw=kw: quality_disparity(l, r, device=dev, **kw),
                ins)
        print(f"phase 22 post-filters {w}x{h}: quality_disparity sgm (census "
              f"7, D=128, LR, uniqueness 10, WLS fill) {share['sgm']:.2%} "
              f"and asw (win 35, d 0..16, consistent, WLS lambda 4) "
              f"{share['asw']:.2%} of the interior within 0.5 px of "
              f"{SHIFT}, dense; launches (S2, K2) {n_sgm}, (S2, K1) {n_asw}; "
              f"K2's S on the path torch.equal to the twin, K1's pass vs "
              f"the twin on {k1_err[3]} max abs err {k1_err[0]:.3g} rel "
              f"{k1_err[1]:.3g} map mismatch {k1_err[2]:.4%}; "
              f"median 3 and 5 equal to the CPU path | host clock, median "
              f"of {n} distinct frames: sgm leg matcher {st['sgm'][0]:.2f} "
              f"ms, WLS {st['sgm'][1]:.2f}, median {st['sgm'][2]:.2f}, "
              f"end to end {e2e['sgm']:.2f} ms; asw leg matcher "
              f"{st['asw'][0]:.2f}, WLS {st['asw'][1]:.2f}, end to end "
              f"{e2e['asw']:.2f} ms | {card}")
        if (h, w) == S2_TIMED:
            a, main, _ = s2_calls[0]
            entry = s2_main_path(**a, main=main, launches=n_sgm[0],
                                 s2_max_err=s2_max_err)
    return entry


# Rows of each band of a 1280x720 K1 pass held against the twin on the
# preset's path (the twin's time grows with the rows it is given).
K1_BAND = 24


def k1_on_path(planes, kw, out, where):
    """K1's pass on a preset's own planes (``out``, what the path's launch
    returned) against the twin under compare_pass's gates: the whole map
    up to 384x288; at larger sizes three bands of K1_BAND rows (top,
    middle, bottom), the twin run on each band and its window's halo (a
    pixel's cost reads only its window, so the band's rows are the whole
    map's). Returns (max abs err, max rel err, worst map mismatch, what
    was compared)."""
    from simplestereo_tpu_torch.passive import asw_cuda
    H, W = kw["H"], kw["W"]
    pad = kw["win_size"] // 2
    if H * W <= 288 * 384:
        bands, what = [(0, H)], "the whole map"
    else:
        mid = H // 2 - K1_BAND // 2
        bands = [(0, K1_BAND), (mid, mid + K1_BAND), (H - K1_BAND, H)]
        what = f"rows {bands}"
    axes = (2, 1, 1, 2)  # the row axis of cost, dispL, dispR, csub

    def rows(ts, r0, r1):
        return tuple(None if t is None else t.narrow(a, r0, r1 - r0)
                     for t, a in zip(ts, axes))

    worst = [0.0, 0.0, 0.0]
    for r0, r1 in bands:
        a, b = max(0, r0 - pad), min(H, r1 + pad)
        p = asw_cuda._asw_pass_plain(
            planes[:, :, a:b + 2 * pad].contiguous(), **dict(kw, H=b - a))
        errs = compare_pass(rows(out, r0, r1), rows(p, r0 - a, r1 - a),
                            kw["min_disp"], f"{where} K1 rows {r0}..{r1}")
        worst = [max(x, y) for x, y in zip(worst, errs)]
    return (*worst, what)


def s2_main_path(conf, w, u, lam_t, along_y, main, launches, s2_max_err):
    """S2 on the first solve the SGM leg's WLS gave it at 1280x720 (its
    inputs and ``main``, what that launch returned): ``main`` and a new
    launch, each torch.equal to the twin on the same inputs; CUDA-event
    times of kernel and twin there."""
    from simplestereo_tpu_torch.passive import wls

    plain_ms, twin = event_ms(
        lambda: wls._solve_plain(conf, w, u, lam_t, along_y))
    again = wls._solve(conf, w, u, lam_t, along_y)
    err = max((main - twin).abs().max().item(),
              (again - twin).abs().max().item())
    check(torch.equal(main, twin) and torch.equal(again, twin),
          f"S2 on the SGM leg's solve {tuple(conf.shape)}: kernel differs "
          f"from twin, max abs {err:.3g}")
    ms, _ = cuda_ms(lambda x: wls._solve(conf, w, u, lam_t, along_y),
                    [None] * 6)
    bound_ms, bound_by = s2_bound(*conf.shape, along_y)
    return {"name": "thomas_solve", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/thomas_kernel.cu",
            "replaces": "simplestereo_tpu/passive/wls.py:32",
            "launches": launches, "max_abs_err": max(err, s2_max_err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# Phase 23: calibration at 1280x720. Ten chessboard pairs (7x6 inner
# corners, squares of 40 units) rendered on the card, 3x3 supersampled
# and box-filtered as tests/test_procam.py renders them, through phase
# 16's seeded rig (distortion on both cameras); board poses tilted up to
# ~0.35 rad, 700-1300 units away, the whole board inside both views.
CAL_CB = (7, 6)
CAL_SQ = 40.0
CAL_VIEWS = 10
CAL_SCALE = 3
CAL_SEED = 23


def calib_rays(K, dist, res, dev):
    """(N, 3) float64 rays (z = 1), on ``dev``, of every supersampled pixel
    of a distorted camera: subpixel i at pixel (i + 0.5) / scale - 0.5."""
    from simplestereo_tpu_torch.geometry import undistort_points
    w, h = res
    s = CAL_SCALE
    xs = (torch.arange(w * s, dtype=torch.float64, device=dev) + 0.5) / s - 0.5
    ys = (torch.arange(h * s, dtype=torch.float64, device=dev) + 0.5) / s - 0.5
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    xy = undistort_points(torch.stack([u, v], -1).reshape(-1, 2), K, dist)
    return torch.cat([xy, torch.ones_like(xy[:, :1])], 1)


def render_board(rays, Rb, tb, res):
    """The board (pose Rb, tb in the camera's frame) seen along ``rays``:
    each ray meets its plane, the board's (x, y) there picks a dark or a
    light square (20 or 235; light outside the board), and each pixel is
    the mean of its subpixels, truncated to uint8."""
    Rb = torch.as_tensor(Rb, device=rays.device)
    tb = torch.as_tensor(tb, device=rays.device)
    n = Rb[:, 2]
    s = (n * tb).sum() / (rays * n).sum(1)
    X = s[:, None] * rays - tb
    bx = (X * Rb[:, 0]).sum(1)
    by = (X * Rb[:, 1]).sum(1)
    cols, rows = CAL_CB
    inside = ((bx > -CAL_SQ) & (bx < cols * CAL_SQ) & (by > -CAL_SQ)
              & (by < rows * CAL_SQ) & (s > 0))
    dark = inside & ((torch.floor(bx / CAL_SQ) + torch.floor(by / CAL_SQ))
                     % 2 == 0)
    img = torch.where(dark, 20.0, 235.0).to(torch.float64)
    w, h = res
    img = img.reshape(h, CAL_SCALE, w, CAL_SCALE).mean((1, 3))
    return img.to(torch.uint8).cpu().numpy()


def calib_poses(rig_args):
    """CAL_VIEWS board poses (R, t) in camera 1's frame whose whole board
    (with its outer squares) projects inside both distorted views with a
    margin of 30 px."""
    from simplestereo_tpu_torch.calibration import ba
    res1, res2, K1, K2, d1, d2, R, T = rig_args
    T = T.ravel()
    cols, rows = CAL_CB
    c = np.array([[-CAL_SQ, -CAL_SQ, 0], [cols * CAL_SQ, -CAL_SQ, 0],
                  [-CAL_SQ, rows * CAL_SQ, 0],
                  [cols * CAL_SQ, rows * CAL_SQ, 0]])

    def inside(K, d, Rc, tc, res):
        uv = ba.project_points(c, ba._rodrigues_inv(Rc), tc, K[0, 0],
                               K[1, 1], K[0, 2], K[1, 2], d)
        return (uv.min() > 30 and uv[:, 0].max() < res[0] - 30
                and uv[:, 1].max() < res[1] - 30)

    rng = np.random.default_rng(CAL_SEED)
    mid = -R.T @ T / 2  # halfway between the two centres
    poses = []
    while len(poses) < CAL_VIEWS:
        Rb = ba._rodrigues(rng.normal(0, 0.35, 3))
        z = rng.uniform(700, 1300)
        tb = np.array([mid[0] - (cols - 1) * CAL_SQ / 2 + rng.normal(0, 60),
                       -(rows - 1) * CAL_SQ / 2 + rng.normal(0, 50), z])
        if inside(K1, d1, Rb, tb, res1) and inside(K2, d2, R @ Rb,
                                                   R @ tb + T, res2):
            poses.append((Rb, tb))
    return poses


def calibration_phase(dev, card):
    """Phase 23: chessboardStereo on ten rendered 1280x720 pairs on the
    card (recovery within tests/test_calibration.py's bounds), the corners
    of the card's corner_response against the CPU path's, and the one-card
    Gauss-Newton on 16 synthetic views (within its test's bounds); times."""
    from simplestereo_tpu_torch import calibration as cal
    from simplestereo_tpu_torch.calibration import ba, chessboard, sharded

    t0 = time.perf_counter()
    args = random_rig_args()
    res1, res2, K1, K2, d1, d2, R, T = args
    poses = calib_poses(args)
    rays1 = calib_rays(K1, d1, res1, dev)
    rays2 = calib_rays(K2, d2, res2, dev)
    pairs = [(render_board(rays1, Rb, tb, res1),
              render_board(rays2, R @ Rb, R @ tb + T.ravel(), res2))
             for Rb, tb in poses]
    del rays1, rays2
    torch.cuda.empty_cache()
    render_s = time.perf_counter() - t0

    # One pass, its stages timed inside it: detection (the card's
    # likelihood, host refinement and ordering) and the host BA.
    t0 = time.perf_counter()
    with calls_of(cal, "find_chessboard_corners") as found, \
            calls_of(ba, "stereo_calibrate") as bas:
        rig = cal.chessboardStereo(pairs, CAL_CB, CAL_SQ, device=dev)
    stereo_s = time.perf_counter() - t0
    r_err = float(np.abs(np.asarray(rig.R) - R).max())
    t_err = float(np.abs(np.asarray(rig.T).ravel() - T.ravel()).max())
    check(rig.reprojectionError < 0.12 and r_err < 2e-3 and t_err < 0.5,
          f"chessboardStereo 1280x720: RMS {rig.reprojectionError:.4f}, "
          f"|R - R_true| {r_err:.3g}, |T - T_true| {t_err:.3g}")
    check(rig.device == dev, "chessboardStereo: rig not on the card")
    check(len(found) == 2 * len(pairs) and len(bas) == 1,
          f"chessboardStereo: {len(found)} detections, {len(bas)} BAs")
    detect_ms = statistics.median(c[2] for c in found) * 1e3
    ba_s = bas[0][2]
    used = sum(found[2 * i][1][0] and found[2 * i + 1][1][0]
               for i in range(len(pairs)))
    check(used >= CAL_VIEWS - 2, f"boards found in both views of only "
          f"{used} of {CAL_VIEWS} pairs")
    worst = 0.0
    for i in (0, len(pairs) - 1):
        for k in range(2):
            a, (f_dev, c_dev), _ = found[2 * i + k]
            f, c = chessboard.find_chessboard_corners(a["gray"], CAL_CB,
                                                      device="cpu")
            check(f == f_dev, f"pair {i}: found on one path only")
            if f:
                worst = max(worst, float(np.abs(c - c_dev).max()))
    check(worst <= 1e-6, f"corners on the card vs the CPU path: {worst:.3g}")
    g = torch.tensor(pairs[0][0].astype(np.float32), device=dev)
    resp_ms, _ = cuda_ms(lambda x: chessboard.corner_response(x), [g] * 6)

    # The one-card Gauss-Newton: tests/test_calibration.py's 16 views.
    rng = np.random.default_rng(11)
    K = np.array([[800., 0, 640], [0, 790, 360], [0, 0, 1]])
    dist = np.array([-0.12, 0.03, 0.001, -0.0005, 0.01])
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30., yy.ravel() * 30., np.zeros(42)], 1)
    imgs = []
    for _ in range(16):
        rvec = rng.normal(0, 0.25, 3)
        tvec = np.array([rng.normal(-90, 30), rng.normal(-75, 30),
                         rng.normal(600, 100)])
        pts = ba.project_points(obj, rvec, tvec, K[0, 0], K[1, 1], K[0, 2],
                                K[1, 2], dist)
        imgs.append(pts + rng.normal(0, 0.1, pts.shape))
    Hs = [ba._homography_dlt(obj[:, :2], i) for i in imgs[:6]]
    fx, fy, cx, cy = ba._zhang_intrinsics(Hs, (1280, 720))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    gn = lambda n: sharded.calibrate_camera_sharded(
        np.tile(obj[None], (16, 1, 1)), np.stack(imgs), K0, np.zeros(5),
        iterations=n, device=dev)
    gn(1)  # warm
    t0 = time.perf_counter()
    rms, Ke, de, ps = gn(25)
    gn_ms = (time.perf_counter() - t0) * 1e3
    k_err = float(np.abs(Ke - K).max())
    check(rms < 0.25 and k_err < 5.0 and ps.shape == (16, 6),
          f"one-card Gauss-Newton: RMS {rms:.4f}, |K - K_true| {k_err:.3g}")
    print(f"phase 23 calibration {res1[0]}x{res1[1]}: {len(pairs)} pairs "
          f"({CAL_CB[0]}x{CAL_CB[1]} corners, 3x3 supersampled, phase 16's "
          f"distorted rig) rendered on the card in {render_s:.2f} s, "
          f"boards in both views of {used}; chessboardStereo RMS "
          f"{rig.reprojectionError:.4f}, |R - R_true| {r_err:.3g}, "
          f"|T - T_true| {t_err:.3g} in {stereo_s:.2f} s; "
          f"corners of the card's likelihood vs the CPU path max "
          f"{worst:.3g} px | corner_response {resp_ms:.3f} ms (CUDA "
          f"events); inside chessboardStereo, detection {detect_ms:.1f} ms "
          f"an image (median of {len(found)}, host clock), stereo BA "
          f"{ba_s * 1e3:.0f} ms (host) | one-card Gauss-Newton, "
          f"16 views, 25 iterations: RMS {rms:.4f}, |K - K_true| "
          f"{k_err:.3g}, {gn_ms:.0f} ms | {card}")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False: needs a "
                 "CUDA card")
    from simplestereo_tpu_torch import _build
    from simplestereo_tpu_torch.passive import StereoASW, asw_cuda

    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"phase 1 device: {kind} x{torch.cuda.device_count()} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | python "
          f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    names = ["asw_kernel", "sgm_kernel", "gsw_kernel", "rotate_kernel",
             "iir_unwrap_kernel", "thomas_kernel"]
    _build.build(names + list(_build.HOST_SOURCES))
    for name in names + list(_build.HOST_SOURCES):
        _build.load_library(name)
    build_s = time.perf_counter() - t0
    ptxas = [ptxas_summary(_build.compile_log(name)) for name in names]
    print(f"phase 2 build: {' + '.join(names)} (nvcc) and "
          f"{' + '.join(_build.HOST_SOURCES)} (g++) in parallel "
          f"{build_s:.2f} s | registers/spill bytes a thread: "
          + " | ".join(ptxas) + f" | {card}")

    # ---- phase 3: kernel vs plain twin, every option case --------------
    worst = [0.0, 0.0, 0.0]
    paths = set()
    for case in CASES:
        kw = dict(case)
        B = kw.pop("B", 1)
        h, w = kw.pop("h", 45), kw.pop("w", 150)
        rng = np.random.default_rng(SEED + 1)
        l = rng.integers(0, 256, (B, h, w, 3), np.uint8)
        r = np.roll(l, -SHIFT, axis=2)
        planes = asw_cuda._build_planes(
            torch.tensor(l, device=dev), torch.tensor(r, device=dev),
            kw["win_size"], kw["min_disp"], kw["max_disp"])
        pkw = dict(H=h, W=w, gamma_c=5.0, gamma_p=17.5, **kw)
        D = kw["max_disp"] - kw["min_disp"] + 1
        p = asw_cuda._asw_pass_plain(planes, **pkw)
        fkw = dict(W=w, min_disp=kw["min_disp"], max_disp=kw["max_disp"],
                   consistent=kw["consistent"],
                   subpixel=kw.get("subpixel", False))
        fp = asw_cuda._finish(*p[1:], **fkw)
        for plan in (asw_cuda._plan(kw["win_size"], kw.get("step", 1), D, B,
                                    h, w),
                     asw_cuda._plan(kw["win_size"], kw.get("step", 1), D, B,
                                    h, w, budgets=())):
            where = f"case {case} {plan['path']} path"
            n0 = asw_cuda.launches
            k = asw_cuda._asw_pass(planes, plan=plan, **pkw)
            torch.cuda.synchronize()
            check(asw_cuda.launches == n0 + 1, f"{where}: launch not counted")
            errs = compare_pass(k, p, kw["min_disp"], where)
            fk = asw_cuda._finish(*k[1:], **fkw)
            m = (fk.floor() != fp.floor()).double().mean().item()
            check(m <= MISMATCH, f"{where}: final map mismatch {m:.2%}")
            worst = [max(a, b) for a, b in zip(worst, errs)]
            paths.add(plan["path"])
    check(paths == {"tile", "l1"}, f"phase 3 ran paths {paths}")

    # The grid-limit case: one call of the whole stack against the same
    # stack in two calls (the twin would take too long at this size).
    deep = dict(ASW_DEEP)
    B, h, w = deep.pop("B"), deep.pop("h"), deep.pop("w")
    l = np.random.default_rng(SEED + 7).integers(0, 256, (B, h, w, 3),
                                                 np.uint8)
    planes = asw_cuda._build_planes(
        torch.tensor(l, device=dev),
        torch.tensor(np.roll(l, -SHIFT, axis=2), device=dev),
        deep["win_size"], deep["min_disp"], deep["max_disp"])
    D = deep["max_disp"] - deep["min_disp"] + 1
    plan = asw_cuda._plan(deep["win_size"], 1, D, B, h, w)
    pkw = dict(H=h, W=w, gamma_c=5.0, gamma_p=17.5, consistent=True, **deep)
    n0 = asw_cuda.launches
    whole = asw_cuda._asw_pass(planes, **pkw)
    torch.cuda.synchronize()
    check(asw_cuda.launches == n0 + 1, "ASW deep stack: launch not counted")
    for a, b in ((0, B // 2), (B // 2, B)):
        part = asw_cuda._asw_pass(planes[a:b].contiguous(), **pkw)
        for name, x, y in zip(("cost", "dispL", "dispR"), whole, part):
            check(torch.equal(x[a:b], y), f"ASW deep stack: {name} of frames "
                  f"{a}..{b} differs from the stack in pieces")
        del part
    del planes, whole
    torch.cuda.empty_cache()
    print(f"phase 3 kernel vs plain on {len(CASES)} option cases (45x150 "
          f"unless stated; step 2/3, D 18/20/41, min_disp -3, subpixel, "
          f"B 2, win 111, B 2 at 37x101), each on the tile and the L1 path: "
          f"ok | max abs err {worst[0]:.3g}, max rel err {worst[1]:.3g} "
          f"(rtol {RTOL}), worst map mismatch {worst[2]:.4%} "
          f"(limit {MISMATCH:.0%}), launch count +1 per call | {B} frames "
          f"of {w}x{h}, D={D} (frames x chunks {B * -(-D // plan['chunk'])} "
          f"> 65,535): one call in {len(_build.frame_pieces(B, plan['frames']))} "
          f"launches bit-equal to two calls | {card}")

    # ---- phases 4-5: the main path -------------------------------------
    m = StereoASW(device="cuda", **MAIN)
    pad = MAIN["winSize"] // 2
    launches_main = None
    e2e = {}
    for phase, (h, w) in ((4, (288, 384)), (5, (720, 1280))):
        left, right = pair(h, w)
        lefts = np.stack([np.roll(left, i, axis=0) for i in range(8)])
        rights = np.stack([np.roll(right, i, axis=0) for i in range(8)])
        asw_cuda.launches = 0
        d = m.compute(left, right)
        batch = m.computeBatch(lefts, rights)
        per = [m.compute(lefts[i], rights[i]) for i in range(8)]
        n = asw_cuda.launches
        check(d.shape == (h, w) and d.dtype == np.int16, f"{h}x{w}: shape")
        interior = d[pad:-pad, MAIN["maxDisparity"] + pad:-pad]
        frac = float((interior == SHIFT).mean())
        check(frac >= 0.95, f"{h}x{w}: only {frac:.2%} of interior is "
              f"{SHIFT}")
        check(n == 10, f"{h}x{w}: {n} kernel launches, expected 10")
        for i in range(8):
            check(np.array_equal(batch[i], per[i]),
                  f"{h}x{w}: batch frame {i} differs from per-frame")
        if launches_main is None:
            launches_main = n
        # end to end per frame: numpy in, numpy out, distinct inputs
        m.compute(lefts[0], rights[0])
        ts = []
        for i in range(1, 8):
            t0 = time.perf_counter()
            m.compute(lefts[i], rights[i])
            ts.append((time.perf_counter() - t0) * 1e3)
        e2e[(h, w)] = statistics.median(ts)
        print(f"phase {phase} main path {w}x{h}: {frac:.2%} of interior = "
              f"{SHIFT}, launches {n}, batch of 8 bit-equal to per-frame, "
              f"compute() median {e2e[(h, w)]:.2f} ms/frame end to end "
              f"(host clock, n={len(ts)}) | {card}")

    # ---- phase 6: times -----------------------------------------------
    D = MAIN["maxDisparity"] - MAIN["minDisparity"] + 1
    pkw = dict(win_size=MAIN["winSize"], min_disp=MAIN["minDisparity"],
               max_disp=MAIN["maxDisparity"], gamma_c=float(MAIN["gammaC"]),
               gamma_p=float(MAIN["gammaP"]), consistent=True)

    def planes_for(h, w, B, n):
        left, right = pair(h, w)
        out = []
        for i in range(n):
            ls = np.stack([np.roll(left, i * B + j, axis=0)
                           for j in range(B)])
            rs = np.stack([np.roll(right, i * B + j, axis=0)
                           for j in range(B)])
            out.append(asw_cuda._build_planes(
                torch.tensor(ls, device=dev), torch.tensor(rs, device=dev),
                pkw["win_size"], pkw["min_disp"], pkw["max_disp"]))
        return out

    def rate(h, w, B, ms):
        return h * w * D * B / (ms * 1e-3) / 1e6

    def l1_run(h, w):
        """The L1 kernel (the first version of K1) on the same inputs."""
        plan = asw_cuda._plan(pkw["win_size"], 1, D, 1, h, w, budgets=())
        return lambda p: asw_cuda._asw_pass(p, H=h, W=w, plan=plan, **pkw)

    plan = asw_cuda._plan(pkw["win_size"], 1, D, 1, 288, 384)
    regs, spill, blocks = asw_cuda.occupancy(plan, dev)
    check(plan["path"] == "tile" and spill == 0 and blocks * 8 > 16,
          f"K1 main plan {plan}: {regs} registers, {spill} B spilled, "
          f"{blocks} blocks an SM")
    tsu = planes_for(288, 384, 1, 11)
    run_k = lambda p: asw_cuda._asw_pass(p, H=288, W=384, **pkw)
    run_p = lambda p: asw_cuda._asw_pass_plain(p, H=288, W=384, **pkw)
    k_ms, _ = cuda_ms(run_k, tsu)
    l1_ms, _ = cuda_ms(l1_run(288, 384), tsu)
    p_ms, _ = cuda_ms(run_p, tsu[:4])
    k = run_k(tsu[0])
    p = run_p(tsu[0])
    abs_err, rel_err, mism = compare_pass(
        k, p, pkw["min_disp"], "main path 384x288")
    print(f"phase 6a 384x288 D={D} win 35: kernel {k_ms:.3f} ms "
          f"({rate(288, 384, 1, k_ms):.1f} Mpix*disp/s; L1 path, the first "
          f"version, {l1_ms:.3f} ms), plain {p_ms:.1f} ms "
          f"({rate(288, 384, 1, p_ms):.2f} Mpix*disp/s), kernel/plain max "
          f"abs err {abs_err:.3g} rel {rel_err:.3g} map mismatch "
          f"{mism:.4%} | occupancy: tile plan chunk {plan['chunk']}, "
          f"{plan['jg']} columns an e2 group, {plan['smem']} B dynamic "
          f"shared memory a block, {regs} registers, {spill} B spilled, "
          f"{blocks} blocks = {blocks * 8} warps resident an SM | {card}")
    # The Pallas cost estimate's count (asw_pallas.py:474): 20 + 4*D
    # operations per (pixel, window offset); planes read once, the cost
    # volume and both maps written once.
    bound_ms, bound_by = bound(
        288 * 384 * MAIN["winSize"] ** 2 * (20 + 4 * D),
        (tsu[0].numel() + sum(o.numel() for o in k[:3])) * 4)
    del tsu
    hd = planes_for(720, 1280, 1, 6)
    run_hd = lambda p: asw_cuda._asw_pass(p, H=720, W=1280, **pkw)
    hd_ms, _ = cuda_ms(run_hd, hd)
    hd_l1_ms, _ = cuda_ms(l1_run(720, 1280), hd)
    hd_bound = bound(720 * 1280 * MAIN["winSize"] ** 2 * (20 + 4 * D),
                     (hd[0].numel() + (D + 2) * 720 * 1280) * 4)
    hd_err = compare_pass(run_hd(hd[0]), asw_cuda._asw_pass_plain(
        hd[0], H=720, W=1280, **pkw), pkw["min_disp"], "main path 1280x720")
    del hd
    b8 = planes_for(288, 384, 8, 6)
    b8_ms, _ = cuda_ms(lambda p: asw_cuda._asw_pass(p, H=288, W=384, **pkw),
                       b8)
    del b8
    print(f"phase 6b kernel 1280x720: {hd_ms:.3f} ms "
          f"({rate(720, 1280, 1, hd_ms):.1f} Mpix*disp/s; L1 path "
          f"{hd_l1_ms:.3f} ms), vs plain max abs err {hd_err[0]:.3g} rel "
          f"{hd_err[1]:.3g} map mismatch {hd_err[2]:.4%}; bounds "
          f"{bound_ms:.4f} ms at 384x288, {hd_bound[0]:.4f} ms at 1280x720 "
          f"({bound_by}, {hd_bound[1]}); kernel 384x288 "
          f"B=8: {b8_ms:.3f} ms ({b8_ms / 8:.3f} ms/frame, "
          f"{rate(288, 384, 8, b8_ms):.1f} Mpix*disp/s) | {card}")

    asw_entry = {
        "name": "asw_pass", "route": "cuda",
        "source": "simplestereo_tpu_torch/csrc/asw_kernel.cu",
        "replaces": "simplestereo_tpu/passive/asw_pallas.py:155",
        "launches": launches_main, "max_abs_err": abs_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}
    del m
    torch.cuda.empty_cache()
    walls = {"1-6": time.perf_counter() - start}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        walls[name] = time.perf_counter() - t
        return out

    sgm_entry = timed("7-10", sgm_phases, dev, card)
    gsw_entry = timed("11-14", gsw_phases, dev, card)
    rotate_entry = timed("15", rotate_phase, dev, card)
    pts, img = timed("16", pipeline_phase, dev, card)
    timed("17", ply_phase, card, pts, img)
    del pts, img
    s1_max_err = timed("18", iir_phase, dev, card)
    timed("19", graycode_phase, dev, card)
    iir_entry = timed("20", ftp_phase, dev, card, s1_max_err)
    s2_max_err = timed("21", s2_phase, dev, card)
    s2_entry = timed("22", postfilter_phase, dev, card, s2_max_err)
    timed("23", calibration_phase, dev, card)
    print("phase wall times (host clock, s, build included in 1-6): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; total {time.perf_counter() - start:.1f} | {card}")

    print(json.dumps({"kernels": [asw_entry, sgm_entry, gsw_entry,
                                  rotate_entry, iir_entry, s2_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
