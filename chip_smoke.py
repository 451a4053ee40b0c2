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
  ``compute()``, and counts the census kernels' calls on the main path.
  The census, speckle and post kernels are held to their twins by their
  own ``card``-marked tests (tests/test_torch_sgm_census.py,
  tests/test_torch_speckle.py, tests/test_torch_sgm_post.py), which phase
  31 runs;
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
  synthetic views, timed;
- the streaming stereo service at full width: the port's VideoWriter
  writes 12 side-by-side frames (left | right, band-limited noise at its
  own shift in 4..14) at 1280x720 and 384x288 as DIB and as MJPG
  (quality 90) AVIs; one ``utils.Capture`` a file feeds batches of 8
  pairs to ``StereoASW(35, 14, 4, 15, 17.5, consistent=True).computeBatch``
  on the ASW kernel, a warm batch and 4 under ``profiling.trace`` with the
  grab / upload / match / readback ranges: each frame's map at its shift
  (DIB; MJPG against DIB), the kernel against its twin on the first
  1280x720 batch, the trace's kernels and ranges, the device's busy
  share, throughput, memory, host-clock stage times and computeBatch with
  the grab thread stopped;
- the native JPEG codec at 1280x720 (round trip within the JAX MJPG
  test's bar, ms a frame each way) and the port's
  ``examples/202_streaming_pipeline.py`` on the card.
- the row-tiled paths of ``parallel``: the 1280x720 ASW pair as 4 row
  tiles with halos through the ASW kernel in context mode (and 384x288 x
  8), concatenated bit-equal to the whole image; the SGM kernel's
  direction families with a carry-in against their twin on random
  volumes, and the 1280x720 D = 128 volume as 4 tiles chained by carries,
  its S ``torch.equal`` to the whole volume's; then every ``parallel``
  path (tiled ASW, SGM, GSW, the sharded FTP cloud, the Gauss-Newton on a
  mesh, ``dryrun_multichip``) on an explicit one-rank NCCL group, each
  equal to its single-card call, with the kernels' launches counted;
- the image formats on the card's host, which has no Pillow: every
  fixture of ``tests/golden/torch_imgio/`` (PNG of every colour type and
  depth, Adam7; BMP of every header, depth and RLE; TIFF strips, tiles,
  planar, big-endian, PackBits, LZW, Deflate, predictor; progressive
  JPEG) equal to the arrays Pillow gave for it; 12 side-by-side 1280x720
  pairs written by ``imgio`` as BMP and as TIFF, each folder through
  ``utils.Capture`` into ``computeBatch`` on the ASW kernel, the maps
  equal to the in-memory frames'; ms to decode a 1280x720 frame in each
  format and the folders' pairs/s;
- the example scripts, the port's entry points that mirror the JAX
  package's: the 19 that no other phase runs, on the card, on a stand-in
  resource tree at the reference's sizes (tests/torch_example_res.py:
  1280x720 chessboards and rig, lawn pair and camera-projector rig,
  384x288 Tsukuba), each held to the tree's truth, with K1, K2, K3 and S2
  held against their twins on the scripts' own inputs, the launch counts
  of each script read, the cheap ones against the same script on the
  CPU, and each script and matcher call timed;
- the census, speckle and post kernels: their ``card``-marked test files
  run in this process (``python -m pytest --noconftest -p
  no:cacheprovider -m card`` on tests/test_torch_sgm_census.py,
  tests/test_torch_speckle.py and tests/test_torch_sgm_post.py), every
  case passing and none skipped, then their calls counted on
  ``compute`` and ``computeBatch`` of the benchmark's two SGM
  configurations at 1280x720.

Every timed kernel's JSON record carries ``bound_ms``, the least time the
card could take for the kernel's work at the timed shape: the larger of
its operations over the float32 peak and its bytes (each input read once,
each output written once) over the memory rate. The census, speckle and
post kernels are not timed here (``ms`` null): the benchmark's
``breakdown`` records their device time inside its cells.

Every phase prints one line, then a line gives each phase's wall time;
any failed check raises, so the exit code is nonzero and no result line
is printed. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Needs a CUDA card, nvcc, g++ and the repository checkout; imports no
JAX, Pillow or matplotlib. Phases 24 and 29 write their videos, images
and traces under the checkout's ``build/chip_smoke_stream/`` and delete
them at the end; phase 29 imports ``tests/image_files.py`` (numpy and
zlib only) to build the 1280x720 files the port cannot write; phases
16, 23 and 30 draw their scenes with ``tests/torch_example_res.py``
(numpy and the port), and phase 30 writes its tree in a temporary
folder.
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
# and the argmin is noise. Each case runs its plan (the wide tile kernel
# for D > 12, else the tile kernel) and the L1 kernel (the path of a
# window too wide for any tile); the deep stack runs the tile kernel.
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


def compare_pass(k, p, min_disp, where, flat_ok=False):
    """Kernel outputs k vs plain outputs p, both (cost, dispL, dispR, csub).
    Costs: the same inf pattern, RTOL on finite entries. Maps: each is the
    first argmin of the kernel's own cost volume, exactly; each pixel that
    differs from the twin's map is a near-tie (the plain volume's cost at
    the kernel's pick is within 2*RTOL of its minimum), and at most
    MISMATCH of the pixels differ. With ``flat_ok``, a flip at a flat
    pixel, whose every in-range candidate lies within 2*RTOL of the
    minimum (a window that meets the SAD cap at every disparity, on a
    black border, ties them all), is held by the exact first-argmin rule
    and the costs' RTOL alone, and counted apart from the MISMATCH share.
    Returns (max abs err, max rel err, worst map mismatch, flips at flat
    pixels left out of it)."""
    from simplestereo_tpu_torch.passive.asw_cuda import _right_volume
    kc, pc = k[0], p[0]
    check(torch.equal(torch.isinf(kc), torch.isinf(pc)),
          f"{where}: inf pattern differs")
    fin = torch.isfinite(pc)
    diff = (kc[fin] - pc[fin]).abs()
    abs_err = diff.max().item()
    rel_err = (diff / pc[fin].abs().clamp(min=1e-30)).max().item()
    check(rel_err <= RTOL, f"{where}: cost rel err {rel_err:.3g} > {RTOL}")
    mism, flat_flips = 0.0, 0
    for km, pm, name in ((k[1], p[1], "dispL"), (k[2], p[2], "dispR")):
        check((km is None) == (pm is None), f"{where}: {name} presence")
        if km is None:
            continue
        own = kc if name == "dispL" else _right_volume(kc, min_disp)
        n_own = int((km != own.argmin(1) + min_disp).sum())
        check(n_own == 0, f"{where}: {name} is not the first argmin of the "
              f"kernel's own costs at {n_own} pixels")
        del own
        bad = km != pm
        if bad.any():
            vol = pc if name == "dispL" else _right_volume(pc, min_disp)
            at = lambda d: torch.gather(vol, 1, (d - min_disp).long()[:, None])
            ck, cp = at(km)[:, 0][bad], at(pm)[:, 0][bad]
            gap = ((ck - cp).abs() / cp.abs().clamp(min=1e-30)).max().item()
            check(gap <= 2 * RTOL, f"{where}: {name} flip with cost gap "
                  f"{gap:.3g}, not a near-tie")
            if flat_ok:
                lo = vol.amin(1)
                hi = torch.where(torch.isfinite(vol), vol, -torch.inf).amax(1)
                flat = (hi - lo) <= 2 * RTOL * lo.abs()
                flat_flips += int((bad & flat).sum())
                bad = bad & ~flat
        m = bad.double().mean().item()
        check(m <= MISMATCH, f"{where}: {name} mismatch {m:.2%}")
        mism = max(mism, m)
    if k[3] is not None:
        agree = (k[1] == p[1])[:, None].expand_as(k[3])
        ks, ps = k[3][agree], p[3][agree]
        check(torch.equal(torch.isinf(ks), torch.isinf(ps)),
              f"{where}: csub inf pattern differs")
        f = torch.isfinite(ps)
        rel = ((ks[f] - ps[f]).abs() / ps[f].abs().clamp(min=1e-30)).max()
        check(rel.item() <= RTOL, f"{where}: csub rel err {rel.item():.3g}")
    return abs_err, rel_err, mism, flat_flips


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
    both configurations (the census kernels' calls counted), and times.
    Returns the JSON record of K2."""
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
    launches_main = census_main = None
    e2e = {}
    for phase, ((h, w), cfg) in zip((8, 9), SGM_MAIN):
        m = StereoSGM(device="cuda", **cfg)
        left, right = pair(h, w)
        lefts = np.stack([np.roll(left, i, axis=0) for i in range(8)])
        rights = np.stack([np.roll(right, i, axis=0) for i in range(8)])
        sgm_cuda.launches = sgm_cuda.census_launches = 0
        sgm_cuda.bt_launches = 0
        d = m.compute(left, right)
        batch = m.computeBatch(lefts, rights)
        per = [m.compute(lefts[i], rights[i]) for i in range(8)]
        n = sgm_cuda.launches
        n_census, n_bt = sgm_cuda.census_launches, sgm_cuda.bt_launches
        census = cfg.get("costMethod") == "census"
        check((n_census, n_bt) == ((10, 0) if census else (0, 10)),
              f"SGM {h}x{w}: {n_census} census and {n_bt} BT kernel calls, "
              f"expected {(10, 0) if census else (0, 10)}")
        if census:
            census_main = n_census
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
              f"0.5 px of {SHIFT}, launches {n} (census kernel calls "
              f"{n_census}, BT {n_bt}), batch of 8 bit-equal to "
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


# The card-marked test files that hold the census, speckle, post and BT
# kernels to their twins, each with the fewest cases it passes on the card.
CARD_TESTS = {"tests/test_torch_sgm_census.py": 80,
              "tests/test_torch_speckle.py": 162,
              "tests/test_torch_sgm_post.py": 21,
              "tests/test_torch_sgm_bt.py": 72}
# The benchmark's two SGM configurations (portbench/configs/sgm_lawn720
# and sgm_cloud720): census with the post; BT with the post and speckles.
SGM_LAWN = dict(minDisparity=1, numDisparities=96, blockSize=3,
                costMethod="census", censusWindow=7, P1=120, P2=480)
SGM_CLOUD = dict(minDisparity=1, numDisparities=96, blockSize=7,
                 disp12MaxDiff=1, speckleWindowSize=120, speckleRange=2)


def bt_times(dev):
    """CUDA-event ms of the BT kernel pair (``sgm_cuda.bt_cost``) at
    sgm_cloud720's shapes (1280x720, D = 96 from 1, block 7, cap 63): one
    frame alone and queued, 8 frames alone and queued, the torch twin on
    the card, and the bound (C written once)."""
    from simplestereo_tpu_torch.passive import sgm, sgm_cuda

    left, right = pair(720, 1280)

    def grays(B, i):
        rows = [i * B + j for j in range(B)]
        return tuple(sgm._gray_frames(torch.tensor(np.stack(
            [np.roll(img, r, axis=0) for r in rows]), device=dev))
            for img in (left, right))

    def kernel(g):
        return sgm_cuda.bt_cost(g[0], g[1], 1, 96, 63.0, 7)

    def twin(g):
        return sgm._box_sum(sgm._bt_cost(sgm._xsobel(g[0], 63.0),
                                         sgm._xsobel(g[1], 63.0), 1, 96), 7)

    one = [grays(1, i) for i in range(7)]
    eight = [grays(8, i) for i in range(4)]
    out = {"ms": cuda_ms(kernel, one)[0], "queued_ms": queued_ms(kernel, one),
           "frames8_ms": cuda_ms(kernel, eight)[0],
           "frames8_queued_ms": queued_ms(kernel, eight),
           "plain_ms": cuda_ms(twin, one[:4])[0]}
    out["bound_ms"], out["bound_by"] = bound(0, 720 * 1280 * 96 * 4)
    return out


def card_tests_phase(dev, card):
    """Phase 31: the census, speckle, post and BT kernels against their
    twins. Runs their ``card``-marked test files (``CARD_TESTS``) in this
    process, as ``python -m pytest --noconftest -p no:cacheprovider -m
    card`` does: no case may fail or skip, and each file passes at least
    its count. Then counts each kernel's calls on the main path,
    ``compute`` and ``computeBatch`` (2 frames) of the benchmark's two SGM
    configurations at 1280x720, and times the BT pair there
    (:func:`bt_times`). Returns the four kernels' JSON records."""
    import collections
    import pathlib

    import pytest

    from simplestereo_tpu_torch.passive import (StereoSGM, sgm_cuda,
                                                speckle_cuda)

    class Outcomes:
        """Each test's outcome, counted by file."""

        def __init__(self):
            self.n = collections.Counter()

        def pytest_runtest_logreport(self, report):
            where = report.nodeid.split("::")[0]
            if report.failed or report.skipped:
                self.n[where, report.outcome] += 1
            elif report.when == "call":
                self.n[where, "passed"] += 1

    root = pathlib.Path(__file__).resolve().parent
    outcomes = Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main([*(str(root / f) for f in CARD_TESTS), "--noconftest",
                      "-p", "no:cacheprovider", "-q", "-rfEs", "-m",
                      "card"], plugins=[outcomes])
    tests_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    check(rc == 0, f"card tests of the census, speckle, post and BT "
          f"kernels: pytest exit code {int(rc)}")
    passed = {}
    for f, least in CARD_TESTS.items():
        n = {k: outcomes.n[f, k] for k in ("passed", "failed", "skipped")}
        check(n["failed"] == 0 and n["skipped"] == 0
              and n["passed"] >= least, f"card tests {f}: {n}, expected "
              f"at least {least} passed and none failed or skipped")
        passed[f] = n["passed"]

    left, right = pair(720, 1280)
    counts = {}
    for name, cfg in (("sgm_lawn720", SGM_LAWN), ("sgm_cloud720", SGM_CLOUD)):
        m = StereoSGM(device="cuda", **cfg)
        sgm_cuda.census_launches = sgm_cuda.post_launches = 0
        sgm_cuda.bt_launches = speckle_cuda.speckle_launches = 0
        one = m.compute(left, right)
        batch = m.computeBatch(np.stack([left] * 2), np.stack([right] * 2))
        counts[name] = (sgm_cuda.census_launches, sgm_cuda.post_launches,
                        speckle_cuda.speckle_launches, sgm_cuda.bt_launches)
        check(np.array_equal(batch[0], one) and np.array_equal(batch[1], one),
              f"{name} on the card: computeBatch differs from compute")
        del m, one, batch
    check(counts == {"sgm_lawn720": (2, 2, 0, 0),
                     "sgm_cloud720": (0, 2, 2, 2)},
          f"census, post, speckle and BT calls on compute + computeBatch: "
          f"{counts}, expected (2, 2, 0, 0) for sgm_lawn720 and (0, 2, 2, 2) "
          f"for sgm_cloud720")
    torch.cuda.empty_cache()
    bt = bt_times(dev)
    torch.cuda.empty_cache()
    print(f"phase 31 census, speckle, post and BT kernels vs twins: their "
          f"card tests in this process, " + ", ".join(
              f"{pathlib.Path(f).name} {n} passed" for f, n in passed.items())
          + f", none failed or skipped, {tests_s:.1f} s; calls on compute + "
          f"computeBatch at 1280x720 (census, post, speckle, BT): "
          f"sgm_lawn720 {counts['sgm_lawn720']}, sgm_cloud720 "
          f"{counts['sgm_cloud720']}; the BT pair at 720p D=96 block 7: "
          f"{bt['ms']:.4f} ms a frame, queued {bt['queued_ms']:.4f}, 8 "
          f"frames {bt['frames8_ms']:.4f}, queued "
          f"{bt['frames8_queued_ms']:.4f}; the torch twin {bt['plain_ms']:.3f}"
          f"; bound {bt['bound_ms']:.4f} ({bt['bound_by']}) | {card}")

    def record(name, source, replaces, launches, tests, times=None):
        # times of the census, speckle and post kernels: the benchmark's
        # breakdown records their device time inside its cells
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": 0.0, "checked_by": tests,
                "card_cases": passed[tests], "ms": None, "plain_ms": None,
                "bound_ms": None, "library_ms": None, **(times or {})}

    sgm_src = "simplestereo_tpu_torch/csrc/sgm_kernel.cu"
    tests = list(CARD_TESTS)
    return [record("sgm_census_cost", sgm_src, "simplestereo_tpu/passive/"
                   "sgm.py:127 (XLA-fused, no TPU kernel)",
                   counts["sgm_lawn720"][0], tests[0]),
            record("speckle_filter",
                   "simplestereo_tpu_torch/csrc/speckle_kernel.cu",
                   "simplestereo_tpu/passive/sgm.py filter_speckles (host "
                   "numpy and scipy, no TPU kernel)",
                   counts["sgm_cloud720"][2], tests[1]),
            record("sgm_post", sgm_src, "simplestereo_tpu/passive/sgm.py "
                   "_sgm_post (XLA-fused, no TPU kernel)",
                   counts["sgm_lawn720"][1], tests[2]),
            record("sgm_bt_cost", sgm_src, "simplestereo_tpu/passive/sgm.py "
                   "_bt_cost, _box_sum (XLA-fused, no TPU kernel)",
                   counts["sgm_cloud720"][3], tests[3], bt)]


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
        a, r_, mm, _ = main_err[(h, w)]
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
    abs_err, rel_err, mism, _ = main_err[(th, tw)]
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
# The renderers (random_rig_args, disparity_plane, render_plane,
# true_disparity) are tests/torch_example_res.py's, which draws phase 30's
# resource tree with them.
PLANE_DISP = 9.0
PIPE_SHAPE = (720, 1280)
# The share of the valid interior whose disparity must lie within 1 px of
# the plane's true rectified disparity is torch_example_res.PLANE_BAR.
# Bound on the card's cloud against a float64 numpy reprojection of the
# same map, relative to each point's distance from the camera (a
# coordinate near 0 has no relative error to speak of: x - cx cancels in
# float32).
CLOUD_RTOL = 1e-5


def tests_on_path():
    """Put the checkout's tests/ on sys.path, for its fixture builders
    (torch_example_res.py, image_files.py)."""
    import pathlib
    tests = pathlib.Path(__file__).resolve().parent / "tests"
    if str(tests) not in sys.path:
        sys.path.insert(0, str(tests))


def example_res():
    """tests/torch_example_res.py."""
    tests_on_path()
    import torch_example_res
    return torch_example_res


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

    res = example_res()
    h, w = PIPE_SHAPE
    args = res.random_rig_args()
    rect = tss.rectification.directRectify(tss.StereoRig(*args, device=dev))
    check(rect.device == dev and rect.mapx1.device == dev,
          "pipeline: maps not on the card")
    plane = res.disparity_plane(rect, PLANE_DISP)
    left, right = res.render_plane(rect, plane, PIPE_SHAPE)
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
    shares = [res.uint8_close(l, cl, where="rectified left"),
              res.uint8_close(r, cr, where="rectified right")]
    map_err = max((getattr(rect, k).cpu() - getattr(cpu, k)).abs().max().item()
                  for k in ("mapx1", "mapy1", "mapx2", "mapy2"))

    # The disparity against the plane's, where both views see the plane
    # and the window and every candidate stay inside the image.
    truth = res.true_disparity(rect, plane, PIPE_SHAPE)
    valid = res.plane_interior(rect, MAIN["winSize"] // 2,
                               MAIN["maxDisparity"])
    check(valid.mean() > 0.5, f"pipeline: valid interior {valid.mean():.2%}")
    lo, hi = truth[valid].min(), truth[valid].max()
    check(MAIN["minDisparity"] + 0.5 <= lo and hi <= MAIN["maxDisparity"]
          - 0.5, f"pipeline: plane disparity {lo:.2f}..{hi:.2f} leaves the "
          "search range")
    frac = float((np.abs(d[valid] - truth[valid]) <= 1.0).mean())
    check(frac >= res.PLANE_BAR, f"pipeline: only {frac:.2%} of the "
          f"interior within 1 px of the plane's disparity")

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
    print(f"phase 16 README pipeline {w}x{h}: rig seed {res.RIG_SEED}, plane "
          f"at disparity {lo:.2f}..{hi:.2f}; rectified pair vs the CPU path: "
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
# (probes.iir_variants.wrapped_phase). Shapes: one row, one column, a
# small ragged block (two bands), 720p (a last band of 16 rows), 1,100
# rows (35 bands, three warps a CTA) at 64 and 333 columns, and 333 rows
# (a last band of 13) at 517.
IIR_SHAPES = ((1, 1280), (720, 1), (33, 47), (720, 1280), (1100, 64),
              (333, 517), (1100, 333))
IIR_TAUS = (0.0, 0.5, 1.0)
IIR_TIMED = (720, 1280)
# Plans besides the wrapper's (the first): the smallest ring (two chunks
# of two columns); two CTAs of one warp (bands wrap round two warps, a
# ring holds a row) in chunks of 4; a portable cluster of 8 with rings of
# 4 chunks of 32.
IIR_PLANS = ({}, dict(chunk=2, slots=2),
             dict(cluster=2, warps_per_cta=1, chunk=4, slots=2),
             dict(cluster=8, chunk=32, slots=4))


def iir_phase(dev, card):
    """Phase 18: S1 (the IIR unwrapping kernel) bit-equal to its twin on
    the card at every shape, precision and tau; CUDA-event times of
    kernel and twin at 720p against the chain and the bytes. Returns the
    largest |kernel - twin| measured."""
    from simplestereo_tpu_torch import _build, unwrapping
    from simplestereo_tpu_torch.probes.iir_variants import wrapped_phase

    n_cases, max_err, p_ms = 0, 0.0, {}
    t0 = time.perf_counter()
    for h, w in IIR_SHAPES:
        for dtype in (np.float32, np.float64):
            t = torch.tensor(wrapped_phase(h, w, dtype), device=dev)
            plans = [unwrapping._plan(h, w, t.element_size(), **kw)
                     for kw in IIR_PLANS]
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
                          f"S1 {h}x{w} {dtype.__name__} tau {tau} plan "
                          f"{plan}: kernel differs from twin, max abs "
                          f"{err:.3g}")
                n_cases += 1
    cases_s = time.perf_counter() - t0
    # The kernel's division by 3 against the IEEE division: every float
    # in its range, 2^30 doubles.
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    unwrapping.LIBRARY.launch("iir_div3_check", dev, bad.data_ptr(),
                              what="S1 div3 check launch")
    bad = bad.tolist()
    check(bad == [0, 0], f"S1 div3 differs from the IEEE division on "
          f"{bad[0]} floats and {bad[1]} of 2^30 doubles")
    h, w = IIR_TIMED
    k_ms = {}
    for dtype in (np.float32, np.float64):
        ins = [torch.tensor(wrapped_phase(h, w, dtype, seed=i), device=dev)
               for i in range(6)]
        k_ms[dtype], _ = cuda_ms(lambda x: unwrapping._iir_unwrap(x, 0.5),
                                 ins)
        row = [t[:1].contiguous() for t in ins]
        k_ms["row", dtype], _ = cuda_ms(
            lambda x: unwrapping._iir_unwrap(x, 0.5), row)
    plan = unwrapping._plan(h, w, 4)
    bands = -(-h // unwrapping.LANES)
    # the transient, then the last band W + 62 steps after it starts,
    # each band 64 + chunk steps after the one above
    steps = (2 * (w - 1) + (bands - 1) * (64 + plan["chunk"]) + w
             + 2 * (h - (bands - 1) * 32 - 1))
    bound_ms, bound_by = s1_bound(h, w, 4)
    k32, k64 = k_ms[np.float32], k_ms[np.float64]
    print(f"phase 18 S1 IIR unwrap kernel vs twin: torch.equal on {n_cases} "
          f"cases ({', '.join(f'{a}x{b}' for a, b in IIR_SHAPES)}; float32 "
          f"and float64; tau {IIR_TAUS}), each on the plan and on "
          f"{len(IIR_PLANS) - 1} smaller ones ({IIR_PLANS[1:]}), max "
          f"|kernel - twin| {max_err:g}, {cases_s:.1f} s; div3 equal to "
          f"the IEEE division on every float in range and 2^30 doubles "
          f"| {w}x{h}, tau "
          f"0.5, plan {plan}: kernel {k32:.3f} ms float32, {k64:.3f} ms "
          f"float64; one row alone (the transient and {w} steps) "
          f"{k_ms['row', np.float32]:.3f} / {k_ms['row', np.float64]:.3f} "
          f"ms; twin {p_ms[np.float32]:.1f} / {p_ms[np.float64]:.1f} ms; "
          f"the chain {steps} dependent steps ({k32 * 1e6 / steps:.0f} ns a "
          f"step in float32); bound {bound_ms:.4f} ms ({bound_by}) | "
          f"registers/spill bytes: "
          f"{ptxas_summary(_build.compile_log('iir_unwrap_kernel'))} | "
          f"{card}")
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
    chain_ms, _ = cuda_ms(lambda x: unwrapping._iir_unwrap(x, 1.0),
                          [t[:1].contiguous()] * 6)
    bound_ms, bound_by = s1_bound(*t.shape, t.element_size())
    return {"name": "iir_unwrap", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/iir_unwrap_kernel.cu",
            "replaces": "simplestereo_tpu/unwrapping.py:142",
            "launches": None, "max_abs_err": max(err, max_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "chain_ms": chain_ms}


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
             (8, 96, 128), (2, 20, 29), (1, 100, 1000))
S2_REGIMES = (dict(lam=2.0, sigma=8.0, invalid=0.05),
              dict(lam=128.0, sigma=2.0, invalid=0.0))
S2_DEEP = (70_000, 4, 5)
S2_TIMED = (720, 1280)
# One line this long is one warp's: its segments are 513 positions.
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
    qx = queued_ms(lambda x: wls._solve(x[0], x[1], x[3], lam_t, False),
                   ins)
    qy = queued_ms(lambda x: wls._solve(x[0], x[2], x[3], lam_t, True), ins)
    line = s2_inputs(1, 1, S2_CHAIN, 8.0, 0.0, dev)
    l_ms, _ = cuda_ms(lambda x: wls._solve(x[0], x[1], x[3], lam_t, False),
                      [line] * 4)
    bx = s2_bound(1, h, w, False)
    by = s2_bound(1, h, w, True)
    shapes = ", ".join(f"{b}x{c}x{d}" for b, c, d in S2_SHAPES)
    print(f"phase 21 S2 WLS line solve kernel vs twin: torch.equal on "
          f"{n_cases} cases ({shapes}, rows and columns, lambda 2 with 5% markers and 128; "
          f"{S2_DEEP[0]} frames of {S2_DEEP[2]}x{S2_DEEP[1]} in two "
          f"launches, equal to the stack in pieces), max |kernel - twin| "
          f"{max_err:g}, {cases_s:.1f} s | {w}x{h}: row solve {kx:.4f} ms, "
          f"column solve {ky:.4f} ms (queued: {qx:.4f} / {qy:.4f}), 3 "
          f"iterations (6 solves) {fgs:.3f} ms; twin {px:.1f} / {py:.1f} "
          f"ms; bound {bx[0]:.4f} / {by[0]:.4f} ms ({bx[1]}); one line of "
          f"{S2_CHAIN} positions alone (segments of "
          f"{wls._segment(S2_CHAIN)}) {l_ms:.3f} ms | registers/spill "
          f"bytes: "
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
              f"the twin on {k1_err[4]} max abs err {k1_err[0]:.3g} rel "
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


def k1_on_path(planes, kw, out, where, flat_ok=False):
    """K1's pass on a preset's own planes (``out``, what the path's launch
    returned) against the twin under compare_pass's gates: the whole map
    up to 384x288; at larger sizes three bands of K1_BAND rows (top,
    middle, bottom), the twin run on each band and its window's halo (a
    pixel's cost reads only its window, so the band's rows are the whole
    map's; ``flat_ok`` as compare_pass's). Returns (max abs err, max rel
    err, worst map mismatch, flips at flat pixels, what was compared)."""
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

    worst = [0.0, 0.0, 0.0, 0]
    for r0, r1 in bands:
        a, b = max(0, r0 - pad), min(H, r1 + pad)
        p = asw_cuda._asw_pass_plain(
            planes[:, :, a:b + 2 * pad].contiguous(), **dict(kw, H=b - a))
        errs = compare_pass(rows(out, r0, r1), rows(p, r0 - a, r1 - a),
                            kw["min_disp"], f"{where} K1 rows {r0}..{r1}",
                            flat_ok)
        worst = [max(x, y) for x, y in zip(worst[:3], errs)] + [
            worst[3] + errs[3]]
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
    # one line of the solve on its own
    one = [t[:, :1].contiguous() if not along_y else t[..., :1].contiguous()
           for t in (conf, w, u)]
    chain_ms, _ = cuda_ms(lambda x: wls._solve(*one, lam_t, along_y),
                          [None] * 6)
    bound_ms, bound_by = s2_bound(*conf.shape, along_y)
    return {"name": "thomas_solve", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/thomas_kernel.cu",
            "replaces": "simplestereo_tpu/passive/wls.py:32",
            "launches": launches, "max_abs_err": max(err, s2_max_err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "chain_ms": chain_ms}


# Phase 23: calibration at 1280x720. Ten chessboard pairs (7x6 inner
# corners, squares of 40 units) rendered on the card, 3x3 supersampled
# and box-filtered as tests/test_procam.py renders them, through phase
# 16's seeded rig (distortion on both cameras); board poses tilted up to
# ~0.35 rad, 700-1300 units away, the whole board inside both views
# (tests/torch_example_res.py's calib_rays, render_board, calib_poses).


def gn_views():
    """tests/test_calibration.py's 16 synthetic views of a 7x6 board and
    the Zhang start values: (K_true, (objects, images, K0, dist0))."""
    from simplestereo_tpu_torch.calibration import ba

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
    return K, (np.tile(obj[None], (16, 1, 1)), np.stack(imgs), K0,
               np.zeros(5))


def calibration_phase(dev, card):
    """Phase 23: chessboardStereo on ten rendered 1280x720 pairs on the
    card (recovery within tests/test_calibration.py's bounds), the corners
    of the card's corner_response against the CPU path's, and the one-card
    Gauss-Newton on 16 synthetic views (within its test's bounds); times."""
    from simplestereo_tpu_torch import calibration as cal
    from simplestereo_tpu_torch.calibration import ba, chessboard, sharded

    res = example_res()
    CAL_CB, CAL_SQ, CAL_VIEWS = res.CAL_CB, res.CAL_SQ, res.CAL_VIEWS
    t0 = time.perf_counter()
    args = res.random_rig_args()
    res1, res2, K1, K2, d1, d2, R, T = args
    pairs = res.render_boards(args, CAL_SQ, dev)
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
    K, views = gn_views()
    gn = lambda n: sharded.calibrate_camera_sharded(
        *views, iterations=n, device=dev)
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


STREAM_SHAPES = ((720, 1280), (288, 384))
STREAM_CODECS = ("DIB ", "MJPG")
STREAM_FRAMES = 12
STREAM_B = 8
STREAM_TIMED = 4     # batches under the trace, after one warm batch
STREAM_BAR = 0.90    # DIB: each frame's share of the interior at its shift
STREAM_MJPG = 0.90   # MJPG: at least this times the DIB stream's share
STREAM_QUALITY = 90
STREAM_SEED = 24
STREAM_RANGES = ("grab", "upload", "match", "readback")
K1_KERNELS = ("asw_cost_tile_kernel", "asw_cost_l1_kernel",
              "asw_select_kernel")


def stream_dir():
    """A fresh working directory under the checkout's build/ (gitignored)."""
    import pathlib
    import shutil
    from simplestereo_tpu_torch import _build
    d = pathlib.Path(_build.BUILD_DIR).parent / "chip_smoke_stream"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def stream_frames(h, w, seed):
    """STREAM_FRAMES side-by-side frames (h, 2w, 3), left | right: a pair
    of band-limited noise (3x3 box-blurred), the right half the left
    rolled along its rows by the frame's own shift in 4..14. Returns the
    frames, their left halves and their shifts."""
    rng = np.random.default_rng(seed)
    shifts = rng.integers(MAIN["minDisparity"], MAIN["maxDisparity"] + 1,
                          STREAM_FRAMES)
    frames, lefts = [], []
    for s in shifts:
        n = rng.integers(0, 256, (h + 2, w + 2, 3)).astype(np.float32)
        left = np.rint(sum(n[dy:dy + h, dx:dx + w] for dy in range(3)
                           for dx in range(3)) / 9).astype(np.uint8)
        frames.append(np.concatenate([left, np.roll(left, -int(s), axis=1)],
                                     axis=1))
        lefts.append(left)
    return frames, np.stack(lefts), shifts


def wait_frame(cap, timeout=10.0):
    """cap.get() once a frame has arrived (as example 202 waits)."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        f = cap.get()
        if f is not None:
            return f
        time.sleep(0.001)
    raise AssertionError("Capture gave no frame in 10 s")


def stream_scores(L, disp, lefts, shifts, where):
    """Each grabbed pair's written frame (the nearest written left half,
    mean |d| on a 4x4-strided grid) and the share of its map's interior
    at that frame's shift; raises when a frame is not clearly nearer one
    written frame than every other (at most half the second distance)."""
    pad = MAIN["winSize"] // 2
    cand = lefts[:, ::4, ::4].astype(np.int16)
    out = []
    for f, d in zip(L, disp):
        dist = np.abs(cand - f[::4, ::4].astype(np.int16)).mean(
            axis=(1, 2, 3))
        k, k2 = np.argsort(dist)[:2]
        check(dist[k] <= 0.5 * dist[k2], f"{where}: a grabbed frame is "
              f"{dist[k]:.1f} from the nearest written frame and "
              f"{dist[k2]:.1f} from the next")
        inner = d[pad:-pad, MAIN["maxDisparity"] + pad:-pad]
        out.append((k, float((inner == shifts[k]).mean())))
    return out


def trace_summary(logdir, wall_s, batches):
    """Parse the trace's JSON: K1's kernels and the four ranges must be in
    it. Returns (K1 device ms a batch, busy share = union of device
    events over the traced wall time, host ms a batch of each range)."""
    from simplestereo_tpu_torch import profiling
    with open(logdir / profiling.PERFETTO_FILE) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kern if any(k in e["name"] for k in K1_KERNELS)]
    names = {k for k in K1_KERNELS if any(k in e["name"] for e in k1)}
    check("asw_select_kernel" in names and len(names) >= 2,
          f"trace {logdir.name}: K1's kernels {sorted(names)} of "
          f"{len(kern)} kernel events")
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in STREAM_RANGES:
            ranges.setdefault(e["name"], []).append(e["dur"] / 1e3)
    check(all(len(ranges.get(r, ())) == batches for r in STREAM_RANGES),
          f"trace {logdir.name}: ranges "
          f"{ {r: len(v) for r, v in ranges.items()} }, expected "
          f"{batches} of each of {STREAM_RANGES}")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -1e30
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return (sum(e["dur"] for e in k1) / 1e3 / batches, busy / 1e6 / wall_s,
            {r: statistics.median(v) for r, v in ranges.items()})


def stream_phase(dev, card):
    """Phase 24, the streaming stereo service at full width: two DIB and
    two MJPG AVIs written by the port's VideoWriter (12 side-by-side frames
    each, 1280x720 and 384x288 pairs), one Capture per file feeding
    batches of 8 pairs to StereoASW(**MAIN).computeBatch on K1, a warm
    batch and 4 under profiling.trace with the grab / upload / match /
    readback ranges; maps, K1 vs its twin, the trace, throughput, memory
    and host-clock stage times, and computeBatch with the grab threads
    stopped."""
    from simplestereo_tpu_torch import profiling, utils, videoio
    from simplestereo_tpu_torch.passive import StereoASW, asw_cuda

    root = stream_dir()
    m = StereoASW(device=dev, **MAIN)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    D = MAIN["maxDisparity"] - MAIN["minDisparity"] + 1
    t0 = time.perf_counter()
    streams = []
    for i, (h, w) in enumerate(STREAM_SHAPES):
        frames, lefts, shifts = stream_frames(h, w, STREAM_SEED + i)
        for codec in STREAM_CODECS:
            path = root / f"{w}x{h}_{codec.strip()}.avi"
            with videoio.VideoWriter(str(path), fps=30.0, codec=codec,
                                     quality=STREAM_QUALITY) as wr:
                for f in frames:
                    wr.write(f)
            streams.append((h, w, codec, path, lefts, shifts))
        del frames
    write_s = time.perf_counter() - t0

    asw_cuda.launches = 0
    calls = 0
    k1_err = None
    report = {}
    for h, w, codec, path, lefts, shifts in streams:
        name = f"{w}x{h} {codec.strip()}"
        pairs = profiling.Throughput(name, unit="pairs")
        rate = profiling.Throughput(name, unit="Mpix*disp")
        stages = []

        def batch(cap):
            t0 = time.perf_counter()
            with profiling.annotate("grab"):
                got = [wait_frame(cap) for _ in range(STREAM_B)]
            t1 = time.perf_counter()
            L = np.stack([g[:, :w] for g in got])
            R = np.stack([g[:, w:] for g in got])
            t2 = time.perf_counter()
            disp = m.computeBatch(L, R)
            stages.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
            return L, R, disp

        kept = []
        t_stream = time.perf_counter()
        with utils.Capture(str(path)) as cap:
            check(cap.isFile and cap.getResolution() == (2 * w, h),
                  f"{name}: Capture routing {type(cap._source).__name__} "
                  f"{cap.getResolution()}")
            if k1_err is None and (h, w) == STREAM_SHAPES[0]:
                with calls_of(asw_cuda, "_asw_pass") as k1_calls:
                    kept.append(batch(cap))
                # The first and the last frame of the stack (the twin
                # takes ~2 s a frame on three bands at this size).
                a, out, _ = k1_calls[0]
                ends = [0, STREAM_B - 1]
                k1_err = k1_on_path(
                    a.pop("planes")[ends], a,
                    tuple(None if t is None else t[ends] for t in out),
                    f"{name} streamed batch, frames {ends}")
                del a, out, k1_calls
            else:
                kept.append(batch(cap))
            warm_s = time.perf_counter() - t_stream
            logdir = root / f"trace_{w}x{h}_{codec.strip()}"
            t0 = time.perf_counter()
            with profiling.trace(logdir, device=dev):
                t1 = time.perf_counter()
                for _ in range(STREAM_TIMED):
                    with pairs.measure(STREAM_B), \
                            rate.measure(STREAM_B * h * w * D / 1e6):
                        kept.append(batch(cap))
                wall = time.perf_counter() - t1  # each batch ends in a readback
            trace_s = time.perf_counter() - t0
            L, R = kept[-1][0], kept[-1][1]
            busy_threads = host_ms(m.computeBatch, [(L, R)] * 5)[0]
        alone = host_ms(m.computeBatch, [(L, R)] * 5)[0]
        stream_s = time.perf_counter() - t_stream
        calls += 1 + STREAM_TIMED + 2 * 5
        k1_ms, busy, ranges = trace_summary(logdir, wall, STREAM_TIMED)
        scores = [s for L_, _, d in kept for s in
                  stream_scores(L_, d, lefts, shifts, name)]
        seen = sorted({k for k, _ in scores})
        share = float(np.mean([v for _, v in scores]))
        worst = min(v for _, v in scores)
        if codec == "DIB ":
            check(worst >= STREAM_BAR, f"{name}: a frame's map is at its "
                  f"shift on only {worst:.2%} of the interior")
        else:
            dib = report[f"{w}x{h} DIB"]["share"]
            check(share >= STREAM_MJPG * dib, f"{name}: share {share:.2%} "
                  f"< {STREAM_MJPG:.0%} of the DIB stream's {dib:.2%}")
        med = lambda k: statistics.median(s[k] for s in stages[1:]) * 1e3
        report[name] = dict(share=share, worst=worst, frames=len(seen),
                            pairs=pairs.report(), rate=rate.report(),
                            k1_ms=k1_ms, busy=busy, ranges=ranges,
                            grab=med(0), stack=med(1), call=med(2),
                            threads=busy_threads, alone=alone,
                            walls=(stream_s, warm_s, trace_s))
    n = asw_cuda.launches
    check(n == calls, f"streaming: {n} K1 launches, expected {calls}")
    mem = profiling.device_memory()
    parts = []
    for name, r in report.items():
        rg = r["ranges"]
        parts.append(
            f"{name}: share {r['share']:.2%} (worst frame {r['worst']:.2%}, "
            f"{r['frames']} of {STREAM_FRAMES} written frames seen), "
            f"{r['pairs']['pairs_per_s']:.1f} pairs/s, "
            f"{r['rate']['Mpix*disp_per_s']:.0f} Mpix*disp/s (traced), K1 "
            f"{r['k1_ms']:.2f} ms a batch (trace), device busy "
            f"{r['busy']:.1%}; host ms a batch: grab wait {r['grab']:.2f}, "
            f"stack {r['stack']:.2f}, computeBatch {r['call']:.2f} (ranges: "
            f"upload {rg['upload']:.2f}, match {rg['match']:.2f}, readback "
            f"{rg['readback']:.2f}; grab {rg['grab']:.2f}); computeBatch "
            f"untraced {r['threads']:.2f} with the grab thread running, "
            f"{r['alone']:.2f} with it stopped; stream wall "
            f"{r['walls'][0]:.2f} s (warm batch {r['walls'][1]:.2f}, trace "
            f"with its start and export {r['walls'][2]:.2f})")
    mem0 = next(iter(mem.values()))
    print(f"phase 24 streaming StereoASW(35, 14, 4, 15, 17.5, consistent) "
          f"B={STREAM_B} through Capture on 4 AVIs written in "
          f"{write_s:.2f} s (MJPG quality {STREAM_QUALITY}), K1 launches "
          f"{n}; K1 vs twin on frames 0 and {STREAM_B - 1} of the first "
          f"{STREAM_SHAPES[0][1]}x{STREAM_SHAPES[0][0]} batch "
          f"({k1_err[4]}): max "
          f"abs err {k1_err[0]:.3g}, rel {k1_err[1]:.3g}, map mismatch "
          f"{k1_err[2]:.4%} | " + " | ".join(parts)
          + f" | device memory in use {mem0['bytes_in_use'] / 2**20:.0f} "
          f"MiB, peak in this phase {mem0['peak_bytes_in_use'] / 2**20:.0f} "
          f"MiB of "
          f"{mem0['bytes_limit'] / 2**30:.1f} GiB | {card}")
    return root


def jpeg_phase(card, root):
    """Phase 25: the JPEG codec on the card's host (no Pillow there):
    1280x720 smooth frames round-trip within the JAX MJPG test's bar (mean
    |d| < 4), ms a frame each way, imgio's .jpg; then the port's
    202_streaming_pipeline.py at its own defaults on the card."""
    import pathlib
    import runpy
    import shutil
    from simplestereo_tpu_torch import imgio, native

    h, w = 720, 1280
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = [np.stack([xx * 200 / w + 8 * i, yy * 200 / h + 5 * i,
                        (xx + yy) * 150 / (w + h) + 20 * i], -1)
              .clip(0, 255).astype(np.uint8) for i in range(6)]
    enc_ms = host_ms(lambda f: native.jpeg_encode(f, 90),
                     [(f,) for f in frames])[0]
    data = [native.jpeg_encode(f, 90) for f in frames]
    dec_ms = host_ms(native.jpeg_decode, [(d,) for d in data])[0]
    errs = [float(np.abs(native.jpeg_decode(d).astype(int) - f).mean())
            for d, f in zip(data, frames)]
    check(max(errs) < 4, f"JPEG 1280x720 round trip: mean |d| {errs}")
    imgio.imwrite(str(root / "f.jpg"), frames[0])
    back = imgio.imread(str(root / "f.jpg"))
    check(back.shape == frames[0].shape and
          np.abs(back.astype(int) - frames[0]).mean() < 4,
          "imgio .jpg round trip")
    ex = pathlib.Path(__file__).resolve().parent / "simplestereo_tpu_torch" \
        / "examples" / "202_streaming_pipeline.py"
    argv = sys.argv
    sys.argv = [str(ex)]
    t0 = time.perf_counter()
    try:
        runpy.run_path(str(ex), run_name="__main__")
    finally:
        sys.argv = argv
    ex_s = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 25 JPEG 1280x720 smooth frames, quality 90, 4:2:0: "
          f"encode {enc_ms:.2f} ms, decode {dec_ms:.2f} ms a frame (host "
          f"clock, median of {len(frames) - 1}), mean |d| max "
          f"{max(errs):.3f} (bar 4); imgio .jpg round trip ok; example "
          f"202_streaming_pipeline.py on the card in {ex_s:.2f} s | {card}")


# Phases 26-28: the row-tiled paths of ``parallel``. The card is one, and
# NCCL takes one rank a card, so the distributed path runs as a world of
# one (phase 28): its halos are the image's boundary and its all-reduces
# the identity. What n tiles do is held here by chains of tiles in one
# process (phases 26-27); the collectives of n > 1 ranks by the CPU tests
# on gloo.
TILES = 4


def tile_rows(H, halo, i, dev):
    """Rows of tile i of TILES (H / TILES rows and ``halo`` on each side,
    clamped to the image) and their (rows,) validity, on ``dev``."""
    hl = H // TILES
    idx = torch.arange(i * hl - halo, (i + 1) * hl + halo, device=dev)
    valid = (idx >= 0) & (idx < H)
    return idx.clamp(0, H - 1), valid


def k1_tiles_phase(dev, card):
    """Phase 26: the ASW main configuration at 1280x720 cut into TILES row
    tiles with real halos and row_valid, each through K1 in context mode;
    concatenated they must equal the whole image's pass and map (bit for
    bit, else compare_pass's rule); the context pass against its twin on
    two tiles; the same at 384x288 with B = 8 through the batch form."""
    from simplestereo_tpu_torch.passive import asw_cuda

    win = MAIN["winSize"]
    pad = win // 2
    kw = dict(win_size=win, min_disp=MAIN["minDisparity"],
              max_disp=MAIN["maxDisparity"], gamma_c=float(MAIN["gammaC"]),
              gamma_p=float(MAIN["gammaP"]), consistent=True)
    fkw = dict(min_disp=kw["min_disp"], max_disp=kw["max_disp"],
               consistent=True, subpixel=False)
    dkw = {k: v for k, v in kw.items()}
    parts = []
    for (h, w), B in (((720, 1280), 1), ((288, 384), 8)):
        left, right = pair(h, w)
        L = torch.tensor(np.stack([np.roll(left, i, axis=0)
                                   for i in range(B)]), device=dev)
        R = torch.tensor(np.stack([np.roll(right, i, axis=0)
                                   for i in range(B)]), device=dev)
        hl = h // TILES
        planes = asw_cuda._build_planes(L, R, win, kw["min_disp"],
                                        kw["max_disp"])
        whole = asw_cuda._asw_pass(planes, H=h, W=w, **kw)
        whole_map = asw_cuda.asw_disparity_batch(L, R, **dkw)
        tiles, maps, inputs = [], [], []
        for i in range(TILES):
            idx, valid = tile_rows(h, pad, i, dev)
            keep = valid[None, :, None, None]
            e1 = torch.where(keep, L[:, idx], 0)
            e2 = torch.where(keep, R[:, idx], 0)
            rv = valid.expand(B, -1)
            inputs.append((e1, e2, rv))
            tp = asw_cuda._build_planes(e1, e2, win, kw["min_disp"],
                                        kw["max_disp"], row_valid=rv,
                                        context=True)
            k = asw_cuda._asw_pass(tp, H=hl, W=w, context=True, **kw)
            tiles.append(k)
            maps.append(asw_cuda.asw_disparity_batch(
                e1, e2, row_valid=rv, context=True, **dkw))
            if B == 1 and i < 2:  # the context pass against its twin
                p = asw_cuda._asw_pass_plain(tp, H=hl, W=w, context=True,
                                             **kw)
                compare_pass(k, p, kw["min_disp"],
                             f"K1 context tile {i} at {w}x{h}")
                del p
        cat = (torch.cat([t[0] for t in tiles], 2),
               torch.cat([t[1] for t in tiles], 1),
               torch.cat([t[2] for t in tiles], 1), None)
        tiled_map = torch.cat(maps, 1)
        bit = all(torch.equal(a, b) for a, b in zip(cat[:3], whole[:3]))
        if bit:
            check(torch.equal(tiled_map, whole_map),
                  f"K1 tiles {w}x{h}: map differs from the whole image's")
            rule = "bit-equal"
        else:
            errs = compare_pass(cat, whole, kw["min_disp"],
                                f"K1 tiles vs whole {w}x{h}")
            m = (tiled_map != whole_map).double().mean().item()
            check(m <= MISMATCH, f"K1 tiles {w}x{h}: map mismatch {m:.2%}")
            rule = (f"not bit-equal: cost rel err {errs[1]:.3g}, pass map "
                    f"mismatch {errs[2]:.4%}, final map mismatch {m:.4%}")
        whole_ms, _ = cuda_ms(lambda x: asw_cuda.asw_disparity_batch(
            L, R, **dkw), [None] * 6)
        tiled_ms, _ = cuda_ms(lambda x: [asw_cuda.asw_disparity_batch(
            e1, e2, row_valid=rv, context=True, **dkw)
            for e1, e2, rv in inputs], [None] * 6)
        parts.append(
            f"{w}x{h} B={B}: {TILES} tiles of {hl} rows + 2 x {pad} halo "
            f"rows ({(hl + 2 * pad) / hl:.3f}x the rows read), passes and "
            f"maps {rule}{'; tiles 0-1 vs twin ok' if B == 1 else ''}; "
            f"{TILES} tile calls {tiled_ms:.3f} ms vs the untiled call "
            f"{whole_ms:.3f} ms (CUDA events)")
        del planes, whole, tiles, cat
        torch.cuda.empty_cache()
    print(f"phase 26 K1 in context mode (win {win}, d {kw['min_disp']}.."
          f"{kw['max_disp']}, consistent; the twin held to compare_pass's "
          f"gates) | " + " | ".join(parts) + f" | {card}")


def k2_carry_phase(dev, card):
    """Phase 27: K2's direction families with a carry-in. Every family
    with a random non-zero carry against the twin (each direction's L
    torch.equal) on small random volumes in every kernel form (D 1, 16,
    40, 100 with 16-byte loads, 130, 300 on the first version; 8 and 4
    paths); then the 720p D = 128 BT volume cut into TILES row tiles,
    downward and upward chained through K2 with carries: the tiles' S
    torch.equal to the whole volume's, one tile's families torch.equal to
    the twin from the same carries; times. Returns the kernels-line entry
    of the carry mode (its launches are set by phase 28)."""
    from simplestereo_tpu_torch.passive import StereoSGM, sgm, sgm_cuda

    rng = np.random.default_rng(SEED + 9)
    forms = set()
    for h, w, D in ((45, 150, 1), (45, 150, 16), (45, 150, 40),
                    (37, 101, 100), (45, 150, 130), (20, 64, 300)):
        for paths in (8, 4):
            C = torch.tensor(rng.integers(0, 200, (h, w, D)).astype(
                np.float32), device=dev)
            k_out = p_out = None
            for fam in ("horizontal", "down", "up"):
                first, n, step = sgm_cuda._family(fam, paths)
                carry = None if fam == "horizontal" else torch.tensor(
                    rng.integers(0, 300, (n, w, D)).astype(np.float32),
                    device=dev)
                k_out = sgm_cuda.aggregate(C, 12.0, 40.0, paths,
                                           directions=fam, carry=carry,
                                           out=k_out)
                p_out = sgm_cuda._aggregate(C, 12.0, 40.0, paths,
                                            directions=fam, carry=carry,
                                            out=p_out)
                torch.cuda.synchronize()
                for j in range(first, first + n * step, step):
                    check(torch.equal(k_out[j], p_out[j]),
                          f"K2 family {fam} direction {j} ({h}x{w} D={D}, "
                          f"{paths} paths) differs from the twin, max abs "
                          f"err {(k_out[j] - p_out[j]).abs().max():.3g}")
            check(torch.equal(sgm_cuda.sum_paths(k_out),
                              sgm_cuda._sum_plain(p_out)),
                  f"K2 sum of the buffers ({h}x{w} D={D}, {paths} paths)")
            forms.add(sgm_cuda._plan(1, h, w, D, paths)["npl"])
    check(forms == {0, *sgm_cuda.NPL}, f"phase 27 ran forms {forms}")

    (h, w), cfg = SGM_MAIN[1]
    m = StereoSGM(device="cuda", **cfg)
    P1, P2, paths, D = float(m.P1), float(m.P2), m.paths, cfg["numDisparities"]
    left, right = pair(h, w)
    kw = m._kwargs(subpixel=True)
    C = sgm._cost_from_gray(
        sgm._gray_frames(torch.tensor(left[None], device=dev)),
        sgm._gray_frames(torch.tensor(right[None], device=dev)),
        **{k: kw[k] for k in ("min_disp", "num_disp", "block_size",
                              "prefilter_cap", "cost_method",
                              "census_window")})[0].contiguous()
    hl = h // TILES
    tiles = [C[i * hl:(i + 1) * hl] for i in range(TILES)]

    def chain():
        Ls = [sgm_cuda.aggregate(t, P1, P2, paths, directions="horizontal")
              for t in tiles]
        carries = {}
        for fam, order in (("down", range(TILES)),
                           ("up", range(TILES - 1, -1, -1))):
            carry = None
            for i in order:
                carries[(fam, i)] = carry
                sgm_cuda.aggregate(tiles[i], P1, P2, paths, directions=fam,
                                   carry=carry, out=Ls[i])
                carry = sgm_cuda.carry_of(Ls[i], fam, paths)
        return Ls, carries

    S_whole = sgm_cuda.aggregate(C, P1, P2, paths)
    n0 = sgm_cuda.launches
    Ls, carries = chain()
    S_tiled = torch.cat([sgm_cuda.sum_paths(L) for L in Ls])
    torch.cuda.synchronize()
    per_tile = (sgm_cuda.launches - n0) / TILES
    check(torch.equal(S_tiled, S_whole),
          f"K2 tiles at {w}x{h} D={D}: S differs from the whole volume's, "
          f"max abs err {(S_tiled - S_whole).abs().max().item():.3g}")
    del S_tiled
    # the twin from the same carries on tile 1 (a carry in both families)
    for fam in ("down", "up"):
        first, n, step = sgm_cuda._family(fam, paths)
        p = sgm_cuda._aggregate(tiles[1], P1, P2, paths, directions=fam,
                                carry=carries[(fam, 1)])
        for j in range(first, first + n * step, step):
            check(torch.equal(Ls[1][j], p[j]), f"K2 tile 1 {fam} direction "
                  f"{j} differs from the twin with the same carry")
        del p
    del Ls
    torch.cuda.empty_cache()

    # times: the whole volume, the chain, one stage's launch and its twin
    whole_ms, _ = cuda_ms(lambda x: sgm_cuda.aggregate(C, P1, P2, paths),
                          [None] * 5)
    chain_ms, _ = cuda_ms(lambda x: [sgm_cuda.sum_paths(L)
                                     for L in chain()[0]], [None] * 4)
    L1 = sgm_cuda.aggregate(tiles[1], P1, P2, paths, directions="horizontal")
    cd = carries[("down", 1)]
    stage = lambda x: sgm_cuda.aggregate(tiles[1], P1, P2, paths,  # noqa
                                         directions="down", carry=cd, out=L1)
    stage_ms, _ = cuda_ms(stage, [None] * 6)
    horiz_ms, _ = cuda_ms(lambda x: sgm_cuda.aggregate(
        tiles[1], P1, P2, paths, directions="horizontal", out=L1),
        [None] * 6)
    sum_ms, _ = cuda_ms(lambda x: sgm_cuda.sum_paths(L1), [None] * 6)
    plain_ms, _ = cuda_ms(lambda x: sgm_cuda._aggregate(
        tiles[1], P1, P2, paths, directions="down", carry=cd), [None] * 3)
    vol = hl * w * D
    # the stage reads its tile's C and the carry once and writes 3 L
    # buffers; per (direction, pixel, d) the recurrence's 8 operations
    bound_ms, bound_by = bound(3 * 8 * vol, (4 * vol + 3 * w * D) * 4)
    print(f"phase 27 K2 families with a carry-in: every family with a "
          f"random carry vs the twin, each direction's L torch.equal, on 6 "
          f"volumes x 8/4 paths (disparities a lane {sorted(forms)}, 0 = the "
          f"first version) | {w}x{h} D={D} BT as {TILES} tiles of {hl} rows, "
          f"down and up chained through K2: S torch.equal to the whole "
          f"volume's, tile 1's families torch.equal to the twin from the "
          f"same carries; {per_tile:.0f} K2 calls a tile (horizontal, down, "
          f"up, sum) | CUDA events: whole volume {whole_ms:.3f} ms, the "
          f"chain {chain_ms:.3f} ms; one tile's stages: horizontal "
          f"{horiz_ms:.3f} ms, down with a carry {stage_ms:.3f} ms (twin "
          f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms, {bound_by}), sum "
          f"{sum_ms:.3f} ms | {card}")
    return {"name": "sgm_scan (carry mode)", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/sgm_kernel.cu",
            "replaces": "simplestereo_tpu/passive/sgm_pallas.py:72",
            "launches": None, "max_abs_err": 0.0, "ms": stage_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def distributed_phase(dev, card):
    """Phase 28: the port's ``parallel`` on an explicit one-rank NCCL group
    on cuda:0: tiled ASW (single and batch), SGM and GSW at 1280x720, the
    sharded FTP cloud on phase 20's scene, the Gauss-Newton on a mesh (16
    views) and dryrun_multichip(1). The launch counts of K1, K2 and K3
    are set to 0 before and read after; then each result is held equal to
    its single-card call. Returns the counts."""
    import torch.distributed as dist
    import simplestereo_tpu_torch as tss
    from simplestereo_tpu_torch import parallel
    from simplestereo_tpu_torch.calibration import sharded
    from simplestereo_tpu_torch.parallel import dryrun
    from simplestereo_tpu_torch.passive import asw_cuda, gsw_cuda, sgm_cuda
    from simplestereo_tpu_torch.passive.gsw import gsw_disparity
    from simplestereo_tpu_torch.passive.sgm import _sgm_disparity

    t0 = time.perf_counter()
    parallel.init_distributed("cuda", world_size=1, rank=0)
    rows = parallel.make_mesh({"rows": 1})
    both = parallel.make_mesh({"batch": 1, "rows": 1})
    views = parallel.make_mesh({"views": 1})
    check(dist.get_backend() == "nccl" and parallel.mesh_device(rows) == dev,
          f"phase 28: backend {dist.get_backend()}, device "
          f"{parallel.mesh_device(rows)}")
    start_s = time.perf_counter() - t0

    (h, w) = (720, 1280)
    left, right = pair(h, w)
    lefts = np.stack([np.roll(left, i, axis=0) for i in range(2)])
    rights = np.stack([np.roll(right, i, axis=0) for i in range(2)])
    akw = dict(win_size=MAIN["winSize"], min_disp=MAIN["minDisparity"],
               max_disp=MAIN["maxDisparity"], gamma_c=MAIN["gammaC"],
               gamma_p=MAIN["gammaP"], consistent=True)
    scfg = SGM_MAIN[1][1]
    skw = dict(min_disp=0, num_disp=scfg["numDisparities"],
               block_size=scfg["blockSize"], P1=scfg["P1"], P2=scfg["P2"],
               paths=8, prefilter_cap=float(scfg["preFilterCap"]),
               uniqueness=float(scfg["uniquenessRatio"]),
               disp12_max_diff=-1, subpixel=True, cost_method="bt",
               census_window=5)
    gkw = dict(win_size=GSW_MAIN["winSize"], max_disp=GSW_MAIN["maxDisparity"],
               min_disp=GSW_MAIN["minDisparity"], gamma=GSW_MAIN["gamma"],
               f_max=float(GSW_MAIN["fMax"]), consistent=True)
    rig = scan_rig(dev)
    fringe = tss.active.buildFringe(FTP_PERIOD, dims=SCAN_RES,
                                    stripeColor="red")
    cam = render_stack([fringe], *plane_to_projector(rig, FTP_Z0), dev,
                       "linear")[0]
    ftp = tss.active.StereoFTP(rig, fringe, FTP_PERIOD, device=dev)
    roi = (16, 16, SCAN_RES[0] - 32, SCAN_RES[1] - 32)
    K_true, gn_args = gn_views()

    calls = {
        "asw": (lambda: parallel.tiled_asw_disparity(left, right, rows,
                                                     **akw),
                lambda: asw_cuda.asw_disparity(
                    torch.tensor(left, device=dev),
                    torch.tensor(right, device=dev), **akw)),
        "asw_batch": (lambda: parallel.tiled_asw_disparity_batch(
            lefts, rights, both, **akw), lambda: asw_cuda.asw_disparity_batch(
                torch.tensor(lefts, device=dev),
                torch.tensor(rights, device=dev), **akw)),
        "sgm": (lambda: parallel.tiled_sgm_disparity(left, right, rows,
                                                     **skw),
                lambda: _sgm_disparity(torch.tensor(left, device=dev),
                                       torch.tensor(right, device=dev),
                                       **skw)),
        "gsw": (lambda: parallel.tiled_gsw_disparity(left, right, rows,
                                                     **gkw),
                lambda: gsw_disparity(torch.tensor(left, device=dev),
                                      torch.tensor(right, device=dev),
                                      iterations=1, **gkw)),
        "gsw_normalize": (lambda: parallel.tiled_gsw_disparity(
            left, right, rows, normalize=True, **gkw),
            lambda: gsw_disparity(torch.tensor(left, device=dev),
                                  torch.tensor(right, device=dev),
                                  iterations=1, normalize=True, **gkw)),
        "ftp": (lambda: parallel.sharded_ftp_cloud(ftp, cam, rows, roi=roi),
                lambda: ftp.getCloud(cam, roi=roi)),
        "gn": (lambda: sharded.calibrate_camera_sharded(
            *gn_args, mesh=views, iterations=25),
            lambda: sharded.calibrate_camera_sharded(
                *gn_args, iterations=25, device=dev)),
    }
    asw_cuda.launches = sgm_cuda.launches = gsw_cuda.launches = 0
    sgm_cuda.post_launches = 0
    tiled = {name: run() for name, (run, _) in calls.items()}
    dry = dryrun.dryrun_multichip(1, "cuda")
    torch.cuda.synchronize()
    counts = {"asw": asw_cuda.launches, "sgm": sgm_cuda.launches,
              "sgm_post": sgm_cuda.post_launches, "gsw": gsw_cuda.launches}
    check(all(counts.values()), f"phase 28: kernel launches {counts}")

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)

    times = []
    for name, (run, single) in calls.items():
        check(same(tiled[name], single()), f"phase 28 {name}: the mesh's "
              f"result differs from the single-card call")
        t_ms, _ = host_ms(lambda: (run(), torch.cuda.synchronize()),
                          [()] * 4)
        s_ms, _ = host_ms(lambda: (single(), torch.cuda.synchronize()),
                          [()] * 4)
        times.append(f"{name} {t_ms:.2f} / {s_ms:.2f}")
    rms, Ke = tiled["gn"][0], tiled["gn"][1]
    check(rms < 0.25 and np.abs(Ke - K_true).max() < 5.0,
          f"phase 28 gn: RMS {rms:.4f}")
    check(tuple(dry["disp"].shape) == (2, 8, 32)
          and np.isfinite(dry["mean_disp"]), "phase 28: dryrun_multichip")
    dist.destroy_process_group()
    print(f"phase 28 parallel on NCCL, a world of one on {dev} (group up "
          f"in {start_s:.2f} s; meshes rows 1, batch 1 x rows 1, views 1): "
          f"tiled ASW 1280x720 and a batch of 2, tiled SGM BT D=128, tiled "
          f"GSW (and normalize) at 1280x720, sharded FTP on phase 20's "
          f"scene, Gauss-Newton on a mesh (16 views, 25 iterations), "
          f"dryrun_multichip(1): each equal to its single-card call; "
          f"launches in that run: K1 {counts['asw']}, K2 {counts['sgm']}, "
          f"K3 {counts['gsw']}, SGM post {counts['sgm_post']} | host "
          f"clock, mesh / single card, ms: " + ", ".join(times)
          + f" | {card}")
    return counts


# Phase 29: the image formats of ``imgio`` on the card's host, which has
# no Pillow: (a) every committed fixture (tests/golden/torch_imgio/, one
# small file of each format and variant, written by Pillow or built by
# tests/image_files.py, and four 1280x720 files held to digests) decodes
# to the arrays Pillow gave when it was made, and refuses where Pillow's
# convert refused; (b) the stream's side-by-side frames as folders of BMP
# and TIFF (the port's imwrite) and of JPEG-in-TIFF (strips coded by the
# port's own JPEG encoder, tables in JPEGTables), and as a list of VP8L
# WebP files (image_files.webp_lossless; the JAX Capture scans folders
# for .png/.jpg/.jpeg/.bmp/.tif/.tiff only), stream through Capture into
# StereoASW(**MAIN).computeBatch on K1: the lossless ones' maps must equal
# those of the frames in memory, JPEG-in-TIFF's those of computeBatch on
# the same files decoded first; (c) host-clock ms to decode one 1280x720
# frame in each format.
FORMAT_SHAPE = (720, 1280)
FORMAT_SEED = 29
FORMAT_STREAMS = ("BMP", "TIFF", "JPEG-in-TIFF", "WebP lossless")
FORMAT_REPS = 6      # decodes timed a format, after one warm decode
FORMAT_JPEG_Q = 90   # the JPEG-in-TIFF strips' quality
# CIELab: Pillow converts LAB to RGB through LittleCMS; the port refuses.
FORMAT_LAB_TO_RGB_REFUSED = ("tif-pillow-LAB", "tif-mm-lab-lzw")


def _fixtures():
    """tests/ on sys.path (image_files.py builds the 720p files), the
    fixtures' folder and its fixtures.json."""
    import pathlib
    tests_on_path()
    folder = (pathlib.Path(__file__).resolve().parent / "tests" / "golden"
              / "torch_imgio")
    return folder, json.loads((folder / "fixtures.json").read_text())


def same_array(a, b, where):
    check(a.dtype == b.dtype and a.shape == b.shape
          and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"),
          f"{where}: {a.dtype}{a.shape} differs from {b.dtype}{b.shape}")


def refuses(fn, where):
    try:
        fn()
    except ValueError:
        return
    check(False, f"{where}: read where Pillow's convert refuses")


def fixtures_part():
    """Phase 29 (a): every fixture against Pillow's stored arrays."""
    from simplestereo_tpu_torch import imgio
    folder, meta = _fixtures()
    import image_files
    with np.load(folder / "pillow.npz") as z:
        stored = {k: z[k] for k in z.files}
    for name, fname in sorted(meta["files"].items()):
        path = str(folder / fname)
        samples = stored[f"{name}/samples"]
        same_array(imgio.read_samples(path), samples, f"fixture {name}")
        no = meta["refuses"].get(name, [])
        if "L" in no:
            refuses(lambda: imgio.imread(path, True), f"fixture {name} gray")
        else:
            same_array(imgio.imread(path, grayscale=True),
                       stored.get(f"{name}/L", samples),
                       f"fixture {name} gray")
        if "RGB" in no or name in FORMAT_LAB_TO_RGB_REFUSED:
            refuses(lambda: imgio.imread(path), f"fixture {name} colour")
        else:
            same_array(imgio.imread(path),
                       stored.get(f"{name}/RGB", samples)[:, :, ::-1],
                       f"fixture {name} colour")
    for name, rec in meta["large"].items():
        path = str(folder / rec["file"])
        check(image_files.digest(imgio.read_samples(path)) == rec["samples"]
              and image_files.digest(imgio.imread(path, True)) == rec["L"],
              f"fixture {name}: digest differs from Pillow's")
    kinds = sorted({n.split("-")[0] for n in meta["files"]})
    return len(meta["files"]) + len(meta["large"]), kinds, meta["pillow"]


def jpeg_tiff(rgb):
    """JPEG-in-TIFF bytes of (h, w, 3) uint8 RGB: YCbCr 4:2:0, strips of 16
    rows, each coded by the port's JPEG encoder, the shared tables in
    JPEGTables (tests/image_files.py's TIFF writer)."""
    import image_files
    from simplestereo_tpu_torch import native
    enc = lambda blk: native.jpeg_encode(blk.astype(np.uint8), FORMAT_JPEG_Q,
                                         bgr=False)
    return image_files.tiff(rgb, 8, 6, comp=7, encode=enc, rows_per_strip=16,
                            subsampling=(2, 2), jpeg_tables=True)


def decode_files(root, frame):
    """{format: (path, what its decode must equal)}: one 1280x720 frame
    in each timed format, under root. The port writes 8-bit PNG, BMP and
    raw TIFF; tests/image_files.py builds 16-bit gray, palette and Adam7
    PNG, LZW and Deflate TIFF with the predictor (strips of 17 rows, as
    libtiff writes them), 16-bit PGM, PFM, float TIFF, JPEG-in-TIFF, GIF
    and VP8L WebP; the progressive JPEG, lossy WebP, CMYK JPEG and CCITT
    Group 4 TIFF are the committed fixtures (Pillow's), held to digests.
    The JPEG-in-TIFF frame must equal its strips, each coded and decoded
    as a JPEG file of its own."""
    from simplestereo_tpu_torch import imgio
    folder, meta = _fixtures()
    import image_files
    rgb = frame[:, :, ::-1]
    g16 = frame[:, :, 1].astype(np.uint16) * 257 + frame[:, :, 0]
    f32 = (frame[:, :, 0].astype(np.float32) - 100.5) / 7
    pal = np.random.default_rng(FORMAT_SEED).integers(0, 256, (256, 3))
    out = {}

    def put(name, ext, data, expect):
        p = root / f"{name}{ext}"
        p.write_bytes(data)
        out[name] = (str(p), expect)

    for name, ext in (("PNG 8-bit RGB", ".png"), ("BMP 24-bit", ".bmp"),
                      ("TIFF raw", ".tif")):
        p = root / f"{name}{ext}"
        imgio.imwrite(str(p), frame)
        out[name] = (str(p), rgb)
    put("PNG 16-bit gray", ".png", image_files.png(g16[:, :, None], 16, 0),
        g16)
    put("PNG palette", ".png", image_files.png(frame[:, :, :1], 8, 3, pal),
        frame[:, :, 0])
    put("PNG Adam7 RGB", ".png", image_files.png(rgb, 8, 2, interlace=True),
        rgb)
    put("TIFF LZW predictor", ".tif", image_files.tiff(
        rgb, 8, 2, comp=5, predictor=2, rows_per_strip=17), rgb)
    put("TIFF Deflate predictor", ".tif", image_files.tiff(
        rgb, 8, 2, comp=8, predictor=2, rows_per_strip=17), rgb)
    put("PGM 16-bit", ".pgm", image_files.pnm(b"P5", g16, 65535),
        g16.astype(np.int32))
    put("PFM", ".pfm", image_files.pnm(b"Pf", f32, scale=-1.0), f32)
    put("TIFF float32", ".tif", image_files.tiff(
        f32[:, :, None], 32, 1, sample_format=3, rows_per_strip=17), f32)
    from simplestereo_tpu_torch import native
    strips = np.concatenate([native.jpeg_decode(native.jpeg_encode(
        rgb[y:y + 16], FORMAT_JPEG_Q, bgr=False), bgr=False)
        for y in range(0, rgb.shape[0], 16)])
    put("JPEG-in-TIFF", ".tif", jpeg_tiff(rgb), strips)
    put("GIF", ".gif", image_files.gif(
        [(frame[:, :, 0], 0, 0, None, False)], frame.shape[:2], pal),
        frame[:, :, 0])
    put("WebP lossless", ".webp", image_files.webp_lossless(rgb), rgb)
    for name, key in (("JPEG progressive", "jpg-progressive-1280x720"),
                      ("JPEG CMYK", "jpg-cmyk-1280x720"),
                      ("CCITT Group 4", "tif-group4-1280x720"),
                      ("WebP lossy", "webp-lossy-1280x720")):
        rec = meta["large"][key]
        out[name] = (str(folder / rec["file"]), rec["samples"])
    return out


def formats_phase(dev, card):
    """Phase 29: fixtures, BMP, TIFF, JPEG-in-TIFF and WebP captures
    through K1, and decode times of 1280x720 frames."""
    from simplestereo_tpu_torch import imgio, profiling, utils
    from simplestereo_tpu_torch.formats import reversed_rgb
    from simplestereo_tpu_torch.passive import StereoASW, asw_cuda

    t0 = time.perf_counter()
    n_fix, kinds, pil = fixtures_part()
    import image_files
    fix_s = time.perf_counter() - t0

    h, w = FORMAT_SHAPE
    root = stream_dir()
    frames, _, shifts = stream_frames(h, w, FORMAT_SEED)
    check(len({f.tobytes() for f in frames}) == len(frames),
          "phase 29: two stream frames are equal")
    t0 = time.perf_counter()
    sources, write_s = {}, {}
    for kind in FORMAT_STREAMS:
        t1 = time.perf_counter()
        folder = root / kind.split()[0].lower()
        folder.mkdir()
        paths = []
        for i, f in enumerate(frames):
            if kind in ("BMP", "TIFF"):
                p = folder / f"{i:03d}.{kind.lower()[:3]}"
                imgio.imwrite(str(p), f)
            elif kind == "JPEG-in-TIFF":
                p = folder / f"{i:03d}.tif"
                p.write_bytes(jpeg_tiff(f[:, :, ::-1]))
            else:
                p = folder / f"{i:03d}.webp"
                p.write_bytes(image_files.webp_lossless(f[:, :, ::-1]))
            paths.append(str(p))
        # The JAX Capture scans a folder for .bmp and .tif, not .webp.
        sources[kind] = (str(folder) if kind != "WebP lossless" else paths,
                         paths)
        write_s[kind] = time.perf_counter() - t1
    m = StereoASW(device=dev, **MAIN)

    def maps(fr):
        L0 = np.stack([f[:, :w] for f in fr])
        R0 = np.stack([f[:, w:] for f in fr])
        return np.concatenate([m.computeBatch(L0[a:a + STREAM_B],
                                              R0[a:a + STREAM_B])
                               for a in range(0, len(fr), STREAM_B)])

    ref = maps(frames)
    pad = MAIN["winSize"] // 2
    inner = ref[:, pad:-pad, MAIN["maxDisparity"] + pad:-pad]
    share = float((inner == shifts[:, None, None]).mean())
    check(share >= STREAM_BAR, f"phase 29 in-memory maps: {share:.2%} of "
          "the interior at the frames' shifts")
    # Each stream's frames as Capture gives them (BGR, contiguous) and the
    # maps they must give: the in-memory ones for the lossless formats,
    # those of the decoded files for JPEG-in-TIFF.
    expected = {}
    for kind, (_, paths) in sources.items():
        if kind == "JPEG-in-TIFF":
            dec = [reversed_rgb(imgio.read_samples(p)) for p in paths]
            dec_maps = maps(dec)
            expected[kind] = ({f.tobytes(): i for i, f in enumerate(dec)},
                              dec_maps)
            jpeg_share = float((dec_maps[:, pad:-pad, MAIN["maxDisparity"]
                                         + pad:-pad]
                                == shifts[:, None, None]).mean())
        else:
            expected[kind] = ({f.tobytes(): i for i, f in enumerate(frames)},
                              ref)

    report = {}
    asw_cuda.launches = 0
    with calls_of(asw_cuda, "_asw_pass") as k1_calls:
        for kind, (source, _) in sources.items():
            name = f"{w}x{h} {kind}"
            index, want = expected[kind]
            pairs = profiling.Throughput(name, unit="pairs")
            kept, stages = [], []

            def batch(cap):
                t0 = time.perf_counter()
                got = [wait_frame(cap) for _ in range(STREAM_B)]
                t1 = time.perf_counter()
                L = np.stack([g[:, :w] for g in got])
                R = np.stack([g[:, w:] for g in got])
                t2 = time.perf_counter()
                kept.append((got, m.computeBatch(L, R)))
                stages.append((t1 - t0, t2 - t1, time.perf_counter() - t2))

            t_stream = time.perf_counter()
            with utils.Capture(source) as cap:
                check(cap.isFile, f"{name}: Capture is not a file sequence")
                batch(cap)  # warm
                for _ in range(STREAM_TIMED):
                    with pairs.measure(STREAM_B):
                        batch(cap)
            stream_s = time.perf_counter() - t_stream
            # Each grabbed frame is one of the written ones (decoded), byte
            # for byte, and its map is the one that frame must give.
            seen = set()
            for got, disp in kept:
                for g, d in zip(got, disp):
                    k = index.get(g.tobytes())
                    check(k is not None, f"{name}: a grabbed frame equals "
                          "no written frame")
                    check(np.array_equal(d, want[k]), f"{name}: the map of "
                          f"frame {k} differs from the expected map")
                    seen.add(k)
            med = [statistics.median(st[i] for st in stages[1:]) * 1e3
                   for i in range(3)]
            report[name] = (pairs.report()["pairs_per_s"], len(seen),
                            stream_s, med)
    n = asw_cuda.launches
    calls = len(FORMAT_STREAMS) * (1 + STREAM_TIMED)
    check(n == calls and len(k1_calls) == calls,
          f"phase 29: {n} K1 launches ({len(k1_calls)} calls seen), "
          f"expected {calls}")

    t0 = time.perf_counter()
    files = decode_files(root, frames[0][:, :w])
    build_s = time.perf_counter() - t0
    times = {}
    for name, (path, expect) in files.items():
        got = imgio.read_samples(path)
        if isinstance(expect, str):
            check(image_files.digest(got) == expect,
                  f"decode {name}: digest differs from Pillow's")
        else:
            same_array(got, expect, f"decode {name}")
        times[name] = host_ms(imgio.read_samples,
                              [(path,)] * (FORMAT_REPS + 1))[0]
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    print(f"phase 29 image formats: (a) {n_fix} fixtures ({', '.join(kinds)}"
          f"; arrays of Pillow {pil}) equal on this host in {fix_s:.2f} s | "
          f"(b) {len(frames)} side-by-side {2 * w}x{h} frames written as "
          + ", ".join(f"{k} ({v:.2f} s)" for k, v in write_s.items())
          + f", each through Capture into StereoASW(35, 14, 4, 15, 17.5, "
          f"consistent).computeBatch B={STREAM_B} (one warm batch, "
          f"{STREAM_TIMED} timed), maps equal to the in-memory frames' "
          f"({share:.2%} of their interior at the shift; JPEG-in-TIFF's to "
          f"the decoded files', {jpeg_share:.2%}), K1 launches {n}: "
          + ", ".join(f"{k} {v[0]:.1f} pairs/s ({v[1]} of {len(frames)} "
                      f"frames seen; host ms a batch: grab wait {v[3][0]:.2f}"
                      f", stack {v[3][1]:.2f}, computeBatch {v[3][2]:.2f}; "
                      f"stream wall {v[2]:.2f} s)"
                      for k, v in report.items())
          + f" | (c) ms to decode one {w}x{h} frame (imgio.read_samples, "
          f"host clock, median of {FORMAT_REPS}; files built in "
          f"{build_s:.2f} s): "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f" | {card}")
    return report, times


# Phase 30: the port's example scripts, the entry points that mirror the
# JAX package's, on tests/torch_example_res.py's stand-in resource tree at
# the reference's sizes (1280x720 rigs, lawn pair and camera-projector
# rig; 384x288 Tsukuba), each run with runpy at its default device, the
# card: every script but 202 (phase 25). The kernels' counts are set to 0
# just before a script and read just after; spies keep what each kernel's
# wrapper was given and returned, to be held against the twins after.
EXAMPLES_SIZE = "full"
# The kernels each script's path launches; every other count must stay 0.
EXAMPLE_KERNELS = {"008": {"K2"}, "009": {"K1"}, "010": {"K1", "K2", "K3"},
                   "011": {"K2", "S2"}, "201": {"K1", "K2", "K3"},
                   "204": {"K3"}}


def k3_on_path(a, out, where, flat_ok=False):
    """K3's pass on a path's own planes (``a``: its arguments, ``out``:
    what the launch returned) against the twin: the kernel again with
    its costs (a compare launch), its map equal to the path's, then
    compare_pass's gates on costs and map (``flat_ok`` as compare_pass's).
    Returns compare_pass's errors."""
    from simplestereo_tpu_torch.passive import gsw_cuda
    kw = {k: v for k, v in a.items()
          if k not in ("planes", "plan", "return_cost")}
    kd, kc = gsw_cuda._gsw_pass(a["planes"], return_cost=True, **kw)
    check(torch.equal(kd, out[0]), f"{where}: K3's map differs from the "
          f"path's launch on the same planes")
    pd, pc = gsw_cuda._gsw_pass_plain(a["planes"], return_cost=True, **kw)
    return compare_pass((kc, kd, None, None), (pc, pd, None, None),
                        kw["min_disp"], where, flat_ok)


def examples_phase(dev, card):
    """Phase 30: the 19 example scripts no other phase runs, on the card,
    on a stand-in resource tree at the reference's sizes: their truths,
    the kernels on the scripts' own inputs against their twins, the
    launch counts, the outputs of the cheap ones against the same script
    with --device cpu, and each script's host-clock seconds."""
    import pathlib
    import tempfile
    import torch.distributed as dist

    import simplestereo_tpu_torch as tss
    from simplestereo_tpu_torch import parallel, unwrapping
    from simplestereo_tpu_torch.imgio import imread
    from simplestereo_tpu_torch.passive import (asw_cuda, gsw_cuda, sgm,
                                                sgm_cuda, wls)
    from simplestereo_tpu_torch.probes import rotate
    from simplestereo_tpu_torch.videoio import VideoWriter

    res = example_res()
    counters = {"K1": asw_cuda, "K2": sgm_cuda, "K3": gsw_cuda, "K4": rotate,
                "S1": unwrapping, "S2": wls}
    tmp = tempfile.TemporaryDirectory()
    work = pathlib.Path(tmp.name)
    t0 = time.perf_counter()
    root = work / "res"
    truth = res.build_res(root, EXAMPLES_SIZE, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    secs, ms, counts = {}, {}, {}

    def run(name, argv=(), spies=(), device=None):
        """The script in a folder of its own (on the card unless
        ``device``), the counts set to 0 just before and read just after,
        and the calls of each (owner, name) in ``spies`` kept. Returns
        (folder, printout, {"owner.name": calls})."""
        tag = name.split("_")[0]
        cwd = work / (tag + ("" if device is None else "_" + device))
        cwd.mkdir()
        with contextlib.ExitStack() as stack:
            kept = {f"{owner.__name__.rsplit('.', 1)[-1]}.{attr}":
                    stack.enter_context(calls_of(owner, attr))
                    for owner, attr in spies}
            for m in counters.values():
                m.launches = 0
            t = time.perf_counter()
            out = res.run_script(name, root, cwd, argv, device=device)
            if device is None:
                torch.cuda.synchronize()
                secs[tag] = time.perf_counter() - t
                counts[tag] = {k: m.launches for k, m in counters.items()}
        if device is None:
            want = EXAMPLE_KERNELS.get(tag, set())
            check(all(counts[tag][k] > 0 for k in want)
                  and not any(counts[tag][k] for k in counters
                              if k not in want),
                  f"example {tag}: launches {counts[tag]}, expected "
                  f"{sorted(want)} only")
        return cwd, out, kept

    def matcher_ms(tag, calls):
        ms[tag] = ", ".join(f"{c[2] * 1e3:.2f}" for c in calls)

    def k2_equal(calls, where):
        for a, S, _ in calls:
            twin = sgm_cuda._aggregate(a["C"], float(a["P1"]), float(a["P2"]),
                                       a["paths"])
            check(torch.equal(S, twin), f"{where}: K2's S on the script's "
                  f"volume {tuple(a['C'].shape)} differs from the twin, max "
                  f"abs {(S - twin).abs().max().item():.3g}")
        return len(calls)

    SGM, ASW, GSW = (tss.passive.StereoSGM, tss.passive.StereoASW,
                     tss.passive.StereoGSW)
    k_err = {}

    # 001, 007, 102: no resources, no kernel.
    d, out, _ = run("001_calibration_chessboard.py")
    check((d / "chessboard.svg").stat().st_size > 0, "001: no chessboard.svg")
    d, out, _ = run("007_use_raw_camera_data.py")
    check(abs(res.numbers(out)[0] - 60.0) < 1e-9, f"007 printed {out!r}")
    d, out, _ = run("102_cam_proj_capture.py")
    check(len(list((d / "graycode_patterns").iterdir())) == 44,
          "102: not 44 patterns")

    # 002 on two generated AVIs of 1280x720 frames.
    rng = np.random.default_rng(SEED + 30)
    avis = []
    for side in "LR":
        p = work / f"cam_{side}.avi"
        with VideoWriter(str(p), fps=30.0, codec="DIB ") as wr:
            for _ in range(4):
                wr.write(rng.integers(0, 256, (720, 1280, 3), np.uint8))
        avis.append(p)
    d, out, _ = run("002_capture_image_pairs.py", avis)
    check(all((d / f"{i}_{s}.png").exists() for i in range(10) for s in "LR"),
          "002: not 10 saved pairs")

    # 003a, 003b: calibration of the rendered boards.
    calib = root / "1" / "calib"
    d, out, _ = run("003a_calibrate_single_camera.py", [calib])
    rms_a = float(res.numbers(out)[0])
    check(rms_a < 0.12, f"003a: RMS {rms_a}")
    d, out, _ = run("003b_build_stereo_rig.py", [calib])
    rig = tss.StereoRig.fromFile(str(d / "rig.json"), device="cpu")
    _, _, K1, K2, _, _, R, T = truth["1"]["rig_args"]
    cal = (rig.reprojectionError,
           max(np.abs(rig.intrinsic1 - K1).max(),
               np.abs(rig.intrinsic2 - K2).max()),
           np.abs(rig.R - R).max(), np.abs(rig.T.ravel() - T.ravel()).max())
    check(cal[0] < 0.12 and cal[1] < 5.0 and cal[2] < 2e-3 and cal[3] < 0.5,
          f"003b: RMS, |K - K_true|, |R - R_true|, |T - T_true| {cal}")

    # 004a, 004b, 005, 006, 101, 103: on the card and on the CPU.
    cpu_diff = {}
    for name in ("004a_undistort_images.py", "004b_draw_epipolar_lines.py",
                 "006_rectify_images.py"):
        d, _, _ = run(name)
        c, _, _ = run(name, device="cpu")
        pngs = sorted(f.name for f in d.glob("*.png"))
        check(len(pngs) == 2, f"{name}: wrote {pngs}")
        cpu_diff[name.split("_")[0]] = max(res.uint8_close(imread(str(d / f)),
                                                 imread(str(c / f)))
                                 for f in pngs)
    d, _, _ = run("005_rectify_rig.py")
    c, _, _ = run("005_rectify_rig.py", device="cpu")
    cpu_diff["005"] = res.json_close(d / "rigRect.json", c / "rigRect.json")
    SL = tss.StructuredLightRig
    d, out, kept = run("101_structured_light_rig.py",
                       spies=[(SL, "triangulate")])
    _, out_cpu, _ = run("101_structured_light_rig.py", device="cpu")
    res.numbers_close(out_cpu, out)
    a, world, _ = kept["StructuredLightRig.triangulate"][0]
    tri = res.triangulation_residual(a["self"], a["camPoints"],
                                     a["projPoints"], world)
    check(tri < 1e-6, f"101: triangulation residual {tri:.3g} px")
    FTP = tss.active.StereoFTP
    d, out, kept = run("103_stereo_ftp.py", spies=[(FTP, "getCloud")])
    c, _, kept_cpu = run("103_stereo_ftp.py", spies=[(FTP, "getCloud")],
                         device="cpu")
    cloud = kept["StereoFTP.getCloud"][0][1]
    cpu_diff["103"] = res.cloud_close(cloud,
                                      kept_cpu["StereoFTP.getCloud"][0][1])
    check(res.ply_layout(d / "scan.ply") == res.ply_layout(c / "scan.ply"),
          "103: PLY layouts differ from the CPU path's")
    ftp_z = res.plane_z(cloud, truth["stereoFTP"]["z0"])
    check(ftp_z[0] < 0.02 and ftp_z[1] < 0.05, f"103: z off by {ftp_z}")

    # 008, 009, 011: the lawn pair at 1280x720.
    lawn = truth["2"]
    d, _, kept = run("008_stereo_matching_sgm.py",
                     spies=[(SGM, "compute"), (sgm, "aggregate")])
    matcher_ms("008", kept["StereoSGM.compute"])
    share = {"008": res.plane_share(kept["StereoSGM.compute"][0][1] / 16,
                                    lawn, 1, 7, 96)}
    k2_equal(kept["sgm.aggregate"], "008")
    del kept
    d, _, kept = run("009_stereo_matching_asw.py",
                     spies=[(ASW, "compute"), (asw_cuda, "_asw_pass")])
    matcher_ms("009", kept["StereoASW.compute"])
    share["009"] = res.plane_share(kept["StereoASW.compute"][0][1], lawn, 1,
                                   35, 90)
    a, out_k, _ = kept["asw_cuda._asw_pass"][0]
    check(a["step"] == 2 and a["max_disp"] == 90, f"009: K1 given {a}")
    k_err["009 K1"] = k1_on_path(a.pop("planes"), a, out_k, "009",
                                 flat_ok=True)
    del kept, a, out_k
    d, _, kept = run("011_build_3d_point_cloud.py",
                     spies=[(SGM, "compute"), (SGM, "_speckles"),
                            (sgm, "aggregate"), (wls, "_solve"),
                            (tss.passive, "wls_filter_disparity")])
    matcher_ms("011", kept["StereoSGM.compute"])
    ms["011 speckles"] = round(kept["StereoSGM._speckles"][0][2] * 1e3, 2)
    ms["011 WLS"] = round(
        kept["passive.wls_filter_disparity"][0][2] * 1e3, 2)
    share["011"] = res.plane_share(kept["StereoSGM.compute"][0][1] / 16,
                                   lawn, 1, 7, 96)
    k2_equal(kept["sgm.aggregate"], "011")
    for a, x, _ in kept["wls._solve"]:
        check(torch.equal(x, wls._solve_plain(**a)), "011: S2 differs from "
              "the twin on the script's solve")
    n_s2 = len(kept["wls._solve"])
    del kept
    check(all(v >= res.PLANE_BAR for v in share.values()),
          f"lawn plane shares {share}")

    # 010, 201, 204: the Tsukuba stand-in at 384x288.
    d, out, kept = run("010_stereo_matching_tsukuba.py",
                       spies=[(SGM, "compute"), (ASW, "compute"),
                              (GSW, "compute"),
                              (tss.passive, "quality_disparity"),
                              (sgm, "aggregate"), (asw_cuda, "_asw_pass"),
                              (gsw_cuda, "_gsw_pass")])
    lines = res.tsukuba_lines(out)
    check(list(lines) == ["ASW", "SGM", "GSW", "quality preset"] and all(
        lines[k]["bad2"] < res.TSUKUBA_BAD2[k] for k in lines),
        f"010: {lines}")
    for m in ("ASW", "SGM", "GSW"):
        matcher_ms(f"010 {m}", kept[f"Stereo{m}.compute"])
    matcher_ms("010 preset", kept["passive.quality_disparity"])
    k2_equal(kept["sgm.aggregate"], "010")
    for i, (a, o, _) in enumerate(kept["asw_cuda._asw_pass"]):
        k_err[f"010 K1 {i}"] = k1_on_path(
            a.pop("planes"), a, o, f"010 K1 {i}", flat_ok=True)
    for i, (a, o, _) in enumerate(kept["gsw_cuda._gsw_pass"]):
        k_err[f"010 K3 {i}"] = k3_on_path(a, o, f"010 K3 {i}", flat_ok=True)
    del kept
    check(not dist.is_initialized(), "201: a process group is up")
    real = {f: getattr(parallel, f) for f in (
        "tiled_asw_disparity", "tiled_sgm_disparity", "tiled_gsw_disparity")}
    d, out, kept = run("201_multichip_tiled_matching.py",
                       spies=[(parallel, f) for f in real])
    for f, fn in real.items():
        a, tiled, _ = kept[f"parallel.{f}"][0]
        single = res.single_call(fn, (), a, tiled.device)
        check(torch.equal(tiled, single), f"201: {f} differs from the "
              "single-call matcher")
    check(len(out.splitlines()) == 3 and not dist.is_initialized(),
          f"201 printed {out!r}")
    del kept
    d, out, kept = run("204_radiometric_auto_matching.py",
                       [root / "tsukuba"],
                       spies=[(GSW, "compute"), (gsw_cuda, "_gsw_pass")])
    matcher_ms("204", kept["StereoGSW.compute"])
    auto = res.auto_lines(out)
    check([auto[0]["pick"], auto[1]["pick"]] == ["sd", "mi"]
          and auto[0]["bad2"] < res.AUTO_BAD2
          and auto[1]["bad2"] < res.AUTO_BAD2
          and auto[2]["bad2"] > res.SD_COLLAPSE, f"204: {auto}")
    k3 = kept["gsw_cuda._gsw_pass"]
    mi = [a.get("ext_vol", False) for a, _, _ in k3]
    check(any(mi) and not all(mi), f"204: K3 ext_vol per call {mi}")
    for i, (a, o, _) in enumerate(k3):
        k_err[f"204 K3 {i}"] = k3_on_path(a, o, f"204 K3 {i}", flat_ok=True)
    del kept

    # 203 at its defaults.
    d, out, _ = run("203_batch_scanning.py")
    off = [float(x) for x in re.findall(r"\(([\d.]+) % off\)", out)]
    check(len(off) == 4 and max(off) < 2.0, f"203: {out!r}")
    tmp.cleanup()

    scripts = {f.name.split("_")[0] for f in pathlib.Path(
        tss.__file__).parent.joinpath("examples").glob("[0-9]*.py")}
    check(set(secs) == scripts - {"202"}, f"phase 30 ran {sorted(secs)}, "
          f"not every script but 202 of {sorted(scripts)}")
    worst = [max(e[i] for e in k_err.values()) for i in range(3)]
    flats = {k: e[3] for k, e in k_err.items() if e[3]}
    n = {k: {c: v for c, v in counts[k].items() if v}
         for k in sorted(counts) if any(counts[k].values())}
    sizes = ", ".join(f"{k} {w}x{h}" for k, (w, h)
                      in res.SIZES[EXAMPLES_SIZE].items())
    print(f"phase 30 examples: the {len(secs)} scripts of "
          f"simplestereo_tpu_torch/examples/ no other phase runs, on the "
          f"card, on tests/torch_example_res.py's {EXAMPLES_SIZE} tree "
          f"(built in {build_s:.2f} s; {sizes}; the lawn at rectified "
          f"disparity {lawn['disp']:g}) | truths: 003b RMS {cal[0]:.4f}, "
          f"|K - K_true| {cal[1]:.3g}, |R - R_true| {cal[2]:.3g}, "
          f"|T - T_true| {cal[3]:.3g}; lawn interior within 1 px "
          + ", ".join(f"{k} {v:.2%}" for k, v in share.items())
          + "; 010 bad-2.0 " + ", ".join(f"{k} {v['bad2']:.2f}%"
                                        for k, v in lines.items())
          + f"; 204 auto {auto[0]['pick']} {auto[0]['bad2']}%, "
          f"{auto[1]['pick']} {auto[1]['bad2']}%, fixed sd "
          f"{auto[2]['bad2']}%; 103 |median z - z0| {ftp_z[0]:.3%}, p80 "
          f"{ftp_z[1]:.3%}; 101 residual {tri:.3g} px; 201 tiles equal to "
          f"one call; 203 worst {max(off):.2f}% off | kernels on the "
          f"scripts' inputs: K2's S torch.equal to the twin (008, 010, 011),"
          f" S2 torch.equal on 011's {n_s2} solves, K1 (009's 720p D=90 "
          f"step 2 in three bands; 010's two passes) and K3 (010; 204's "
          f"{len(mi)} SD and MI passes) under compare_pass: max abs err "
          f"{worst[0]:.3g} rel {worst[1]:.3g} map mismatch {worst[2]:.4%} "
          f"(limit {MISMATCH:.0%}); flips at flat pixels, each the first "
          f"argmin of the kernel's own costs, {flats} | "
          f"launches {n} | card vs --device cpu: "
          + ", ".join(f"{k} {v:.3g}" for k, v in cpu_diff.items())
          + " | host clock s a script: "
          + ", ".join(f"{k} {v:.2f}" for k, v in secs.items())
          + " | matcher ms (host clock, the script's call): "
          + ", ".join(f"{k} {v}" for k, v in ms.items()) + f" | {card}")


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
    names, host = _build.library_names()
    _build.build(names + host)
    build_s = time.perf_counter() - t0
    ptxas = [ptxas_summary(_build.compile_log(name)) for name in names]
    print(f"phase 2 build: {' + '.join(names)} (nvcc) and "
          f"{' + '.join(host)} (g++) in parallel "
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
    check(paths == {"wide", "tile", "l1"}, f"phase 3 ran paths {paths}")

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
    plan = asw_cuda._tile_plan(deep["win_size"], 1, D, B, h, w)
    pkw = dict(H=h, W=w, gamma_c=5.0, gamma_p=17.5, consistent=True, **deep)
    n0 = asw_cuda.launches
    whole = asw_cuda._asw_pass(planes, plan=plan, **pkw)
    torch.cuda.synchronize()
    check(asw_cuda.launches == n0 + 1, "ASW deep stack: launch not counted")
    for a, b in ((0, B // 2), (B // 2, B)):
        part = asw_cuda._asw_pass(
            planes[a:b].contiguous(), plan=asw_cuda._tile_plan(
                deep["win_size"], 1, D, b - a, h, w), **pkw)
        for name, x, y in zip(("cost", "dispL", "dispR"), whole, part):
            check(torch.equal(x[a:b], y), f"ASW deep stack: {name} of frames "
                  f"{a}..{b} differs from the stack in pieces")
        del part
    del planes, whole
    torch.cuda.empty_cache()
    print(f"phase 3 kernel vs plain on {len(CASES)} option cases (45x150 "
          f"unless stated; step 2/3, D 18/20/41, min_disp -3, subpixel, "
          f"B 2, win 111, B 2 at 37x101), each on its plan (wide for D > "
          f"12, else tile) and the L1 path: "
          f"ok | max abs err {worst[0]:.3g}, max rel err {worst[1]:.3g} "
          f"(rtol {RTOL}), worst map mismatch {worst[2]:.4%} "
          f"(limit {MISMATCH:.0%}), launch count +1 per call | {B} frames "
          f"of {w}x{h}, D={D} (frames x chunks {B * -(-D // plan['chunk'])} "
          f"> 65,535): one call in {len(_build.frame_pieces(B, plan['frames']))} "
          f"launches of the tile kernel bit-equal to two calls | {card}")

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
    abs_err, rel_err, mism, _ = compare_pass(
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
    root = timed("24", stream_phase, dev, card)
    timed("25", jpeg_phase, card, root)
    timed("26", k1_tiles_phase, dev, card)
    carry_entry = timed("27", k2_carry_phase, dev, card)
    counts = timed("28", distributed_phase, dev, card)
    carry_entry["launches"] = counts["sgm"]
    timed("29", formats_phase, dev, card)
    timed("30", examples_phase, dev, card)
    census_entry, speckle_entry, post_entry, bt_entry = timed(
        "31", card_tests_phase, dev, card)
    print("phase wall times (host clock, s, build included in 1-6): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; total {time.perf_counter() - start:.1f} | {card}")

    print(json.dumps({"kernels": [asw_entry, sgm_entry, census_entry,
                                  speckle_entry, post_entry, bt_entry,
                                  carry_entry,
                                  gsw_entry, rotate_entry, iir_entry,
                                  s2_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
