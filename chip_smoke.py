#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the kernels of ``simplestereo_tpu_torch/csrc/`` (one nvcc per
source, all started together) and drives the port's two main paths:

- ASW: checks the ASW kernel against its plain PyTorch twin on the card,
  drives ``StereoASW(35, 14, 4, 15, 17.5, consistent=True).compute`` (the
  Tsukuba-size headline configuration) on synthetic 384x288 and 1280x720
  pairs with a known shift of 5, and times kernel and twin;
- SGM: checks the path-aggregation kernel against its twin on option cases
  (S bit-equal), drives ``StereoSGM(device="cuda").compute`` and
  ``computeBatch`` in the Tsukuba-size census configuration at 384x288 and
  the full-width BT row at 1280x720 with D = 128 on the same synthetic
  pairs, and times kernel, twin and ``compute()``.

Every phase prints one line; any failed check raises, so the exit code is
nonzero and no result line is printed. The last two lines are the kernels'
JSON record and ``{"ok": true, "device": {...}}``.

Needs a CUDA card, nvcc and the repository checkout; imports no JAX.
"""

import json
import statistics
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port must run without JAX

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
# Kernel vs plain twin: the same inf pattern; rtol on finite costs (the
# kernel multiplies two expf where the twin takes one exp of the sum, and
# sums in another order); argmin maps may flip on near-ties.
RTOL = 2e-5
MISMATCH = 0.01
# Option cases of the kernel, at a small ragged size (not a multiple of
# the (32, 8) block): lattice step, D > 16 (two register chunks),
# negative min_disp, sub-pixel neighbourhood, a frame batch. Every range
# holds the pair's true shift: without it every TAD of a noise pair hits
# the cap, all costs tie to the last ulp and the argmin is noise.
CASES = [
    dict(win_size=7, min_disp=1, max_disp=6, consistent=False),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True),
    dict(win_size=7, min_disp=1, max_disp=6, consistent=True, step=2),
    dict(win_size=7, min_disp=0, max_disp=17, consistent=True),
    dict(win_size=5, min_disp=-3, max_disp=16, consistent=True),
    dict(win_size=5, min_disp=1, max_disp=6, consistent=False, subpixel=True),
    dict(win_size=9, min_disp=4, max_disp=14, consistent=True, subpixel=True,
         B=2),
]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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
        n0 = sgm_cuda.launches
        k = sgm_cuda.aggregate(C, m.P1, m.P2, m.paths)
        torch.cuda.synchronize()
        check(sgm_cuda.launches == n0 + 1, f"SGM case {case}: launch not "
              "counted")
        p = sgm_cuda._aggregate(C, float(m.P1), float(m.P2), m.paths)
        check(torch.equal(k, p), f"SGM case {case}: S differs from the "
              f"twin, max abs err {(k - p).abs().max().item():.3g}")
        check(torch.equal(post(m, k), post(m, p)),
              f"SGM case {case}: final maps differ")
    print(f"phase 7 SGM kernel vs twin on {len(SGM_CASES)} option cases at "
          f"45x150 (paths 4/8, D 3/11/16/40, min_disp -4, blockSize 1/3/5, "
          f"bt/census 7/bt+census, LR 1, uniqueness 10, B 2): S "
          f"torch.equal, maps equal, launch count +1 per call")

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
        k_ms, _ = cuda_ms(run_k, vols)
        p_ms, _ = cuda_ms(run_p, vols[:3])
        k, p = run_k(vols[0]), run_p(vols[0])
        err = (k - p).abs().max().item()
        check(torch.equal(k, p), f"SGM {w}x{h} D={D}: kernel S differs from "
              f"the twin at the main-path shape, max abs err {err:.3g}")
        del k, p
        times[(h, w)] = (k_ms, p_ms, err)
        print(f"phase 10 SGM {w}x{h} D={D}: kernel {k_ms:.3f} ms "
              f"({rate(h, w, D, 1, k_ms):.1f} Mpix*disp/s), twin "
              f"{p_ms:.1f} ms ({rate(h, w, D, 1, p_ms):.2f} Mpix*disp/s), "
              f"kernel S torch.equal to the twin's; compute() "
              f"{e2e[(h, w)]:.2f} ms | {card}")
        del vols
        torch.cuda.empty_cache()

    m = StereoSGM(device="cuda", **SGM_BATCH8)
    vols = volumes(m, 288, 384, 8, 6)
    b8_ms, _ = cuda_ms(lambda C: sgm_cuda.aggregate(C, m.P1, m.P2, m.paths),
                       vols)
    del vols
    left, right = pair(288, 384)
    stacks = [(np.stack([np.roll(left, i * 8 + j, axis=0) for j in range(8)]),
               np.stack([np.roll(right, i * 8 + j, axis=0)
                         for j in range(8)])) for i in range(6)]
    cb_ms, n_cb = host_ms(m.computeBatch, stacks)
    one_ms, n_one = host_ms(m.compute, [(ls[0], rs[0]) for ls, rs in stacks])
    print(f"phase 10 SGM sgm_batch8 384x288 D=16 bt B=8: kernel "
          f"{b8_ms:.3f} ms ({b8_ms / 8:.3f} ms/frame, "
          f"{rate(288, 384, 16, 8, b8_ms):.1f} Mpix*disp/s); computeBatch() "
          f"{cb_ms:.2f} ms ({cb_ms / 8:.3f} ms/frame end to end, host "
          f"clock, n={n_cb}); compute() of one frame {one_ms:.2f} ms "
          f"(n={n_one}) | {card}")

    k_ms, p_ms, err = times[SGM_MAIN[0][0]]
    return {"name": "sgm_aggregate", "route": "cuda",
            "source": "simplestereo_tpu_torch/csrc/sgm_kernel.cu",
            "replaces": "simplestereo_tpu/passive/sgm_pallas.py:72",
            "launches": launches_main, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False: needs a "
                 "CUDA card")
    from simplestereo_tpu_torch import _build
    from simplestereo_tpu_torch.passive import StereoASW, asw_cuda

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
    _build.build(["asw_kernel", "sgm_kernel"])
    _build.load_library("asw_kernel")
    _build.load_library("sgm_kernel")
    build_s = time.perf_counter() - t0
    ptxas = [f"{name}: {ln.strip()}" for name in ("asw_kernel", "sgm_kernel")
             for ln in _build.compile_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: asw_kernel + sgm_kernel in parallel {build_s:.2f} "
          f"s | " + " | ".join(ptxas))

    # ---- phase 3: kernel vs plain twin, every option case --------------
    worst = [0.0, 0.0, 0.0]
    for case in CASES:
        kw = dict(case)
        B = kw.pop("B", 1)
        h, w = 45, 150
        rng = np.random.default_rng(SEED + 1)
        l = rng.integers(0, 256, (B, h, w, 3), np.uint8)
        r = np.roll(l, -SHIFT, axis=2)
        planes = asw_cuda._build_planes(
            torch.tensor(l, device=dev), torch.tensor(r, device=dev),
            kw["win_size"], kw["min_disp"], kw["max_disp"])
        pkw = dict(H=h, W=w, gamma_c=5.0, gamma_p=17.5, **kw)
        n0 = asw_cuda.launches
        k = asw_cuda._asw_pass(planes, **pkw)
        torch.cuda.synchronize()
        check(asw_cuda.launches == n0 + 1, "launch not counted")
        p = asw_cuda._asw_pass_plain(planes, **pkw)
        errs = compare_pass(k, p, kw["min_disp"], f"case {case}")
        fkw = dict(W=w, min_disp=kw["min_disp"], max_disp=kw["max_disp"],
                   consistent=kw["consistent"],
                   subpixel=kw.get("subpixel", False))
        fk = asw_cuda._finish(*k[1:], **fkw)
        fp = asw_cuda._finish(*p[1:], **fkw)
        m = (fk.floor() != fp.floor()).double().mean().item()
        check(m <= MISMATCH, f"case {case}: final map mismatch {m:.2%}")
        worst = [max(a, b) for a, b in zip(worst, errs)]
    print(f"phase 3 kernel vs plain on {len(CASES)} option cases at 45x150: "
          f"ok | max abs err {worst[0]:.3g}, max rel err {worst[1]:.3g} "
          f"(rtol {RTOL}), worst map mismatch {worst[2]:.4%} "
          f"(limit {MISMATCH:.0%})")

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
              f"(host clock, n={len(ts)})")

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

    tsu = planes_for(288, 384, 1, 11)
    run_k = lambda p: asw_cuda._asw_pass(p, H=288, W=384, **pkw)
    run_p = lambda p: asw_cuda._asw_pass_plain(p, H=288, W=384, **pkw)
    k_ms, _ = cuda_ms(run_k, tsu)
    p_ms, _ = cuda_ms(run_p, tsu[:4])
    k = run_k(tsu[0])
    p = run_p(tsu[0])
    abs_err, rel_err, mism = compare_pass(
        k, p, pkw["min_disp"], "main path 384x288")
    print(f"phase 6a 384x288 D={D} win 35: kernel {k_ms:.3f} ms "
          f"({rate(288, 384, 1, k_ms):.1f} Mpix*disp/s), plain "
          f"{p_ms:.1f} ms ({rate(288, 384, 1, p_ms):.2f} Mpix*disp/s), "
          f"kernel/plain max abs err {abs_err:.3g} rel {rel_err:.3g} map "
          f"mismatch {mism:.4%} | {card}")
    del tsu
    hd = planes_for(720, 1280, 1, 11)
    hd_ms, _ = cuda_ms(lambda p: asw_cuda._asw_pass(p, H=720, W=1280, **pkw),
                       hd)
    del hd
    b8 = planes_for(288, 384, 8, 6)
    b8_ms, _ = cuda_ms(lambda p: asw_cuda._asw_pass(p, H=288, W=384, **pkw),
                       b8)
    del b8
    print(f"phase 6b kernel 1280x720: {hd_ms:.3f} ms "
          f"({rate(720, 1280, 1, hd_ms):.1f} Mpix*disp/s); kernel 384x288 "
          f"B=8: {b8_ms:.3f} ms ({b8_ms / 8:.3f} ms/frame, "
          f"{rate(288, 384, 8, b8_ms):.1f} Mpix*disp/s) | {card}")

    asw_entry = {
        "name": "asw_pass", "route": "cuda",
        "source": "simplestereo_tpu_torch/csrc/asw_kernel.cu",
        "replaces": "simplestereo_tpu/passive/asw_pallas.py:155",
        "launches": launches_main, "max_abs_err": abs_err,
        "ms": k_ms, "plain_ms": p_ms}
    del m
    torch.cuda.empty_cache()
    sgm_entry = sgm_phases(dev, card)

    print(json.dumps({"kernels": [asw_entry, sgm_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
