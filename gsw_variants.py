#!/usr/bin/env python3
"""Where the GSW tile kernel spends its time, and what its weight's
approximate sqrt and exp2 buy, on one CUDA card.

    python3 gsw_variants.py

Builds edited copies of ``simplestereo_tpu_torch/csrc/gsw_kernel.cu`` side
by side (one nvcc each, all started together) under
``build/gsw_variants/``:

- "IEEE sqrtf, division, expf" and "IEEE sqrtf and division, __expf":
  the weight as the first version computed it, and with the fast
  ``__expf`` alone; "2 pixels a thread" (a 32 x 16 tile); "a branch per
  pixel" (a pixel that does not use a staged row skips it instead of
  weighing it 0). Each is held, as the unchanged source is, to
  ``chip_smoke.py``'s phase-11 gate (costs within rtol 2e-5 of the twin
  with the same inf pattern, at most 1% of the map flipped and each flip a
  near-tie) on every phase-11 SD option case and at both main-path sizes;
  a line says whether it passes and by how much;
- "weight without sqrt/exp2" and "no d loop": parts switched off, so
  their results are wrong and only their time means anything.

Every copy is timed at the GSW main point (win 23, d 4..14, gamma 12.5,
fMax 20, both directions; 384x288 and 1280x720; CUDA events, median over
distinct inputs) in turns with the unchanged source. The last line is the
card's name and power limit.

Needs a CUDA card, nvcc and the repository checkout; imports no JAX.
"""

import ctypes
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from simplestereo_tpu_torch import _build
from simplestereo_tpu_torch.passive import gsw_cuda

WEIGHT = "return ex2_approx(sqrt_approx(dsq) * kexp);"
DLOOP = "num[q][k] += w * v[k];"
SELECT = """          const float w = weight(r0, r1, r2, ctr[q], gamma, kexp) *
                          (use[q] ? 1.0f : 0.0f);"""
# name: (source edits, pixel rows a tile, gated against the twin)
VARIANTS = {
    "base": ([], 32, True),
    "IEEE sqrtf, division, expf": (
        [(WEIGHT, "return expf(-sqrtf(dsq) / gamma);")], 32, True),
    "IEEE sqrtf and division, __expf": (
        [(WEIGHT, "return __expf(-sqrtf(dsq) / gamma);")], 32, True),
    "2 pixels a thread": (
        [("constexpr int kPY = 4;", "constexpr int kPY = 2;")], 16, True),
    "a branch per pixel": (
        [(SELECT, "          if (!use[q]) continue;\n          const float "
                  "w = weight(r0, r1, r2, ctr[q], gamma, kexp);")], 32, True),
    "weight without sqrt/exp2": ([(WEIGHT, "return dsq;")], 32, False),
    "no d loop": ([(DLOOP, "if (w == 12345.0f) num[q][k] += w * v[k];")],
                  32, False),
}
MAIN = dict(win_size=23, min_disp=4, max_disp=14, gamma=12.5, f_max=20.0)


def build(root):
    src = (_build._CSRC / "gsw_kernel.cu").read_text()
    root.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (edits, _, _)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{name}: {old!r} not found once")
            text = text.replace(old, new)
        cu = root / f"v{i}.cu"
        cu.write_text(text)
        jobs[name] = (root / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(root / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = _build.bind(ctypes.CDLL(str(so)),
                                 gsw_cuda.LIBRARY.signatures)
    return libs


def sd_planes(dev, l, r, win, consistent=True):
    return gsw_cuda._build_planes(*gsw_cuda._directions(
        torch.tensor(l, device=dev), torch.tensor(r, device=dev),
        consistent), win)


def plan_for(rows, win, step, D, B, H, W):
    """gsw_cuda._plan with the shared memory of a tile of ``rows`` pixel
    rows (the kernel computes its grid from its own tile)."""
    plan = gsw_cuda._plan(win, step, D, B, H, W)
    if plan["path"] == "tile":
        pad = win // 2
        smem = 4 * (3 + plan["nd"]) * (rows + 2 * pad) * (32 + 2 * pad)
        if smem > gsw_cuda.SMEM_MAX:
            raise ValueError(f"tile of {rows} rows at win {win}: {smem} B")
        plan = dict(plan, smem=smem)
    return plan


def gate(dev, rows, twins):
    """The phase-11 gate of the loaded kernel on the SD option cases of
    chip_smoke and at both main-path sizes (``twins``: the twin's outputs
    by case, filled on the first call). Returns (worst rel err, worst map
    mismatch) or raises AssertionError."""
    worst = [0.0, 0.0]
    cases = [dict(c) for c in cs.GSW_CASES if not c.get("mi")]
    cases += [dict(MAIN, consistent=True, h=h, w=w) for h, w in cs.GSW_SHAPES]
    for i, kw in enumerate(cases):
        B = kw.pop("B", 1)
        cons = kw.pop("consistent", False)
        h, w = kw.pop("h", 45), kw.pop("w", 150)
        kw.setdefault("gamma", 10.0)
        kw.setdefault("f_max", 20.0)
        l = np.random.default_rng(cs.SEED + 3).integers(0, 256, (B, h, w, 3),
                                                        np.uint8)
        planes = sd_planes(dev, l, np.roll(l, -cs.SHIFT, axis=2),
                           kw["win_size"], cons)
        plan = plan_for(rows, kw["win_size"], kw.get("step", 1),
                        kw["max_disp"] - kw["min_disp"] + 1, planes.shape[0],
                        h, w)
        kd, kc = gsw_cuda._gsw_pass(planes, H=h, W=w, return_cost=True,
                                    plan=plan, **kw)
        if i not in twins:
            twins[i] = gsw_cuda._gsw_pass_plain(planes, H=h, W=w,
                                                return_cost=True, **kw)
        pd, pc = twins[i]
        _, rel, mism, _ = cs.compare_pass((kc, kd, None, None),
                                          (pc, pd, None, None),
                                          kw["min_disp"], f"case {kw} {h}x{w}")
        worst = [max(worst[0], rel), max(worst[1], mism)]
    return worst


def main():
    if not torch.cuda.is_available():
        sys.exit("gsw_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "gsw_variants")
    base = gsw_cuda.LIBRARY.loaded
    twins = {}
    try:
        for name, (_, rows, gated) in VARIANTS.items():
            if not gated:
                continue
            gsw_cuda.LIBRARY.loaded = libs[name]
            try:
                rel, mism = gate(dev, rows, twins)
                verdict = (f"passes: worst rel err {rel:.3g}, worst map "
                           f"mismatch {mism:.4%}")
            except AssertionError as e:
                verdict = f"fails: {e}"
            print(f"{name} against the phase-11 gate: {verdict}", flush=True)
        for h, w in cs.GSW_SHAPES:
            left, right = cs.pair(h, w)
            planes = [sd_planes(dev, np.roll(left, i, 0)[None],
                                np.roll(right, i, 0)[None], MAIN["win_size"])
                      for i in range(6)]
            runs = ["base"]
            for name in VARIANTS:
                if name != "base":
                    runs += [name, "base"]
            for name in runs:
                gsw_cuda.LIBRARY.loaded = libs[name]
                plan = plan_for(VARIANTS[name][1], MAIN["win_size"], 1, 11, 2,
                                h, w)
                ms, _ = cs.cuda_ms(lambda p: gsw_cuda._gsw_pass(
                    p, H=h, W=w, plan=plan, **MAIN), planes)
                regs, spill, blocks = gsw_cuda.occupancy(plan, device=dev)
                print(f"{w}x{h} {name}: {ms:.3f} ms | {plan['smem']} B "
                      f"shared memory, {regs} registers, {spill} B spilled, "
                      f"{blocks} blocks an SM", flush=True)
    finally:
        gsw_cuda.LIBRARY.loaded = base
    print(card)


if __name__ == "__main__":
    main()
