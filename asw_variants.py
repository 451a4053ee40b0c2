#!/usr/bin/env python3
"""Where the ASW tile kernels spend their time, on one CUDA card.

    python3 asw_variants.py [main] [cell]

Builds edited copies of ``simplestereo_tpu_torch/csrc/asw_kernel.cu`` side
by side (one nvcc each, all started together) under
``build/asw_variants/``. Each copy switches one part of a tile kernel
off, or changes its register cap, so its results are wrong and only its
time means anything. Each copy is timed in turns with the unchanged
source (CUDA events, median over distinct inputs):

- the tile kernel (``asw_cost_tile_kernel``) at the ASW main path (win
  35, d 4..14, 384x288 and 1280x720), beside the L1 kernel (the first
  version of the cost kernel);
- the tile kernel in chunks of 12 and the wide tile kernel
  (``asw_cost_tile_kernel_wide``) at the ``asw_lawn720`` cell's shape
  (1280x720, win 35, d 1..90, step 2).

``main`` and ``cell`` choose the first or the second set (default: both).
One line per (shape, variant); the last line is the card's name and power
limit. Needs a CUDA card, nvcc and the repository checkout; imports no JAX.
"""

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from simplestereo_tpu_torch import _build
from simplestereo_tpu_torch.passive import asw_cuda

# The tile kernel's source lines that a variant edits.
E2 = "*dst = expf(-sqrtf(dsq) * inv_gc);"
E1 = "const float e1 = expf(-sqrtf(dsq) * inv_gc) * proxs[m0 + jj];"
ACC = "for (int q = 0; q < ND / 4; ++q) {"
GROUPS = "for (int m0 = 0; m0 < nl; m0 += jg) {"
SPLIT = "constexpr int kSplit = 2;"
E2LOOP = "for (int jj = h; jj < gn; jj += kSplit) {"
E1LOOP = "for (int jj = 0; jj < gn; ++jj) {\n          float dsq = 0.0f;"
BOUNDS = "__launch_bounds__(kThreads, 3)"
# The wide kernel's.
W_EXP = "const float ew = expf(-sqrtf(dsq) * inv_gc);"
W_ACC = "for (int jj = 0; jj < gn; ++jj) {\n          col += S;"
W_TAD = "for (int col = c0; col < CW; col += kTadCols) {"
W_TASKS = "for (int t = tid; t < kWSplit * kTasks; t += kWThreads) {"
W_COLS = "for (int jj = h; jj < gn; jj += kWSplit) {"
W_UNROLL = "#pragma unroll 4\n        for (int col = c0;"
W_SPLIT = "constexpr int kWSplit = 4;"
W_ROWS = "constexpr int kWTH = 4;"
W_BLOCKS = "constexpr int kWBlocks = 1;"
NO_E2 = (E2, "*dst = dsq;")
NO_E1 = (E1, "const float e1 = dsq;")
NO_ACC = (ACC, ACC.replace("q < ND / 4;", "q < ND / 4 && e1 == 12345.0f;"))
NO_GROUPS = (GROUPS, GROUPS.replace("m0 < nl;", "m0 < nl && jg < 0;"))
# name: (source edits, shared-memory budgets of the plan or None); timed
# at the main path's shapes on the tile kernel
VARIANTS = {
    "base": ([], None),
    "e2 without expf/sqrtf": ([NO_E2], None),
    "e1 without expf/sqrtf": ([NO_E1], None),
    "no e1/e2 expf/sqrtf": ([NO_E2, NO_E1], None),
    "no d loop": ([NO_ACC], None),
    "staging alone": ([NO_GROUPS], None),
    "kSplit 1": ([(SPLIT, "constexpr int kSplit = 1;")], None),
    "e2 loop unrolled 3": ([(E2LOOP, "#pragma unroll 3\n" + E2LOOP)], None),
    "e1 loop unrolled 2": ([(E1LOOP, "#pragma unroll 2\n" + E1LOOP)], None),
    "4 blocks, 64 registers": (
        [(BOUNDS, "__launch_bounds__(kThreads, 4)")], (57_344,)),
    "2 blocks, one e2 group": ([], (115_712,)),
}
# name: (source edits, plan, asw_cuda constants of the plan): timed at
# the asw_lawn720 cell's shape, on the tile kernel's chunks of 12 ("tile")
# or the wide kernel ("wide")
CELL_VARIANTS = {
    "chunks of 12": ([], "tile", {}),
    "chunks of 12, no d loop": ([NO_ACC], "tile", {}),
    "chunks of 12, staging alone": ([NO_GROUPS], "tile", {}),
    "chunks of 12, no e1/e2 expf/sqrtf": ([NO_E2, NO_E1], "tile", {}),
    "wide": ([], "wide", {}),
    "wide, no d loop": ([(W_ACC, W_ACC.replace("jj < gn;",
                                                "jj < gn && jg < 0;"))],
                        "wide", {}),
    "wide, no tad": ([(W_TAD, W_TAD.replace("col < CW;", "col < 0;"))],
                     "wide", {}),
    "wide, no e1/e2": ([(W_TASKS, W_TASKS.replace("t < kWSplit", "t < 0 *"
                                                  " kWSplit"))], "wide", {}),
    "wide, no e1/e2 expf/sqrtf": ([(W_EXP, "const float ew = dsq;")],
                                  "wide", {}),
    "wide, e1/e2 column loop unrolled 2": (
        [(W_COLS, "#pragma unroll 2\n" + W_COLS)], "wide", {}),
    "wide, tad loop not unrolled": (
        [(W_UNROLL, W_UNROLL.replace("#pragma unroll 4\n", ""))], "wide", {}),
    "wide, tad loop unrolled 2": (
        [(W_UNROLL, W_UNROLL.replace("unroll 4", "unroll 2"))], "wide", {}),
    "wide, kWSplit 2": ([(W_SPLIT, W_SPLIT.replace("4", "2"))], "wide", {}),
    "wide, kWSplit 8": ([(W_SPLIT, W_SPLIT.replace("4", "8"))], "wide", {}),
    "wide, 32 x 2 tiles, 2 blocks an SM": (
        [(W_ROWS, "constexpr int kWTH = 2;"),
         (W_BLOCKS, "constexpr int kWBlocks = 2;")], "wide",
        {"WIDE_TILE_H": 2}),
}
MAIN = dict(win_size=35, min_disp=4, max_disp=14, gamma_c=15.0,
            gamma_p=17.5, consistent=True)
CELL = dict(win_size=35, min_disp=1, max_disp=90, gamma_c=15.0,
            gamma_p=17.5, consistent=True, step=2)


def build(root):
    """{edits: bound library} of every distinct edited source."""
    src = (_build._CSRC / "asw_kernel.cu").read_text()
    root.mkdir(parents=True, exist_ok=True)
    jobs = {}
    edit_sets = dict.fromkeys(
        tuple(v[0]) for v in [*VARIANTS.values(), *CELL_VARIANTS.values()])
    for i, edits in enumerate(edit_sets):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{old!r} not found once")
            text = text.replace(old, new)
        cu = root / f"v{i}.cu"
        cu.write_text(text)
        jobs[edits] = (root / f"v{i}.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(root / f"v{i}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for edits, (so, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {edits}:\n{out}")
        libs[edits] = _build.bind(ctypes.CDLL(str(so)),
                                  asw_cuda.LIBRARY.signatures)
    return libs


def timed(libs, edits, plan, planes, h, w, pkw, label):
    """Time one variant on ``planes`` and print its line."""
    asw_cuda.LIBRARY.loaded = libs[tuple(edits)]
    ms, _ = cs.cuda_ms(lambda p: asw_cuda._asw_pass(
        p, H=h, W=w, plan=plan, **pkw), planes)
    regs, spill, blocks = asw_cuda.occupancy(plan, planes[0].device)
    print(f"{w}x{h} D={pkw['max_disp'] - pkw['min_disp'] + 1} step "
          f"{pkw.get('step', 1)} {label}: {ms:.3f} ms | plan {plan['path']} "
          f"chunk {plan['chunk']} jg {plan['jg']} smem {plan['smem']} B, "
          f"{regs} registers, {spill} B spilled, {blocks} blocks an SM",
          flush=True)


def stack(h, w, pkw, dev):
    """Planes of 6 distinct pairs of one size."""
    left, right = cs.pair(h, w)
    return [asw_cuda._build_planes(
        torch.tensor(np.roll(left, i, 0)[None], device=dev),
        torch.tensor(np.roll(right, i, 0)[None], device=dev),
        pkw["win_size"], pkw["min_disp"], pkw["max_disp"]) for i in range(6)]


def main():
    if not torch.cuda.is_available():
        sys.exit("asw_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "asw_variants")
    sets = sys.argv[1:] or ["main", "cell"]
    base = asw_cuda.LIBRARY.loaded
    try:
        D = MAIN["max_disp"] - MAIN["min_disp"] + 1
        for h, w in ((720, 1280), (288, 384)) if "main" in sets else ():
            planes = stack(h, w, MAIN, dev)
            runs = [("base", None)]
            for name in VARIANTS:
                if name != "base":
                    runs += [(name, None), ("base", None)]
            runs.append(("base", "l1"))
            for name, path in runs:
                edits, budgets = VARIANTS[name]
                budgets = () if path == "l1" else budgets
                plan = asw_cuda._plan(MAIN["win_size"], 1, D, 1, h, w,
                                      **({} if budgets is None
                                         else dict(budgets=budgets)))
                timed(libs, edits, plan, planes, h, w, MAIN,
                      "L1 kernel" if path == "l1" else name)
        if "cell" not in sets:
            return
        h, w = 720, 1280
        D = CELL["max_disp"] - CELL["min_disp"] + 1
        args = (CELL["win_size"], CELL["step"], D, 1, h, w)
        planes = stack(h, w, CELL, dev)
        bases = {"tile": "chunks of 12", "wide": "wide"}
        runs = [bases["tile"], bases["wide"]]
        for name, (_, kind, _) in CELL_VARIANTS.items():
            if name not in bases.values():
                runs += [name, bases[kind]]
        for name in runs:
            edits, kind, consts = CELL_VARIANTS[name]
            saved = {k: getattr(asw_cuda, k) for k in consts}
            vars(asw_cuda).update(consts)
            plan = (asw_cuda._tile_plan if kind == "tile"
                    else asw_cuda._plan)(*args)
            vars(asw_cuda).update(saved)
            timed(libs, edits, plan, planes, h, w, CELL, name)
    finally:
        asw_cuda.LIBRARY.loaded = base
        print(card)


if __name__ == "__main__":
    main()
