#!/usr/bin/env python3
"""Where the ASW tile kernel spends its time, on one CUDA card.

    python3 asw_variants.py

Builds edited copies of ``simplestereo_tpu_torch/csrc/asw_kernel.cu`` side
by side (one nvcc each, all started together) under
``build/asw_variants/``. Each copy switches one part of the tile kernel
off, or changes its register cap, so its results are wrong and only its
time means anything. Every copy is timed at the ASW main path (win 35,
d 4..14, 384x288 and 1280x720; CUDA events, median over distinct inputs)
in turns with the unchanged source, beside the L1 kernel (the first
version of the cost kernel). One line per (size, variant); the last line
is the card's name and power limit.

Needs a CUDA card, nvcc and the repository checkout; imports no JAX.
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

E2 = "*dst = expf(-sqrtf(dsq) * inv_gc);"
E1 = "const float e1 = expf(-sqrtf(dsq) * inv_gc) * proxs[m0 + jj];"
ACC = "for (int q = 0; q < ND / 4; ++q) {"
GROUPS = "for (int m0 = 0; m0 < nl; m0 += jg) {"
SPLIT = "constexpr int kSplit = 2;"
E2LOOP = "for (int jj = h; jj < gn; jj += kSplit) {"
E1LOOP = "for (int jj = 0; jj < gn; ++jj) {"
BOUNDS = "__launch_bounds__(kThreads, 3)"
# name: (source edits, shared-memory budgets of the plan or None)
NO_E2 = (E2, "*dst = dsq;")
NO_E1 = (E1, "const float e1 = dsq;")
VARIANTS = {
    "base": ([], None),
    "e2 without expf/sqrtf": ([NO_E2], None),
    "e1 without expf/sqrtf": ([NO_E1], None),
    "no e1/e2 expf/sqrtf": ([NO_E2, NO_E1], None),
    "no d loop": ([(ACC, ACC.replace("q < ND / 4;",
                                     "q < ND / 4 && e1 == 12345.0f;"))],
                  None),
    "staging alone": ([(GROUPS, GROUPS.replace("m0 < nl;",
                                               "m0 < nl && jg < 0;"))],
                      None),
    "kSplit 1": ([(SPLIT, "constexpr int kSplit = 1;")], None),
    "e2 loop unrolled 3": ([(E2LOOP, "#pragma unroll 3\n" + E2LOOP)], None),
    "e1 loop unrolled 2": ([(E1LOOP, "#pragma unroll 2\n" + E1LOOP)], None),
    "4 blocks, 64 registers": (
        [(BOUNDS, "__launch_bounds__(kThreads, 4)")], (57_344,)),
    "2 blocks, one e2 group": ([], (115_712,)),
}


def build(root):
    src = (_build._CSRC / "asw_kernel.cu").read_text()
    root.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
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
                                 asw_cuda.LIBRARY.signatures)
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("asw_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "asw_variants")
    pkw = dict(win_size=35, min_disp=4, max_disp=14, gamma_c=15.0,
               gamma_p=17.5, consistent=True)
    D = pkw["max_disp"] - pkw["min_disp"] + 1
    base = asw_cuda.LIBRARY.loaded
    try:
        for h, w in ((720, 1280), (288, 384)):
            left, right = cs.pair(h, w)
            planes = [asw_cuda._build_planes(
                torch.tensor(np.roll(left, i, 0)[None], device=dev),
                torch.tensor(np.roll(right, i, 0)[None], device=dev),
                pkw["win_size"], pkw["min_disp"], pkw["max_disp"])
                for i in range(6)]
            runs = [("base", None)]
            for name in VARIANTS:
                if name != "base":
                    runs += [(name, None), ("base", None)]
            runs.append(("base", "l1"))
            for name, path in runs:
                asw_cuda.LIBRARY.loaded = libs[name]
                budgets = () if path == "l1" else VARIANTS[name][1]
                plan = asw_cuda._plan(pkw["win_size"], 1, D, 1, h, w,
                                      **({} if budgets is None
                                         else dict(budgets=budgets)))
                ms, _ = cs.cuda_ms(lambda p: asw_cuda._asw_pass(
                    p, H=h, W=w, plan=plan, **pkw), planes)
                regs, spill, blocks = asw_cuda.occupancy(plan, dev)
                label = "L1 kernel" if path == "l1" else name
                print(f"{w}x{h} {label}: {ms:.3f} ms | plan {plan['path']} "
                      f"chunk {plan['chunk']} jg {plan['jg']} smem "
                      f"{plan['smem']} B, {regs} registers, {spill} B "
                      f"spilled, {blocks} blocks an SM", flush=True)
    finally:
        asw_cuda.LIBRARY.loaded = base
    print(card)


if __name__ == "__main__":
    main()
