"""Where the S1 (IIR unwrapping) kernel spends its time, on one CUDA card.

    python3 -m simplestereo_tpu_torch.probes.iir_variants

Builds edited copies of ``simplestereo_tpu_torch/csrc/iir_unwrap_kernel.cu``
side by side (one nvcc each, all started together) under
``build/iir_variants/``. Each copy switches one part of the kernel off, so
its results are wrong and only its time means anything, or puts back a
part back as it could be written (the library's fmod, the IEEE division,
the modulo corrected inline); other variants run the
unchanged source on another launch plan (chunks of 8 or 32 columns, a
portable cluster, one warp a CTA). Every variant is timed on 1280x720
wrapped phases (float32 and float64, tau 0.5; CUDA events, median over
distinct inputs) in turns with the unchanged source; the edited copies
also on one 1280-column row (one warp: the transient and 1,280 steps),
and the unchanged source at 1280x64. One line per (precision, variant); the last line
is the card's name and power limit.

Run from the root of the checkout. Needs a CUDA card, nvcc and the
repository checkout; imports no JAX.
"""

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from .. import _build, unwrapping

TRANSIENT = "  if (rank == 0) {\n    T* p0 = tiles;"
BANDS = "  const int bands = (H + kLanes - 1) / kLanes;"
LOAD = ("          cp_async(&tile[r * kTileStride +\n"
        "                         ((k * kTileCols + c16) & (kCols - 1))],\n"
        "                   phi + size_t(y0 + r) * W + col);")
STORE = ("          out[size_t(y0 + r) * W + col] =\n"
         "              tile[r * kTileStride + ((k * kTileCols + c16) & "
         "(kCols - 1))];")
ARITHMETIC = "      T u = pixel(pa, cur, up0, up1, left, right, c, ok);"
QUICK = "  return O::fma(-q, c.two_pi, a);"
# name: (source edits, unwrapping._plan keywords)
VARIANTS = {
    "base": ([], {}),
    "no transient (row 0 copied)": ([(TRANSIENT, (
        "  for (int x = threadIdx.x; rank == 0 && x < W; x += blockDim.x)\n"
        "    r0[x] = phi[x];\n"
        "  if (rank == 0 && H < 0) {\n    T* p0 = tiles;"))], {}),
    "transient alone": ([(BANDS, BANDS.replace(";", " * 0;"))], {}),
    "arithmetic replaced by two adds": ([(ARITHMETIC, (
        "      T u = O::add(O::add(pa, up0), O::add(cur, up1));\n"
        "      ok = true;"))], {}),
    "library fmod": ([(QUICK, (
        "  return O::mod(a, c.two_pi);"))], {}),
    "modulo corrected inline, no exact branch": ([(QUICK, (
        "  return fmod_fast(a, c.two_pi, c.inv_two_pi);"))], {}),
    "IEEE division": ([(
        "  return either(keep(div3(total), both),",
        "  return either(keep(O::div(total, T(3)), both),")], {}),
    "division by reciprocal": ([(
        "  return O::fma(z, O::fma(T(-3), q0, x), q0);", "  return q0;")],
        {}),
    "phase tiles not loaded (the I/O warp)": ([(LOAD, "          ;")], {}),
    "no global store (the I/O warp)": ([(STORE, "          ;")], {}),
    "no shuffle (lane i reads its own row)": ([(
        "__shfl_up_sync(kFull, cur, 1)", "cur")], {}),
    "no exact path (never taken)": ([(
        "      if (__builtin_expect(!ok & active, 0))\n",
        "      if (c.tau < T(-1))\n")],
        {}),
    "launch bounds of 1,024 threads (64 registers)": ([(
        "__launch_bounds__(2 * kMaxWarps * kLanes)",
        "__launch_bounds__(1024)")], {}),
    "chunks of 8 columns": ([], dict(chunk=8, slots=32)),
    "chunks of 32 columns": ([], dict(chunk=32, slots=8)),
    "a portable cluster (8 CTAs)": ([], dict(cluster=8)),
    "one warp a CTA (16 CTAs, bands wrap)": ([], dict(warps_per_cta=1)),
}


def build(root):
    src = (_build._CSRC / "iir_unwrap_kernel.cu").read_text()
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
                                 unwrapping.LIBRARY.signatures)
    return libs


def launcher(lib, plan_kw):
    """Run a copy of the kernel with the wrapper's plan, or one made with
    other keywords."""
    def run(x):
        H, W = x.shape
        plan = unwrapping._plan(H, W, x.element_size(), **plan_kw)
        out = torch.empty_like(x)
        err = lib.iir_unwrap(x.data_ptr(), out.data_ptr(), H, W, 0.5,
                             int(x.dtype == torch.float64),
                             plan["warps_per_cta"], plan["ctas"],
                             plan["chunk"], plan["slots"], plan["smem"],
                             x.device.index,
                             torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(lib.iir_error_string(err).decode())
        return out
    return run


def wrapped_phase(h, w, dtype, seed=0):
    """A wrapped phase map: a tilted plane, a bump and noise (chip_smoke.py
    checks S1 on it too)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    phi = 0.21 * x + 0.13 * y + 3 * np.exp(
        -((x - w / 2) ** 2 + (y - h / 2) ** 2) / (0.1 * (h * w + 1)))
    phi += rng.normal(0, 0.2, (h, w))
    return np.angle(np.exp(1j * phi)).astype(dtype)


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
    return statistics.median(ts)


def main():
    if not torch.cuda.is_available():
        sys.exit("iir_variants: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build(_build.BUILD_DIR.parent / "iir_variants")
    w = 1280
    base = launcher(libs["base"], {})
    for h, dtype in ((720, np.float32), (720, np.float64), (1, np.float32)):
        # the first version's chain (the transient and one wavefront), the
        # yardstick of a step's time across versions
        steps = w + 2 * (h - 1) + 2 * (w - 1)
        ins = [torch.tensor(wrapped_phase(h, w, dtype, seed=i), device=dev)
               for i in range(6)]
        if not torch.equal(base(ins[0]),
                           unwrapping._iir_unwrap_plain(ins[0], 0.5)):
            raise AssertionError("iir_variants: the unchanged source "
                                 "differs from the twin")
        runs = ["base"]
        for name in VARIANTS:
            if name != "base" and (h > 1 or not VARIANTS[name][1]):
                runs += [name, "base"]
        for name in runs:
            ms = cuda_ms(launcher(libs[name], VARIANTS[name][1]), ins)
            print(f"{w}x{h} {dtype.__name__} {name}: {ms:.3f} ms "
                  f"({ms * 1e6 / steps:.0f} ns a step of {steps})",
                  flush=True)
        if h == 1:
            continue
        # The unchanged source at H = 64: a tenth of the live rows a step.
        # A step bound by issue gets faster with fewer rows; one bound by
        # its latency does not.
        h64 = 64
        steps64 = w + 2 * (h64 - 1) + 2 * (w - 1)
        ins64 = [torch.tensor(wrapped_phase(h64, w, dtype, seed=i),
                              device=dev) for i in range(6)]
        for name in ("base", "transient alone"):
            ms = cuda_ms(launcher(libs[name], {}), ins64)
            print(f"{w}x{h64} {dtype.__name__} {name}: {ms:.3f} ms "
                  f"({ms * 1e6 / steps64:.0f} ns a step of {steps64})",
                  flush=True)
    print(card)


if __name__ == "__main__":
    main()
