"""Where the S1 (IIR unwrapping) kernel spends its time, on one CUDA card.

    python3 -m simplestereo_tpu_torch.probes.iir_variants

Builds edited copies of ``simplestereo_tpu_torch/csrc/iir_unwrap_kernel.cu``
side by side (one nvcc each, all started together) under
``build/iir_variants/``. Each copy switches one part of the kernel off, so
its results are wrong and only its time means anything, or puts back a
part of the first version (the library's fmod, the smallest ring). Every
copy is timed on 1280x720 wrapped phases (float32 and float64, tau 0.5;
CUDA events, median over distinct inputs) in turns with the unchanged
source. One line per (precision, variant);
the last line is the card's name and power limit.

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

TRANSIENT = "  if (threadIdx.x == 0) {\n    T f = phi[0];"
STEPS = "const int steps = W + 2 * (H - 1);"
DONE = "if (x >= W) continue;  // this row is done"
PREFETCH = 'asm volatile("prefetch.global.L1 [%0];" ::"l"(row + x + kLine));'
STORE = "out[(long long)y * W + x] = u;"
# name: (source edits, the smallest ring instead of a slot per row)
VARIANTS = {
    "base": ([], False),
    "no transient (row 0 copied)": ([(TRANSIENT, (
        "  for (int x = threadIdx.x; x < W; x += blockDim.x) r0[x] = phi[x];\n"
        "  if (threadIdx.x == 0 && H < 0) {\n    T f = phi[0];"))], False),
    "transient alone": ([(STEPS, "const int steps = 0;")], False),
    "wavefront steps empty": ([(DONE, "if (x >= W || W > 0) continue;")],
                              False),
    "library fmod (the first version)": ([(
        "fmod_pos(O::add(O::sub(phi, u), c.pi), c.two_pi, c.inv_two_pi);",
        "O::mod(O::add(O::sub(phi, u), c.pi), c.two_pi);")], False),
    "division by reciprocal": ([
        ("return __fdiv_rn(a, b);", "return __fmul_rn(a, __frcp_rn(b));"),
        ("return __ddiv_rn(a, b);", "return __dmul_rn(a, __drcp_rn(b));")],
        False),
    "no prefetch": ([(PREFETCH, ";")], False),
    "phase not loaded": ([("const T p = prow[x];",
                           "const T p = T(x) * T(0.001);")], False),
    "no global store": ([(STORE, "if (u == T(12345.678)) " + STORE)],
                        False),
    "smallest ring (slot y % ring_rows)": ([], True),
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
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in \
                _build._SIGNATURES["iir_unwrap_kernel"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def launcher(lib, small_ring):
    """Run a copy of the kernel with the wrapper's plan, or with the
    smallest ring that keeps live rows apart."""
    def run(x):
        H, W = x.shape
        plan = unwrapping._plan(
            H, W, x.element_size(),
            ring_rows=min(H, W // 2 + 2) if small_ring else None)
        out = torch.empty_like(x)
        work = torch.empty(W, dtype=x.dtype, device=x.device)
        err = lib.iir_unwrap(x.data_ptr(), out.data_ptr(), work.data_ptr(),
                             H, W, 0.5, int(x.dtype == torch.float64),
                             plan["threads"], plan["ring_rows"], plan["smem"],
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
    h, w = 720, 1280
    steps = w + 2 * (h - 1) + 2 * (w - 1)
    base = launcher(libs["base"], False)
    for dtype in (np.float32, np.float64):
        ins = [torch.tensor(wrapped_phase(h, w, dtype, seed=i), device=dev)
               for i in range(6)]
        if not torch.equal(base(ins[0]),
                           unwrapping._iir_unwrap_plain(ins[0], 0.5)):
            raise AssertionError("iir_variants: the unchanged source "
                                 "differs from the twin")
        runs = ["base"]
        for name in VARIANTS:
            if name != "base":
                runs += [name, "base"]
        for name in runs:
            ms = cuda_ms(launcher(libs[name], VARIANTS[name][1]), ins)
            print(f"{w}x{h} {dtype.__name__} {name}: {ms:.3f} ms "
                  f"({ms * 1e6 / steps:.0f} ns a step of {steps})",
                  flush=True)
    print(card)


if __name__ == "__main__":
    main()
