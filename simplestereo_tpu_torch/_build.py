"""
Build the CUDA sources under ``csrc/`` at first use and bind them with
ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/simplestereo_tpu_torch/lib<name>-<hash>.so`` at the
root of the checkout, keyed by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. A plain
C interface keeps the build to seconds (a source that includes PyTorch's
headers takes minutes). Nothing is fetched: the sources are the
repository's own.

The sources, one per TPU kernel of the JAX package:

- ``asw_kernel.cu``: ASW cost + select (K1, ``asw_pallas._asw_kernel``);
- ``sgm_kernel.cu``: SGM path aggregation (K2,
  ``sgm_pallas._sgm_scan_kernel``);
- ``gsw_kernel.cu``: GSW volume + support-weight aggregation (K3,
  ``gsw_pallas._gsw_kernel``);
- ``rotate_kernel.cu``: per-plane dynamic roll (K4, the
  ``benchmarks/probe_dynamic_rotate.py`` probe).

Pointers and the stream are passed as ``c_void_p``, integers as ``c_int``
and floats as ``c_float``; every C entry returns ``cudaGetLastError()`` of
its launches, which the caller turns into an exception.
"""

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _CSRC.parents[1] / "build" / "simplestereo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures, by library: {function: (argtypes, restype)}.
_SIGNATURES = {
    "asw_kernel": {
        # planes, prox, cost, dispL, dispR, csub,
        # B, H, W, Hp, Wp, x0, win, step, min_disp, D, inv_gc,
        # chunk, jg, smem, device, stream
        "asw_pass": ([_P] * 6 + [_I] * 10 + [_F] + [_I] * 4 + [_P], _I),
        # chunk, smem, device, info (int[3])
        "asw_occupancy": ([_I, _I, _I, _P], _I),
        "asw_error_string": ([_I], ctypes.c_char_p),
    },
    "sgm_kernel": {
        # C, S, work, B, H, W, D, P1, P2, paths, mode, npl, group, vec,
        # device, stream
        "sgm_aggregate": ([_P] * 3 + [_I] * 4 + [_F] * 2 + [_I] * 6 + [_P],
                          _I),
        "sgm_error_string": ([_I], ctypes.c_char_p),
    },
    "gsw_kernel": {
        # planes, vol, disp, cost, B, C, H, W, Hp, Wp, win, step, min_disp,
        # D, gamma, f_max, normalize, ext_vol, nd, smem, device, stream
        "gsw_pass": ([_P] * 4 + [_I] * 10 + [_F] * 2 + [_I] * 5 + [_P], _I),
        # nd, normalize, smem, device, info (int[3])
        "gsw_occupancy": ([_I] * 4 + [_P], _I),
        "gsw_error_string": ([_I], ctypes.c_char_p),
    },
    "rotate_kernel": {
        # x, shifts, out, N, R, W, device, stream
        "rotate_planes": ([_P] * 3 + [_I] * 4 + [_P], _I),
        "rotate_error_string": ([_I], ctypes.c_char_p),
    },
}


# CUDA's limits on a grid's extents; the matchers' kernels put the frames
# of a stack on y or z.
GRID_X_MAX = 2**31 - 1
GRID_YZ_MAX = 65_535


def frame_pieces(B, per_launch):
    """[(b0, b1), ...]: the frames [0, B) cut, in order, into launches of
    at most ``per_launch`` frames each. Frames are independent, so the
    pieces give what one launch of the whole stack would, bit for bit."""
    if per_launch < 1:
        raise ValueError(f"per_launch must be >= 1, got {per_launch}")
    return [(b, min(b + per_launch, B)) for b in range(0, B, per_launch)]


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (nvcc on PATH or CUDA_HOME)")
    return found


def _library_path(name):
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_log(name):
    """nvcc's output (ptxas register and spill report) for ``name``'s
    current build, or '' when it was not built by this checkout yet."""
    log = _library_path(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names):
    """Compile each ``csrc/<name>.cu`` of ``names`` whose build is missing:
    one nvcc per source, all started together, so a cold build of every
    kernel takes as long as the slowest source rather than their sum.
    Returns when every one has finished; raises if any failed."""
    jobs = []
    for name in names:
        src, lib_path = _library_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        log = lib_path.with_suffix(f".{os.getpid()}.tmplog")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((src, lib_path, tmp, log, proc))
    failed = []
    for src, lib_path, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"nvcc failed for {src.name} (exit "
                          f"{proc.returncode}):\n{log.read_text()}")
            tmp.unlink(missing_ok=True)
            log.unlink()
            continue
        os.replace(log, lib_path.with_suffix(".log"))
        os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name):
    """Build ``csrc/<name>.cu`` if its build is missing, load it, and set
    the ctypes signatures of its C entries."""
    build([name])
    lib = ctypes.CDLL(str(_library_path(name)[1]))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
