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
  ``sgm_pallas._sgm_scan_kernel``), the census cost volume it reads and
  the post pass over the path sum it writes (no TPU kernels: XLA fuses
  the JAX package's);
- ``gsw_kernel.cu``: GSW volume + support-weight aggregation (K3,
  ``gsw_pallas._gsw_kernel``);
- ``rotate_kernel.cu``: per-plane dynamic roll (K4, the
  ``benchmarks/probe_dynamic_rotate.py`` probe);
- ``iir_unwrap_kernel.cu``: the IIR phase-unwrapping recursion (S1, the
  ``lax.scan`` of ``simplestereo_tpu.unwrapping._iir_unwrap``);
- ``thomas_kernel.cu``: the tridiagonal line solves of the WLS smoother
  (S2, the ``lax.scan``s of ``simplestereo_tpu.passive.wls._thomas_rows``);
- ``speckle_kernel.cu``: the speckle filter's connected components (no
  TPU kernel: the JAX package filters on the host), built only when a
  CUDA ``StereoSGM`` with ``speckleWindowSize > 0`` first filters a map.

The host sources are built the same way with ``g++`` (``HOST_SOURCES``):
``native/_ply.cpp``, the PLY writer and parser, ``native/_png.cpp``,
the PNG row filters undone, ``native/_jpeg.cpp``, the JPEG codec
(baseline and progressive decoding), ``native/_tiff.cpp``, TIFF's LZW and
PackBits decoders, ``native/_bmp.cpp``, BMP's RLE decoder, and
``native/_fax.cpp``, TIFF's CCITT decoders, ``native/_gif.cpp``, GIF's
LZW, and ``native/_webp.cpp``, the WebP decoder (VP8L, VP8 and alpha).

Pointers and the stream are passed as ``c_void_p``, integers as ``c_int``
(``c_longlong`` for sizes of the host libraries), floats as ``c_float`` or
``c_double``; every kernel's C entry returns ``cudaGetLastError()`` of its
launches, which the caller turns into an exception, and the host entries
return 0 or an error code.
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

GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
# Host libraries: name -> source, built with g++ and GXX_FLAGS.
HOST_SOURCES = {"ply": _CSRC.parent / "native" / "_ply.cpp",
                "png": _CSRC.parent / "native" / "_png.cpp",
                "jpeg": _CSRC.parent / "native" / "_jpeg.cpp",
                "tiff": _CSRC.parent / "native" / "_tiff.cpp",
                "bmp": _CSRC.parent / "native" / "_bmp.cpp",
                "fax": _CSRC.parent / "native" / "_fax.cpp",
                "gif": _CSRC.parent / "native" / "_gif.cpp",
                "webp": _CSRC.parent / "native" / "_webp.cpp"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _D, _S = ctypes.c_longlong, ctypes.c_double, ctypes.c_char_p
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
        # C, L, carry, B, H, W, D, P1, P2, dir0, ndir, dir_step,
        # slot_stride, npl, group, vec, device, stream
        "sgm_scan": ([_P] * 3 + [_I] * 4 + [_F] * 2 + [_I] * 3 + [_L]
                     + [_I] * 4 + [_P], _I),
        # L, S, vol, stride, nbuf, device, stream
        "sgm_sum": ([_P] * 2 + [_L] * 2 + [_I] * 2 + [_P], _I),
        # gray1, gray2, rows, codes, C, B, H, W, min_disp, D, win, block,
        # device, stream
        "sgm_census_cost": ([_P] * 5 + [_I] * 8 + [_P], _I),
        # S, out, keys, disps, B, H, W, D, min_disp, uniq_factor, uniq,
        # lr_max, subpixel, nj, group, device, stream
        "sgm_post": ([_P] * 4 + [_I] * 5 + [_F] + [_I] * 6 + [_P], _I),
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
    "iir_unwrap_kernel": {
        # phase, out, H, W, tau, double, warps_per_cta, ctas, chunk, slots,
        # smem, device, stream
        "iir_unwrap": ([_P] * 2 + [_I] * 2 + [_D] + [_I] * 7 + [_P], _I),
        # mismatches (uint64[2]), device, stream: div3 against the IEEE
        # division (every float in range, 2^30 doubles)
        "iir_div3_check": ([_P, _I, _P], _I),
        "iir_error_string": ([_I], ctypes.c_char_p),
    },
    "thomas_kernel": {
        # conf, w, u, out, B, H, W, along_y, lam, eps, segment, lines,
        # stride, smem, device, stream
        "thomas_solve": ([_P] * 4 + [_I] * 4 + [_F] * 2 + [_I] * 5 + [_P],
                         _I),
        "thomas_error_string": ([_I], ctypes.c_char_p),
    },
    "speckle_kernel": {
        # disp, out, label, count, B, H, W, m, size, new_val, device, stream
        "speckle_filter": ([_P] * 4 + [_I] * 7 + [_P], _I),
        "speckle_error_string": ([_I], ctypes.c_char_p),
    },
    "ply": {
        # path, header, header_len, xyz, n, mode, rgb, vals, as_int,
        # precision
        "ply_write": ([_S, _S, _L, _P, _L, _I, _P, _P, _I, _I], _I),
        # path, n_skip, n_rows, n_cols, out
        "ply_read": ([_S, _L, _L, _L, _P], _I),
    },
    "png": {
        # in, height, stride, bpp, out
        "png_unfilter": ([_P, _L, _L, _I, _P], _L),
    },
    "jpeg": {
        # data, n, info (int[3])
        "jpeg_header": ([_P, _L, _P], _I),
        # data, n, out, cap, bgr, colour
        "jpeg_decode": ([_P, _L, _P, _L, _I, _I], _I),
        # img, h, w, c, bgr, quality, hs, vs, out, cap
        "jpeg_encode": ([_P] + [_I] * 7 + [_P, _L], _L),
        "jpeg_error": ([], ctypes.c_char_p),
    },
    "tiff": {
        # in, n, out, cap
        "tiff_lzw": ([_P, _L, _P, _L], _L),
        "tiff_packbits": ([_P, _L, _P, _L], _L),
        "tiff_error": ([], ctypes.c_char_p),
    },
    "bmp": {
        # in, n, start, rle4, width, out, cap
        "bmp_rle": ([_P, _L, _L, _I, _L, _P, _L], _L),
    },
    "fax": {
        # in, n, compression, t4options, width, rows, out, stride
        "tiff_fax": ([_P, _L, _I, _I, _I, _I, _P, _L], _L),
        "tiff_fax_error": ([], ctypes.c_char_p),
    },
    "gif": {
        # in, n, min_size, out, cap
        "gif_lzw": ([_P, _L, _I, _P, _L], _L),
    },
    "webp": {
        # data, n, info (int[3])
        "webp_info": ([_P, _L, _P], _I),
        # data, n, out
        "webp_decode": ([_P, _L, _P], _I),
        "webp_error": ([], ctypes.c_char_p),
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


def _gxx():
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: building the host libraries "
                           "needs a C++17 compiler on PATH")
    return found


def _compiler(name):
    """The compiler and flags that build ``name``."""
    if name in HOST_SOURCES:
        return [_gxx(), *GXX_FLAGS]
    return [_nvcc(), *NVCC_FLAGS]


def _library_path(name):
    src = HOST_SOURCES.get(name, _CSRC / f"{name}.cu")
    flags = GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_log(name):
    """The compiler's output (for nvcc, ptxas's register and spill report)
    for ``name``'s current build, or '' when it was not built by this
    checkout yet."""
    log = _library_path(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names):
    """Compile each ``csrc/<name>.cu`` (or host source of ``HOST_SOURCES``)
    of ``names`` whose build is missing: one compiler per source, all
    started together, so a cold build of every library takes as long as
    the slowest source rather than their sum.
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
                [*_compiler(name), "-o", str(tmp), str(src)],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((src, lib_path, tmp, log, proc))
    failed = []
    for src, lib_path, tmp, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"build failed for {src.name} (exit "
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
    """Build ``csrc/<name>.cu`` (or the host source ``name``) if its build
    is missing, load it, and set the ctypes signatures of its C entries."""
    build([name])
    lib = ctypes.CDLL(str(_library_path(name)[1]))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
