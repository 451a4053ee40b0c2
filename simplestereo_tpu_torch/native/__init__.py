"""
native
======

Host C++ of the port, built at first use: the PLY writer and parser of
``_ply.cpp`` (the port of ``simplestereo_tpu/native/_ply.cpp``) and the
PNG row unfiltering of ``_png.cpp`` (for :mod:`..imgio`).

Each source has a plain C interface, so it needs no ``Python.h``: ``g++``
builds it in about a second (:mod:`.._build`, ``HOST_SOURCES``) into
``build/simplestereo_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout, and ctypes loads it. A failed build raises with the compiler's
log; nothing falls back to Python code.
"""

import os

import numpy as np

from .. import _build


def _raise(err, what, path):
    if err == -1:
        raise ValueError(f"PLY {what} failed: malformed body in {path!r}")
    raise OSError(err, f"PLY {what} failed: {os.strerror(err)}", path)


def write_ply(path, header, xyz, rgb=None, vals=None, as_int=False,
              precision=6):
    """Write ``header`` (bytes) then one line per point of ``xyz`` ((n, 3)
    float64), with ``rgb`` ((n, 3) uint8) or ``vals`` ((n,) float64,
    printed as integers when ``as_int``) after the coordinates."""
    lib = _build.load_library("ply")
    xyz = np.ascontiguousarray(xyz, np.float64).reshape(-1, 3)
    mode, extra = 0, None
    if rgb is not None:
        mode, extra = 1, np.ascontiguousarray(rgb, np.uint8).reshape(-1, 3)
    elif vals is not None:
        mode, extra = 2, np.ascontiguousarray(vals, np.float64).reshape(-1)
    if extra is not None and extra.shape[0] != xyz.shape[0]:
        raise ValueError(f"{extra.shape[0]} colours or intensities for "
                         f"{xyz.shape[0]} points")
    ptr = None if extra is None else extra.ctypes.data
    err = lib.ply_write(os.fsencode(path), header, len(header),
                        xyz.ctypes.data, xyz.shape[0], mode,
                        ptr if mode == 1 else None,
                        ptr if mode == 2 else None, int(bool(as_int)),
                        int(precision))
    if err:
        _raise(err, "write", path)


def read_ply(path, n_skip, n_rows, n_cols):
    """(n_rows, n_cols) float64 array of the numbers on the n_rows lines
    after the first ``n_skip`` lines of ``path``."""
    lib = _build.load_library("ply")
    out = np.empty((n_rows, n_cols), np.float64)
    err = lib.ply_read(os.fsencode(path), n_skip, n_rows, n_cols,
                       out.ctypes.data)
    if err:
        _raise(err, "read", path)
    return out


def png_unfilter(data, height, stride, bpp):
    """(height, stride) uint8 rows of a PNG image from its inflated IDAT
    bytes (each row a filter-type byte and ``stride`` filtered bytes),
    ``bpp`` bytes a pixel."""
    lib = _build.load_library("png")
    raw = np.frombuffer(data, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    bad = lib.png_unfilter(raw.ctypes.data, height, stride, bpp,
                           out.ctypes.data)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has unknown filter type "
                         f"{raw[(bad - 1) * (stride + 1)]}")
    return out
