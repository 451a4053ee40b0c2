"""
native
======

Host C++ of the port, built at first use: the PLY writer and parser of
``_ply.cpp`` (the port of ``simplestereo_tpu/native/_ply.cpp``), and the
byte chains of the image decoders, where the JAX package uses Pillow: the
PNG row unfiltering of ``_png.cpp``, the JPEG codec of ``_jpeg.cpp``
(baseline, progressive, arithmetic-coded and lossless decoding, CMYK and
YCCK too; baseline encoding; for :mod:`..imgio`, :mod:`..videoio` and
JPEG-in-TIFF), TIFF's LZW and PackBits of ``_tiff.cpp``, TIFF's CCITT
fax codes of ``_fax.cpp``, BMP's RLE8/RLE4 of ``_bmp.cpp``, GIF's LZW of
``_gif.cpp`` and the WebP decoder (VP8L, VP8, alpha) of ``_webp.cpp``
(for :mod:`..formats`). ctypes releases the GIL during each call, so a
decode in a :class:`..utils.Capture` grab thread leaves the other threads
running.

Each source has a plain C interface, so it needs no ``Python.h``: ``g++``
builds it in about a second (:mod:`.._build`) into
``build/simplestereo_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout, and ctypes loads it. A failed build raises with the compiler's
log; nothing falls back to Python code.
"""

import ctypes
import os

import numpy as np

from .. import _build

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
_L = ctypes.c_longlong
_PLY = _build.Library("ply", {
    # path, header, header_len, xyz, n, mode, rgb, vals, as_int, precision
    "ply_write": ([_S, _S, _L, _P, _L, _I, _P, _P, _I, _I], _I),
    # path, n_skip, n_rows, n_cols, out
    "ply_read": ([_S, _L, _L, _L, _P], _I),
})
_PNG = _build.Library("png", {
    # in, height, stride, bpp, out
    "png_unfilter": ([_P, _L, _L, _I, _P], _L),
})
_JPEG = _build.Library("jpeg", {
    # data, n, info (int[3])
    "jpeg_header": ([_P, _L, _P], _I),
    # data, n, out, cap, bgr, colour
    "jpeg_decode": ([_P, _L, _P, _L, _I, _I], _I),
    # img, h, w, c, bgr, quality, hs, vs, out, cap
    "jpeg_encode": ([_P] + [_I] * 7 + [_P, _L], _L),
    "jpeg_error": ([], _S),
})
_TIFF = _build.Library("tiff", {
    # in, n, out, cap
    "tiff_lzw": ([_P, _L, _P, _L], _L),
    "tiff_packbits": ([_P, _L, _P, _L], _L),
    "tiff_error": ([], _S),
})
_BMP = _build.Library("bmp", {
    # in, n, start, rle4, width, out, cap
    "bmp_rle": ([_P, _L, _L, _I, _L, _P, _L], _L),
})
_FAX = _build.Library("fax", {
    # in, n, compression, t4options, width, rows, out, stride
    "tiff_fax": ([_P, _L, _I, _I, _I, _I, _P, _L], _L),
    "tiff_fax_error": ([], _S),
})
_GIF = _build.Library("gif", {
    # in, n, min_size, out, cap
    "gif_lzw": ([_P, _L, _I, _P, _L], _L),
})
_WEBP = _build.Library("webp", {
    # data, n, info (int[3])
    "webp_info": ([_P, _L, _P], _I),
    # data, n, out
    "webp_decode": ([_P, _L, _P], _I),
    "webp_error": ([], _S),
})


def _raise(err, what, path):
    if err == -1:
        raise ValueError(f"PLY {what} failed: malformed body in {path!r}")
    raise OSError(err, f"PLY {what} failed: {os.strerror(err)}", path)


def write_ply(path, header, xyz, rgb=None, vals=None, as_int=False,
              precision=6):
    """Write ``header`` (bytes) then one line per point of ``xyz`` ((n, 3)
    float64), with ``rgb`` ((n, 3) uint8) or ``vals`` ((n,) float64,
    printed as integers when ``as_int``) after the coordinates."""
    lib = _PLY.load()
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
    lib = _PLY.load()
    out = np.empty((n_rows, n_cols), np.float64)
    err = lib.ply_read(os.fsencode(path), n_skip, n_rows, n_cols,
                       out.ctypes.data)
    if err:
        _raise(err, "read", path)
    return out


def png_unfilter(data, height, stride, bpp):
    """(height, stride) uint8 rows of a PNG image (or of one Adam7 pass)
    from its inflated IDAT bytes (each row a filter-type byte and
    ``stride`` filtered bytes). ``bpp`` is the filters' unit, the bytes of
    one pixel rounded up: 1 to 8 (RGBA at 16 bits), and 1 for depths
    below 8 bits."""
    lib = _PNG.load()
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


def tiff_decompress(data, size, packbits=False):
    """The first ``size`` bytes that one TIFF strip or tile of LZW (or,
    with ``packbits``, PackBits) bytes ``data`` decodes to; fewer when the
    data ends first."""
    lib = _TIFF.load()
    out = np.empty(size, np.uint8)
    fn = lib.tiff_packbits if packbits else lib.tiff_lzw
    n = fn(data, len(data), out.ctypes.data, size)
    if n < 0:
        raise ValueError(f"TIFF: {lib.tiff_error().decode()}")
    return out[:n]


def tiff_fax(data, compression, width, rows, t4options=0):
    """(rows, (width + 7) // 8) uint8: one TIFF strip or tile of CCITT
    data (``compression`` 2, 3 or 4; ``FillOrder`` 1), the bits of black
    runs set, as libtiff decodes it. Rows that the data does not reach
    are white, as in libtiff."""
    lib = _FAX.load()
    stride = (width + 7) // 8
    out = np.empty((rows, stride), np.uint8)
    n = lib.tiff_fax(data, len(data), int(compression), int(t4options),
                     int(width), int(rows), out.ctypes.data, stride)
    if n < 0:
        raise ValueError(f"TIFF: {lib.tiff_fax_error().decode()}")
    return out


def gif_lzw(data, min_size, out):
    """Decode one GIF frame's LZW sub-blocks ``data`` (from just after
    its minimum code size ``min_size``) into the uint8 array ``out``;
    returns the indices written (fewer than ``out.size`` when the data
    ends first)."""
    lib = _GIF.load()
    n = lib.gif_lzw(data, len(data), int(min_size), out.ctypes.data,
                    out.size)
    if n < 0:
        raise ValueError("GIF: corrupt LZW data")
    return n


def webp_decode(data):
    """(RGBA (H, W, 4) uint8, alpha) of WebP bytes: the first frame on
    its canvas, as libwebp's animation decoder draws it for Pillow;
    ``alpha`` says whether Pillow opens the file as RGBA (else RGB)."""
    lib = _WEBP.load()
    info = np.zeros(3, np.int32)
    if lib.webp_info(data, len(data), info.ctypes.data):
        raise ValueError(f"WebP: {lib.webp_error().decode()}")
    w, h, alpha = (int(v) for v in info)
    out = np.empty((h, w, 4), np.uint8)
    if lib.webp_decode(data, len(data), out.ctypes.data):
        raise ValueError(f"WebP: {lib.webp_error().decode()}")
    return out, bool(alpha)


def bmp_rle(data, start, rle4, width, height):
    """(height, width) uint8 palette indices of a BMP's RLE8 (or RLE4)
    stream ``data`` in stored row order, as Pillow decodes it; ``start``
    is the stream's offset in the file. A stream that ends before the
    image is filled raises, as in Pillow."""
    lib = _BMP.load()
    out = np.empty((height, width), np.uint8)
    n = lib.bmp_rle(data, len(data), start, int(bool(rle4)), width,
                    out.ctypes.data, out.size)
    if n < 0:
        raise ValueError("BMP: truncated RLE delta record")
    if n < out.size:  # Pillow: "not enough image data"
        raise ValueError(f"BMP: the RLE data ends after {n} of "
                         f"{out.size} pixels")
    return out


def _jpeg_fail(lib):
    raise ValueError(f"JPEG: {lib.jpeg_error().decode()}")


def _jpeg_header(data):
    """(height, width, components) of the JPEG bytes ``data``."""
    lib = _JPEG.load()
    info = np.zeros(3, np.int32)
    if lib.jpeg_header(data, len(data), info.ctypes.data):
        _jpeg_fail(lib)
    return tuple(int(v) for v in info)


def jpeg_decode(data, bgr=True, colour="auto"):
    """Decode JPEG bytes: (H, W, 3) uint8, BGR when
    ``bgr`` else RGB, (H, W) uint8 for a grayscale image, or (H, W, 4)
    CMYK for a 4-component one (YCCK converted), inverted as Pillow reads
    it (``CMYK;I``). ``colour`` "auto" takes the colour space from the
    markers as libjpeg does, "ycbcr" converts YCbCr whatever they say and
    "none" leaves the components as stored (libtiff's two settings).
    Baseline, progressive (Huffman or arithmetic), sequential arithmetic
    and lossless frames decode. Raises ``ValueError`` on malformed data
    and on what the codec leaves out (hierarchical frames, samples of
    other than 8 bits, lossless with subsampling), naming it."""
    lib = _JPEG.load()
    h, w, c = _jpeg_header(data)
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    if lib.jpeg_decode(data, len(data), out.ctypes.data, out.nbytes,
                       int(bool(bgr)), {"auto": 0, "ycbcr": 1,
                                        "none": 2}[colour]):
        _jpeg_fail(lib)
    return out


def jpeg_encode(image, quality=75, bgr=True, sampling=(2, 2)):
    """Baseline JPEG bytes of ``image``: (H, W) gray or (H, W, 3) uint8 in
    BGR order when ``bgr`` else RGB. ``sampling`` is the luma component's
    (horizontal, vertical) factors against chroma's 1x1: (2, 2) is 4:2:0,
    Pillow's default, (2, 1) 4:2:2, (1, 2) 4:4:0 and (1, 1) 4:4:4; any
    factors of 1 to 4 with at most 8 luma blocks (4:1:1 is (4, 1))."""
    lib = _JPEG.load()
    img = np.ascontiguousarray(image, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[:, :, 0])
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"cannot encode an image of shape {img.shape} as "
                         "JPEG: gray (H, W) or colour (H, W, 3) only")
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else 3
    cap = img.nbytes // 2 + 65536
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data, h, w, c, int(bool(bgr)),
                            int(quality), int(sampling[0]), int(sampling[1]),
                            out.ctypes.data, cap)
        if n == -1:
            _jpeg_fail(lib)
        if n >= 0:
            return out[:n].tobytes()
        cap = -n - 2
