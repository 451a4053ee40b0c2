"""
imgio
=====

Image I/O without Pillow: the port of :mod:`simplestereo_tpu.imgio`,
which reads and writes through Pillow. The port reads what the JAX
package reads in the formats a stereo or scanning rig produces, and gives
the same arrays:

- PNG: every colour type and bit depth (gray 1/2/4/8/16, RGB 8/16,
  palette 1/2/4/8, gray + alpha 8/16, RGBA 8/16), plain or
  Adam7-interlaced (:mod:`.formats.png`);
- BMP: core, info, V4 and V5 headers; 1/4/8-bit palette (raw, RLE8,
  RLE4), 16, 24 and 32-bit (raw or bit fields); bottom-up or top-down
  (:mod:`.formats.bmp`);
- TIFF: the first image; strips or tiles; none, PackBits, LZW or Deflate,
  predictor 2; planar 1 or 2; bilevel, 2/4/8/16-bit gray, gray + alpha,
  RGB and RGBA at 8 and 16 bits, palette (:mod:`.formats.tiff`);
- JPEG: baseline and progressive (Huffman), gray or YCbCr/RGB, decoded
  by the host C++ of :mod:`.native` to libjpeg's pixels;
- binary PGM/PPM (P5/P6, maxval 255).

Refused, each with a ``ValueError`` naming the format: GIF, WebP,
CMYK/YCCK, arithmetic-coded, 12-bit, lossless and hierarchical JPEG,
JPEG-in-TIFF, float and 32-bit integer TIFF (and the rarer layouts each
format module lists), and anything else.

Writes ``.png`` (8-bit), ``.jpg``/``.jpeg`` (baseline, quality 75, 4:2:0,
Pillow's defaults), ``.bmp`` and ``.tif``/``.tiff`` (uncompressed, byte
for byte what Pillow's ``Image.save`` writes) and ``.pgm``/``.ppm``/
``.pnm`` (P5/P6).

Convention, as in the JAX package (which reads through Pillow) and the
reference (``cv2.imread``): colour images are **BGR** uint8 arrays.
:func:`imread` converts as Pillow's ``convert`` does: ``grayscale=True``
gives ``convert("L")`` (ITU-R 601 luma in fixed point, ``(R*19595 +
G*38470 + B*7471 + 0x8000) >> 16``, of the palette's colours for a
palette file), colour gives ``convert("RGB")`` (the palette's colours;
gray repeated); alpha is dropped, not composited; 16-bit gray is clipped
at 255, not scaled (so a 16-bit capture read with ``grayscale=True``
saturates, as it does in the JAX package); bilevel is 0 or 255.
:func:`read_samples` gives the file's own samples, as
``np.asarray(Image.open(path))`` does.
"""

import os
import zlib
from struct import error as struct_error

import numpy as np

from . import native
from .formats import bmp, png, reversed_rgb, tiff


def _pnm_tokens(data, count):
    """The first ``count`` header tokens of a PNM file (comments skipped)
    and the offset of the raster, one whitespace byte after the last."""
    tokens, pos = [], 2
    while len(tokens) < count:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PGM/PPM header")
        tokens.append(int(data[start:pos]))
    return tokens, pos + 1


def _read_pnm(data):
    c = 1 if data[:2] == b"P5" else 3
    (w, h, maxval), pos = _pnm_tokens(data, 3)
    if maxval != 255:
        raise ValueError(f"PGM/PPM with maxval {maxval} is not supported "
                         "(8-bit, maxval 255 only)")
    raster = np.frombuffer(data, np.uint8, h * w * c, pos)
    return raster.reshape((h, w) if c == 1 else (h, w, c)), \
        "L" if c == 1 else "RGB", None


def _read_jpeg(data):
    img = native.jpeg_decode(data, bgr=False)
    return img, "L" if img.ndim == 2 else "RGB", None


def _format(data):
    """The decoder of ``data``'s format, or the format's name."""
    if data.startswith(png.SIGNATURE):
        return png.decode
    if data[:2] == b"BM":
        return bmp.decode
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return tiff.decode
    if data[:2] == b"\xff\xd8":
        return _read_jpeg
    if data[:2] in (b"P5", b"P6"):
        return _read_pnm
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:2] in (b"P1", b"P2", b"P3", b"P4"):
        return f"PNM {data[:2].decode()} (plain or bitmap)"
    return "unknown"


def _decode(path):
    """(array, mode, palette) of an image file; see :mod:`.formats`."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format(data)
    if isinstance(fmt, str):
        raise ValueError(f"{path!r}: {fmt} image format is not supported "
                         "(PNG, JPEG, BMP, TIFF, PGM and PPM only)")
    try:
        return fmt(data)
    except ValueError as e:
        raise ValueError(f"{path!r}: {e}") from None
    except (IndexError, struct_error, zlib.error) as e:
        raise ValueError(f"{path!r}: corrupt or truncated file ({e})") \
            from None


def read_samples(path):
    """The samples of an image file as it stores them, as
    ``np.asarray(Image.open(path))`` gives them: (H, W) for one band, (H,
    W, C) for more, colour in RGB(A) order; bool for bilevel files, uint16
    for 16-bit gray (``>u2`` for a big-endian TIFF's), the palette indices
    for a palette file, uint8 otherwise."""
    return _decode(path)[0]


def _luma(rgb):
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
             + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def imread(path, grayscale=False):
    """Read an image file to a numpy array (BGR for color, like cv2.imread).

    Parameters
    ----------
    path : str
    grayscale : bool
        If True, convert to single-channel luminance (ITU-R 601, as
        Pillow's ``convert("L")``).

    Returns
    -------
    numpy.ndarray
        (H, W) uint8 if grayscale, else (H, W, 3) uint8 BGR.
    """
    arr, mode, palette = _decode(path)
    if mode == "P":
        return (_luma(palette) if grayscale else palette[:, ::-1])[arr]
    if arr.ndim == 2:  # 1, L, I;16, I;16B
        if mode == "1":
            g = arr.astype(np.uint8) * np.uint8(255)
        elif arr.dtype != np.uint8:
            g = np.minimum(arr, 255).astype(np.uint8)
        else:
            g = arr
        g = np.ascontiguousarray(g)
        return g if grayscale else np.repeat(g[:, :, None], 3, axis=2)
    if mode == "LA":
        g = np.ascontiguousarray(arr[:, :, 0])
        return g if grayscale else np.repeat(g[:, :, None], 3, axis=2)
    if grayscale:
        return _luma(arr)
    return reversed_rgb(arr)  # RGB(A) -> BGR


def imwrite(path, image):
    """Write a numpy array to an image file (expects BGR for color).

    The format follows the extension: ``.png``, ``.jpg``/``.jpeg``
    (baseline, quality 75, 4:2:0 as Pillow writes it), ``.bmp`` (8-bit
    gray with the gray palette, or 24-bit), ``.tif``/``.tiff``
    (uncompressed), or ``.pgm``/``.ppm``/``.pnm`` (binary P5 for gray, P6
    for colour); BMP and TIFF byte for byte as Pillow's ``Image.save``.
    Non-uint8 values are clipped to [0, 255] and truncated to uint8, as
    the JAX package does.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"cannot write an image of shape {arr.shape}: "
                         "gray (H, W) or BGR (H, W, 3) only")
    arr = reversed_rgb(arr) if arr.ndim == 3 else np.ascontiguousarray(arr)
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".png":
        data = png.encode(arr)
    elif ext in (".jpg", ".jpeg"):
        data = native.jpeg_encode(arr, quality=75, bgr=False)
    elif ext == ".bmp":
        data = bmp.encode(arr)
    elif ext in (".tif", ".tiff"):
        data = tiff.encode(arr)
    elif ext in (".pgm", ".ppm", ".pnm"):
        magic = b"P5" if arr.ndim == 2 else b"P6"
        h, w = arr.shape[:2]
        data = magic + f"\n{w} {h}\n255\n".encode() + arr.tobytes()
    else:
        raise ValueError(f"{path!r}: cannot write {ext or 'no'} extension "
                         "(.png, .jpg, .jpeg, .bmp, .tif, .tiff, .pgm, .ppm "
                         "or .pnm only)")
    with open(path, "wb") as f:
        f.write(data)
