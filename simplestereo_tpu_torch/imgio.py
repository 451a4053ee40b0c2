"""
imgio
=====

Image I/O without Pillow: the port of :mod:`simplestereo_tpu.imgio`,
which reads and writes through Pillow. The port reads what the JAX
package reads in the formats a stereo or scanning rig, a scanner or a
dataset produces, and gives the same arrays:

- PNG: every colour type and bit depth (gray 1/2/4/8/16, RGB 8/16,
  palette 1/2/4/8, gray + alpha 8/16, RGBA 8/16), plain or
  Adam7-interlaced (:mod:`.formats.png`);
- BMP: core, info, V4 and V5 headers; 1/4/8-bit palette (raw, RLE8,
  RLE4), 16, 24 and 32-bit (raw or bit fields); bottom-up or top-down
  (:mod:`.formats.bmp`);
- TIFF and BigTIFF: the first image; strips or tiles; none, PackBits, LZW,
  Deflate, JPEG (with JPEGTables) or CCITT (RLE, Group 3 1-D and 2-D,
  Group 4); the horizontal and floating-point predictors; planar 1 or 2;
  bilevel, 2/4/8/12/16-bit gray, signed 8/16/32-bit, unsigned 32-bit and
  float32 samples, gray + alpha, RGB and RGBA at 8 and 16 bits, palette
  (and palette + alpha), CMYK, CIELab, and YCbCr with its subsampling
  (:mod:`.formats.tiff`);
- JPEG: baseline, progressive, arithmetic-coded (sequential and
  progressive) and lossless, gray, YCbCr/RGB or CMYK/YCCK, every sampling
  factor libjpeg takes, decoded by the host C++ of :mod:`.native` to
  libjpeg's pixels;
- PNM: P1-P6 at any maxval from 1 to 65535, and gray PFM (``Pf``)
  (:mod:`.formats.pnm`);
- GIF: the first frame, in its local or global colour table
  (:mod:`.formats.gif`);
- WebP: lossless (VP8L), lossy (VP8) and with alpha (``ALPH``), the
  first frame of an animation (:mod:`.formats.webp`).

Refused, each with a ``ValueError`` naming the format: the files Pillow
refuses too (12-bit and hierarchical JPEG, uncompressed YCbCr, float64
and other TIFF layouts outside Pillow's table, big-endian BigTIFF, BMP
with JPEG or PNG payloads, colour PFM, PAM, ...), old-style JPEG-in-TIFF
and CCITT RLEW, the conversion of CIELab to RGB (Pillow's goes through
LittleCMS), and formats outside these (JPEG 2000, TGA, ...).

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
gray repeated); alpha is dropped, not composited; 16 and 32-bit integer
gray is clipped at 0 and 255, not scaled (so a 16-bit capture read with
``grayscale=True`` saturates, as it does in the JAX package); float is
clipped and truncated (NaN gives 0); CMYK is Pillow's ``cmyk2rgb``;
bilevel is 0 or 255. :func:`read_samples` gives the file's own samples,
as ``np.asarray(Image.open(path))`` does.
"""

import os
import zlib
from struct import error as struct_error

import numpy as np

from . import native
from .formats import bmp, gif, png, pnm, reversed_rgb, tiff, webp


def _read_jpeg(data):
    img = native.jpeg_decode(data, bgr=False)
    mode = "L" if img.ndim == 2 else "RGB" if img.shape[2] == 3 else "CMYK"
    return img, mode, None


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
    if data[:1] == b"P" and data[1:2] in b"1234567fF":
        return pnm.decode
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return gif.decode
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return webp.decode
    return "unknown"


def _decode(path):
    """(array, mode, palette) of an image file; see :mod:`.formats`."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format(data)
    if isinstance(fmt, str):
        raise ValueError(f"{path!r}: {fmt} image format is not supported "
                         "(PNG, JPEG, BMP, TIFF, PNM, PFM, GIF and WebP "
                         "only)")
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


def _cmyk_rgb(cmyk):
    """Pillow's ``cmyk2rgb``: each of C, M, Y taken out of the ink K leaves
    white, ``nk - MULDIV255(c, nk)`` with ``nk = 255 - k``."""
    nk = 255 - cmyk[..., 3:4].astype(np.int32)
    t = cmyk[..., :3].astype(np.int32) * nk + 128
    return (nk - (((t >> 8) + t) >> 8)).astype(np.uint8)


def _gray_of(arr, mode):
    """(H, W) uint8 of a one-band mode, as ``convert("L")`` gives it."""
    if mode == "1":
        return arr.astype(np.uint8) * np.uint8(255)
    if mode == "F":  # f2l: clipped, then truncated; NaN gives 0
        a = np.nan_to_num(arr.astype(np.float32), nan=0.0)
        return np.clip(a, 0, 255).astype(np.uint8)
    if arr.dtype != np.uint8:  # I, I;16, I;16B: clipped at 0 and 255
        return np.clip(arr, 0, 255).astype(np.uint8)
    return arr


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
    if mode in ("P", "PA"):
        idx = arr if mode == "P" else arr[:, :, 0]
        return (_luma(palette) if grayscale else palette[:, ::-1])[idx]
    if mode == "LAB":
        raise ValueError(f"{path!r}: conversion from LAB to "
                         f"{'L' if grayscale else 'RGB'} is not supported "
                         "(Pillow refuses LAB to L; its LAB to RGB goes "
                         "through LittleCMS)")
    if arr.ndim == 2 or mode == "LA":
        g = np.ascontiguousarray(_gray_of(arr if arr.ndim == 2
                                          else arr[:, :, 0], mode))
        return g if grayscale else np.repeat(g[:, :, None], 3, axis=2)
    if mode == "CMYK":
        arr = _cmyk_rgb(arr)
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
        data = pnm.encode(arr)
    else:
        raise ValueError(f"{path!r}: cannot write {ext or 'no'} extension "
                         "(.png, .jpg, .jpeg, .bmp, .tif, .tiff, .pgm, .ppm "
                         "or .pnm only)")
    with open(path, "wb") as f:
        f.write(data)
