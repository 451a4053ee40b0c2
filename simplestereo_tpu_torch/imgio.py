"""
imgio
=====

Minimal image I/O without Pillow: the port of :mod:`simplestereo_tpu.imgio`.

Reads 8-bit, non-interlaced PNG (gray, gray + alpha, RGB, RGBA), baseline
JPEG and binary PGM/PPM (P5/P6, maxval 255); writes 8-bit gray or colour
PNG, JPEG (quality 75, 4:2:0, Pillow's defaults) and P5/P6. zlib comes
from Python's standard library; the PNG row filters are undone and JPEG is
coded by host C++ (:mod:`.native`, built at first use). Any other format
(16-bit or palette PNG, interlaced PNG, progressive or arithmetic-coded
JPEG, ...) raises ``ValueError`` naming it.

Convention, as in the JAX package (which reads through Pillow) and the
reference (``cv2.imread``): colour images are **BGR** uint8 arrays.
``grayscale=True`` gives what Pillow's ``convert("L")`` gives: ITU-R 601
luma in fixed point, ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``.
Alpha is dropped, not composited, as Pillow's ``convert`` drops it.
"""

import os
import struct
import zlib

import numpy as np

from . import native

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (0 gray, 2 RGB, 3 palette, 4 gray + alpha,
# 6 RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _read_png(data):
    """(H, W, C) uint8 samples of a PNG file's bytes, C in 1..4."""
    pos = len(_PNG_SIG)
    ihdr = None
    idat = []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype == 3:
        raise ValueError("palette PNG (colour type 3) is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"PNG colour type {ctype} is not supported")
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG is not supported (8-bit only)")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if comp != 0 or filt != 0:
        raise ValueError(f"PNG compression {comp} / filter method {filt} "
                         "is not supported")
    c = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    return native.png_unfilter(raw, h, w * c, c).reshape(h, w, c)


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
    return raster.reshape(h, w, c)


def _format(data):
    if data.startswith(_PNG_SIG):
        return "png"
    if data[:2] in (b"P5", b"P6"):
        return "pnm"
    if data[:2] == b"\xff\xd8":
        return "JPEG"
    if data[:2] in (b"P1", b"P2", b"P3", b"P4"):
        return f"PNM {data[:2].decode()} (plain or bitmap)"
    return "unknown"


def read_samples(path):
    """(H, W, C) uint8 samples of an image file as it stores them: C = 1
    (gray), 2 (gray + alpha), 3 (RGB) or 4 (RGBA), colour in RGB order, as
    ``np.asarray(Image.open(path))`` gives them (with a trailing axis of 1
    for gray)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format(data)
    if fmt == "png":
        return _read_png(data)
    if fmt == "pnm":
        return _read_pnm(data)
    if fmt == "JPEG":
        try:
            img = native.jpeg_decode(data, bgr=False)
        except ValueError as e:
            raise ValueError(f"{path!r}: {e}") from None
        return img[:, :, None] if img.ndim == 2 else img
    raise ValueError(f"{path!r}: {fmt} image format is not supported "
                     "(8-bit PNG, baseline JPEG, PGM and PPM only)")


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
    img = read_samples(path)
    if img.shape[2] in (2, 4):  # drop alpha
        img = img[:, :, :img.shape[2] - 1]
    if grayscale:
        if img.shape[2] == 1:
            return np.ascontiguousarray(img[:, :, 0])
        rgb = img.astype(np.uint32)
        return ((rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
                 + rgb[:, :, 2] * 7471 + 0x8000) >> 16).astype(np.uint8)
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, ::-1])  # RGB -> BGR


def _png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _encode_png(arr):
    h, w = arr.shape[:2]
    ctype = 0 if arr.ndim == 2 else 2
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def imwrite(path, image):
    """Write a numpy array to an image file (expects BGR for color).

    The format follows the extension: ``.png``, ``.jpg``/``.jpeg``
    (baseline, quality 75, 4:2:0 as Pillow writes it), or ``.pgm``/
    ``.ppm``/``.pnm`` (binary P5 for gray, P6 for colour). Non-uint8
    values are clipped to [0, 255] and truncated to uint8, as the JAX
    package does.
    """
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"cannot write an image of shape {arr.shape}: "
                         "gray (H, W) or BGR (H, W, 3) only")
    if arr.ndim == 3:
        arr = arr[:, :, ::-1]  # BGR -> RGB
    arr = np.ascontiguousarray(arr)
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".png":
        data = _encode_png(arr)
    elif ext in (".jpg", ".jpeg"):
        data = native.jpeg_encode(arr, quality=75, bgr=False)
    elif ext in (".pgm", ".ppm", ".pnm"):
        magic = b"P5" if arr.ndim == 2 else b"P6"
        h, w = arr.shape[:2]
        data = magic + f"\n{w} {h}\n255\n".encode() + arr.tobytes()
    else:
        raise ValueError(f"{path!r}: cannot write {ext or 'no'} extension "
                         "(.png, .jpg, .jpeg, .pgm, .ppm or .pnm only)")
    with open(path, "wb") as f:
        f.write(data)
