"""PNG, every colour type and bit depth, plain or Adam7-interlaced, read
as Pillow reads it (``PngImagePlugin``):

====================  =========  ==========================================
colour type, depth    mode       array
====================  =========  ==========================================
gray 1                ``1``      bool
gray 2 / 4 / 8        ``L``      uint8, 2 and 4 bits scaled by 85 and 17
gray 16               ``I;16``   uint16
RGB 8 / 16            ``RGB``    uint8 (16 bits: the high byte)
palette 1/2/4/8       ``P``      uint8 indices; ``PLTE`` is the palette
gray + alpha 8        ``LA``     uint8 (H, W, 2)
gray + alpha 16       ``RGBA``   uint8: gray, gray, gray, alpha (high bytes)
RGBA 8 / 16           ``RGBA``   uint8 (16 bits: the high byte)
====================  =========  ==========================================

``tRNS`` changes no sample (Pillow keeps it aside, and ``convert`` to RGB
or L ignores it). zlib (Python's standard library) inflates the IDAT
stream; :func:`..native.png_unfilter` undoes the row filters, a pass at a
time for Adam7 (passes of zero width or height carry no rows), and numpy
unpacks the samples and scatters each pass to its pixels.

Writes 8-bit gray or RGB, unfiltered, zlib level 6.
"""

import struct
import zlib

import numpy as np

from . import pad_palette, unpack_samples
from .. import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples a pixel, bit depths allowed)
_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
          4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of each pass.
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data):
    pos = len(SIGNATURE)
    ihdr, plte, idat = None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without an IHDR chunk")
    return ihdr, plte, b"".join(idat)


def _samples(raw, h, w, c, depth):
    """(h, w, c) samples of one image (or pass): uint8, or uint16 for
    16 bits, from its filtered rows; returns them and the bytes used."""
    stride = (w * c * depth + 7) // 8
    n = h * (stride + 1)
    if len(raw) < n:
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {n}")
    rows = native.png_unfilter(raw[:n], h, stride, max(1, c * depth // 8))
    if depth == 16:
        s = rows.view(">u2").astype(np.uint16)
    else:
        s = unpack_samples(rows, depth, w * c)
    return s.reshape(h, w, c), n


def decode(data):
    (w, h, depth, ctype, comp, filt, interlace), plte, idat = _chunks(data)
    if ctype not in _TYPES or depth not in _TYPES[ctype][1]:
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not a "
                         "valid PNG")
    if comp != 0 or filt != 0 or interlace > 1:
        raise ValueError(f"PNG compression {comp} / filter method {filt} / "
                         f"interlace {interlace} is not supported")
    if ctype == 3 and plte is None:
        raise ValueError("palette PNG without a PLTE chunk")
    c = _TYPES[ctype][0]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if interlace:
        s = np.empty((h, w, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                s[y0::dy, x0::dx], n = _samples(raw[pos:], ph, pw, c, depth)
                pos += n
    else:
        s = _samples(raw, h, w, c, depth)[0]
    if ctype == 3:
        return s[:, :, 0].astype(np.uint8), "P", pad_palette(
            np.frombuffer(plte, np.uint8)[:len(plte) // 3 * 3])
    if ctype == 0:
        g = s[:, :, 0]
        if depth == 1:
            return g.astype(bool), "1", None
        if depth == 16:
            return g, "I;16", None
        return (g * (255 // ((1 << depth) - 1))).astype(np.uint8), "L", None
    if depth == 16:
        s = (s >> 8).astype(np.uint8)
        if ctype == 4:  # Pillow opens it as RGBA: gray, gray, gray, alpha
            s = s[:, :, [0, 0, 0, 1]]
            return s, "RGBA", None
    return s, {2: "RGB", 4: "LA", 6: "RGBA"}[ctype], None


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode(arr):
    """PNG bytes of (H, W) gray or (H, W, 3) RGB uint8."""
    h, w = arr.shape[:2]
    ctype = 0 if arr.ndim == 2 else 2
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
