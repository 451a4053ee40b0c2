"""BMP, read as Pillow reads it (``BmpImagePlugin``) and written as
``Image.save`` writes it.

Reads the core (12-byte), info (40), V2-V3 (52, 56), OS/2 2 (64), V4
(108) and V5 (124) headers; bottom-up and top-down (negative height)
rows, padded to 4 bytes; depths 1, 4 and 8 with a palette (mode ``P``,
the indices; ``L`` when the palette is the gray ramp 0, 1, 2, ..., and
``1`` when it is black and white), raw or RLE8/RLE4 (:func:`..native.
bmp_rle`, Pillow's decoder with its departures from the documentation);
16 bits (5-5-5 without bit fields; 5-6-5 and 5-5-5 with them, each
channel scaled to 8 bits as ``v * 255 // max``), 24 bits, and 32 bits
(``BI_RGB``: mode ``RGB``, the fourth byte dropped, as Pillow reads the
32-bit BMP it writes from RGBA; ``BI_BITFIELDS`` with the byte masks
Pillow takes: ``RGB`` or ``RGBA``).

Writes 8-bit gray with the gray palette, or 24-bit colour, byte for byte
as Pillow's ``Image.save`` (96 dpi).
"""

import struct

import numpy as np

from . import pad_palette, reversed_rgb, unpack_samples
from .. import native

_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
# 32-bit bit fields (r, g, b, a) -> the byte of each channel in a pixel
# (little-endian: mask 0xFF is byte 0) and whether it has alpha.
_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0): ((2, 1, 0), False),
    (0xFF000000, 0xFF0000, 0xFF00, 0): ((3, 2, 1), False),
    (0xFF000000, 0xFF00, 0xFF, 0): ((3, 1, 0), False),
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): ((3, 2, 1, 0), True),
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): ((0, 1, 2, 3), True),
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): ((2, 1, 0, 3), True),
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): ((3, 1, 0, 2), True),
    (0, 0, 0, 0): ((2, 1, 0, 3), True),
}
# 16-bit layouts: (shift, bits) of r, g, b.
_RGB555 = ((10, 5), (5, 5), (0, 5))
_RGB565 = ((11, 5), (5, 6), (0, 5))


def _header(data):
    """The fields of the file's headers that decoding needs."""
    u16 = lambda p: struct.unpack_from("<H", data, p)[0]
    u32 = lambda p: struct.unpack_from("<I", data, p)[0]
    offset, size = u32(10), u32(14)
    f = dict(offset=offset, size=size, masks=None)
    if size == 12:
        f.update(w=u16(18), h=u16(20), bits=u16(24), comp=_RAW, colors=0,
                 entry=3, top_down=False)
    elif size in (40, 52, 56, 64, 108, 124):
        flip = data[25] == 0xFF
        h = u32(22)
        f.update(w=u32(18), h=2**32 - h if flip else h, bits=u16(28),
                 comp=u32(30), colors=u32(46), entry=4, top_down=flip)
        if f["comp"] == _BITFIELDS:
            if size >= 52:
                f["masks"] = tuple(u32(54 + 4 * i) for i in range(4))
            else:  # three masks after the 40-byte header; no alpha
                f["masks"] = tuple(u32(54 + 4 * i) for i in range(3)) + (0,)
    else:
        raise ValueError(f"BMP header of {size} bytes is not supported")
    f["colors"] = f["colors"] or 1 << f["bits"]
    # The palette follows the header (and a 40-byte header's masks).
    f["palette_at"] = 14 + size + (12 if size == 40 and f["masks"] else 0)
    if offset == 14 + size and f["bits"] <= 8:
        f["offset"] += 4 * f["colors"]
    return f


def _scale(v, shift, bits):
    m = (1 << bits) - 1
    return ((v >> shift) & m) * 255 // m


def decode(data):
    f = _header(data)
    w, h, bits, comp = f["w"], f["h"], f["bits"], f["comp"]
    if comp not in (_RAW, _RLE8, _RLE4, _BITFIELDS):
        name = {4: "JPEG", 5: "PNG"}.get(comp, str(comp))
        raise ValueError(f"BMP compression {name} is not supported (Pillow "
                         "does not read it either)")
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"BMP pixel depth {bits} is not supported")
    masks = f["masks"]
    if comp == _BITFIELDS and not (
            (bits == 32 and masks in _MASKS32)
            or (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF))
            or (bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                             (0x7C00, 0x3E0, 0x1F)))):
        raise ValueError(f"BMP bit fields {masks} at {bits} bits are not "
                         "supported")
    mode, palette = None, None
    if bits <= 8:
        if not 0 < f["colors"] <= 65536:
            raise ValueError(f"BMP palette of {f['colors']} colours")
        e, p0 = f["entry"], f["palette_at"]
        raw = np.frombuffer(data, np.uint8, min(f["colors"] * e,
                                                len(data) - p0), p0)
        bgr = raw[:len(raw) // e * e].reshape(-1, e)[:, :3]
        ramp = (0, 255) if f["colors"] == 2 else range(f["colors"])
        gray = len(bgr) >= len(ramp) and all(
            (bgr[i] == v).all() for i, v in enumerate(ramp))
        if gray:
            mode = "1" if f["colors"] == 2 else "L"
        else:
            mode, palette = "P", pad_palette(bgr[:, ::-1])
    if comp in (_RLE8, _RLE4):
        px = native.bmp_rle(data[f["offset"]:], f["offset"], comp == _RLE4,
                            w, h)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        need = stride * h
        if len(data) - f["offset"] < need:
            raise ValueError(f"truncated BMP: {len(data) - f['offset']} of "
                             f"{need} bytes of pixel data")
        rows = np.frombuffer(data, np.uint8, need, f["offset"]).reshape(
            h, stride)
        if bits <= 8:
            px = unpack_samples(rows, bits, w)
        elif bits == 16:
            v = rows[:, :2 * w].view("<u2")
            layout = _RGB565 if comp == _BITFIELDS and masks[1] == 0x7E0 \
                else _RGB555
            px = np.stack([_scale(v, *sb) for sb in layout], -1).astype(
                np.uint8)
        elif bits == 24:
            px = rows[:, :3 * w].reshape(h, w, 3)  # B, G, R
        else:
            b = rows[:, :4 * w].reshape(h, w, 4)
            order, alpha = _MASKS32[masks] if comp == _BITFIELDS \
                else ((2, 1, 0), False)
            px = b[:, :, list(order)]
            mode = "RGBA" if alpha else "RGB"
        mode = mode or "RGB"
    if not f["top_down"]:
        px = px[::-1]
    if bits == 24:
        px = reversed_rgb(px)
    px = np.ascontiguousarray(px)
    if mode == "1":
        px = px != 0
    return px, mode, palette


def encode(arr):
    """BMP bytes of (H, W) gray or (H, W, 3) RGB uint8, as Pillow's
    ``Image.save`` writes them: 8-bit with the gray palette, or 24-bit."""
    h, w = arr.shape[:2]
    bits = 8 if arr.ndim == 2 else 24
    colors = 256 if bits == 8 else 0
    stride = ((w * bits + 7) // 8 + 3) & ~3
    offset = 14 + 40 + 4 * colors
    ppm = int(96 * 39.3701 + 0.5)
    head = (b"BM" + struct.pack("<IIIIiiHHIIiiII", offset + stride * h, 0,
                                offset, 40, w, h, 1, bits, 0, stride * h,
                                ppm, ppm, colors, colors))
    if colors:  # the gray ramp, as B, G, R, 0
        pal = np.zeros((256, 4), np.uint8)
        pal[:, :3] = np.arange(256, dtype=np.uint8)[:, None]
        head += pal.tobytes()
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = (arr if bits == 8 else arr[:, :, ::-1]
                               ).reshape(h, -1)
    return head + rows[::-1].tobytes()
