"""TIFF, read as Pillow reads it (``TiffImagePlugin``, and libtiff for
compressed files) and written as ``Image.save`` writes it.

Reads the first image directory (Pillow opens frame 0) of a little-endian
(``II``) or big-endian (``MM``) file: strips or tiles; no compression,
PackBits, LZW (:func:`..native.tiff_decompress`: libtiff's MSB-first
codes with the early code-width change) or Deflate (compression 8 and
32946, through Python's zlib); horizontal differencing (predictor 2) at 8
and 16 bits, per sample, on LZW and Deflate data (libtiff ignores the tag
elsewhere); ``PlanarConfiguration`` 1 and 2; ``FillOrder``
2. The layouts are Pillow's ``OPEN_INFO`` entries that hold 1 to 16-bit
unsigned samples: bilevel (mode ``1``), 2, 4 and 8-bit gray (``L``,
scaled; WhiteIsZero inverted), 16-bit gray (``I;16``, uint16; ``I;16B``,
a big-endian ``>u2`` array, for an ``MM`` file, as ``np.asarray`` gives
it; WhiteIsZero not inverted, as Pillow), gray + alpha, RGB and RGBA at 8
and 16 bits (16: the high byte; an unused extra sample dropped;
associated alpha divided out at 8 bits, as Pillow's ``RGBa``), and
palette at 1, 2, 4 and 8 bits (``P``; the ``ColorMap``'s high bytes).

Refused with a ``ValueError`` naming what: JPEG-in-TIFF (compression 6
and 7), CCITT fax, other compressions, float and 32-bit integer samples,
signed and 12-bit samples, CMYK, YCbCr and CIELab, BigTIFF, old-style
LZW.

Writes 8-bit gray or RGB uncompressed, one strip, byte for byte as
Pillow's ``Image.save`` (which needs no libtiff for it).
"""

import math
import struct
import zlib

import numpy as np

from . import pad_palette, unpack_samples
from .. import native

# Tag numbers.
(WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER, STRIP_OFFSETS,
 SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, PLANAR, PREDICTOR, COLORMAP,
 TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA,
 SAMPLE_FORMAT) = (256, 257, 258, 259, 262, 266, 273, 277, 278, 279, 284,
                   317, 320, 322, 323, 324, 325, 338, 339)
# Integer field types -> numpy codes (BYTE, SHORT, LONG, SBYTE, UNDEFINED,
# SSHORT, SLONG, IFD, LONG8).
_INTS = {1: "u1", 3: "u2", 4: "u4", 6: "i1", 7: "u1", 8: "i2", 9: "i4",
         13: "u4", 16: "u8"}
_COMPRESSIONS = {1: "raw", 5: "lzw", 8: "deflate", 32946: "deflate",
                 32773: "packbits"}
_REFUSED = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4",
            6: "JPEG-in-TIFF (old-style)", 7: "JPEG-in-TIFF",
            34712: "JPEG 2000"}
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)


def _directory(data):
    """(byte order, {tag: numpy array of its integer values}) of the
    first image directory."""
    if data[:2] not in (b"II", b"MM"):
        raise ValueError("not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    magic = struct.unpack_from(e + "H", data, 2)[0]
    if magic == 43:
        raise ValueError("BigTIFF is not supported")
    off = struct.unpack_from(e + "I", data, 4)[0]
    n = struct.unpack_from(e + "H", data, off)[0]
    tags = {}
    for i in range(n):
        tag, typ, cnt = struct.unpack_from(e + "HHI", data, off + 2 + 12 * i)
        if typ not in _INTS:
            continue
        dt = np.dtype(e + _INTS[typ])
        pos = off + 10 + 12 * i
        if cnt * dt.itemsize > 4:
            pos = struct.unpack_from(e + "I", data, pos)[0]
        if pos + cnt * dt.itemsize > len(data):
            raise ValueError(f"truncated TIFF: tag {tag} past the end")
        tags[tag] = np.frombuffer(data, dt, cnt, pos).astype(np.int64)
    return e, tags


def _layout(e, tags):
    """Pillow's (mode, photometric, bits, samples, extra) of the file, or
    a ValueError naming what is not supported."""
    get = lambda t, d: tuple(int(v) for v in tags[t]) if t in tags else d
    comp = get(COMPRESSION, (1,))[0]
    if comp in _REFUSED:
        raise ValueError(f"{_REFUSED[comp]} compression is not supported")
    if comp not in _COMPRESSIONS:
        raise ValueError(f"TIFF compression {comp} is not supported")
    photo = get(PHOTOMETRIC, (0,))[0]
    fmt = get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and min(fmt) == max(fmt) == 1:
        fmt = (1,)
    bits = get(BITS, (1,))
    extra = get(EXTRA, ())
    spp = get(SAMPLES, (1,))[0]
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp or len(set(bits)) != 1:
        raise ValueError(f"TIFF with {spp} samples of {bits} bits is not "
                         "supported")
    b = bits[0]
    if 3 in fmt:
        raise ValueError(f"float TIFF ({b}-bit samples) is not supported")
    if b == 32:
        raise ValueError("32-bit integer TIFF is not supported")
    if 2 in fmt and not (b == 8 and photo == 1):
        raise ValueError(f"signed {b}-bit TIFF is not supported")
    if b not in (1, 2, 4, 8, 16):
        raise ValueError(f"{b}-bit TIFF is not supported")
    names = {5: "CMYK", 6: "YCbCr", 8: "CIELab"}
    if photo in names:
        raise ValueError(f"{names[photo]} TIFF is not supported")
    mode = None
    if photo in (0, 1) and spp == 1:
        if b == 16:
            mode = "I;16" if e == "<" else ("I;16B" if photo == 1 else None)
        else:
            mode = "1" if b == 1 else "L"
    elif photo == 1 and b == 8 and spp == 2 and extra == (2,):
        mode = "LA"
    elif photo == 2 and b in (8, 16):
        if spp == 3 and not extra:
            mode = "RGB"
        elif spp == 4 and extra in ((), (2,), (999,)):
            mode = "RGBA"
        elif spp == 4 and extra == (0,):
            mode = "RGB"  # the extra sample dropped
        elif spp == 4 and extra == (1,) and b == 8:
            mode = "RGBa"  # associated alpha, divided out below
    elif photo == 3 and (spp == 1 and b <= 8
                         or spp == 2 and b == 8 and extra == (0,)):
        mode = "P"
    if mode is None:
        raise ValueError(f"TIFF layout (photometric {photo}, {spp} samples "
                         f"of {b} bits, extra samples {extra}) is not "
                         "supported")
    return mode, photo, b, spp, _COMPRESSIONS[comp]


def _decompress(raw, comp, size):
    if comp == "raw":
        out = np.frombuffer(raw, np.uint8)[:size]
    elif comp == "deflate":
        out = np.frombuffer(zlib.decompressobj().decompress(raw, size),
                            np.uint8)
    else:
        out = native.tiff_decompress(raw, size, packbits=comp == "packbits")
    if out.size < size:
        raise ValueError(f"truncated TIFF strip or tile: {out.size} of "
                         f"{size} bytes")
    return out


def decode(data):
    e, tags = _directory(data)
    mode, photo, b, spp, comp = _layout(e, tags)
    one = lambda t, d: int(tags[t][0]) if t in tags else d
    w, h = one(WIDTH, 0), one(LENGTH, 0)
    planes = spp if one(PLANAR, 1) == 2 and spp > 1 else 1
    cs = spp // planes  # samples a pixel in one strip or tile
    # libtiff's PackBits and uncompressed strips ignore the tag, and Pillow
    # reads them so.
    predictor = one(PREDICTOR, 1) if comp in ("lzw", "deflate") else 1
    if predictor not in (1, 2) or (predictor == 2 and b not in (8, 16)):
        raise ValueError(f"TIFF predictor {predictor} at {b} bits is not "
                         "supported")
    if TILE_OFFSETS in tags:
        cw, ch = one(TILE_WIDTH, 0), one(TILE_LENGTH, 0)
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_COUNTS)
        across = math.ceil(w / cw)
        boxes = [((j // across) * ch, (j % across) * cw, ch)
                 for j in range(across * math.ceil(h / ch))]
    else:
        cw, ch = w, max(1, min(one(ROWS_PER_STRIP, h), h))
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_COUNTS)
        boxes = [(y, 0, min(ch, h - y)) for y in range(0, h, ch)]
    if len(offsets) < len(boxes) * planes:
        raise ValueError(f"TIFF with {len(offsets)} strips or tiles, "
                         f"expected {len(boxes) * planes}")
    dt = np.uint16 if b == 16 else np.uint8
    out = np.empty((h, w, spp), dt)
    row_bytes = (cw * cs * b + 7) // 8
    reverse = one(FILLORDER, 1) == 2
    for p in range(planes):
        for j, (y0, x0, rows) in enumerate(boxes):
            k = p * len(boxes) + j
            off = int(offsets[k])
            size = rows * row_bytes
            raw = data[off:off + (int(counts[k]) if counts is not None
                                  else size)]
            if reverse:
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            px = _decompress(raw, comp, size).reshape(rows, row_bytes)
            if b == 16:
                px = px.view(e + "u2").astype(np.uint16)
            else:
                px = unpack_samples(px, b, cw * cs)
            px = px.reshape(rows, cw, cs)
            if predictor == 2:
                px = np.cumsum(px, axis=1, dtype=dt)
            yh, xw = min(rows, h - y0), min(cw, w - x0)
            out[y0:y0 + yh, x0:x0 + xw, p * cs:(p + 1) * cs] = px[:yh, :xw]
    return _to_mode(out, mode, photo, b, tags)


def _to_mode(s, mode, photo, b, tags):
    """The samples (h, w, spp) as np.asarray(Image.open(path)) gives them
    in Pillow's ``mode``, and the palette."""
    if mode == "P":
        cmap = tags.get(COLORMAP)
        if cmap is None:
            raise ValueError("palette TIFF without a ColorMap")
        pal = (cmap[:3 << b] // 256).reshape(3, -1).T
        return s[:, :, 0].astype(np.uint8), "P", pad_palette(pal)
    if mode in ("1", "L", "I;16", "I;16B"):
        g = s[:, :, 0]
        if mode == "1":
            return (g == 0) if photo == 0 else (g != 0), "1", None
        if mode == "L":
            g = g * np.uint8(255 // ((1 << b) - 1))
            return (255 - g if photo == 0 else g).astype(np.uint8), "L", None
        return (g.astype(">u2") if mode == "I;16B" else g), mode, None
    if b == 16:
        s = (s >> 8).astype(np.uint8)
    if mode == "RGBa":
        a = s[:, :, 3:4].astype(np.int32)
        rgb = np.minimum(s[:, :, :3].astype(np.int32) * 255
                         // np.maximum(a, 1), 255)
        s = np.where(a == 0, 0, np.concatenate([rgb, a], 2)).astype(
            np.uint8)
        return s, "RGBA", None
    n = {"LA": 2, "RGB": 3, "RGBA": 4}[mode]
    return np.ascontiguousarray(s[:, :, :n]), mode, None


def encode(arr):
    """Uncompressed TIFF bytes of (H, W) gray or (H, W, 3) RGB uint8, as
    Pillow's ``Image.save`` writes them: one strip, the tags in Pillow's
    order and types, BitsPerSample out of line for RGB."""
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else 3
    n = 9 if c == 1 else 10
    ifd_end = 8 + 2 + 12 * n + 4
    bits_at = ifd_end
    data_at = ifd_end + (6 if c == 3 else 0)
    S, L = 3, 4
    entries = [(WIDTH, L, 1, w), (LENGTH, L, 1, h),
               (BITS, S, c, bits_at if c == 3 else 8), (COMPRESSION, S, 1, 1),
               (PHOTOMETRIC, S, 1, 1 if c == 1 else 2),
               (STRIP_OFFSETS, L, 1, data_at)]
    if c == 3:
        entries.append((SAMPLES, S, 1, 3))
    entries += [(ROWS_PER_STRIP, L, 1, h), (STRIP_COUNTS, L, 1, h * w * c),
                (PLANAR, S, 1, 1)]
    out = [b"II*\x00", struct.pack("<I", 8), struct.pack("<H", n)]
    for tag, typ, cnt, val in entries:
        # one SHORT sits in the first half of the 4-byte value field
        field = (struct.pack("<HH", val, 0) if typ == S and cnt == 1
                 else struct.pack("<I", val))
        out.append(struct.pack("<HHI", tag, typ, cnt) + field)
    out.append(struct.pack("<I", 0))
    if c == 3:
        out.append(struct.pack("<HHH", 8, 8, 8))
    out.append(np.ascontiguousarray(arr).tobytes())
    return b"".join(out)
