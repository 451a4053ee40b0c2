"""TIFF, read as Pillow reads it (``TiffImagePlugin``, and libtiff for
compressed files) and written as ``Image.save`` writes it.

Reads the first image directory (Pillow opens frame 0) of a little-endian
(``II``) or big-endian (``MM``) TIFF, or a little-endian BigTIFF (8-byte
offsets and counts; Pillow mistakes a big-endian one's header and
refuses it): strips or tiles; no compression, PackBits, LZW
(:func:`..native.tiff_decompress`: libtiff's MSB-first codes with the
early code-width change), Deflate (compression 8 and 32946, through
Python's zlib), JPEG (compression 7: each strip or tile a JPEG stream,
the ``JPEGTables`` tag's tables ahead of it, decoded by
:func:`..native.jpeg_decode` as libtiff drives libjpeg: YCbCr to RGB,
another photometric's components as stored) and CCITT RLE, Group 3 (1-D
and 2-D, ``T4Options``) and Group 4 (:func:`..native.tiff_fax`);
horizontal differencing (predictor 2) at 8, 16 and 32 bits and the
floating-point predictor (3), on LZW and Deflate data (libtiff ignores
the tag elsewhere); ``PlanarConfiguration`` 1 and 2; ``FillOrder`` 2.

The layouts are the entries of Pillow's ``OPEN_INFO`` table, which this
module's ``_Layout`` follows key by key (byte order, photometric,
sample format, fill order, bits, extra samples): bilevel (mode ``1``),
2, 4 and 8-bit gray (``L``, scaled; WhiteIsZero inverted; signed 8-bit
as its bytes), 12-bit gray (``I;16``, little-endian only, MSB-first
packed, not scaled), 16-bit gray (``I;16``, uint16; ``I;16B``, a
big-endian ``>u2`` array, for an ``MM`` file, as ``np.asarray`` gives
it; WhiteIsZero not inverted, as Pillow), signed 16 and 32-bit and
unsigned 32-bit gray (``I``, int32; the unsigned wrap, little-endian
only), float32 gray (``F``), gray + alpha, RGB and RGBA at 8 and 16 bits
(16: the high byte; unused extra samples dropped; associated alpha
divided out, as Pillow's ``RGBa``), palette at 1, 2, 4 and 8 bits and
palette + alpha (``P``, ``PA``; the ``ColorMap``'s high bytes), CMYK at
8 and 16 bits, CIELab (``LAB``, the samples as stored) and YCbCr: one
sample as ``L``; three, compressed, converted to RGB as libtiff's
``TIFFRGBAImage`` does (each subsampled block's one Cb and Cr for all its
pixels; ``tif_color.c``'s tables with ``YCbCrCoefficients`` and
``ReferenceBlackWhite``). Where libtiff decodes a big-endian file's
32-bit or signed 16-bit samples (any compression) they come out in host
order, and Pillow's big-endian raw modes swap them again: so do these.

Refused with a ``ValueError`` naming what: every layout outside Pillow's
table (float64 and float16, 10-bit, big-endian 12-bit and unsigned
32-bit, ...), uncompressed YCbCr (Pillow reads four bytes a pixel and
finds the file truncated), old-style JPEG (compression 6), CCITT RLEW
(32771), JPEG 2000 and other compressions, old-style LZW.

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
 SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS, T4_OPTIONS, PLANAR, PREDICTOR,
 COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA,
 SAMPLE_FORMAT, JPEG_TABLES, YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING,
 REFERENCE_BLACK_WHITE) = (256, 257, 258, 259, 262, 266, 273, 277, 278,
                           279, 292, 284, 317, 320, 322, 323, 324, 325,
                           338, 339, 347, 529, 530, 532)
# Field types -> numpy codes (BYTE, ASCII, SHORT, LONG, SBYTE, UNDEFINED,
# SSHORT, SLONG, FLOAT, DOUBLE, IFD, LONG8, SLONG8, IFD8); RATIONAL and
# SRATIONAL are pairs of LONG and SLONG.
_TYPES = {1: "u1", 2: "u1", 3: "u2", 4: "u4", 6: "i1", 7: "u1", 8: "i2",
          9: "i4", 11: "f4", 12: "f8", 13: "u4", 16: "u8", 17: "i8",
          18: "u8", 5: "u4", 10: "i4"}
_COMPRESSIONS = {1: "raw", 5: "lzw", 8: "deflate", 32946: "deflate",
                 32773: "packbits", 7: "jpeg", 2: "fax", 3: "fax",
                 4: "fax"}
_REFUSED = {6: "JPEG-in-TIFF (old-style)", 34712: "JPEG 2000",
            32771: "CCITT RLEW"}
_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)


def _directory(data):
    """(byte order, {tag: numpy array of its values}) of the first image
    directory of a TIFF or BigTIFF file (rationals as float64)."""
    if data[:2] not in (b"II", b"MM"):
        raise ValueError("not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    big = struct.unpack_from(e + "H", data, 2)[0] == 43
    if big and e == ">":
        raise ValueError("big-endian BigTIFF is not supported (Pillow "
                         "takes its header for a classic TIFF's and "
                         "refuses it)")
    if big:  # 8-byte offsets and counts, 20-byte entries
        off = struct.unpack_from(e + "Q", data, 8)[0]
        n = struct.unpack_from(e + "Q", data, off)[0]
        first, entry, head, slot = off + 8, 20, e + "HHQ", 8
    else:
        off = struct.unpack_from(e + "I", data, 4)[0]
        n = struct.unpack_from(e + "H", data, off)[0]
        first, entry, head, slot = off + 2, 12, e + "HHI", 4
    tags = {}
    for i in range(n):
        at = first + entry * i
        tag, typ, cnt = struct.unpack_from(head, data, at)
        if typ not in _TYPES:
            continue
        dt = np.dtype(e + _TYPES[typ])
        k = cnt * (2 if typ in (5, 10) else 1)
        pos = at + entry - slot
        if k * dt.itemsize > slot:
            pos = struct.unpack_from(e + ("Q" if big else "I"), data, pos)[0]
        if pos + k * dt.itemsize > len(data):
            raise ValueError(f"truncated TIFF: tag {tag} past the end")
        v = np.frombuffer(data, dt, k, pos)
        if typ in (5, 10):
            v = v[0::2] / np.maximum(v[1::2], 1)
        elif dt.kind != "f":
            v = v.astype(np.int64)
        tags[tag] = v
    return e, tags


class _Layout:
    """What decoding needs of the directory: Pillow's ``mode``, the
    photometric interpretation, the samples (bits, count, numpy kind,
    extra samples), the compression and ``libtiff`` (whether Pillow
    hands the file to libtiff, which it does for every compression)."""

    def __init__(self, e, tags):
        get = lambda t, d: (tuple(int(v) for v in tags[t]) if t in tags
                            else d)
        comp = get(COMPRESSION, (1,))[0]
        if comp in _REFUSED:
            raise ValueError(f"{_REFUSED[comp]} compression is not "
                             "supported")
        if comp not in _COMPRESSIONS:
            raise ValueError(f"TIFF compression {comp} is not supported")
        self.comp_tag, self.comp = comp, _COMPRESSIONS[comp]
        self.libtiff = self.comp != "raw"
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
            raise ValueError(f"TIFF with {spp} samples of {bits} bits is "
                             "not supported")
        b = bits[0]
        self.e, self.photo, self.bits, self.spp = e, photo, b, spp
        self.extra, self.fmt = extra, fmt
        self.fill = get(FILLORDER, (1,))[0]
        self.mode = self._mode()
        if self.mode is None:
            what = {3: "float", 2: "signed"}.get(fmt[0], "unsigned")
            raise ValueError(
                f"TIFF layout (photometric {photo}, {spp} {what} samples "
                f"of {b} bits, extra samples {extra}, {e}) is not "
                "supported (Pillow does not read it either)")
        if self.comp == "fax" and self.mode != "1":
            raise ValueError("CCITT fax TIFF that is not bilevel")
        if self.comp == "jpeg" and b != 8:
            raise ValueError(f"{b}-bit JPEG-in-TIFF is not supported")
        self.kind = {1: "u", 2: "i", 3: "f"}.get(fmt[0], "u")

    def _mode(self):
        """Pillow's mode for the layout (its ``OPEN_INFO`` table), or
        None where Pillow has no entry."""
        photo, fmt, b, spp = self.photo, self.fmt, self.bits, self.spp
        ex, ii, fill = self.extra, self.e == "<", self.fill
        if fill == 2 and not (b <= 8 or b == 16 and ii and photo == 1):
            return None
        if photo in (0, 1) and spp == 1 and not ex:
            if fmt == (1,):
                if b in (1, 2, 4, 8):
                    return "1" if b == 1 else "L"
                if b == 12 and ii and photo == 1 and fill == 1:
                    return "I;16"
                if b == 16 and fill == 1 and (ii or photo == 1):
                    return "I;16" if ii else "I;16B"
                if b == 16 and ii and photo == 1:  # I;16R
                    return "I;16"
                if b == 32 and ii and photo == 1:
                    return "I"
            if fmt == (2,) and fill == 1 and photo == 1:
                return {8: "L", 16: "I", 32: "I"}.get(b)
            if fmt == (3,) and fill == 1 and b == 32:
                return "F"
            return None
        if fmt != (1,):
            return None
        if photo == 1 and b == 8 and spp == 2 and ex == (2,):
            return "LA" if fill == 1 else None
        if photo == 2 and b in (8, 16) and 3 <= spp <= 6:
            alpha = {(): "RGBA" if spp == 4 else "RGB", (0,): "RGB",
                     (1,): "RGBa", (2,): "RGBA", (999,): "RGBA"}
            first = ex[:1] if spp > 3 else ()
            if spp - 3 != len(ex) and not (spp == 4 and ex == ()):
                return None
            if any(ex[1:]) or (b == 16 and (spp > 4 or ex == (999,))):
                return None
            if fill == 2 and (b != 8 or spp != 3):
                return None
            return alpha.get(first)
        if photo == 3 and fill in (1, 2):
            if spp == 1 and b <= 8:
                return "P"
            if spp == 2 and b == 8 and ex in ((0,), (2,)) and fill == 1:
                return "P" if ex == (0,) else "PA"
            return None
        if photo == 5 and fill == 1 and (b == 8 and spp - 4 == len(ex)
                                         and not any(ex) and spp <= 6
                                         or b == 16 and spp == 4
                                         and not ex):
            return "CMYK"
        if photo == 6 and b == 8 and fill == 1 and not ex:
            return {1: "L", 3: "RGB"}.get(spp)
        if photo == 8 and b == 8 and spp == 3 and fill == 1 and not ex:
            return "LAB"
        return None


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


def _chunks(tags, w, h, planes):
    """(chunk width, chunk height, [(row, column, rows)], offsets, byte
    counts) of the strips or tiles."""
    one = lambda t, d: int(tags[t][0]) if t in tags else d
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
    return cw, ch, boxes, offsets, counts


def _unpack(px, lay, rows, n):
    """(rows, n) samples of (rows, row bytes) uint8: packed below 8 bits
    and at 12, in the file's byte order (or, for the floating-point
    predictor, the host's) at 16, 32 and 64."""
    b = lay.bits
    if b <= 8:
        return unpack_samples(px, b, n)
    if b == 12:  # Pillow's I;12: MSB-first 12-bit samples
        bits = np.unpackbits(px, axis=1)[:, :n * 12].reshape(rows, n, 12)
        weights = (1 << np.arange(11, -1, -1)).astype(np.uint16)
        return (bits.astype(np.uint16) * weights).sum(2, dtype=np.uint16)
    return px.view(lay.e + lay.kind + str(b // 8))


def _float_predictor(px, cs, bps):
    """libtiff's floating-point predictor (3) undone on (rows, bytes):
    the bytes summed along each row at a stride of one pixel, then taken
    from byte planes (most significant first) into big-endian samples."""
    px = np.cumsum(px.reshape(px.shape[0], -1, cs), axis=1,
                   dtype=np.uint8).reshape(px.shape[0], -1)
    rows, nb = px.shape
    return px.reshape(rows, bps, nb // bps).transpose(0, 2, 1).reshape(
        rows, nb)


def decode(data):
    e, tags = _directory(data)
    lay = _Layout(e, tags)
    one = lambda t, d: int(tags[t][0]) if t in tags else d
    w, h = one(WIDTH, 0), one(LENGTH, 0)
    spp, b = lay.spp, lay.bits
    planes = spp if one(PLANAR, 1) == 2 and spp > 1 else 1
    cs = spp // planes  # samples a pixel in one strip or tile
    cw, ch, boxes, offsets, counts = _chunks(tags, w, h, planes)
    if lay.comp == "jpeg":
        return _decode_jpeg(data, lay, tags, w, h, planes, cw, boxes,
                            offsets, counts)
    ycc, sub = lay.photo == 6 and lay.mode == "RGB", (1, 1)
    if ycc:
        if not lay.libtiff:  # Pillow reads 4 bytes a pixel: truncated
            raise ValueError("uncompressed YCbCr TIFF is not supported "
                             "(Pillow refuses it as truncated)")
        if planes > 1:
            raise ValueError("planar YCbCr TIFF is not supported")
        sub = tuple(int(v) for v in tags.get(YCBCR_SUBSAMPLING, (2, 2)))
    # libtiff's PackBits and uncompressed strips ignore the tag, and Pillow
    # reads them so.
    predictor = one(PREDICTOR, 1) if lay.comp in ("lzw", "deflate") else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and (
            b not in (8, 16, 32) or lay.kind == "f")) or (
            predictor == 3 and lay.kind != "f"):
        raise ValueError(f"TIFF predictor {predictor} at {b} bits is not "
                         "supported")
    dt = (np.uint8 if b <= 8 else np.uint16 if b == 12
          else np.dtype(lay.kind + str(b // 8)))
    out = np.empty((h, w, 3) if ycc else (h, w, spp),
                   np.uint8 if ycc else dt)
    if ycc:
        row_bytes = math.ceil(cw / sub[0]) * (sub[0] * sub[1] + 2)
    else:
        row_bytes = (cw * cs * b + 7) // 8
    reverse = lay.fill == 2
    for p in range(planes):
        for j, (y0, x0, rows) in enumerate(boxes):
            k = p * len(boxes) + j
            off = int(offsets[k])
            lines = math.ceil(rows / sub[1])
            size = lines * row_bytes
            raw = data[off:off + (int(counts[k]) if counts is not None
                                  else size)]
            if reverse:
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            if lay.comp == "fax":
                px = native.tiff_fax(raw, lay.comp_tag, cw, rows,
                                     one(T4_OPTIONS, 0))
            else:
                px = _decompress(raw, lay.comp, size).reshape(lines,
                                                              row_bytes)
            yh, xw = min(rows, h - y0), min(cw, w - x0)
            if ycc:
                rgb = _ycbcr_rgb(px, tags, sub, cw, rows)
                out[y0:y0 + yh, x0:x0 + xw] = rgb[:yh, :xw]
                continue
            if predictor == 3:
                px = _float_predictor(px, cs, b // 8)
                px = px.view(">" + lay.kind + str(b // 8))
            else:
                px = _unpack(px, lay, rows, cw * cs)
            px = px.reshape(rows, cw, cs)
            if predictor == 2:
                px = np.cumsum(px, axis=1, dtype=px.dtype)
            out[y0:y0 + yh, x0:x0 + xw, p * cs:(p + 1) * cs] = px[:yh, :xw]
    if lay.libtiff and e == ">" and (b == 32 or b == 16
                                     and lay.kind == "i"):
        # libtiff hands Pillow host-order samples, and Pillow's big-endian
        # raw modes (F;32BF, I;32BS, I;16BS) swap them again.
        out = out.byteswap()
    if ycc:
        return out, "RGB", None
    return _to_mode(out, lay, tags)


def _ycbcr_rgb(px, tags, sub, cw, rows):
    """(rows, cw, 3) uint8 RGB of one chunk of subsampled YCbCr blocks,
    as libtiff's TIFFRGBAImage converts them (tif_getimage.c: each
    block's one Cb and Cr for all its pixels; tif_color.c's tables)."""
    hs, vs = sub
    bw = math.ceil(cw / hs)
    blocks = px.reshape(px.shape[0], bw, hs * vs + 2)
    y = blocks[:, :, :hs * vs].reshape(-1, bw, vs, hs).transpose(
        0, 2, 1, 3).reshape(-1, bw * hs)
    cb = np.repeat(np.repeat(blocks[:, :, hs * vs], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(blocks[:, :, hs * vs + 1], vs, 0), hs, 1)
    r_tab, b_tab, g_cr, g_cb, y_tab = _ycbcr_tables(tags)
    y = y_tab[y.astype(np.int64)]
    cb, cr = cb.astype(np.int64), cr.astype(np.int64)
    rgb = np.stack([y + r_tab[cr], y + ((g_cb[cb] + g_cr[cr]) >> 16),
                    y + b_tab[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)[:rows, :cw]


def _ycbcr_tables(tags):
    """tif_color.c's TIFFYCbCrToRGBInit, in its float32 and fixed-point
    steps: (Cr_r, Cb_b, Cr_g, Cb_g, Y) indexed by the sample."""
    f32 = np.float32
    luma = [f32(v) for v in tags.get(YCBCR_COEFFICIENTS,
                                      (0.299, 0.587, 0.114))]
    rbw = [f32(v) for v in tags.get(REFERENCE_BLACK_WHITE,
                                    (0, 255, 128, 255, 128, 255))]
    fix = lambda x: int(float(f32(x) * f32(65536)) + 0.5)
    clamp = lambda f: min(max(f, f32(0)), f32(2))
    f1 = f32(2) - f32(2) * luma[0]
    f2 = luma[0] * f1 / luma[1]
    f3 = f32(2) - f32(2) * luma[2]
    f4 = luma[2] * f3 / luma[1]
    d1, d2 = fix(clamp(f1)), -fix(clamp(f2))
    d3, d4 = fix(clamp(f3)), -fix(clamp(f4))

    def code2v(c, rb, rw, cr):
        den = rw - rb if rw - rb != 0 else f32(1)
        v = f32((c - int(rb)) * cr) / f32(den)
        return int(min(max(v, f32(-128 * 32)), f32(128 * 32)))

    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), f32(127))
        cb = code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), f32(127))
        tabs[:, i] = ((d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16,
                      d2 * cr, d4 * cb + 32768,
                      code2v(x + 128, rbw[0], rbw[1], f32(255)))
    return tabs


def _decode_jpeg(data, lay, tags, w, h, planes, cw, boxes, offsets, counts):
    """Compression 7: each strip or tile a JPEG stream (abbreviated when
    the JPEGTables tag holds the tables), decoded by :mod:`..native` as
    libtiff drives libjpeg: YCbCr converted to RGB, any other
    photometric's components taken as they are."""
    if planes > 1:
        raise ValueError("planar JPEG-in-TIFF is not supported")
    tables = tags.get(JPEG_TABLES)
    head = b"" if tables is None else tables.astype(np.uint8).tobytes()
    if head[-2:] == b"\xff\xd9":
        head = head[:-2]
    colour = "ycbcr" if lay.photo == 6 else "none"
    c = 3 if lay.spp >= 3 else 1
    out = np.empty((h, w, c) if c == 3 else (h, w), np.uint8)
    for k, (y0, x0, rows) in enumerate(boxes):
        off = int(offsets[k])
        raw = data[off:off + int(counts[k])]
        if head and raw[:2] == b"\xff\xd8":
            raw = head + raw[2:]
        px = native.jpeg_decode(raw, bgr=False, colour=colour)
        yh, xw = min(rows, h - y0), min(cw, w - x0)
        if px.shape[:2] < (yh, xw):
            raise ValueError("JPEG-in-TIFF strip or tile smaller than "
                             "its place in the image")
        out[y0:y0 + yh, x0:x0 + xw] = px[:yh, :xw]
    if c == 1:
        return _to_mode(out[:, :, None], lay, tags)
    return out, "RGB", None


def _to_mode(s, lay, tags):
    """The samples (h, w, spp) as np.asarray(Image.open(path)) gives them
    in Pillow's mode, and the palette."""
    mode, photo, b = lay.mode, lay.photo, lay.bits
    if mode in ("P", "PA"):
        cmap = tags.get(COLORMAP)
        if cmap is None:
            raise ValueError("palette TIFF without a ColorMap")
        pal = (cmap[:3 << b] // 256).reshape(3, -1).T
        idx = s[:, :, 0] if mode == "P" else s[:, :, :2]
        return np.ascontiguousarray(idx).astype(np.uint8), mode, \
            pad_palette(pal)
    if mode in ("1", "L") and s.shape[2] == 1:
        g = s[:, :, 0]
        if mode == "1":
            return (g == 0) if photo == 0 else (g != 0), "1", None
        g = g * np.uint8(255 // ((1 << b) - 1))  # signed 8-bit: its bytes
        return (255 - g if photo == 0 else g).astype(np.uint8), "L", None
    if mode in ("I;16", "I;16B"):
        g = s[:, :, 0]
        return (g.astype(">u2") if mode == "I;16B" else
                g.astype(np.uint16)), mode, None
    if mode in ("I", "F"):
        return s[:, :, 0].astype(np.int32 if mode == "I" else np.float32), \
            mode, None
    if b == 16:
        s = (s >> 8).astype(np.uint8)
    if mode == "RGBa":
        a = s[:, :, 3:4].astype(np.int32)
        rgb = np.minimum(s[:, :, :3].astype(np.int32) * 255
                         // np.maximum(a, 1), 255)
        s = np.where(a == 0, 0, np.concatenate([rgb, a], 2)).astype(
            np.uint8)
        return s, "RGBA", None
    n = {"LA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4, "LAB": 3, "L": 1}[mode]
    out = np.ascontiguousarray(s[:, :, :n])
    return (out[:, :, 0] if n == 1 else out), mode, None


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
