"""Image files built byte by byte, for the PyTorch port's image-format
tests, the committed fixtures (``tests/golden/torch_imgio/``) and
``chip_smoke.py``'s phase 29.

Pillow cannot write Adam7 PNG, 2- and 4-bit gray PNG, 16-bit colour PNG,
BMP other than 1/8/24/32-bit ``BI_RGB``, RLE BMP, or TIFF that is tiled,
planar or big-endian beyond 16-bit gray, so these builders write them
from numpy samples (numpy, zlib and struct only: the card's machine has
no Pillow). Pillow's reading of a built file is the tests' oracle.

``CATALOGUE`` names one variant of each format and layout the port reads,
each a function of a numpy Generator giving ``(extension, bytes)``; the
ones Pillow writes import Pillow when called.
"""

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def smooth(rng, h, w, c=3, noise=1, fmax=0.2):
    """Smooth content (a few waves of at most ``fmax`` radians a pixel)
    with a little noise: small when compressed, and no two neighbours
    need be equal."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = rng.uniform(fmax / 10, fmax, (c, 3))
    img = np.stack([128 + 90 * np.sin(xx * f[k, 0] + yy * f[k, 1] + f[k, 2]
                                      * 10) for k in range(c)], -1)
    img += rng.integers(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- PNG


def _pack_rows(s, depth, order=">"):
    """(h, bytes) rows of (h, w, c) samples at ``depth`` bits, most
    significant bits first, each row padded to a byte."""
    h = s.shape[0]
    v = s.reshape(h, -1)
    if depth == 16:
        return v.astype(order + "u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return v.astype(np.uint8)
    k = 8 // depth
    p = np.zeros((h, -(-v.shape[1] // k) * k), np.uint16)
    p[:, :v.shape[1]] = v
    p = p.reshape(h, -1, k)
    return sum(p[:, :, j] << (8 - depth * (j + 1))
               for j in range(k)).astype(np.uint8)


def _png_filter(rows, bpp, seed):
    """Rows filtered with the five PNG filters in turn (row y: type
    (y + seed) % 5), each with its filter byte."""
    out = []
    raw = rows.astype(np.int64)
    for y in range(raw.shape[0]):
        t = (y + seed) % 5
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur])[:cur.size]
        ul = np.concatenate([np.zeros(bpp, np.int64), up])[:cur.size]
        if t == 0:
            pred = np.zeros_like(cur)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([t]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    return b"".join(out)


def png_chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def png(samples, depth, ctype, palette=None, trns=None, interlace=False,
        seed=0, level=6):
    """PNG bytes of (h, w, c) samples (c as the colour type has them),
    rows filtered with all five filters, Adam7 when ``interlace``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        body = b"".join(
            _png_filter(_pack_rows(samples[y0::dy, x0::dx], depth), bpp,
                        seed)
            for x0, y0, dx, dy in ADAM7
            if samples[y0::dy, x0::dx].size)
    else:
        body = _png_filter(_pack_rows(samples, depth), bpp, seed)
    out = (b"\x89PNG\r\n\x1a\n"
           + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                            0, 0, int(interlace))))
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    return (out + png_chunk(b"IDAT", zlib.compress(body, level))
            + png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_variant(rng, ctype, depth, shape, interlace, trns=None):
    c = _PNG_CHANNELS[ctype]
    s = rng.integers(0, 1 << depth, shape + (c,))
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, ((1 << depth) - 1, 3))  # one short
        s = np.minimum(s, len(palette) - 1)
    return png(s, depth, ctype, palette, trns, interlace,
               seed=int(rng.integers(5)))


# ---------------------------------------------------------------- BMP


def rle8(rows):
    """A BMP RLE8 stream of index rows (stored order): runs of two or
    more as encoded records, the rest in absolute runs of at least three
    (shorter ones as runs of one), an end-of-line after each row and an
    end-of-bitmap at the end."""
    out = bytearray()
    for row in rows:
        x, n = 0, len(row)
        while x < n:
            run = 1
            while x + run < n and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2:
                out += bytes([run, row[x]])
                x += run
                continue
            k = x
            while k < n and k - x < 255 and not (k + 1 < n and
                                                 row[k + 1] == row[k]):
                k += 1
            if k - x < 3:
                for v in row[x:max(k, x + 1)]:
                    out += bytes([1, v])
                x = max(k, x + 1)
                continue
            out += bytes([0, k - x]) + bytes(row[x:k])
            if (k - x) % 2:
                out += b"\0"
            x = k
        out += b"\0\0"
    out[-2:] = b"\0\1"
    return bytes(out)


def rle4(rows):
    """A BMP RLE4 stream of 4-bit index rows: runs of one value as encoded
    records, pairs of differing values in absolute runs of an even
    length, an end-of-line after each row, an end-of-bitmap at the end."""
    out = bytearray()
    for row in rows:
        x, n = 0, len(row)
        while x < n:
            run = 1
            while x + run < n and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 2 or n - x < 4:
                out += bytes([run, row[x] << 4 | row[x]])
                x += run
                continue
            k = x + 4
            while k + 2 <= n and k - x < 254 and row[k] != row[k - 1]:
                k += 2
            px = row[x:k]
            packed = bytes(int(a) << 4 | int(b) for a, b in zip(px[::2],
                                                                px[1::2]))
            out += bytes([0, k - x]) + packed
            if len(packed) % 2:
                out += b"\0"
            x = k
        out += b"\0\0"
    out[-2:] = b"\0\1"
    return bytes(out)


def bmp(pixels, bits, header=40, palette=None, comp=0, masks=None,
        top_down=False, stream=None):
    """BMP bytes: ``pixels`` (h, w) indices or uint16 values, or (h, w, k)
    bytes in stored order (B, G, R[, X]); ``palette`` (n, 3) RGB;
    ``stream`` replaces the rows (RLE). Header 12 (core), 40, 108 (V4)
    or 124 (V5); 40 with ``masks`` stores three masks after it."""
    h, w = pixels.shape[:2]
    if stream is None:
        rows = pixels if top_down else pixels[::-1]
        if bits <= 8:
            raw = _pack_rows(rows[:, :, None], bits)
        elif bits == 16:
            raw = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            raw = rows.astype(np.uint8).reshape(h, -1)
        stride = ((w * bits + 31) >> 3) & ~3
        data = np.zeros((h, stride), np.uint8)
        data[:, :raw.shape[1]] = raw
        data = data.tobytes()
    else:
        data = stream
    ncol = 0 if palette is None else len(palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        pal = b"" if palette is None else np.asarray(
            palette, np.uint8)[:, ::-1].tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, comp, len(data), 2835, 2835, ncol, 0)
        if header >= 108:
            info += struct.pack("<IIII", *(masks or (0, 0, 0, 0)))
            info += b"BGRs" + bytes(36) + bytes(12)
            if header == 124:
                info += struct.pack("<IIII", 4, 0, 0, 0)
        elif masks is not None:
            info += struct.pack("<III", *masks[:3])
        pal = b""
        if palette is not None:
            p = np.zeros((ncol, 4), np.uint8)
            p[:, :3] = np.asarray(palette, np.uint8)[:, ::-1]
            pal = p.tobytes()
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + info + pal + data)


# ---------------------------------------------------------------- TIFF


class _Bits:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, code, nbits):
        self.acc = (self.acc << nbits) | code
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def bytes(self):
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
        return bytes(self.out)


def lzw(data):
    """TIFF LZW bytes of ``data``, as libtiff's LZWEncode writes them:
    a Clear first, MSB-first codes of 9 to 12 bits widened once the next
    free code passes the width's largest, a Clear when the table is full,
    EndOfInformation last."""
    out = _Bits()
    out.put(256, 9)
    table, free, nbits = {}, 258, 9
    w = -1
    for b in data:
        if w < 0:
            w = b
            continue
        nxt = table.get((w, b))
        if nxt is not None:
            w = nxt
            continue
        out.put(w, nbits)
        table[(w, b)] = free
        free += 1
        if free == 4094:
            out.put(256, nbits)
            table, free, nbits = {}, 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
        w = b
    if w >= 0:
        out.put(w, nbits)
        free += 1
        if free == 4094:
            out.put(256, nbits)
            nbits = 9
        elif free > (1 << nbits) - 1:
            nbits += 1
    out.put(257, nbits)
    return out.bytes()


def packbits(data):
    """PackBits bytes of ``data``: repeats of three or more as repeat
    runs, the rest as literal runs of at most 128."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + bytes(data[i:j])
        i = j
    return bytes(out)


_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)


def tiff(samples, bits, photo, order="<", comp=1, predictor=1, planar=1,
         tile=None, rows_per_strip=None, extra=(), colormap=None,
         fillorder=1, sample_format=None):
    """TIFF bytes of (h, w, spp) integer samples: strips (``rows_per_strip``)
    or ``tile`` = (width, length) tiles, each plane apart when ``planar``
    is 2; ``comp`` 1 (none), 5 (LZW), 8 (Deflate) or 32773 (PackBits);
    ``predictor`` 2 differences each sample from its left neighbour."""
    h, w, spp = samples.shape
    planes = spp if planar == 2 else 1
    cs = spp // planes
    if tile:
        cw, ch = tile
        boxes = [(y, x, ch) for y in range(0, h, ch)
                 for x in range(0, w, cw)]
    else:
        cw, ch = w, rows_per_strip or h
        boxes = [(y, 0, min(ch, h - y)) for y in range(0, h, ch)]
    chunks = []
    for p in range(planes):
        for y0, x0, rows in boxes:
            blk = np.zeros((rows, cw, cs), np.int64)
            part = samples[y0:y0 + rows, x0:x0 + cw, p * cs:(p + 1) * cs]
            blk[:part.shape[0], :part.shape[1]] = part
            if predictor == 2:
                blk[:, 1:] = (blk[:, 1:] - blk[:, :-1]) % (1 << bits)
            raw = _pack_rows(blk, bits, order)
            if fillorder == 2:
                raw = _REVERSED[raw]
            raw = raw.tobytes()
            encode = {1: bytes, 5: lzw, 8: zlib.compress,
                      32773: packbits}[comp]
            chunks.append(encode(raw))
    S, L = 3, 4
    tags = {256: (L, [w]), 257: (L, [h]), 258: (S, [bits] * spp),
            259: (S, [comp]), 262: (S, [photo]), 277: (S, [spp]),
            284: (S, [planar])}
    if fillorder != 1:
        tags[266] = (S, [fillorder])
    if predictor != 1:
        tags[317] = (S, [predictor])
    if colormap is not None:
        tags[320] = (S, list(np.asarray(colormap).T.reshape(-1)))
    if extra:
        tags[338] = (S, list(extra))
    if sample_format is not None:
        tags[339] = (S, [sample_format] * spp)
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags[322], tags[323] = (S, [tile[0]]), (S, [tile[1]])
    else:
        tags[278] = (L, [ch])
    tags[off_tag] = (L, [0] * len(chunks))
    tags[cnt_tag] = (L, [len(c) for c in chunks])
    n = len(tags)
    ifd_end = 8 + 2 + 12 * n + 4
    extra_bytes = sum(len(v) * (2 if t == S else 4) for t, v in
                      tags.values() if len(v) * (2 if t == S else 4) > 4)
    at = ifd_end + extra_bytes
    offsets = []
    for c in chunks:
        offsets.append(at)
        at += len(c)
    tags[off_tag] = (L, offsets)
    e = order
    head = (b"II*\x00" if e == "<" else b"MM\x00*") + struct.pack(e + "I", 8)
    ifd, values = [struct.pack(e + "H", n)], []
    pos = ifd_end
    for tag in sorted(tags):
        t, v = tags[tag]
        blob = struct.pack(e + ("H" if t == S else "I") * len(v), *v)
        if len(blob) > 4:
            ifd.append(struct.pack(e + "HHII", tag, t, len(v), pos))
            values.append(blob)
            pos += len(blob)
        else:
            ifd.append(struct.pack(e + "HHI", tag, t, len(v))
                       + blob.ljust(4, b"\0"))
    ifd.append(struct.pack(e + "I", 0))
    return head + b"".join(ifd) + b"".join(values) + b"".join(chunks)


# ------------------------------------------------------------ catalogue


def _pillow(arr, fmt, mode=None, **kw):
    import io
    from PIL import Image
    im = Image.fromarray(arr)
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pillow_i16b(a):
    import io
    from PIL import Image
    im = Image.frombytes("I;16B", a.shape[::-1], a.astype(">u2").tobytes())
    buf = io.BytesIO()
    im.save(buf, "TIFF")
    return buf.getvalue()


SHAPE = (9, 13)
MID = (24, 40)  # two tile rows of 16 and a half tile column
PNG_TYPES = {"g1": (0, 1), "g2": (0, 2), "g4": (0, 4), "g8": (0, 8),
             "g16": (0, 16), "rgb8": (2, 8), "rgb16": (2, 16),
             "p1": (3, 1), "p2": (3, 2), "p4": (3, 4), "p8": (3, 8),
             "ga8": (4, 8), "ga16": (4, 16), "rgba8": (6, 8),
             "rgba16": (6, 16)}


def _catalogue():
    cat = {}
    for name, (ct, d) in PNG_TYPES.items():
        cat[f"png-{name}"] = (".png", lambda r, ct=ct, d=d: png_variant(
            r, ct, d, SHAPE, False))
        cat[f"png-{name}-adam7"] = (".png", lambda r, ct=ct, d=d:
                                    png_variant(r, ct, d, (7, 9), True))
    for name, ct, d, shape in (("g1", 0, 1, (1, 1)), ("rgb16", 2, 16, (2, 3)),
                               ("p4", 3, 4, (2, 3)), ("rgba8", 6, 8, (1, 1)),
                               ("ga16", 4, 16, (15, 21))):
        cat[f"png-{name}-adam7-{shape[0]}x{shape[1]}"] = (
            ".png", lambda r, ct=ct, d=d, s=shape: png_variant(r, ct, d, s,
                                                               True))
    cat["png-p8-trns"] = (".png", lambda r: png_variant(
        r, 3, 8, SHAPE, False, trns=b"\x00\x80\xff"))
    cat["png-g8-trns"] = (".png", lambda r: png_variant(
        r, 0, 8, SHAPE, False, trns=b"\x00\x10"))
    cat["png-pillow-I16"] = (".png", lambda r: _pillow(
        r.integers(0, 65536, SHAPE).astype(np.uint16), "PNG"))
    cat["png-pillow-1"] = (".png", lambda r: _pillow(
        r.integers(0, 256, SHAPE + (3,), np.uint8), "PNG", "1"))
    cat["png-pillow-P"] = (".png", lambda r: _pillow(
        r.integers(0, 256, SHAPE + (3,), np.uint8), "PNG", "P"))

    rgb = lambda r, s=SHAPE: r.integers(0, 256, s + (3,), np.uint8)
    for mode in ("1", "L", "P", "RGB"):
        cat[f"bmp-pillow-{mode}"] = (".bmp", lambda r, m=mode: _pillow(
            smooth(r, *MID), "BMP", m))
    cat["bmp-pillow-RGBA"] = (".bmp", lambda r: _pillow(
        r.integers(0, 256, SHAPE + (4,), np.uint8), "BMP"))
    pal = lambda r, n: r.integers(0, 256, (n, 3))
    idx = lambda r, n, s=SHAPE: r.integers(0, n, s)
    cat["bmp-core-24"] = (".bmp", lambda r: bmp(rgb(r), 24, header=12))
    cat["bmp-core-8"] = (".bmp", lambda r: bmp(idx(r, 256), 8, header=12,
                                               palette=pal(r, 256)))
    cat["bmp-1-colour"] = (".bmp", lambda r: bmp(idx(r, 2, (5, 37)), 1,
                                                 palette=pal(r, 2)))
    cat["bmp-4"] = (".bmp", lambda r: bmp(idx(r, 16, (5, 7)), 4,
                                          palette=pal(r, 16)))
    cat["bmp-8-short-palette"] = (".bmp", lambda r: bmp(
        idx(r, 20), 8, palette=pal(r, 20)))
    cat["bmp-8-gray"] = (".bmp", lambda r: bmp(
        idx(r, 256), 8, palette=np.repeat(np.arange(256), 3).reshape(-1,
                                                                    3)))
    cat["bmp-16-555"] = (".bmp", lambda r: bmp(
        r.integers(0, 65536, SHAPE), 16))
    cat["bmp-16-565"] = (".bmp", lambda r: bmp(
        r.integers(0, 65536, SHAPE), 16, comp=3,
        masks=(0xF800, 0x7E0, 0x1F)))
    cat["bmp-32-bgrx-bitfields"] = (".bmp", lambda r: bmp(
        r.integers(0, 256, SHAPE + (4,)), 32, comp=3,
        masks=(0xFF0000, 0xFF00, 0xFF)))
    cat["bmp-v4-32-alpha"] = (".bmp", lambda r: bmp(
        r.integers(0, 256, SHAPE + (4,)), 32, header=108, comp=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    cat["bmp-v5-32-rgba"] = (".bmp", lambda r: bmp(
        r.integers(0, 256, SHAPE + (4,)), 32, header=124, comp=3,
        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)))
    cat["bmp-v5-24"] = (".bmp", lambda r: bmp(rgb(r), 24, header=124))
    cat["bmp-topdown-24"] = (".bmp", lambda r: bmp(rgb(r, (2, 3)), 24,
                                                   top_down=True))
    cat["bmp-topdown-8"] = (".bmp", lambda r: bmp(
        idx(r, 256, (1, 1)), 8, palette=pal(r, 256), top_down=True))

    def rle_image(r, n, shape=(9, 23)):
        """Indices with runs and stretches of differing values."""
        img = r.integers(0, n, shape)
        img[:, 3:9] = img[:, 3:4]
        img[::2, 12:16] = r.integers(0, n)
        return img

    def rle_bmp(r, bits, top_down=False, delta=False):
        img = rle_image(r, 1 << bits)
        rows = img if top_down else img[::-1]
        stream = (rle8 if bits == 8 else rle4)(rows)
        if delta:  # Pillow reads (right, up) from the 3rd and 4th byte on
            stream = stream[:-2] + b"\0\2\0\0\3\1" + bytes([4, img[0, 0]]) \
                + b"\0\1"
        return bmp(img, bits, palette=pal(r, 1 << bits),
                   comp=1 if bits == 8 else 2, top_down=top_down,
                   stream=stream)

    cat["bmp-rle8"] = (".bmp", lambda r: rle_bmp(r, 8))
    cat["bmp-rle8-topdown-delta"] = (".bmp", lambda r: rle_bmp(
        r, 8, top_down=True, delta=True))
    cat["bmp-rle4"] = (".bmp", lambda r: rle_bmp(r, 4))

    def rle4_odd(r):
        """An absolute run of 5 pixels: Pillow reads 2 bytes (4 pixels)
        and counts 5, so the row's end comes a pixel early."""
        stream = (b"\x03\x12\x00\x05\x34\x56\x04\xab\x00\x00"
                  b"\x0c\x78\x00\x01")
        return bmp(np.zeros((2, 12), int), 4, palette=pal(r, 16), comp=2,
                   stream=stream)

    cat["bmp-rle4-odd-absolute"] = (".bmp", rle4_odd)

    for mode in ("L", "RGB", "RGBA", "1", "P", "LA"):
        cat[f"tif-pillow-{mode}"] = (".tif", lambda r, m=mode: _pillow(
            r.integers(0, 256, SHAPE + (3,), np.uint8), "TIFF", m))
    cat["tif-pillow-I16"] = (".tif", lambda r: _pillow(
        r.integers(0, 65536, SHAPE).astype(np.uint16), "TIFF"))
    cat["tif-pillow-I16B"] = (".tif", lambda r: _pillow_i16b(
        r.integers(0, 65536, SHAPE)))
    for comp in ("tiff_lzw", "packbits", "tiff_adobe_deflate"):
        cat[f"tif-pillow-{comp}"] = (".tif", lambda r, c=comp: _pillow(
            smooth(r, *MID), "TIFF", compression=c))
        cat[f"tif-pillow-{comp}-pred"] = (".tif", lambda r, c=comp: _pillow(
            smooth(r, *MID), "TIFF", compression=c, tiffinfo={317: 2}))
    cat["tif-pillow-lzw-big"] = (".tif", lambda r: _pillow(
        r.integers(0, 256, (32, 48, 3), np.uint8), "TIFF",
        compression="tiff_lzw"))  # past 4,094 codes: Clear codes
    cat["tif-pillow-I16-lzw-pred"] = (".tif", lambda r: _pillow(
        (smooth(r, 13, 17, 1)[:, :, 0].astype(np.uint16) * 257), "TIFF",
        compression="tiff_lzw", tiffinfo={317: 2}))
    cat["tif-mm-rgb16-deflate-pred"] = (".tif", lambda r: tiff(
        r.integers(0, 65536, SHAPE + (3,)), 16, 2, ">", comp=8,
        predictor=2))
    cat["tif-mm-g16-lzw"] = (".tif", lambda r: tiff(
        r.integers(0, 65536, SHAPE + (1,)), 16, 1, ">", comp=5))
    cat["tif-mm-rgb8-lzw-pred-strips"] = (".tif", lambda r: tiff(
        smooth(r, *MID), 8, 2, ">", comp=5, predictor=2,
        rows_per_strip=5))
    cat["tif-tiles-raw"] = (".tif", lambda r: tiff(
        smooth(r, *MID), 8, 2, tile=(16, 16)))
    cat["tif-tiles-lzw-pred"] = (".tif", lambda r: tiff(
        smooth(r, *MID), 8, 2, comp=5, predictor=2, tile=(32, 16)))
    cat["tif-tiles-deflate-g16"] = (".tif", lambda r: tiff(
        smooth(r, *MID, 1).astype(np.uint16) * 257, 16, 1, comp=8,
        tile=(32, 16)))
    cat["tif-planar2-raw"] = (".tif", lambda r: tiff(
        rgb(r), 8, 2, planar=2))
    cat["tif-planar2-lzw-rgba"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (4,)), 8, 2, comp=5, planar=2,
        extra=(2,), rows_per_strip=4))
    cat["tif-planar2-tiles-packbits"] = (".tif", lambda r: tiff(
        smooth(r, *MID), 8, 2, comp=32773, planar=2, tile=(16, 16)))
    cat["tif-g2"] = (".tif", lambda r: tiff(
        r.integers(0, 4, SHAPE + (1,)), 2, 1))
    cat["tif-g4-white-is-zero"] = (".tif", lambda r: tiff(
        r.integers(0, 16, SHAPE + (1,)), 4, 0))
    cat["tif-g8-white-is-zero"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (1,)), 8, 0))
    cat["tif-1-fillorder2-packbits"] = (".tif", lambda r: tiff(
        r.integers(0, 2, SHAPE + (1,)), 1, 1, comp=32773, fillorder=2))
    cat["tif-rgba-associated"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (4,)), 8, 2, extra=(1,)))
    cat["tif-rgbx"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (4,)), 8, 2, extra=(0,)))
    cat["tif-rgba16"] = (".tif", lambda r: tiff(
        r.integers(0, 65536, SHAPE + (4,)), 16, 2, extra=(2,)))
    cat["tif-p4"] = (".tif", lambda r: tiff(
        r.integers(0, 16, SHAPE + (1,)), 4, 3,
        colormap=r.integers(0, 65536, (16, 3))))

    photo = lambda r, s=MID, c=3: smooth(r, *s, c)
    for name, kw in (("444", dict(subsampling=0)),
                     ("422", dict(subsampling=1)),
                     ("420-restart", dict(subsampling=2,
                                          restart_marker_blocks=3)),
                     ("420-restart-rows", dict(restart_marker_rows=1))):
        cat[f"jpg-progressive-{name}"] = (".jpg", lambda r, kw=kw: _pillow(
            photo(r), "JPEG", progressive=True, **kw))
    cat["jpg-progressive-gray"] = (".jpg", lambda r: _pillow(
        photo(r, c=1)[:, :, 0], "JPEG", progressive=True))
    for s in ((1, 1), (2, 3), (17, 9)):
        cat[f"jpg-progressive-{s[0]}x{s[1]}"] = (
            ".jpg", lambda r, s=s: _pillow(photo(r, s), "JPEG",
                                           progressive=True, quality=95))
    cat["jpg-baseline"] = (".jpg", lambda r: _pillow(photo(r), "JPEG"))
    return cat


CATALOGUE = _catalogue()


def digest(arr):
    """A short digest of an array's dtype, shape and values."""
    import hashlib
    h = hashlib.sha256(f"{arr.dtype.str} {arr.shape}".encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


def large_progressive_jpeg():
    """A 1280x720 progressive JPEG (Pillow's, quality 90, 4:2:0) of slow
    waves: the committed fixture that phase 29 times the progressive
    decoder on (smooth, so it stays small; a photo's file holds more
    coefficients and decodes slower)."""
    return _pillow(smooth(np.random.default_rng(720), 720, 1280, noise=0,
                          fmax=0.02), "JPEG", progressive=True, quality=90)


def make(name, seed=None):
    """(extension, bytes) of the catalogue's variant ``name``, from a
    Generator seeded by the name (or ``seed``)."""
    ext, fn = CATALOGUE[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) if seed is None
                                else seed)
    return ext, fn(rng)
