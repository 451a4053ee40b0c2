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


def _pack_rows(s, depth, order=">", kind="u"):
    """(h, bytes) rows of (h, w, c) samples at ``depth`` bits, most
    significant bits first, each row padded to a byte; 16, 32 and 64-bit
    samples in byte ``order``, of numpy ``kind`` u, i or f."""
    h = s.shape[0]
    v = s.reshape(h, -1)
    if depth in (16, 32, 64) or kind == "f":
        dt = np.dtype(f"{order}{kind}{depth // 8}")
        return np.asarray(v).astype(dt).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return v.astype(np.uint8)
    if depth > 8 or 8 % depth:
        bits = (v.astype(np.uint64)[:, :, None]
                >> np.arange(depth - 1, -1, -1, dtype=np.uint64)) & 1
        return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
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


def ycbcr_blocks(blk, hs, vs):
    """TIFF's subsampled YCbCr layout of (rows, w, 3) samples: for each
    hs x vs block, its Y samples row by row, then one Cb and one Cr (the
    block's first pixel's), the image padded to whole blocks by edge
    replication; one row of (rows / vs) lines of blocks."""
    rows, w = blk.shape[:2]
    ph, pw = -(-rows // vs) * vs, -(-w // hs) * hs
    p = np.pad(blk, ((0, ph - rows), (0, pw - w), (0, 0)), mode="edge")
    y = p[:, :, 0].reshape(ph // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3)
    c = p[::vs, ::hs, 1:]
    out = np.concatenate([y.reshape(ph // vs, pw // hs, hs * vs), c], 2)
    return out.reshape(ph // vs, -1)


def _jpeg_tables(chunks):
    """(tables-only stream, abbreviated chunks): each chunk's DQT and DHT
    segments, which must be the same in every chunk, moved to one
    JPEGTables stream, as libtiff writes them."""
    def split(c):
        keep, tables, i = bytearray(c[:2]), bytearray(), 2
        while c[i + 1] != 0xDA:
            n = 2 + struct.unpack(">H", c[i + 2:i + 4])[0]
            (tables if c[i + 1] in (0xDB, 0xC4) else keep).extend(
                c[i:i + n])
            i += n
        return bytes(tables), bytes(keep + c[i:])
    parts = [split(c) for c in chunks]
    assert len({t for t, _ in parts}) == 1
    return b"\xff\xd8" + parts[0][0] + b"\xff\xd9", [c for _, c in parts]


def tiff(samples, bits, photo, order="<", comp=1, predictor=1, planar=1,
         tile=None, rows_per_strip=None, extra=(), colormap=None,
         fillorder=1, sample_format=None, big=False, tags=None,
         subsampling=None, encode=None, jpeg_tables=False):
    """TIFF bytes of (h, w, spp) samples: strips (``rows_per_strip``)
    or ``tile`` = (width, length) tiles, each plane apart when ``planar``
    is 2; ``comp`` 1 (none), 5 (LZW), 8 (Deflate) or 32773 (PackBits), or
    any other with ``encode`` turning a chunk's (rows, width, samples)
    array into its bytes; ``predictor`` 2 differences each sample from
    its left neighbour; ``sample_format`` 2 (signed) or 3 (float);
    ``subsampling`` (hs, vs) stores YCbCr in its block layout; ``big``
    writes BigTIFF; ``jpeg_tables`` moves the chunks' JPEG tables to a
    JPEGTables tag; ``tags`` adds {tag: (type, values)}."""
    h, w, spp = samples.shape
    planes = spp if planar == 2 else 1
    cs = spp // planes
    kind = {None: "u", 1: "u", 2: "i", 3: "f"}[sample_format]
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
            blk = np.zeros((rows, cw, cs), samples.dtype if kind == "f"
                           else np.int64)
            part = samples[y0:y0 + rows, x0:x0 + cw, p * cs:(p + 1) * cs]
            blk[:part.shape[0], :part.shape[1]] = part
            if tile is None or encode is not None:
                blk = blk[:, :w]
            if encode is not None:
                chunks.append(encode(blk))
                continue
            if predictor == 2:
                blk[:, 1:] = (blk[:, 1:] - blk[:, :-1]) % (1 << bits)
            if subsampling:
                raw = ycbcr_blocks(blk, *subsampling).astype(np.uint8)
            else:
                raw = _pack_rows(blk, bits, order, kind)
            if fillorder == 2:
                raw = _REVERSED[raw]
            raw = raw.tobytes()
            chunks.append({1: bytes, 5: lzw, 8: zlib.compress,
                           32773: packbits}[comp](raw))
    S, L = 3, 4
    L8 = 16 if big else L
    table = {256: (L, [w]), 257: (L, [h]), 258: (S, [bits] * spp),
             259: (S, [comp]), 262: (S, [photo]), 277: (S, [spp]),
             284: (S, [planar])}
    if fillorder != 1:
        table[266] = (S, [fillorder])
    if predictor != 1:
        table[317] = (S, [predictor])
    if colormap is not None:
        table[320] = (S, list(np.asarray(colormap).T.reshape(-1)))
    if extra:
        table[338] = (S, list(extra))
    if sample_format is not None:
        table[339] = (S, [sample_format] * spp)
    if subsampling:
        table[530] = (S, list(subsampling))
    if jpeg_tables:
        tables, chunks = _jpeg_tables(chunks)
        table[347] = (7, list(tables))
    table.update(tags or {})
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        table[322], table[323] = (S, [tile[0]]), (S, [tile[1]])
    else:
        table[278] = (L, [ch])
    table[cnt_tag] = (L8, [len(c) for c in chunks])
    e = order
    size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 11: 4, 12: 8, 16: 8}
    code = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f",
            12: "d", 16: "Q"}
    slot, entry, count = (8, 20, "Q") if big else (4, 12, "I")
    n = len(table) + 1
    ifd_end = (16 if big else 8) + (8 if big else 2) + entry * n + slot
    blob_of = lambda t, v: struct.pack(e + code[t] * len(v), *v)
    long_len = lambda t, v: (len(blob_of(t, v))
                             if len(blob_of(t, v)) > slot else 0)
    count_of = lambda t, v: len(v) // 2 if t == 5 else len(v)
    table[off_tag] = (L8, [0] * len(chunks))
    at = ifd_end + sum(long_len(t, v) for t, v in table.values())
    offsets = []
    for c in chunks:
        offsets.append(at)
        at += len(c)
    table[off_tag] = (L8, offsets)
    if big:
        head = ((b"II+\x00" if e == "<" else b"MM\x00+")
                + struct.pack(e + "HHQ", 8, 0, 16))
    else:
        head = ((b"II*\x00" if e == "<" else b"MM\x00*")
                + struct.pack(e + "I", 8))
    ifd, values = [struct.pack(e + ("Q" if big else "H"), len(table))], []
    pos = ifd_end
    for tag in sorted(table):
        t, v = table[tag]
        blob = blob_of(t, v)
        if len(blob) > slot:
            ifd.append(struct.pack(e + "HH" + count + count, tag, t,
                                   count_of(t, v), pos))
            values.append(blob)
            pos += len(blob)
        else:
            ifd.append(struct.pack(e + "HH" + count, tag, t,
                                   count_of(t, v)) + blob.ljust(slot, b"\0"))
    ifd.append(struct.pack(e + count, 0))
    return head + b"".join(ifd) + b"".join(values) + b"".join(chunks)


# ---------------------------------------------------------------- PNM


def pnm(magic, samples, maxval=None, comment=False, scale=None):
    """PNM bytes: ``magic`` P1-P6 of (h, w[, 3]) integer samples (bool
    for P1/P4, True = black), or ``Pf`` of (h, w) floats with ``scale``
    (negative: little-endian); a comment in the header when ``comment``,
    and for plain files within the raster too."""
    h, w = samples.shape[:2]
    head = magic + (b"\n# made by image_files\n" if comment else b"\n")
    head += f"{w} {h}\n".encode()
    if magic == b"Pf":
        order = "<" if scale < 0 else ">"
        return head + f"{scale}\n".encode() + np.asarray(
            samples[::-1], order + "f4").tobytes()
    if magic in (b"P1", b"P4"):
        if magic == b"P4":
            return head + np.packbits(samples.astype(np.uint8),
                                      axis=1).tobytes()
        rows = [b"".join(b"1" if v else b"0" for v in r) for r in samples]
        return head + b"\n".join(rows) + b"\n"
    head += f"{maxval}\n".encode()
    if magic in (b"P5", b"P6"):
        dt = np.uint8 if maxval < 256 else ">u2"
        return head + np.asarray(samples, dt).tobytes()
    flat = [str(int(v)).encode() for v in samples.reshape(-1)]
    lines = [b" ".join(flat[i:i + 7]) for i in range(0, len(flat), 7)]
    if comment:
        lines.insert(1, b"# a comment in the raster")
    return head + b"\n".join(lines) + b"\n"


# ---------------------------------------------------------------- GIF


def gif_lzw(idx, min_size):
    """GIF LZW sub-blocks of the index bytes ``idx``: a Clear first,
    LSB-first codes widened once the next free code reaches the width's
    limit, a Clear when the table is full, End last."""
    clear, out = 1 << min_size, bytearray()
    acc = nacc = 0

    def put(code, bits):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    bits, table, nxt = min_size + 1, {}, clear + 2
    put(clear, bits)
    w = None
    for b in idx:
        if w is None:
            w = b
            continue
        if (w, b) in table:
            w = table[(w, b)]
            continue
        put(w, bits)
        if nxt < 4096:
            table[(w, b)] = nxt
            nxt += 1
            if nxt > (1 << bits) and bits < 12:
                bits += 1
        else:
            put(clear, bits)
            bits, table, nxt = min_size + 1, {}, clear + 2
        w = b
    if w is not None:
        put(w, bits)
    put(clear + 1, bits)
    if nacc:
        out.append(acc & 0xFF)
    blocks = b"".join(bytes([len(out[i:i + 255])]) + out[i:i + 255]
                      for i in range(0, len(out), 255))
    return bytes([min_size]) + blocks + b"\0"


def gif(frames, screen, palette=None, transparency=None, version=b"89a"):
    """GIF bytes: ``frames`` a list of (indices (h, w), x0, y0, local
    colour table or None, interlaced); ``palette`` the global table
    ((2**k, 3) RGB, or None); ``transparency`` a graphic control
    extension's index for each frame."""
    def table_bits(t):
        return max(0, int(np.log2(len(t))) - 1)
    out = b"GIF" + version + struct.pack("<HH", *screen[::-1])
    if palette is not None:
        out += bytes([0x80 | 0x70 | table_bits(palette), 0, 0])
        out += np.asarray(palette, np.uint8).tobytes()
    else:
        out += b"\x00\x00\x00"
    for idx, x0, y0, local, interlace in frames:
        if transparency is not None:
            out += b"\x21\xf9\x04\x01\x00\x00" + bytes([transparency]) \
                + b"\x00"
        h, w = idx.shape
        flags = 0x40 if interlace else 0
        if local is not None:
            flags |= 0x80 | table_bits(local)
        out += b"\x2c" + struct.pack("<HHHHB", x0, y0, w, h, flags)
        if local is not None:
            out += np.asarray(local, np.uint8).tobytes()
        rows = idx
        if interlace:
            rows = np.concatenate([idx[s::k] for s, k in
                                   ((0, 8), (4, 8), (2, 4), (1, 2))])
        n = max(len(local if local is not None else palette), 4)
        out += gif_lzw(rows.astype(np.uint8).reshape(-1).tolist(),
                       max(2, int(np.log2(n))))
    return out + b"\x3b"


# --------------------------------------------------------------- WebP


def _port_table(source, name):
    """A C array of the port's host C++ (``native/<source>``), read from
    its source: the spec tables the test encoders share with it."""
    import pathlib
    import re
    src = (pathlib.Path(__file__).resolve().parents[1]
           / "simplestereo_tpu_torch" / "native" / source).read_text()
    body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
    return [int(v, 0) for v in body.replace("\n", " ").split(",")
            if v.strip()]


def _vp8_table(name):
    """An RFC 6386 table as the port's WebP decoder holds it."""
    return _port_table("_webp.cpp", name)


class _BoolDecoder:
    """RFC 6386 7.3's boolean decoder, recording each decision."""

    def __init__(self, data):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8) | data[1]
        self.range, self.count, self.log = 255, 0, []

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            b, self.range, self.value = 1, self.range - split, \
                self.value - (split << 8)
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(
                    self.data) else 0
                self.pos += 1
        self.log.append([b, prob])
        return b

    def lit(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v


def _bool_encode(decisions):
    """RFC 6386 7.3's boolean encoder of [(bit, prob), ...]."""
    out = bytearray()
    rng, bottom, count = 255, 0, 24

    def carry():
        i = len(out) - 1
        while out[i] == 255:
            out[i] = 0
            i -= 1
        out[i] += 1

    for b, prob in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if b:
            bottom += split
            rng -= split
        else:
            rng = split
        while rng < 128:
            rng <<= 1
            if bottom & (1 << 31):
                carry()
            bottom = (bottom << 1) & 0xFFFFFFFF
            count -= 1
            if count == 0:
                out.append((bottom >> 24) & 0xFF)
                bottom &= (1 << 24) - 1
                count = 8
    c, v = count, bottom
    if v & (1 << (32 - c)):
        carry()
    v = (v << (c & 7)) & 0xFFFFFFFF
    for _ in range(c >> 3):
        v = (v << 8) & 0xFFFFFFFF
    for _ in range(4):
        out.append((v >> 24) & 0xFF)
        v = (v << 8) & 0xFFFFFFFF
    return bytes(out)


def vp8_refilter(webp, simple=None, level=None, sharpness=None,
                 deltas=None):
    """A simple lossy WebP file with its VP8 loop-filter header replaced:
    the filter type (``simple``), ``level`` (0-63), ``sharpness`` (0-7)
    and ``deltas`` (reference and mode deltas, 4 each, signed 6-bit).
    The first partition is decoded decision by decision and coded again
    with the new header; the macroblocks' modes and tokens stay, so the
    file decodes to the same reconstruction, filtered otherwise."""
    assert webp[12:16] == b"VP8 "
    frame = webp[20:20 + struct.unpack("<I", webp[16:20])[0]]
    tag = int.from_bytes(frame[:3], "little")
    size0 = tag >> 5
    w = int.from_bytes(frame[6:8], "little") & 0x3FFF
    h = int.from_bytes(frame[8:10], "little") & 0x3FFF
    br = _BoolDecoder(frame[10:10 + size0])
    br.lit(2)
    seg_map = False
    if br.bit(128):
        seg_map = br.bit(128)
        if br.bit(128):
            br.bit(128)
            for bits in (7,) * 4 + (6,) * 4:
                if br.bit(128):
                    br.lit(bits + 1)
        if seg_map:
            seg_p = [br.lit(8) if br.bit(128) else 255 for _ in range(3)]
    at = len(br.log)
    br.bit(128)
    br.lit(6)
    br.lit(3)
    if br.bit(128) and br.bit(128):
        for _ in range(8):
            if br.bit(128):
                br.lit(7)
    old = br.log[at:]
    br.log = br.log[:at]
    br.lit(2)
    br.lit(7)
    for _ in range(5):
        if br.bit(128):
            br.lit(5)
    br.bit(128)
    upd = _vp8_table("kCoeffsUpdateProba")
    for p in upd:
        if br.bit(p):
            br.lit(8)
    skip = br.bit(128)
    skip_p = br.lit(8) if skip else 0
    bmodes = _vp8_table("kBModesProba")
    tree = [-0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9]
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    top = [0] * (4 * mbw)
    for my in range(mbh):
        left = [0] * 4
        for mx in range(mbw):
            if seg_map:
                if not br.bit(seg_p[0]):
                    br.bit(seg_p[1])
                else:
                    br.bit(seg_p[2])
            if skip:
                br.bit(skip_p)
            if br.bit(145):
                ym = ((1 if br.bit(128) else 3) if br.bit(156)
                      else (2 if br.bit(163) else 0))
                top[4 * mx:4 * mx + 4] = [ym] * 4
                left = [ym] * 4
            else:
                for yy in range(4):
                    ym = left[yy]
                    for xx in range(4):
                        prob = bmodes[(top[4 * mx + xx] * 10 + ym) * 9:][:9]
                        i = tree[br.bit(prob[0])]
                        while i > 0:
                            i = tree[2 * i + br.bit(prob[i])]
                        ym = -i
                        top[4 * mx + xx] = ym
                    left[yy] = ym
            if br.bit(142) and br.bit(114):
                br.bit(183)
    bits = lambda v, n: [[(v >> k) & 1, 128] for k in range(n - 1, -1, -1)]
    new = [old[0]] + old[1:7] + old[7:10] if simple is None else \
        [[int(simple), 128]] + old[1:7] + old[7:10]
    if level is not None:
        new[1:7] = bits(level, 6)
    if sharpness is not None:
        new[7:10] = bits(sharpness, 3)
    if deltas is None:
        new += old[10:]
    else:
        new += [[1, 128], [1, 128]]
        for d in deltas:
            new += [[1, 128]] + bits(abs(d), 6) + [[int(d < 0), 128]]
    part0 = _bool_encode(br.log[:at] + new + br.log[at:])
    frame = ((len(part0) << 5) | (tag & 0x1F)).to_bytes(3, "little") \
        + frame[3:10] + part0 + frame[10 + size0:]
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame \
        + b"\0" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _prefix_lengths(counts, limit=15):
    """Huffman code lengths of ``counts`` (zero for unused symbols), at
    most ``limit`` bits: the counts are flattened until the code fits."""
    import heapq
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) == 1:
        lengths[used] = 1
        return lengths
    c = counts[used].copy()
    while True:
        heap = [(int(v), i, [i]) for i, v in enumerate(c)]
        heapq.heapify(heap)
        depth = np.zeros(len(c), np.int64)
        k = len(c)
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            depth[a[2] + b[2]] += 1
            heapq.heappush(heap, (a[0] + b[0], k, a[2] + b[2]))
            k += 1
        if depth.max() <= limit:
            lengths[used] = depth
            return lengths
        c = (c + 1) // 2 + 1


def _canonical(lengths):
    """The canonical codes of ``lengths``, bit-reversed for an LSB-first
    stream (VP8L reads a code's most significant bit first)."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for l in range(1, 16):
        for s in np.flatnonzero(lengths == l):
            codes[s] = int(f"{code:0{l}b}"[::-1], 2)
            code += 1
        code <<= 1
    return codes


class _LSBWriter:
    def __init__(self):
        self.vals, self.lens = [], []

    def put(self, value, nbits):
        self.vals.append(np.atleast_1d(np.asarray(value, np.int64)))
        self.lens.append(np.broadcast_to(np.asarray(nbits, np.int64),
                                         self.vals[-1].shape))

    def bytes(self):
        v, n = np.concatenate(self.vals), np.concatenate(self.lens)
        keep = n > 0
        v, n = v[keep], n[keep]
        start = np.cumsum(n) - n
        owner = np.repeat(np.arange(len(n)), n)
        bit = np.arange(int(n.sum())) - start[owner]
        bits = ((v[owner] >> bit) & 1).astype(np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()


def _write_prefix(wr, counts):
    """A VP8L prefix code for ``counts``: simple for one symbol below 256,
    else normal, the code lengths coded without repeat codes."""
    lengths = _prefix_lengths(counts)
    used = np.flatnonzero(lengths)
    if len(used) == 1 and used[0] < 256:
        wr.put([1, 0, 1, int(used[0])], [1, 1, 1, 8])
        return np.zeros(len(counts), np.int64), np.zeros(len(counts),
                                                          np.int64)
    hist = np.bincount(lengths, minlength=19)
    hist[0] += 1  # two code-length symbols at least
    cl = _prefix_lengths(hist, 7)
    order = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15]
    wr.put([0, 15], [1, 4])
    wr.put([int(cl[i]) for i in order], 3)
    wr.put(0, 1)  # no max_symbol: every symbol has its length
    clc = _canonical(cl)
    wr.put(clc[lengths], cl[lengths])
    return _canonical(lengths), lengths


def webp_lossless(rgb):
    """VP8L WebP bytes of (h, w, 3) uint8 RGB: the subtract-green and
    predictor (mode 1, the left pixel) transforms, then one prefix code
    for each of green, red, blue and alpha; no colour cache and no
    backward references. Numpy only (phase 29 writes its frames with it
    on the card's host, which has no Pillow)."""
    h, w = rgb.shape[:2]
    a = rgb.astype(np.int64)
    g = a[:, :, 1]
    px = np.stack([(a[:, :, 0] - g) % 256, g, (a[:, :, 2] - g) % 256,
                   np.full((h, w), 255)], -1)  # R, G, B, A after green
    pred = np.zeros_like(px)
    pred[:, 1:] = px[:, :-1]
    pred[1:, 0] = px[:-1, 0]
    pred[0, 0] = (0, 0, 0, 255)
    res = (px - pred) % 256
    wr = _LSBWriter()
    wr.put([0x2F, w - 1, h - 1, 0, 0], [8, 14, 14, 1, 3])
    bits = 9
    wr.put([1, 0, bits - 2], [1, 2, 3])  # predictor transform
    # Its sub-image: every block mode 1 (green 1), five one-symbol codes.
    wr.put([0], [1])  # no colour cache
    for sym in (1, 0, 0, 0, 0):
        wr.put([1, 0, 1, sym], [1, 1, 1, 8])
    wr.put([1, 2], [1, 2])  # subtract green
    wr.put([0, 0, 0], [1, 1, 1])  # no more transforms, no cache, no meta
    flat = res.reshape(-1, 4)
    codes = []
    for ch, size in ((1, 280), (0, 256), (2, 256), (3, 256)):
        codes.append(_write_prefix(wr, np.bincount(flat[:, ch],
                                                   minlength=size)))
    wr.put([1, 0, 0, 0], [1, 1, 1, 1])  # distance code: symbol 0
    sym = np.stack([codes[k][0][flat[:, ch]] for k, ch in
                    enumerate((1, 0, 2, 3))], 1)
    nb = np.stack([codes[k][1][flat[:, ch]] for k, ch in
                   enumerate((1, 0, 2, 3))], 1)
    wr.put(sym.reshape(-1), nb.reshape(-1))
    body = wr.bytes()
    chunk = b"VP8L" + struct.pack("<I", len(body)) + body + b"\0" * (
        len(body) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def webp_animation(frames, canvas, alpha=True):
    """An animated WebP: ``frames`` a list of (still WebP bytes from
    Pillow, x, y) whose image chunks (ALPH, VP8 or VP8L) become ANMF
    frames at (x, y) (even) on a ``canvas`` (width, height)."""
    def chunk(tag, body):
        return tag + struct.pack("<I", len(body)) + body + b"\0" * (
            len(body) & 1)

    def images(data):
        out, pos = b"", 12
        while pos < len(data):
            tag, n = data[pos:pos + 4], struct.unpack(
                "<I", data[pos + 4:pos + 8])[0]
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                out += data[pos:pos + 8 + n + (n & 1)]
            pos += 8 + n + (n & 1)
        return out

    def size(data):
        from PIL import Image
        import io
        return Image.open(io.BytesIO(data)).size

    u24 = lambda v: struct.pack("<I", v)[:3]
    body = chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                 + u24(canvas[0] - 1) + u24(canvas[1] - 1))
    body += chunk(b"ANIM", b"\0\0\0\0\0\0")
    for data, x, y in frames:
        w, h = size(data)
        body += chunk(b"ANMF", u24(x // 2) + u24(y // 2) + u24(w - 1)
                      + u24(h - 1) + u24(100) + b"\0" + images(data))
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


# ------------------------------------------------------------ catalogue


def adobe_transform(jpeg, transform, jfif=True):
    """JPEG bytes with an Adobe APP14 marker's transform byte set to
    ``transform`` (None: the marker taken out), and the JFIF APP0 marker
    taken out unless ``jfif``; a marker missing is added after SOI."""
    out, i = bytearray(jpeg[:2]), 2
    seen = False
    while jpeg[i + 1] != 0xDA:
        n = 2 + struct.unpack(">H", jpeg[i + 2:i + 4])[0]
        seg = bytearray(jpeg[i:i + n])
        if seg[1] == 0xEE:
            seen = True
            if transform is None:
                seg = b""
            else:
                seg[15] = transform
        elif seg[1] == 0xE0 and not jfif:
            seg = b""
        out += seg
        i += n
    if not seen and transform is not None:
        out[2:2] = (b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                    + bytes([transform]))
    return bytes(out + jpeg[i:])


def fax_strips(bits, comp, rows, fillorder=1, photo=1, t4=None,
               tile=False):
    """TIFF bytes of the (h, w) bool image ``bits`` in CCITT ``comp``
    ("group3" or "group4"): each strip of ``rows`` rows (or each tile of
    rows x rows, where ``tile``) coded by Pillow (libtiff) on its own,
    its bytes bit-reversed for ``fillorder`` 2; ``photo`` 0 stores the
    inverse, so that the pixels stay the same."""
    import io
    from PIL import Image

    def encode(blk):
        b = blk[:, :, 0].astype(bool)
        im = Image.fromarray(b if photo == 1 else ~b)
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=comp,
                **({} if t4 is None else {"tiffinfo": {292: t4}}))
        t = Image.open(buf)
        data = buf.getvalue()[t.tag_v2[273][0]:][:t.tag_v2[279][0]]
        return _REVERSED[np.frombuffer(data, np.uint8)].tobytes() \
            if fillorder == 2 else data

    tags = {} if t4 is None else {292: (4, [t4])}
    return tiff(bits[:, :, None].astype(np.int64), 1, photo,
                comp={"group3": 3, "group4": 4}[comp], encode=encode,
                fillorder=fillorder, tags=tags,
                tile=(rows, rows) if tile else None,
                rows_per_strip=None if tile else rows)


def _pillow(arr, fmt, mode=None, **kw):
    import io
    from PIL import Image
    im = Image.fromarray(arr)
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _pillow_frames(arrs, fmt, **kw):
    import io
    from PIL import Image
    ims = [Image.fromarray(a) for a in arrs]
    buf = io.BytesIO()
    ims[0].save(buf, fmt, save_all=True, append_images=ims[1:], **kw)
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

    for mode in ("1", "L", "RGB", "I;16", "F"):
        def pil_pnm(r, m=mode):
            a = smooth(r, *SHAPE)
            if m == "I;16":
                a = a[:, :, 0].astype(np.uint16) * 257 + 3
            elif m == "F":
                a = (a[:, :, 0] - 100.25).astype(np.float32) / 3
            return _pillow(a, "PPM", None if m in ("I;16", "F") else m)
        cat[f"pnm-pillow-{mode.replace(';', '')}"] = (".pnm", pil_pnm)
    levels = lambda r, top, s=SHAPE: r.integers(0, top + 1, s)
    cat["pnm-p5-maxval-1023"] = (".pgm", lambda r: pnm(
        b"P5", levels(r, 1023), 1023))
    cat["pnm-p5-maxval-15"] = (".pgm", lambda r: pnm(
        b"P5", levels(r, 15), 15, comment=True))
    cat["pnm-p5-maxval-100-over"] = (".pgm", lambda r: pnm(
        b"P5", levels(r, 255), 100))  # samples above maxval clip
    cat["pnm-p6-16bit"] = (".ppm", lambda r: pnm(
        b"P6", levels(r, 65535, SHAPE + (3,)), 65535))
    cat["pnm-p6-maxval-1000"] = (".ppm", lambda r: pnm(
        b"P6", levels(r, 1000, SHAPE + (3,)), 1000))
    cat["pnm-p4-odd-width"] = (".pbm", lambda r: pnm(
        b"P4", levels(r, 1, (5, 11)) > 0, comment=True))
    cat["pnm-p1-plain"] = (".pbm", lambda r: pnm(
        b"P1", levels(r, 1) > 0, comment=True))
    cat["pnm-p2-plain-4095"] = (".pgm", lambda r: pnm(
        b"P2", levels(r, 4095), 4095, comment=True))
    cat["pnm-p2-plain-255"] = (".pgm", lambda r: pnm(
        b"P2", levels(r, 255), 255))
    cat["pnm-p3-plain-7"] = (".ppm", lambda r: pnm(
        b"P3", levels(r, 7, SHAPE + (3,)), 7, comment=True))
    cat["pfm-big-endian"] = (".pfm", lambda r: pnm(
        b"Pf", r.normal(0, 300, SHAPE).astype(np.float32), scale=2.5))
    cat["pfm-little-endian-inf"] = (".pfm", lambda r: pnm(
        b"Pf", np.where(r.random(SHAPE) < 0.2, np.inf, r.uniform(
            -5, 300, SHAPE)).astype(np.float32), scale=-1.0))

    for mode in ("F", "I", "CMYK", "LAB"):
        def pil_tif(r, m=mode):
            a = smooth(r, *SHAPE)
            if m == "F":
                a = (a[:, :, 0] - 120.5).astype(np.float32) * 2.25
                a[0, :4] = (np.nan, np.inf, -np.inf, 255.5)
            elif m == "I":
                a = (a[:, :, 0].astype(np.int32) - 60) * 9
            return _pillow(a, "TIFF", None if m in ("F", "I") else m)
        cat[f"tif-pillow-{mode}"] = (".tif", pil_tif)
    cat["tif-pillow-bigtiff"] = (".tif", lambda r: _pillow(
        smooth(r, *SHAPE), "TIFF", big_tiff=True))
    cat["tif-pillow-bigtiff-lzw"] = (".tif", lambda r: _pillow(
        smooth(r, *MID), "TIFF", big_tiff=True, compression="tiff_lzw"))
    gray = lambda r, s=SHAPE: smooth(r, *s, 1)
    cat["tif-mm-f32-white-is-zero"] = (".tif", lambda r: tiff(
        r.normal(0, 1e3, SHAPE + (1,)).astype(np.float32), 32, 0, ">",
        sample_format=3))
    cat["tif-mm-f32-lzw"] = (".tif", lambda r: tiff(  # Pillow swaps bytes
        r.normal(0, 1e3, SHAPE + (1,)).astype(np.float32), 32, 1, ">",
        comp=5, sample_format=3))
    cat["tif-f32-deflate-pred3"] = (".tif", lambda r: tiff(
        (gray(r, MID) / 7).astype(np.float32), 32, 1, comp=8,
        predictor=3, sample_format=3, rows_per_strip=5))
    cat["tif-f32-tiles-lzw"] = (".tif", lambda r: tiff(
        r.normal(0, 50, MID + (1,)).astype(np.float32), 32, 1, comp=5,
        sample_format=3, tile=(16, 16)))
    cat["tif-u32"] = (".tif", lambda r: tiff(
        r.integers(0, 2**32, SHAPE + (1,)), 32, 1))
    cat["tif-s32-mm-lzw-pred"] = (".tif", lambda r: tiff(
        r.integers(-2**31, 2**31, SHAPE + (1,)), 32, 1, ">", comp=5,
        predictor=2, sample_format=2))
    cat["tif-s16"] = (".tif", lambda r: tiff(
        r.integers(-2**15, 2**15, SHAPE + (1,)), 16, 1, sample_format=2))
    cat["tif-s16-mm"] = (".tif", lambda r: tiff(
        r.integers(-2**15, 2**15, SHAPE + (1,)), 16, 1, ">",
        sample_format=2))
    cat["tif-s16-mm-deflate"] = (".tif", lambda r: tiff(
        r.integers(-300, 300, SHAPE + (1,)), 16, 1, ">", comp=8,
        sample_format=2))
    cat["tif-s8"] = (".tif", lambda r: tiff(
        r.integers(-128, 128, SHAPE + (1,)), 8, 1, sample_format=2))
    cat["tif-g12"] = (".tif", lambda r: tiff(
        r.integers(0, 4096, SHAPE + (1,)), 12, 1))
    cat["tif-g12-lzw"] = (".tif", lambda r: tiff(
        r.integers(0, 4096, SHAPE + (1,)), 12, 1, comp=5, rows_per_strip=4))
    cat["tif-g16-fillorder2"] = (".tif", lambda r: tiff(
        r.integers(0, 65536, SHAPE + (1,)), 16, 1, fillorder=2))
    cat["tif-cmyk16"] = (".tif", lambda r: tiff(
        r.integers(0, 65536, SHAPE + (4,)), 16, 5))
    cat["tif-cmykx-lzw"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (5,)), 8, 5, comp=5, extra=(0,)))
    cat["tif-rgba16-associated"] = (".tif", lambda r: tiff(
        r.integers(0, 65536, SHAPE + (4,)), 16, 2, extra=(1,)))
    cat["tif-rgbxx"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (5,)), 8, 2, extra=(0, 0)))
    cat["tif-rgbax-packbits"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (5,)), 8, 2, comp=32773, extra=(2, 0)))
    cat["tif-pa"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (2,)), 8, 3, extra=(2,),
        colormap=r.integers(0, 65536, (256, 3))))
    cat["tif-mm-lab-lzw"] = (".tif", lambda r: tiff(
        r.integers(0, 256, SHAPE + (3,)), 8, 8, ">", comp=5))
    cat["tif-ycbcr-gray"] = (".tif", lambda r: tiff(
        gray(r), 8, 6))
    for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4)):
        cat[f"tif-ycbcr-{hs}{vs}-lzw"] = (".tif", lambda r, hs=hs, vs=vs:
                                         tiff(smooth(r, 11, 14), 8, 6,
                                              comp=5, subsampling=(hs, vs),
                                              rows_per_strip=4 * vs))
    cat["tif-ycbcr-22-deflate-refbw"] = (".tif", lambda r: tiff(
        smooth(r, 10, 12), 8, 6, comp=8, subsampling=(2, 2),
        tags={532: (5, [15, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]),
              529: (5, [2126, 10000, 7152, 10000, 722, 10000])}))
    cat["tif-bigtiff-tiles-deflate"] = (".tif", lambda r: tiff(
        smooth(r, *MID), 8, 2, comp=8, tile=(16, 16), big=True))

    def bilevel(r, shape=(21, 150)):
        """Thresholded waves with noise, a row of each colour and an
        alternating row: short and long runs, every mode of 2-D coding."""
        a = smooth(r, *shape, 1, noise=40)[:, :, 0] > 128
        a[3], a[4], a[5] = True, False, np.arange(shape[1]) % 2 == 0
        return a

    for comp, info in (("group4", None), ("group3", None),
                       ("group3-2d", {292: 1}), ("group3-2d-fill", {292: 5}),
                       ("tiff_ccitt", None)):
        cat[f"tif-pillow-{comp}"] = (".tif", lambda r, c=comp, i=info:
                                     _pillow(bilevel(r), "TIFF", compression=
                                             c.split("-")[0],
                                             **({"tiffinfo": i} if i else {})))
    cat["tif-pillow-group4-wide"] = (".tif", lambda r: _pillow(
        bilevel(r, (6, 2700))[:, ::2].repeat(2, 1), "TIFF",
        compression="group4"))
    cat["tif-group4-fillorder2-strips"] = (".tif", lambda r: fax_strips(
        bilevel(r, (21, 77)), "group4", 8, fillorder=2, photo=0))
    cat["tif-group3-2d-tiles"] = (".tif", lambda r: fax_strips(
        bilevel(r, (32, 48)), "group3", 16, t4=1, tile=True))

    cat["gif-pillow-P-interlaced"] = (".gif", lambda r: _pillow(
        smooth(r, *MID), "GIF", "P"))
    cat["gif-pillow-P"] = (".gif", lambda r: _pillow(
        smooth(r, *MID), "GIF", "P", interlace=False))
    cat["gif-pillow-L"] = (".gif", lambda r: _pillow(
        smooth(r, *MID)[:, :, 0], "GIF"))
    cat["gif-pillow-transparency"] = (".gif", lambda r: _pillow(
        smooth(r, 9, 13), "GIF", "P", transparency=3))

    def gif_hand(r, local=False, small=False, interlace=True,
                 transparency=None, frames=1, version=b"89a", colours=16,
                 shape=(23, 19)):
        pal = r.integers(0, 256, (colours, 3))
        shape = (13, 17) if small else shape
        fr = []
        for k in range(frames):
            idx = r.integers(0, colours, shape)
            idx[:, 4:9] = idx[:, 4:5]
            fr.append((idx, 3 * small, 5 * small,
                       r.integers(0, 256, (colours, 3)) if local else None,
                       interlace))
        return gif(fr, (23, 27) if small else shape,
                   None if local and k == 0 else pal, transparency, version)

    cat["gif-local-table-small-frame"] = (".gif", lambda r: gif_hand(
        r, local=True, small=True))
    cat["gif-small-frame-transparent"] = (".gif", lambda r: gif_hand(
        r, small=True, transparency=5, interlace=False))
    cat["gif-87a-4-colours"] = (".gif", lambda r: gif_hand(
        r, version=b"87a", colours=4))
    cat["gif-2-colours-animated"] = (".gif", lambda r: gif_hand(
        r, colours=2, frames=3))
    cat["gif-256-colours-table-full"] = (".gif", lambda r: gif_hand(
        r, colours=256, shape=(64, 96)))  # past 4,096 codes: Clears
    cat["gif-gray-table"] = (".gif", lambda r: gif(
        [(r.integers(0, 16, (7, 9)), 0, 0, None, False)], (7, 9),
        np.repeat(np.arange(16), 3).reshape(16, 3)))

    def few(r, n, shape=(23, 37), c=3):
        """``n`` colours (and alpha, for c = 4) in blocks."""
        pal = r.integers(0, 256, (n, c), np.uint8)
        idx = r.integers(0, n, shape)
        idx[:, 5:12] = idx[:, 5:6]
        return pal[idx]

    for name, arr, kw in (
            ("lossless", lambda r: smooth(r, *MID), {}),
            ("lossless-m0", lambda r: smooth(r, *MID), {"method": 0}),
            ("lossless-m6-q100", lambda r: smooth(r, 31, 43, noise=3),
             {"method": 6, "quality": 100}),
            ("lossless-noise", lambda r: r.integers(0, 256, (17, 29, 3),
                                                    np.uint8), {}),
            ("lossless-2-colours", lambda r: few(r, 2), {}),
            ("lossless-4-colours", lambda r: few(r, 4), {}),
            ("lossless-11-colours", lambda r: few(r, 11), {}),
            ("lossless-200-colours", lambda r: few(r, 200, (40, 50)), {}),
            ("lossless-rgba", lambda r: np.dstack([smooth(r, *MID), smooth(
                r, *MID, 1)]), {"exact": True}),
            ("lossless-1x1", lambda r: smooth(r, 1, 1), {}),
            ("lossless-wide", lambda r: smooth(r, 3, 301), {})):
        cat[f"webp-{name}"] = (".webp", lambda r, a=arr, k=kw: _pillow(
            a(r), "WEBP", lossless=True, **k))

    for q in (5, 30, 75, 100):
        cat[f"webp-lossy-q{q}"] = (".webp", lambda r, q=q: _pillow(
            smooth(r, 37, 53, noise=6), "WEBP", quality=q))
    cat["webp-lossy-noise-m6"] = (".webp", lambda r: _pillow(
        r.integers(0, 256, (33, 35, 3), np.uint8), "WEBP", quality=60,
        method=6))
    cat["webp-lossy-odd-1x1"] = (".webp", lambda r: _pillow(
        smooth(r, 1, 1), "WEBP"))
    cat["webp-lossy-odd-17x5"] = (".webp", lambda r: _pillow(
        smooth(r, 17, 5), "WEBP", quality=90))
    cat["webp-lossy-blocks-m0"] = (".webp", lambda r: _pillow(
        few(r, 6, (48, 64)), "WEBP", quality=40, method=0))
    cat["webp-lossy-alpha"] = (".webp", lambda r: _pillow(
        np.dstack([smooth(r, 21, 30), smooth(r, 21, 30, 1)]), "WEBP",
        quality=70))
    cat["webp-lossy-alpha-lossy"] = (".webp", lambda r: _pillow(
        np.dstack([smooth(r, 21, 30), smooth(r, 21, 30, 1)]), "WEBP",
        quality=70, alpha_quality=40))
    cat["webp-lossy-sharp-yuv"] = (".webp", lambda r: _pillow(
        smooth(r, 30, 26), "WEBP", quality=85, use_sharp_yuv=True))

    lossy = lambda r, q=75, m=4: _pillow(smooth(r, 37, 53, noise=6),
                                         "WEBP", quality=q, method=m)
    for name, kw in (("simple-filter", dict(simple=True)),
                     ("simple-filter-sharp7", dict(simple=True, level=40,
                                                   sharpness=7)),
                     ("filter-off", dict(level=0)),
                     ("filter-63-sharp7", dict(level=63, sharpness=7)),
                     ("filter-60-sharp3", dict(level=60, sharpness=3)),
                     ("filter-deltas", dict(level=30, deltas=(
                         5, -3, 2, 0, -12, 7, 0, 31)))):
        cat[f"webp-lossy-{name}"] = (".webp", lambda r, kw=kw: vp8_refilter(
            lossy(r, 30), **kw))

    cat["webp-lossless-hand"] = (".webp", lambda r: webp_lossless(
        smooth(r, 29, 31, noise=4)))
    cat["webp-lossless-hand-flat"] = (".webp", lambda r: webp_lossless(
        np.full((3, 5, 3), 77, np.uint8)))
    cat["webp-animated-offset-lossless"] = (".webp", lambda r: webp_animation(
        [(_pillow(smooth(r, 9, 11), "WEBP", lossless=True), 4, 6),
         (_pillow(smooth(r, 20, 24), "WEBP", lossless=True), 0, 0)],
        (24, 20)))
    cat["webp-animated-lossy-alpha"] = (".webp", lambda r: webp_animation(
        [(_pillow(np.dstack([smooth(r, 13, 17), smooth(r, 13, 17, 1)]),
                  "WEBP", quality=50), 2, 0),
         (_pillow(smooth(r, 13, 17), "WEBP"), 0, 0)], (21, 19)))
    cat["webp-animated-pillow"] = (".webp", lambda r: _pillow_frames(
        [smooth(r, 16, 20) for _ in range(3)], "WEBP", lossless=True))
    cat["webp-lossless-vp8x-exif"] = (".webp", lambda r: _pillow(
        smooth(r, 12, 14), "WEBP", lossless=True,
        exif=b"Exif\0\0II*\0\x08\0\0\0\0\0\0\0\0\0"))

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
    def native_jpeg(r, sampling, shape=(37, 45), q=85):
        from simplestereo_tpu_torch import native
        return native.jpeg_encode(smooth(r, *shape), q, bgr=False,
                                  sampling=sampling)

    for hs in (1, 2, 3, 4):
        for vs in (1, 2, 3, 4):
            if hs * vs <= 8 and (hs, vs) != (1, 1):
                cat[f"jpg-sampling-{hs}x{vs}"] = (
                    ".jpg", lambda r, s=(hs, vs): native_jpeg(r, s))
    cat["jpg-sampling-4x2-wide"] = (".jpg", lambda r: native_jpeg(
        r, (4, 2), (19, 131)))
    cat["jpg-arithmetic"] = (".jpg", lambda r: jpeg_arithmetic(
        smooth(r, 21, 29, noise=4)))
    cat["jpg-arithmetic-gray-restart-dac"] = (".jpg", lambda r:
                                              jpeg_arithmetic(
        smooth(r, 19, 27, 1, noise=9)[:, :, 0], restart=3,
        dac={(0, 0): 0x52, (1, 0): 2}))
    cat["jpg-arithmetic-progressive"] = (".jpg", lambda r: jpeg_arithmetic(
        smooth(r, 21, 29, noise=4), progressive=True, q=3))
    cat["jpg-arithmetic-progressive-gray-restart"] = (
        ".jpg", lambda r: jpeg_arithmetic(smooth(r, 17, 23, 1, noise=20)[
            :, :, 0], progressive=True, restart=2, q=2))
    for psv in range(1, 8):
        cat[f"jpg-lossless-p{psv}"] = (".jpg", lambda r, p=psv: jpeg_lossless(
            smooth(r, 11, 13, noise=30), psv=p))
    cat["jpg-lossless-gray-pt2-restart"] = (".jpg", lambda r: jpeg_lossless(
        smooth(r, 12, 9, 1, noise=50)[:, :, 0], psv=4, pt=2,
        restart_rows=3))
    cat["jpg-pillow-cmyk"] = (".jpg", lambda r: _pillow(
        photo(r), "JPEG", "CMYK"))
    cat["jpg-pillow-cmyk-progressive"] = (".jpg", lambda r: _pillow(
        photo(r, (17, 9)), "JPEG", "CMYK", progressive=True))
    cat["jpg-ycck"] = (".jpg", lambda r: adobe_transform(_pillow(
        photo(r), "JPEG", "CMYK"), 2))
    cat["jpg-cmyk-no-adobe"] = (".jpg", lambda r: adobe_transform(_pillow(
        photo(r), "JPEG", "CMYK"), None))
    cat["jpg-adobe-rgb"] = (".jpg", lambda r: adobe_transform(_pillow(
        photo(r), "JPEG", "RGB", subsampling=0), 0, jfif=False))

    def tif_jpeg(r, photo_, shape=(40, 56), sampling=(2, 2), strips=16,
                 tile=None, tables=True, c=3):
        from simplestereo_tpu_torch import native
        s = smooth(r, *shape, c)
        enc = lambda blk: native.jpeg_encode(
            blk.astype(np.uint8)[:, :, 0] if c == 1 else
            blk.astype(np.uint8), 90, bgr=False, sampling=sampling)
        return tiff(s, 8, photo_, comp=7, encode=enc, tile=tile,
                    rows_per_strip=None if tile else strips,
                    jpeg_tables=tables,
                    subsampling=sampling if photo_ == 6 else None)

    cat["tif-pillow-jpeg"] = (".tif", lambda r: _pillow(
        photo(r), "TIFF", compression="jpeg"))
    cat["tif-pillow-jpeg-L"] = (".tif", lambda r: _pillow(
        photo(r, c=1)[:, :, 0], "TIFF", compression="jpeg"))
    cat["tif-jpeg-ycbcr-strips"] = (".tif", lambda r: tif_jpeg(r, 6))
    cat["tif-jpeg-ycbcr-422-no-tables"] = (".tif", lambda r: tif_jpeg(
        r, 6, sampling=(2, 1), strips=8, tables=False))
    cat["tif-jpeg-ycbcr-tiles"] = (".tif", lambda r: tif_jpeg(
        r, 6, tile=(32, 16)))
    cat["tif-jpeg-rgb-tiles"] = (".tif", lambda r: tif_jpeg(
        r, 2, sampling=(1, 1), tile=(16, 32)))
    cat["tif-jpeg-gray"] = (".tif", lambda r: tif_jpeg(
        r, 1, c=1, strips=24))

    return cat


CATALOGUE = _catalogue()


def jpeg_flat(sof=0xC1, precision=12, size=(8, 16)):
    """A real one-component JPEG of a flat image (every block's DC
    difference 0, then EOB) under the Annex K luma tables: with
    ``precision`` 12 and SOF1, the smallest valid 12-bit JPEG; another
    ``sof`` marks the same scan as that frame type."""
    h, w = size
    seg = lambda m, body: bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) \
        + body
    dc_bits = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
    ac_bits = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D])
    ac_vals = bytes([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
        0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
        0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
        0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
        0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
        0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
        0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
        0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
        0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
        0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
    blocks = ((h + 7) // 8) * ((w + 7) // 8)
    bits = _Bits()
    for _ in range(blocks):
        bits.put(0b00, 2)    # DC: category 0
        bits.put(0b1010, 4)  # AC: EOB
    if bits.n:
        bits.put((1 << (8 - bits.n)) - 1, 8 - bits.n)
    scan = bits.bytes().replace(b"\xff", b"\xff\x00")
    pq = 1 if precision > 8 else 0
    return (b"\xff\xd8"
            + seg(0xDB, bytes([pq << 4]) + (b"\x00\x01" if pq else b"\x01")
                  * 64)
            + seg(sof, bytes([precision]) + struct.pack(">HH", h, w)
                  + b"\x01\x01\x11\x00")
            + seg(0xC4, b"\x00" + dc_bits + bytes(range(12)))
            + seg(0xC4, b"\x10" + ac_bits + ac_vals)
            + seg(0xDA, b"\x01\x01\x00\x00\x3f\x00") + scan + b"\xff\xd9")


# ------------------------------------------------ arithmetic-coded JPEG


def _qe_table():
    """T.81 Table D.2, packed as the port's decoder holds it (Qe << 16 |
    next index after an MPS << 8 | switch << 7 | next after an LPS)."""
    return _port_table("_jpeg.cpp", "kAriTab")


class _ArithEncoder:
    """libjpeg's jcarith.c arith_encode and finish_pass (T.81 Annex D's
    QM coder, with its carry handling and 0xFF stuffing)."""

    def __init__(self):
        self.tab = _qe_table()
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = \
            0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats, i, val):
        sv = stats[i]
        qe = self.tab[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            for sh in (19, 11):
                if sh == 11 and not self.c & 0x7F800:
                    break
                b = (self.c >> sh) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _dct_blocks(plane, q):
    """(by, bx, 64) quantised DCT coefficients (natural order) of a plane
    padded to whole blocks: a float DCT, rounded (any coefficients make a
    valid file; these follow the image)."""
    h, w = plane.shape
    p = np.pad(plane.astype(np.float64) - 128,
               ((0, -h % 8), (0, -w % 8)), mode="edge")
    k = np.arange(8)
    basis = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    basis *= np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    blocks = p.reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(
        0, 2, 1, 3)
    coef = basis @ blocks @ basis.T
    return np.round(coef.reshape(*coef.shape[:2], 64) / q).astype(np.int64)


_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19,
           26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49,
           56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52,
           45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def jpeg_arithmetic(img, progressive=False, restart=0, dac=None, q=6):
    """An arithmetic-coded JPEG (SOF9, or SOF10 when ``progressive``) of
    (h, w) gray or (h, w, 3) uint8 samples, coded as YCbCr components of
    their own (no colour conversion: the file has an Adobe marker, so
    libjpeg reads the components as RGB), sampling 1x1, every sample
    quantised by ``q``; ``restart`` MCUs between RSTn markers; ``dac``
    {(class, table): value} for a DAC segment. The progressive script:
    DC first (Al 1) of all components, AC 1-5 and 6-63 first (Al 1) of
    each, then the refinements (DC, AC 1-63) at Al 0. libjpeg's jcarith.c
    encoding, decision by decision."""
    chans = [img] if img.ndim == 2 else [img[:, :, i] for i in range(3)]
    n = len(chans)
    blocks = [_dct_blocks(c, q) for c in chans]
    by, bx = blocks[0].shape[:2]
    dac = dac or {}
    dc_l = {t: dac.get((0, t), 0x10) & 15 for t in range(2)}
    dc_u = {t: dac.get((0, t), 0x10) >> 4 for t in range(2)}
    ac_k = {t: dac.get((1, t), 5) for t in range(2)}
    seg = lambda m, body: bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) \
        + body
    head = b"\xff\xd8" + seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    head += seg(0xDB, b"\x00" + bytes([q]) * 64)
    head += seg(0xCA if progressive else 0xC9, bytes([8]) + struct.pack(
        ">HH", *img.shape[:2]) + bytes([n]) + b"".join(
            bytes([i + 1, 0x11, 0]) for i in range(n)))
    if dac:
        head += seg(0xCC, b"".join(bytes([(c << 4) | t, v])
                                   for (c, t), v in dac.items()))
    if restart:
        head += seg(0xDD, struct.pack(">H", restart))

    def scan(comps, ss, se, ah, al):
        """One scan's bytes (its SOS and the coded data)."""
        out = seg(0xDA, bytes([len(comps)]) + b"".join(
            bytes([c + 1, 0x00]) for c in comps) + bytes([ss, se,
                                                          (ah << 4) | al]))
        data = bytearray()
        enc = _ArithEncoder()
        dc_stats, ac_stats = [0] * 64, [0] * 256
        fixed = [113]
        last = [0] * len(comps)
        ctx = [0] * len(comps)

        def reset():
            dc_stats[:] = [0] * 64
            ac_stats[:] = [0] * 256
            last[:] = [0] * len(comps)
            ctx[:] = [0] * len(comps)

        def dc(i, value):
            st0 = ctx[i]
            v = value - last[i]
            if v == 0:
                enc.encode(dc_stats, st0, 0)
                ctx[i] = 0
                return
            last[i] = value
            enc.encode(dc_stats, st0, 1)
            if v > 0:
                enc.encode(dc_stats, st0 + 1, 0)
                st = st0 + 2
                ctx[i] = 4
            else:
                v = -v
                enc.encode(dc_stats, st0 + 1, 1)
                st = st0 + 3
                ctx[i] = 8
            m = 0
            v -= 1
            if v:
                enc.encode(dc_stats, st, 1)
                m, v2, st = 1, v, 20
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(dc_stats, st, 1)
                    m <<= 1
                    st += 1
            enc.encode(dc_stats, st, 0)
            if m < (1 << dc_l[0]) >> 1:
                ctx[i] = 0
            elif m > (1 << dc_u[0]) >> 1:
                ctx[i] += 8
            st += 14
            while m >> 1:
                m >>= 1
                enc.encode(dc_stats, st, 1 if m & v else 0)

        def ac(zz, k0, k1, al):
            vals = [(z >> al) if z >= 0 else -((-z) >> al) for z in zz]
            ke = k1
            while ke >= k0 and vals[ke] == 0:
                ke -= 1
            k = k0
            while k <= ke:
                st = 3 * (k - 1)
                enc.encode(ac_stats, st, 0)
                while vals[k] == 0:
                    enc.encode(ac_stats, st + 1, 0)
                    st += 3
                    k += 1
                enc.encode(ac_stats, st + 1, 1)
                v = vals[k]
                enc.encode(fixed, 0, 0 if v > 0 else 1)
                v = abs(v)
                st += 2
                m = 0
                v -= 1
                if v:
                    enc.encode(ac_stats, st, 1)
                    m, v2 = 1, v
                    if v2 >> 1:
                        v2 >>= 1
                        enc.encode(ac_stats, st, 1)
                        m <<= 1
                        st = 189 if k <= ac_k[0] else 217
                        while v2 >> 1:
                            v2 >>= 1
                            enc.encode(ac_stats, st, 1)
                            m <<= 1
                            st += 1
                enc.encode(ac_stats, st, 0)
                st += 14
                while m >> 1:
                    m >>= 1
                    enc.encode(ac_stats, st, 1 if m & v else 0)
                k += 1
            if k <= k1:
                enc.encode(ac_stats, 3 * (k - 1), 1)

        def ac_refine(zz, k0, k1, ah, al):
            absval = [abs(z) for z in zz]
            ke = k1
            while ke >= k0 and not absval[ke] >> al:
                ke -= 1
            kex = ke
            while kex >= k0 and not absval[kex] >> ah:
                kex -= 1
            k = k0
            while k <= ke:
                st = 3 * (k - 1)
                if k > kex:
                    enc.encode(ac_stats, st, 0)
                while True:
                    v = absval[k] >> al
                    if v:
                        if v >> 1:
                            enc.encode(ac_stats, st + 2, v & 1)
                        else:
                            enc.encode(ac_stats, st + 1, 1)
                            enc.encode(fixed, 0, 1 if zz[k] < 0 else 0)
                        break
                    enc.encode(ac_stats, st + 1, 0)
                    st += 3
                    k += 1
                k += 1
            if k <= k1:
                enc.encode(ac_stats, 3 * (k - 1), 1)

        units = [(y, x) for y in range(by) for x in range(bx)]
        for u, (y, x) in enumerate(units):
            if restart and u and u % restart == 0:
                data += enc.finish() + bytes([0xFF, 0xD0 + (u // restart - 1)
                                              % 8])
                enc = _ArithEncoder()
                reset()
            for i, c in enumerate(comps):
                zz = [int(blocks[c][y, x, _ZIGZAG[k]]) for k in range(64)]
                if not progressive:
                    dc(i, zz[0])
                    ac(zz, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    dc(i, zz[0] >> al)
                elif ss == 0:
                    enc.encode(fixed, 0, (zz[0] >> al) & 1)
                elif ah == 0:
                    ac(zz, ss, se, al)
                else:
                    ac_refine(zz, ss, se, ah, al)
        return out + bytes(data) + enc.finish()

    comps = list(range(n))
    if not progressive:
        body = scan(comps, 0, 63, 0, 0)
    else:
        body = scan(comps, 0, 0, 0, 1)
        for c in comps:
            body += scan([c], 1, 5, 0, 1) + scan([c], 6, 63, 0, 1)
        body += scan(comps, 0, 0, 1, 0)
        for c in comps:
            body += scan([c], 1, 63, 1, 0)
    return head + body + b"\xff\xd9"


def jpeg_lossless(img, psv=1, pt=0, restart_rows=0):
    """A lossless JPEG (SOF3) of (h, w) gray or (h, w, 3) uint8 samples:
    predictor ``psv`` (1-7), point transform ``pt``, a restart every
    ``restart_rows`` rows; the differences Huffman-coded with the Annex K
    luma DC table; three components are marked RGB (Adobe transform 0)."""
    chans = [img] if img.ndim == 2 else [img[:, :, i] for i in range(3)]
    h, w = img.shape[:2]
    dc_bits = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
    codes, code, k = {}, 0, 0
    for length, count in enumerate(dc_bits, 1):
        for _ in range(count):
            codes[k] = (code, length)
            code += 1
            k += 1
        code <<= 1
    bits = _Bits()
    stuffed = bytearray()

    def flush_segment():
        if bits.n:
            bits.put((1 << (8 - bits.n)) - 1, 8 - bits.n)
        stuffed.extend(bits.bytes().replace(b"\xff", b"\xff\x00"))
        bits.out.clear()

    samples = [c.astype(np.int64) >> pt for c in chans]
    rst = 0
    for y in range(h):
        if y and restart_rows and y % restart_rows == 0:
            flush_segment()
            stuffed.extend(bytes([0xFF, 0xD0 + rst % 8]))
            rst += 1
        first = y % restart_rows == 0 if restart_rows else y == 0
        for x in range(w):
            for s in samples:
                if first:
                    pred = 1 << (8 - pt - 1) if x == 0 else s[y, x - 1]
                elif x == 0:
                    pred = s[y - 1, x]
                else:
                    ra, rb, rc = s[y, x - 1], s[y - 1, x], s[y - 1, x - 1]
                    pred = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                            rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv - 1]
                diff = (int(s[y, x]) - int(pred)) % 65536
                if diff > 32768:
                    diff -= 65536
                cat = int(abs(diff)).bit_length()
                bits.put(*codes[cat])
                if cat:
                    bits.put((diff if diff > 0 else diff - 1)
                             & ((1 << cat) - 1), cat)
    flush_segment()
    seg = lambda m, body: bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) \
        + body
    n = len(chans)
    out = b"\xff\xd8"
    if n == 3:
        out += seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    out += seg(0xC3, bytes([8]) + struct.pack(">HH", h, w) + bytes([n])
               + b"".join(bytes([i + 1, 0x11, 0]) for i in range(n)))
    out += seg(0xC4, b"\x00" + bytes(dc_bits) + bytes(range(12)))
    if restart_rows:
        out += seg(0xDD, struct.pack(">H", restart_rows * w))
    out += seg(0xDA, bytes([n]) + b"".join(bytes([i + 1, 0])
                                            for i in range(n))
               + bytes([psv, 0, pt]))
    return out + bytes(stuffed) + b"\xff\xd9"


def _refused():
    """Files that Pillow refuses as well: {name: (extension, builder,
    what the port's ValueError names)}."""
    ref = {}
    ref["tif-ycbcr-raw"] = (".tif", lambda r: tiff(
        smooth(r, 8, 12), 8, 6, subsampling=(2, 2)), "uncompressed YCbCr")
    ref["tif-bigtiff-mm"] = (".tif", lambda r: tiff(
        smooth(r, *SHAPE), 8, 2, ">", big=True), "big-endian BigTIFF")
    ref["tif-f64"] = (".tif", lambda r: tiff(
        r.normal(0, 1, SHAPE + (1,)), 64, 1, sample_format=3),
        "float samples of 64 bits")
    ref["tif-g10"] = (".tif", lambda r: tiff(
        r.integers(0, 1024, SHAPE + (1,)), 10, 1), "samples of 10 bits")
    ref["tif-mm-g12"] = (".tif", lambda r: tiff(
        r.integers(0, 4096, SHAPE + (1,)), 12, 1, ">"), "samples of 12 bits")
    ref["tif-mm-u32"] = (".tif", lambda r: tiff(
        r.integers(0, 2**32, SHAPE + (1,)), 32, 1, ">"),
        "samples of 32 bits")
    ref["tif-float16"] = (".tif", lambda r: tiff(
        r.normal(0, 1, SHAPE + (1,)).astype(np.float16), 16, 1,
        sample_format=3), "float samples of 16 bits")
    ref["jpg-12-bit"] = (".jpg", lambda r: jpeg_flat(), "12-bit")
    ref["jpg-hierarchical"] = (".jpg", lambda r: jpeg_flat(0xC5, 8),
                               "hierarchical")
    ref["pfm-colour"] = (".pfm", lambda r: b"PF\n2 1\n-1.0\n" + bytes(24),
                         "colour PFM")
    ref["pam"] = (".pam", lambda r: b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 1\n"
                  b"MAXVAL 255\nTUPLTYPE GRAYSCALE\nENDHDR\n\x00", "PAM")
    jpeg = lambda r: _pillow(smooth(r, 8, 8), "JPEG")
    png_ = lambda r: png(smooth(r, 8, 8), 8, 2)
    ref["bmp-jpeg-payload"] = (".bmp", lambda r: bmp_payload(jpeg(r), 4),
                               "compression JPEG")
    ref["bmp-png-payload"] = (".bmp", lambda r: bmp_payload(png_(r), 5),
                              "compression PNG")
    ref["bmp-32-10-10-10"] = (".bmp", lambda r: bmp(
        r.integers(0, 256, SHAPE + (4,)), 32, comp=3,
        masks=(0x3FF00000, 0xFFC00, 0x3FF)), "bit fields")
    ref["bmp-16-444"] = (".bmp", lambda r: bmp(
        r.integers(0, 65536, SHAPE), 16, comp=3,
        masks=(0xF00, 0xF0, 0xF)), "bit fields")
    ref["bmp-2-bit"] = (".bmp", lambda r: bmp(
        r.integers(0, 4, SHAPE), 2, palette=r.integers(0, 256, (4, 3))),
        "depth 2")
    return ref


def bmp_payload(data, comp):
    """A BMP whose pixels are a JPEG (compression 4) or PNG (5) file."""
    import io
    from PIL import Image
    w, h = Image.open(io.BytesIO(data)).size
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 0, comp, len(data),
                       2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + len(data), 0, 0, 54) + info
            + data)


REFUSED = _refused()


def digest(arr):
    """A short digest of an array's dtype, shape and values."""
    import hashlib
    h = hashlib.sha256(f"{arr.dtype.str} {arr.shape}".encode())
    if arr.dtype == np.bool_:  # Pillow's bool arrays hold bytes 0 and 255
        arr = arr.astype(np.uint8)
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:32]


def large_progressive_jpeg():
    """A 1280x720 progressive JPEG (Pillow's, quality 90, 4:2:0) of slow
    waves: the committed fixture that phase 29 times the progressive
    decoder on (smooth, so it stays small; a photo's file holds more
    coefficients and decodes slower)."""
    return _pillow(_large_waves(), "JPEG", progressive=True, quality=90)


def _large_waves(c=3):
    return smooth(np.random.default_rng(720), 720, 1280, c, noise=0,
                  fmax=0.02)


# The 1280x720 fixtures, Pillow's: {name: (extension, builder)}.
LARGE = {
    "jpg-progressive-1280x720": (".jpg", large_progressive_jpeg),
    "webp-lossy-1280x720": (".webp", lambda: _pillow(
        _large_waves(), "WEBP", quality=75)),
    "jpg-cmyk-1280x720": (".jpg", lambda: _pillow(
        _large_waves(), "JPEG", "CMYK", quality=60)),
    "tif-group4-1280x720": (".tif", lambda: _pillow(
        _large_waves(1)[:, :, 0] > 128, "TIFF", compression="group4")),
}


def make(name, seed=None):
    """(extension, bytes) of the catalogue's (or ``REFUSED``'s) variant
    ``name``, from a Generator seeded by the name (or ``seed``)."""
    ext, fn = CATALOGUE[name] if name in CATALOGUE else REFUSED[name][:2]
    rng = np.random.default_rng(zlib.crc32(name.encode()) if seed is None
                                else seed)
    return ext, fn(rng)
