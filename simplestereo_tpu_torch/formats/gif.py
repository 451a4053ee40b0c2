"""GIF, the first frame, read as Pillow reads it (``GifImagePlugin``).

The frame's indices come from :func:`..native.gif_lzw`. Pillow's rules
for the first frame:

- the canvas is the logical screen, grown to hold a frame that reaches
  past it; outside the frame it holds the frame's transparency index
  when a graphic control extension sets one, else 0;
- the colour table is the frame's local one, else the global one; a
  table whose every entry i is (i, i, i) is "not needed" and the frame
  opens as mode ``L`` (the indices are the gray levels), else as ``P``
  with the table as its palette (entries past the table's end black);
- interlaced rows (passes from rows 0, 4, 2 and 1, every 8, 8, 4 and 2
  rows) are put back in order; the transparency index changes no pixel.

Later frames, whose disposal and blending make Pillow switch to RGB or
RGBA, are not read: Pillow's ``np.asarray`` of the file is the first.
"""

import struct

import numpy as np

from . import pad_palette
from .. import native


def _table(data, pos, flags):
    """(colour table bytes or None, position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 3 << ((flags & 7) + 1)
    if pos + n > len(data):
        raise ValueError("GIF: truncated colour table")
    return data[pos:pos + n], pos + n


def _needed(table):
    """Pillow's _is_palette_needed: False for the identity gray ramp."""
    t = np.frombuffer(table, np.uint8).reshape(-1, 3)
    return not (np.all(t == np.arange(len(t))[:, None]))


def _skip_blocks(data, pos):
    """The position after a chain of data sub-blocks and its terminator."""
    while True:
        if pos >= len(data):
            raise ValueError("GIF: truncated data sub-blocks")
        n = data[pos]
        pos += 1 + n
        if n == 0:
            return pos


def decode(data):
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("not a GIF file")
    sw, sh, flags = struct.unpack_from("<HHB", data, 6)
    glob, pos = _table(data, 13, flags)
    palette = glob if glob is not None and _needed(glob) else None
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("GIF: no image in the file")
        kind = data[pos]
        if kind == 0x21:  # extension
            label = data[pos + 1]
            if label == 0xF9 and data[pos + 2] >= 4 and data[pos + 3] & 1:
                transparency = data[pos + 6]
            pos = _skip_blocks(data, pos + 2)
        elif kind == 0x2C:  # image descriptor
            break
        else:
            raise ValueError(f"GIF: unknown block 0x{kind:02X}")
    if pos + 11 > len(data):
        raise ValueError("GIF: truncated image descriptor")
    x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos + 1)
    local, pos = _table(data, pos + 10, fflags)
    if local is not None:
        palette = local if _needed(local) else None
    min_size = data[pos]
    w, h = max(sw, x0 + fw), max(sh, y0 + fh)
    idx = np.empty(fw * fh, np.uint8)
    n = native.gif_lzw(data[pos + 1:], min_size, idx)
    if n < idx.size:
        raise ValueError(f"GIF: the image data ends after {n} of "
                         f"{idx.size} pixels")
    frame = idx.reshape(fh, fw)
    if fflags & 0x40:  # interlaced: the rows of the four passes in order
        order = np.concatenate([np.arange(s, fh, step) for s, step in
                                ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = np.empty_like(frame)
        rows[order] = frame
        frame = rows
    canvas = np.full((h, w), transparency or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return canvas, "L", None
    return canvas, "P", pad_palette(np.frombuffer(palette, np.uint8))
