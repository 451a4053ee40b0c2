"""
formats
=======

The image file formats of :mod:`..imgio` that the JAX package reads and
writes through Pillow: PNG (:mod:`.png`), BMP (:mod:`.bmp`), TIFF
(:mod:`.tiff`), PNM and PFM (:mod:`.pnm`), GIF (:mod:`.gif`) and WebP
(:mod:`.webp`); JPEG is :mod:`..native`'s. Each ``decode(data)`` gives
``(array, mode, palette)``:

- ``array`` is what ``np.asarray(Image.open(path))`` gives for the file:
  (H, W) for one band, (H, W, C) for more; bool for mode ``"1"``, uint16
  for ``"I;16"`` (big-endian ``>u2`` for ``"I;16B"``), int32 for ``"I"``,
  float32 for ``"F"``, uint8 otherwise (palette files: the indices);
- ``mode`` is the Pillow mode the file opens as;
- ``palette`` is the (256, 3) uint8 RGB palette of mode ``"P"`` (entries
  that the file leaves out are black, as in Pillow), else None.

Where Pillow departs from a format's documentation, the decoders follow
Pillow. The byte chains (PNG's row filters, LZW, PackBits, RLE, CCITT,
GIF's LZW, WebP) run in the host C++ of :mod:`..native`; the rest is
whole-array numpy work.
"""

import numpy as np


def unpack_samples(rows, depth, n):
    """(h, n) uint8 samples of ``depth`` 1, 2 or 4 bits from (h, bytes)
    rows, most significant bits first, as PNG, BMP and TIFF pack them."""
    if depth == 8:
        return rows[:, :n]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    out = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return out.reshape(rows.shape[0], -1)[:, :n]


def pad_palette(rgb):
    """(256, 3) uint8: the palette's entries, then black."""
    pal = np.zeros((256, 3), np.uint8)
    rgb = np.asarray(rgb, np.uint8).reshape(-1, 3)[:256]
    pal[:len(rgb)] = rgb
    return pal


def reversed_rgb(a):
    """Contiguous (H, W, 3): channels 2, 1, 0 of (H, W, C >= 3), the
    values of ``a[:, :, 2::-1]`` (RGB(A) <-> BGR). Copied a plane at a
    time: numpy copies the reversed view element by element, about four
    times slower."""
    out = np.empty(a.shape[:2] + (3,), a.dtype)
    for i in range(3):
        out[:, :, i] = a[:, :, 2 - i]
    return out
