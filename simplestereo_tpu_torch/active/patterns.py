"""
patterns
========

Structured-light pattern generation: Gray codes and sinusoidal fringes.
A numpy copy of :mod:`simplestereo_tpu.active.patterns`; the PNGs of
:func:`generateGrayCodeImgs` are written by the port's own
:mod:`..imgio` (no Pillow).

The Gray code has the reference's (``cv2.structured_light_GrayCodePattern``)
layout: column patterns first (vertical stripes), then row patterns, each
bit image immediately followed by its inverse; bits are the Gray code
g = i ^ (i >> 1) of the pixel index, most significant bit first.
"""

import os

import numpy as np


def graycode_num_bits(n):
    """Number of bits needed to code indices [0, n)."""
    b = 0
    while (1 << b) < n:
        b += 1
    return max(b, 1)


def graycode_patterns(resolution):
    """Gray-code pattern stack for a (width, height) target.

    Returns (patterns (N, H, W) uint8, n_bits_x, n_bits_y); N =
    2*(n_bits_x + n_bits_y): column-bit images (MSB first, each followed
    by its inverse), then row-bit images.
    """
    width, height = resolution
    nx = graycode_num_bits(width)
    ny = graycode_num_bits(height)
    xs = np.arange(width)
    ys = np.arange(height)
    gx = xs ^ (xs >> 1)
    gy = ys ^ (ys >> 1)
    pats = []
    for b in range(nx - 1, -1, -1):
        bit = ((gx >> b) & 1).astype(np.uint8) * 255
        img = np.broadcast_to(bit[None, :], (height, width))
        pats.append(img)
        pats.append(255 - img)
    for b in range(ny - 1, -1, -1):
        bit = ((gy >> b) & 1).astype(np.uint8) * 255
        img = np.broadcast_to(bit[:, None], (height, width))
        pats.append(img)
        pats.append(255 - img)
    return np.ascontiguousarray(np.stack(pats)), nx, ny


def generateGrayCodeImgs(targetDir, resolution):
    """Generate Gray code patterns and save them as PNGs.

    Parity: active.py:23-64 — saves 0.png, 1.png (inverse), ... plus
    black.png and white.png; returns the number of patterns (black/white
    excluded).
    """
    from ..imgio import imwrite

    width, height = resolution
    pats, _, _ = graycode_patterns(resolution)
    os.makedirs(targetDir, exist_ok=True)
    for i, p in enumerate(pats):
        imwrite(os.path.join(targetDir, f"{i}.png"), p)
    imwrite(os.path.join(targetDir, "black.png"),
            np.zeros((height, width), np.uint8))
    imwrite(os.path.join(targetDir, "white.png"),
            np.full((height, width), 255, np.uint8))
    return len(pats)


def _getCentralPeak(length, period, shift=0):
    """Position of the maximum-intensity peak nearest the image center
    (parity: active.py:67-84)."""
    k = (length / 2) // period
    return period * (k - shift / (2 * np.pi))


def _apply_stripe(row, length, period, shift, stripeColor):
    """Keep only one color channel inside the central-period stripe."""
    peak = _getCentralPeak(length, period, shift)
    left = int(peak - period / 2)
    right = int(left + period)
    if stripeColor in ("r", "red"):
        row[0, left:right, :2] = 0
    elif stripeColor in ("g", "green"):
        row[0, left:right, 0] = 0
        row[0, left:right, 2] = 0
    elif stripeColor in ("b", "blue"):
        row[0, left:right, 1:] = 0
    else:
        raise ValueError("stripeColor value not permitted!")
    return row


def _finalize(row, dims, vertical, dtype):
    full = np.repeat(row.astype(dtype), dims[1], axis=0)
    if vertical:
        full = np.rot90(full, k=3, axes=(0, 1))
    return full


def buildFringe(period, shift=0, dims=(1280, 720), vertical=False,
                stripeColor=None, dtype=np.uint8):
    """Sinusoidal fringe image (parity: active.py:87-148).

    Intensity (1 + cos(2*pi*(x + shift)/period)) / 2, scaled to the dtype
    range; optional single-color central stripe of one period width.
    """
    if vertical:
        dims = (dims[1], dims[0])
    row = ((1 + np.cos(2 * np.pi * (1 / period)
                       * (np.arange(dims[0], dtype=float) + shift)))
           / 2)[None, :]
    if np.dtype(dtype).char in np.typecodes["AllInteger"]:
        row = row * np.iinfo(dtype).max
    if stripeColor is not None:
        row = np.repeat(row[:, :, None], 3, axis=2)
        row = _apply_stripe(row, dims[0], period, shift, stripeColor)
    return _finalize(row, dims, vertical, dtype)


def buildBinaryFringe(period=10, shift=0, dims=(1280, 720), vertical=False,
                      stripeColor=None, dtype=np.uint8):
    """Binary (square-wave) fringe image (parity: active.py:151-213)."""
    if vertical:
        dims = (dims[1], dims[0])
    period = int(period)
    row = np.ones(period, dtype=float)
    row[period // 4:period // 2 + period // 4] = 0
    row = np.resize(row, (1, dims[0]))
    row = row * np.iinfo(dtype).max
    if stripeColor is not None:
        row = np.repeat(row[:, :, None], 3, axis=2)
        row = _apply_stripe(row, dims[0], period, shift, stripeColor)
    return _finalize(row, dims, vertical, dtype)


def buildAnaglyphFringe(period=10, shift=0, dims=(1280, 720),
                        vertical=False, dtype=np.uint8):
    """Anaglyph fringe: B and R sinusoids in antiphase, G central stripe
    (parity: active.py:216-269). B - R suppresses the DC component."""
    if vertical:
        dims = (dims[1], dims[0])
    xs = np.arange(dims[0], dtype=float)
    mx = np.iinfo(dtype).max
    phase = 2 * np.pi * (1 / period) * (xs + shift)
    rowR = mx * ((1 + np.cos(phase)) / 2)[None, :]
    rowB = mx * ((1 + np.cos(phase + np.pi)) / 2)[None, :]
    peak = _getCentralPeak(dims[0], period, shift)
    left = int(peak - period / 2)
    right = int(left + period)
    rowG = np.zeros_like(rowR)
    rowG[0, left:right] = rowR[0, left:right]
    row = np.stack((rowB, rowG, rowR), axis=2)
    return _finalize(row, dims, vertical, dtype)
