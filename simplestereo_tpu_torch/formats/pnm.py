"""PNM (PBM, PGM, PPM) and gray PFM, read as Pillow reads them
(``PpmImagePlugin``).

Binary P4, P5 and P6 and plain (ASCII) P1, P2 and P3 at any maxval from
1 to 65535, and ``Pf``. Pillow's rules, which depart from netpbm's:

- bitmaps (P1, P4) are mode ``1``, a bool array, True where the file says
  white (bit or token 0);
- gray with a maxval above 255 is mode ``I`` (int32): P5 at maxval 65535
  as stored, any other maxval rescaled to 0..65535;
- colour stays ``RGB`` uint8 at every maxval: each sample rescaled to
  0..255, so 16-bit P6 is rounded, not cut to its high byte;
- a maxval other than 255 (and 65535 for P5) is rescaled as
  ``min(out_max, round(v / maxval * out_max))``, Python's round (half to
  even) of a float64; a binary sample above maxval clips, a plain one
  raises;
- ``Pf`` is mode ``F``, float32: little-endian when the scale token is
  negative, big-endian otherwise, rows stored bottom-up.

Header tokens are at most 10 bytes, separated by whitespace; a ``#``
comment runs to the end of its line, and one inside a token leaves the
token going. The raster starts one byte after the last token. Colour PFM
(``PF``) and PAM (``P7``) are not Pillow formats, and raise.
"""

import re

import numpy as np

MAGICS = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"Pf": "F"}
_WHITESPACE = b" \t\n\v\f\r"


def _magic(data):
    """The magic number: up to 6 bytes before the first whitespace."""
    magic = b""
    for c in data[:6]:
        if c in _WHITESPACE:
            break
        magic += bytes([c])
    return magic


def _token(data, pos):
    """(token, offset after its terminating whitespace byte), as
    ``PpmImageFile._read_token`` reads it."""
    token = b""
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1  # the line end (or past the end of the data)
            continue
        token += c
    if not token:
        raise ValueError("PNM: reached the end of the data in the header")
    if len(token) > 10:
        raise ValueError(f"PNM: header token {token[:11]!r} is too long")
    return token, pos


def _rescale(v, maxval, out_max):
    """Pillow's ``min(out_max, round(v / maxval * out_max))``."""
    return np.minimum(np.round(v.astype(np.float64) / maxval * out_max),
                      out_max)


def _plain_tokens(body):
    """The whitespace-separated tokens of a plain raster, comments (``#``
    to the end of the line) taken out."""
    return re.sub(rb"#[^\r\n]*(\r|\n|$)", b"", body).split()


def decode(data):
    magic = _magic(data)
    if magic not in MAGICS:
        if magic[:2] in (b"PF", b"P7"):
            name = "colour PFM (PF)" if magic[:2] == b"PF" else "PAM (P7)"
            raise ValueError(f"{name} is not supported (Pillow does not "
                             "read it either)")
        raise ValueError(f"not a PNM file (magic {magic!r})")
    mode = MAGICS[magic]
    pos = len(magic) + 1
    w, pos = _token(data, pos)
    h, pos = _token(data, pos)
    w, h = int(w), int(h)
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        body = data[pos:]
        if plain:
            bits = b"".join(_plain_tokens(body))
            if bits.strip(b"01"):
                raise ValueError("PBM: invalid token in a plain bitmap")
            if len(bits) < w * h:
                raise ValueError("PBM: not enough image data")
            bits = np.frombuffer(bits, np.uint8, w * h)
            return (bits == 48).reshape(h, w), "1", None
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError("PBM: truncated raster")
        rows = np.frombuffer(body, np.uint8, stride * h).reshape(h, stride)
        return ~np.unpackbits(rows, axis=1)[:, :w].astype(bool), "1", None
    if mode == "F":
        scale, pos = _token(data, pos)
        s = float(scale)
        if s == 0.0 or not np.isfinite(s):
            raise ValueError("PFM: scale must be finite and non-zero")
        if len(data) - pos < 4 * w * h:
            raise ValueError("PFM: truncated raster")
        arr = np.frombuffer(data, "<f4" if s < 0 else ">f4", w * h, pos)
        return arr.reshape(h, w)[::-1].astype(np.float32), "F", None
    maxval, pos = _token(data, pos)
    maxval = int(maxval)
    if not 0 < maxval < 65536:
        raise ValueError(f"PNM: maxval {maxval} is not in 1..65535")
    if mode == "L" and maxval > 255:
        mode = "I"
    bands = 3 if mode == "RGB" else 1
    n = w * h * bands
    out_max, out_dt = (65535, np.int32) if mode == "I" else (255, np.uint8)
    if plain:
        tokens = _plain_tokens(data[pos:])[:n]
        if len(tokens) < n:
            raise ValueError("PNM: not enough image data")
        if any(len(t) > 10 for t in tokens):
            raise ValueError("PNM: token too long in the raster")
        v = np.array([int(t) for t in tokens], np.int64)
        if (v < 0).any() or (v > maxval).any():
            raise ValueError(f"PNM: sample outside 0..{maxval}")
        v = _rescale(v, maxval, out_max)
    else:
        dt = np.dtype(np.uint8 if maxval < 256 else ">u2")
        if len(data) - pos < n * dt.itemsize:
            raise ValueError("PNM: truncated raster")
        v = np.frombuffer(data, dt, n, pos)
        if not (maxval == 255 or maxval == 65535 and mode == "I"):
            v = _rescale(v, maxval, out_max)
    v = v.astype(out_dt).reshape((h, w, 3) if bands == 3 else (h, w))
    return v, mode, None


def encode(arr):
    """Binary P5 (gray) or P6 (RGB) bytes of uint8 ``arr``, maxval 255."""
    magic = b"P5" if arr.ndim == 2 else b"P6"
    h, w = arr.shape[:2]
    return magic + f"\n{w} {h}\n255\n".encode() + arr.tobytes()
