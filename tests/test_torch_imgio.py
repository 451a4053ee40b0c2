"""PyTorch port: the Pillow-free image reader and writer against Pillow
(through the JAX package's ``imgio``, which reads and writes with it).

PNGs that Pillow writes read back equal (colour as BGR, ``grayscale=True``
as Pillow's ``convert("L")``); the port's PNGs and P5/P6 files read equal
in Pillow; a hand-built PNG for each of the five row filters decodes to
its pixels; 16-bit, palette, interlaced and JPEG files raise ValueError.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import simplestereo_tpu.imgio as jio
from simplestereo_tpu_torch import imgio


def _image(seed=0, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape + (3,), np.uint8)
    img[:10] = np.linspace(0, 255, shape[1]).astype(np.uint8)[None, :, None]
    return img


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_reads_pillow_png(tmp_path, mode):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image()[:, :, ::-1].copy()).convert(mode).save(path)
    for gray in (False, True):
        np.testing.assert_array_equal(imgio.imread(path, grayscale=gray),
                                      jio.imread(path, grayscale=gray))


def test_reads_jax_imwrite(tmp_path):
    img = _image(1)
    for arr, name in ((img, "c.png"), (img[:, :, 1], "g.png")):
        path = str(tmp_path / name)
        jio.imwrite(path, arr)
        for gray in (False, True):
            np.testing.assert_array_equal(imgio.imread(path, gray),
                                          jio.imread(path, gray))


@pytest.mark.parametrize("ext", [".png", ".ppm", ".pgm"])
def test_writes_pillow_reads(tmp_path, ext):
    img = _image(2)
    arr = img[:, :, 0] if ext == ".pgm" else img
    path = str(tmp_path / f"w{ext}")
    imgio.imwrite(path, arr)
    back = np.asarray(Image.open(path))
    expect = arr if arr.ndim == 2 else arr[:, :, ::-1]
    np.testing.assert_array_equal(back, expect)
    np.testing.assert_array_equal(imgio.imread(path, arr.ndim == 2), arr)


def test_pnm_round_trip_and_comment(tmp_path):
    img = _image(3)
    path = tmp_path / "c.ppm"
    Image.fromarray(img[:, :, ::-1].copy()).save(str(path))
    np.testing.assert_array_equal(imgio.imread(str(path)), img)
    h, w = img.shape[:2]
    gray = img[:, :, 2]
    path.write_bytes(f"P5\n# a comment\n{w} {h}\n255\n".encode()
                     + gray.tobytes())
    np.testing.assert_array_equal(imgio.imread(str(path), True), gray)
    np.testing.assert_array_equal(imgio.imread(str(path)),
                                  np.repeat(gray[:, :, None], 3, 2))


def test_float_values_clipped(tmp_path):
    path = str(tmp_path / "f.png")
    vals = np.array([[-5.0, 0.4, 254.9, 300.0]])
    imgio.imwrite(path, vals)
    jio.imwrite(str(tmp_path / "j.png"), vals)
    np.testing.assert_array_equal(imgio.imread(path, True),
                                  jio.imread(str(tmp_path / "j.png"), True))


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _png(w, h, ctype, rows, depth=8, interlace=0):
    """PNG bytes of already-filtered rows (each with its filter byte)."""
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, interlace))
            + _chunk(b"IDAT", zlib.compress(rows))
            + _chunk(b"IEND", b""))


def _filter(img, ftype):
    """Rows of an (h, w, c) uint8 image filtered with one PNG filter."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur = raw[y]
        up = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
    return b"".join(out)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_each_row_filter(tmp_path, ftype):
    img = _image(4, (9, 11))
    path = tmp_path / f"f{ftype}.png"
    path.write_bytes(_png(11, 9, 2, _filter(img[:, :, ::-1], ftype)))
    np.testing.assert_array_equal(imgio.imread(str(path)), img)
    np.testing.assert_array_equal(imgio.imread(str(path)),
                                  jio.imread(str(path)))


def test_idat_split_over_chunks(tmp_path):
    img = _image(5, (8, 6))
    rows = _filter(img[:, :, ::-1], 4)
    z = zlib.compress(rows)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 8, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", z[:7]) + _chunk(b"tEXt", b"k\x00v")
            + _chunk(b"IDAT", z[7:]) + _chunk(b"IEND", b""))
    path = tmp_path / "split.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(imgio.imread(str(path)), img)


@pytest.mark.parametrize("what", ["16-bit", "palette", "interlaced", "JPEG"])
def test_unsupported_raises(tmp_path, what):
    path = tmp_path / "u.png"
    if what == "16-bit":
        Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 900
                        ).save(str(path))
    elif what == "palette":
        Image.fromarray(_image(6)).convert("P").save(str(path))
    elif what == "interlaced":
        path.write_bytes(_png(4, 4, 0, b"\x00" * 20, interlace=1))
    else:
        path = tmp_path / "u.jpg"
        Image.fromarray(_image(6)).save(str(path))
    with pytest.raises(ValueError, match=what.split("-")[0]):
        imgio.imread(str(path))


def test_unsupported_extension(tmp_path):
    with pytest.raises(ValueError, match="extension"):
        imgio.imwrite(str(tmp_path / "x.bmp"), np.zeros((2, 2), np.uint8))
