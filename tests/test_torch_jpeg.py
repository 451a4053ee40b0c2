"""PyTorch port: the native baseline JPEG codec (``native/_jpeg.cpp``)
against Pillow, which the JAX package's ``imgio`` and ``videoio`` use.

Gates: the decoder on bytes that Pillow writes (4:4:4, 4:2:2, 4:2:0,
grayscale, with and without restart markers, odd sizes) within max |d| 1
on 4:4:4 and grayscale and 2 on subsampled images, with at least 99% of
the samples exactly equal (it uses libjpeg's ISLOW IDCT, fancy upsampling
and colour tables, so it is exact in practice); 4:4:0 on the port's own
bytes, decoded by both; a Motion-JPEG frame without DHT segments equal to
the same frame with its tables; the port's encoder decoded by Pillow
within the JAX MJPG test's bar (mean |d| < 4 on smooth frames); errors
for arithmetic-coded progressive (SOF10), CMYK and malformed input
(progressive Huffman files decode: tests/test_torch_imgio_formats.py).
"""

import io
import pathlib

import numpy as np
import pytest
from PIL import Image

import simplestereo_tpu.imgio as jio
from simplestereo_tpu_torch import imgio, native

SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0"}


def _photo(seed, h, w, c=3):
    """Smooth blobs plus noise: a photo-like image with edges."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, c)).astype(np.float32)
    img = np.kron(x, np.ones((4, 4, 1)))[:h, :w]
    img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3
    img = img + rng.normal(0, 6, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _pillow_bytes(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow_decode(data):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if im.mode == "L" else im.convert("RGB"))


def _gate(got, ref, max_diff):
    d = np.abs(got.astype(int) - ref.astype(int))
    assert d.max() <= max_diff, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


@pytest.mark.parametrize("restart", [None, 2])
@pytest.mark.parametrize("sub", [0, 1, 2])
@pytest.mark.parametrize("shape", [(37, 53), (64, 48), (17, 9), (2, 3)])
def test_decoder_matches_pillow(shape, sub, restart):
    img = _photo(sum(shape) + sub, *shape)
    kw = {} if restart is None else dict(restart_marker_blocks=restart)
    data = _pillow_bytes(img, quality=85, subsampling=sub, **kw)
    assert (b"\xff\xdd" in data) == (restart is not None)  # DRI written
    got = native.jpeg_decode(data, bgr=False)
    _gate(got, _pillow_decode(data), 1 if sub == 0 else 2)
    # BGR order is the same samples reversed
    np.testing.assert_array_equal(native.jpeg_decode(data), got[..., ::-1])


@pytest.mark.parametrize("restart", [None, 3])
@pytest.mark.parametrize("shape", [(37, 53), (8, 8), (1, 1)])
def test_decoder_matches_pillow_grayscale(shape, restart):
    img = _photo(7, *shape, c=1)
    kw = {} if restart is None else dict(restart_marker_rows=1)
    data = _pillow_bytes(img, quality=90, **kw)
    got = native.jpeg_decode(data)
    assert got.shape == shape
    _gate(got, _pillow_decode(data), 1)


@pytest.mark.parametrize("sampling", [(1, 2), (2, 1), (2, 2), (1, 1)])
def test_own_bytes_decode_as_pillow(sampling):
    """4:4:0 (which Pillow does not write) and the rest, on the port's
    encoder's bytes."""
    img = _photo(11, 45, 67)
    data = native.jpeg_encode(img, 90, bgr=False, sampling=sampling)
    ref = _pillow_decode(data)
    _gate(native.jpeg_decode(data, bgr=False), ref,
          1 if sampling == (1, 1) else 2)


def _strip_dht(data):
    """The JPEG with every DHT segment removed (as Motion-JPEG cameras
    send frames: AVI1 APP0, no Huffman tables)."""
    out, p = bytearray(data[:2]), 2
    while p < len(data):
        marker = data[p + 1]
        if marker == 0xDA:
            out += data[p:]
            break
        n = (data[p + 2] << 8) | data[p + 3]
        if marker != 0xC4:
            out += data[p:p + 2 + n]
        p += 2 + n
    return bytes(out)


def test_mjpeg_frame_without_huffman_tables():
    img = _photo(3, 40, 56)
    data = _pillow_bytes(img, quality=80)  # Pillow writes Annex K tables
    bare = _strip_dht(data)
    assert b"\xff\xc4" not in bare and len(bare) < len(data)
    np.testing.assert_array_equal(native.jpeg_decode(bare),
                                  native.jpeg_decode(data))
    np.testing.assert_array_equal(native.jpeg_decode(bare, bgr=False),
                                  _pillow_decode(bare))


def test_encoder_read_by_pillow_and_jax_imgio(tmp_path):
    """The JAX MJPG test's frames and bar (tests/test_videoio.py)."""
    base = np.linspace(0, 200, 32, dtype=np.float32)
    for i in range(4):
        f = (np.clip(base[None, :, None] + 10 * i, 0, 255).astype(np.uint8)
             .repeat(3, axis=2).repeat(24, axis=0).reshape(24, 32, 3))
        data = native.jpeg_encode(f, 90)  # BGR in, as videoio writes
        back = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.abs(back[..., ::-1].astype(int) - f).mean() < 4
    # imwrite's .jpg is Pillow's default file (quality 75, 4:2:0)
    img = _photo(5, 30, 41)
    path, ref = str(tmp_path / "p.jpg"), str(tmp_path / "ref.jpg")
    imgio.imwrite(path, img)
    jio.imwrite(ref, img)
    np.testing.assert_array_equal(imgio.imread(path), jio.imread(path))
    _gate(imgio.imread(path), jio.imread(ref), 2)


@pytest.mark.parametrize("shape", [(33, 50), (30, 41), (2, 3)])
def test_encoder_matches_pillow_encoder(shape):
    """Same quality and sampling: the decoded pixels of the port's bytes
    equal those of Pillow's bytes (the IJG tables, forward DCT,
    downsampling and edge padding)."""
    img = _photo(9, *shape)
    for sub, sampling in ((0, (1, 1)), (1, (2, 1)), (2, (2, 2))):
        ours = _pillow_decode(native.jpeg_encode(img, 75, bgr=False,
                                                 sampling=sampling))
        ref = _pillow_decode(_pillow_bytes(img, quality=75, subsampling=sub))
        _gate(ours, ref, 2)


@pytest.mark.parametrize("kind", ["progressive", "truncated", "not-jpeg",
                                  "cmyk"])
def test_errors(tmp_path, kind):
    img = _photo(2, 24, 32)
    if kind == "progressive":  # arithmetic-coded progressive (SOF10) over
        # Huffman-coded scans: decoded now, as libjpeg-turbo decodes it
        data = bytearray(_pillow_bytes(img, progressive=True))
        data[data.index(b"\xff\xc2") + 1] = 0xCA
        np.testing.assert_array_equal(
            native.jpeg_decode(bytes(data), bgr=False),
            np.asarray(Image.open(io.BytesIO(bytes(data)))))
        return
    elif kind == "truncated":
        data = _pillow_bytes(img)
        data, match = data[:len(data) // 2], "truncated"
    elif kind == "cmyk":  # decoded now: Pillow's inverted CMYK samples
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        np.testing.assert_array_equal(native.jpeg_decode(buf.getvalue()),
                                      np.asarray(Image.open(buf)))
        path = str(tmp_path / "c.jpg")
        pathlib.Path(path).write_bytes(buf.getvalue())
        np.testing.assert_array_equal(imgio.imread(path), jio.imread(path))
        return
    else:
        data, match = b"\xff\xd8\x00\x01junk", "frame header"
    with pytest.raises(ValueError, match=match):
        native.jpeg_decode(data)
    path = tmp_path / "e.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        imgio.imread(str(path))


def test_imgio_jpeg_grayscale_matches_jax(tmp_path):
    img = _photo(4, 29, 31)
    path = str(tmp_path / "g.jpg")
    Image.fromarray(img).save(path, quality=92, subsampling=2)
    for gray in (False, True):
        np.testing.assert_array_equal(imgio.imread(path, grayscale=gray),
                                      jio.imread(path, grayscale=gray))
