"""PyTorch port: the image formats that the JAX package reads through
Pillow, read without it (``imgio``, ``formats/``, the host C++ of
``native/``), against Pillow.

For every variant of ``image_files.CATALOGUE`` (PNG of every colour type
and depth, plain and Adam7; BMP of every header, depth and compression;
TIFF strips, tiles, planar, big-endian and BigTIFF, every compression
(JPEG and CCITT too) with and without the predictors, float, signed,
32-bit and 12-bit samples, CMYK, CIELab and subsampled YCbCr; baseline,
progressive and CMYK/YCCK JPEG; binary and plain PNM at any maxval and
PFM; GIF; lossless, lossy, alpha and animated WebP), written by Pillow or
built by hand where Pillow cannot write it: ``imgio.imread`` (colour and
gray) array-equal to the JAX package's, ``read_samples`` equal to
``np.asarray(Image.open(path))`` and the ``Capture`` frame equal to the
JAX ``Capture``'s, dtype and shape included. Every variant of
``image_files.REFUSED`` is refused by Pillow and by the port, which names
it. The port's ``.bmp`` and ``.tif`` are Pillow's bytes; a progressive
MJPG frame decodes through ``videoio``; the committed fixtures
(``tests/golden/torch_imgio/``) decode to the arrays Pillow gave when
they were made.
"""

import json
import pathlib
import time

import numpy as np
import pytest
import PIL
from PIL import Image

import image_files
import simplestereo_tpu as jss
import simplestereo_tpu.imgio as jio
import simplestereo_tpu_torch as tss
from simplestereo_tpu import videoio as jvideo
from simplestereo_tpu_torch import imgio, videoio

NAMES = sorted(image_files.CATALOGUE)
FIXTURES = pathlib.Path(__file__).parent / "golden" / "torch_imgio"


def _file(tmp_path, name):
    ext, data = image_files.make(name)
    path = tmp_path / f"{name}{ext}"
    path.write_bytes(data)
    return str(path)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                        b.dtype, b.shape)
    np.testing.assert_array_equal(a, b)


def _grab(mod, paths):
    with mod.utils.Capture(paths) as cap:
        for _ in range(500):
            f = cap.get()
            if f is not None:
                return f
            time.sleep(0.005)
    raise AssertionError(f"{mod.__name__}: Capture gave no frame")


# CIELab: Pillow converts LAB to RGB through LittleCMS's sRGB transform,
# which the port does not replicate; it raises instead (ROADMAP A.3), as
# both packages do for LAB to L.
LAB_TO_RGB_REFUSED = {"tif-pillow-LAB", "tif-mm-lab-lzw"}


@pytest.mark.parametrize("name", NAMES)
def test_imread_equals_jax(tmp_path, name):
    path = _file(tmp_path, name)
    for gray in (False, True):
        try:
            want = jio.imread(path, grayscale=gray)
        except ValueError:  # Pillow's convert refuses: so does the port
            with pytest.raises(ValueError):
                imgio.imread(path, grayscale=gray)
            continue
        if name in LAB_TO_RGB_REFUSED and not gray:
            with pytest.raises(ValueError, match="LAB"):
                imgio.imread(path)
            continue
        _same(imgio.imread(path, grayscale=gray), want)


@pytest.mark.parametrize("name", NAMES)
def test_samples_and_capture_equal_jax(tmp_path, name):
    path = _file(tmp_path, name)
    _same(imgio.read_samples(path), np.asarray(Image.open(path)))
    _same(_grab(tss, [path]), _grab(jss, [path]))


@pytest.mark.parametrize("name", sorted(image_files.REFUSED))
def test_refused_variants_both_refuse(tmp_path, name):
    """Files Pillow refuses (so the JAX package cannot read them): the
    port refuses each with a ValueError naming what it is."""
    path = _file(tmp_path, name)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        Image.open(path).load()
    for fn in (imgio.read_samples, imgio.imread):
        with pytest.raises(ValueError, match=image_files.REFUSED[name][2]):
            fn(path)


def test_cmyk_capture_frame_is_y_m_c(tmp_path):
    """The JAX Capture reverses the first three channels of whatever the
    file holds, so a CMYK file's frame is its Y, M and C samples (ROADMAP
    C, faults of the JAX package); the port keeps that."""
    path = _file(tmp_path, "jpg-pillow-cmyk")
    cmyk = np.asarray(Image.open(path))
    assert cmyk.shape[2] == 4
    _same(_grab(jss, [path]), cmyk[:, :, 2::-1])
    _same(_grab(tss, [path]), cmyk[:, :, 2::-1])


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (37, 53)])
@pytest.mark.parametrize("colour", [False, True])
@pytest.mark.parametrize("ext", [".bmp", ".tif"])
def test_writes_pillows_bytes(tmp_path, ext, colour, shape):
    rng = np.random.default_rng(sum(shape))
    arr = rng.integers(0, 256, shape + ((3,) if colour else ()), np.uint8)
    ours, theirs = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    imgio.imwrite(ours, arr)
    jio.imwrite(theirs, arr)
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
    back = np.asarray(Image.open(ours))
    _same(back, arr[:, :, ::-1] if colour else arr)
    _same(imgio.imread(ours, grayscale=not colour), arr)


def _jpeg_with(data, marker=None, precision=None):
    """Pillow's baseline JPEG bytes with its SOF0 marker (and precision
    byte) replaced: a header of a kind the port refuses."""
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _refused(kind):
    """(file bytes, extension, what a refusal must name) of each kind of
    file that the port refused before it read GIF, WebP, CMYK JPEG and
    the TIFF sample formats."""
    rng = np.random.default_rng(7)
    img = image_files.smooth(rng, 16, 24)
    pillow = lambda fmt, arr=img, mode=None, **kw: image_files._pillow(
        arr, fmt, mode, **kw)
    if kind == "GIF":
        return pillow("GIF"), ".png", "GIF"
    if kind == "WebP":
        return pillow("WEBP"), ".jpg", "WebP"
    if kind == "CMYK JPEG":
        return pillow("JPEG", mode="CMYK"), ".jpg", "CMYK"
    base = pillow("JPEG")
    if kind == "arithmetic JPEG":
        return _jpeg_with(base, 0xC9), ".jpg", "arithmetic"
    if kind == "12-bit JPEG":
        return _jpeg_with(base, precision=12), ".jpg", "12-bit"
    if kind == "lossless JPEG":
        return _jpeg_with(base, 0xC3), ".jpg", "lossless"
    if kind == "hierarchical JPEG":
        return _jpeg_with(base, 0xC5), ".jpg", "hierarchical"
    if kind == "JPEG-in-TIFF":
        return pillow("TIFF", compression="jpeg"), ".tif", "JPEG-in-TIFF"
    if kind == "float TIFF":
        return pillow("TIFF", img[:, :, 0].astype(np.float32)), ".tif", \
            "float"
    assert kind == "32-bit integer TIFF"
    return pillow("TIFF", img[:, :, 0].astype(np.int32)), ".tif", \
        "32-bit integer"


@pytest.mark.parametrize("kind", [
    "GIF", "WebP", "CMYK JPEG", "arithmetic JPEG", "12-bit JPEG",
    "lossless JPEG", "hierarchical JPEG", "JPEG-in-TIFF", "float TIFF",
    "32-bit integer TIFF"])
def test_refused_formats_are_named(tmp_path, kind):
    """Each kind of file the port once refused: where Pillow reads it, the
    port now gives Pillow's arrays (whatever the file's name says; the
    "arithmetic JPEG" is Huffman-coded data under an SOF9 header, which
    both arithmetic decoders read alike); where Pillow refuses it, so
    does the port, naming the kind."""
    data, ext, what = _refused(kind)
    path = str(tmp_path / f"r{ext}")
    pathlib.Path(path).write_bytes(data)
    try:
        im = Image.open(path)
        samples = np.asarray(im)
    except (OSError, ValueError, SyntaxError):
        for fn in (imgio.read_samples, imgio.imread):
            with pytest.raises(ValueError, match=what):
                fn(path)
        return
    _same(imgio.read_samples(path), samples)
    _same(imgio.imread(path, grayscale=True), np.asarray(im.convert("L")))
    _same(imgio.imread(path), np.asarray(im.convert("RGB"))[:, :, ::-1])


@pytest.mark.parametrize("name", [
    "png-rgb8", "bmp-core-24", "tif-rgbx", "tif-pillow-tiff_lzw", "bmp-rle8",
    "pnm-p5-maxval-1023", "pnm-p2-plain-4095", "pfm-big-endian",
    "tif-pillow-F", "tif-pillow-jpeg", "tif-pillow-group4",
    "tif-ycbcr-22-lzw", "tif-pillow-bigtiff", "jpg-pillow-cmyk",
    "gif-pillow-P-interlaced", "webp-lossless", "webp-lossy-q75",
    "webp-lossy-alpha"])
def test_truncated_files_raise(tmp_path, name):
    """Pillow refuses each of these cut to half its bytes; so does the
    port, with a ValueError."""
    ext, data = image_files.make(name)
    path = tmp_path / f"t{ext}"
    path.write_bytes(data[:len(data) // 2])
    with pytest.raises((OSError, ValueError)):
        Image.open(str(path)).load()
    with pytest.raises(ValueError):
        imgio.read_samples(str(path))


@pytest.mark.parametrize("ext", [".webp", ".gif"])
def test_refused_extensions_are_named(tmp_path, ext):
    with pytest.raises(ValueError, match=ext):
        imgio.imwrite(str(tmp_path / f"x{ext}"), np.zeros((2, 2), np.uint8))


# Facts of Pillow's reading that the port follows, each held here against
# Pillow itself: (variant, Pillow's mode, np.asarray's dtype).
FACTS = {
    "png-g16": ("I;16", np.uint16),          # not scaled to 8 bits
    "png-g1": ("1", np.bool_),               # bilevel: bool
    "png-p4": ("P", np.uint8),               # the indices, not colours
    "png-ga16": ("RGBA", np.uint8),          # gray + alpha 16 -> RGBA
    "bmp-pillow-RGBA": ("RGB", np.uint8),    # 32-bit BMP: alpha dropped
    "tif-pillow-I16B": ("I;16B", np.dtype(">u2")),  # big-endian array
    "pfm-big-endian": ("F", np.float32),     # PFM: float32, host order
    "tif-pillow-F": ("F", np.float32),       # float TIFF
    "pnm-p5-maxval-1023": ("I", np.int32),   # deep PGM: int32
    "tif-s16": ("I", np.int32),              # signed 16-bit TIFF: int32
    "tif-u32": ("I", np.int32),              # unsigned 32-bit: wraps
    "tif-g12": ("I;16", np.uint16),          # 12-bit TIFF: not scaled
    "pnm-p6-16bit": ("RGB", np.uint8),       # 16-bit PPM: 8 bits
    "gif-pillow-P": ("P", np.uint8),         # GIF: the indices
    "gif-gray-table": ("L", np.uint8),       # identity gray table: L
    "webp-lossless-rgba": ("RGBA", np.uint8),  # WebP with alpha
    "webp-lossy-q75": ("RGB", np.uint8),     # WebP without alpha
    "jpg-pillow-cmyk": ("CMYK", np.uint8),   # CMYK JPEG, inverted
    "tif-pillow-CMYK": ("CMYK", np.uint8),
    "tif-pillow-LAB": ("LAB", np.uint8),     # CIELab: the raw samples
}


@pytest.mark.parametrize("name", sorted(FACTS))
def test_pillow_facts(tmp_path, name):
    path = _file(tmp_path, name)
    im = Image.open(path)
    mode, dtype = FACTS[name]
    assert im.mode == mode and np.asarray(im).dtype == dtype
    assert imgio.read_samples(path).dtype == dtype


def test_16bit_gray_clips_at_255(tmp_path):
    """A 16-bit capture read as gray saturates (Pillow's convert("L")
    clips; it does not take the high byte), in both packages."""
    a = np.array([[0, 200, 255, 256, 4000, 65535]], np.uint16)
    path = str(tmp_path / "g16.png")
    Image.fromarray(a).save(path)
    expect = np.array([[0, 200, 255, 255, 255, 255]], np.uint8)
    _same(jio.imread(path, grayscale=True), expect)
    _same(imgio.imread(path, grayscale=True), expect)
    _same(imgio.imread(path), np.repeat(expect[:, :, None], 3, 2))


@pytest.mark.parametrize("mode", ["F", "I", "I;16S", "CMYK"])
def test_convert_at_the_clip_points(tmp_path, mode):
    """Pillow's convert("L") and convert("RGB") of float, 32-bit and signed
    16-bit integer and CMYK samples at and beyond their clip points (0
    and 255; NaN and the infinities for float), as the JAX package gives
    them, from TIFF files holding them."""
    if mode == "F":
        v = np.array([-1e30, -np.inf, -1, -0.5, 0, 0.3, 0.99, 1, 1.5, 127.5,
                      254.9, 255, 255.5, 256, 1e30, np.inf, np.nan],
                     np.float32)[None, :, None]
        data = image_files.tiff(v, 32, 1, sample_format=3)
    elif mode == "I":
        v = np.array([-2**31, -256, -1, 0, 1, 127, 254, 255, 256, 65535,
                      2**31 - 1])[None, :, None]
        data = image_files.tiff(v, 32, 1, sample_format=2)
    elif mode == "I;16S":
        v = np.array([-32768, -1, 0, 1, 254, 255, 256, 32767])[None, :, None]
        data = image_files.tiff(v, 16, 1, ">", sample_format=2)
    else:
        v = np.array([[0, 0, 0, 0], [255, 0, 0, 0], [0, 255, 0, 128],
                      [255, 255, 255, 255], [1, 2, 254, 1], [128, 127, 1, 254],
                      [10, 20, 30, 40]])[None]
        data = image_files.tiff(v, 8, 5)
    path = tmp_path / "c.tif"
    path.write_bytes(data)
    assert Image.open(str(path)).mode == ("I" if mode == "I;16S" else mode)
    for gray in (False, True):
        _same(imgio.imread(str(path), grayscale=gray),
              jio.imread(str(path), grayscale=gray))


def test_trns_changes_no_pixel(tmp_path):
    s = np.arange(12).reshape(3, 4, 1) % 7
    pal = np.arange(21).reshape(7, 3) * 12
    plain, trns = tmp_path / "a.png", tmp_path / "b.png"
    plain.write_bytes(image_files.png(s, 8, 3, pal))
    trns.write_bytes(image_files.png(s, 8, 3, pal, trns=b"\x00\x40"))
    for gray in (False, True):
        _same(imgio.imread(str(trns), gray), imgio.imread(str(plain), gray))
        _same(imgio.imread(str(trns), gray), jio.imread(str(trns), gray))


def test_progressive_mjpg_frame_through_videoio(tmp_path, monkeypatch):
    """An MJPG AVI whose frames are progressive JPEGs (Pillow's, with
    successive approximation) decodes through the port's videoio to the
    JAX package's (Pillow's) pixels."""
    rng = np.random.default_rng(3)
    frames = [image_files.smooth(rng, 24, 40) for _ in range(2)]
    prog = lambda f, q: image_files._pillow(f[:, :, ::-1].copy(), "JPEG",
                                            progressive=True, quality=q)
    monkeypatch.setattr(videoio, "_jpeg_encode", prog)
    path = tmp_path / "p.avi"
    with videoio.VideoWriter(str(path), codec="MJPG") as wr:
        for f in frames:
            wr.write(f)
    got = []
    for mod in (videoio, jvideo):
        src = mod.VideoFileSource(str(path), loop=False)
        got.append([src.read() for _ in frames])
        src.release()
    for a, b in zip(*got):
        _same(a, b)


def _stored():
    with np.load(FIXTURES / "pillow.npz") as z:
        return {k: z[k] for k in z.files}


STORED = _stored()
META = json.loads((FIXTURES / "fixtures.json").read_text())


def _fixture(name):
    """(path, [samples, L, RGB]): Pillow's stored arrays, None where its
    convert refused."""
    path = str(FIXTURES / META["files"][name])
    samples = STORED[f"{name}/samples"]
    refused = META["refuses"].get(name, [])
    return path, [samples] + [None if k in refused else
                              STORED.get(f"{name}/{k}", samples)
                              for k in ("L", "RGB")]


@pytest.mark.parametrize("name", sorted(META["files"]))
def test_fixture_port_equals_stored(name):
    """The port against what Pillow gave when the fixtures were made
    (make_fixtures.py); chip_smoke.py's phase 29 holds the card's host to
    the same arrays."""
    path, (samples, gray, rgb) = _fixture(name)
    _same(imgio.read_samples(path), samples)
    for want, kw in ((gray, {"grayscale": True}), (rgb, {})):
        if want is None or (name in LAB_TO_RGB_REFUSED and not kw):
            with pytest.raises(ValueError):
                imgio.imread(path, **kw)
        else:
            got = imgio.imread(path, **kw)
            _same(got, want if kw else want[:, :, ::-1])


def _convert(im, mode):
    try:
        return np.asarray(im.convert(mode))
    except ValueError:
        return None


@pytest.mark.parametrize("name", sorted(META["files"]))
def test_fixture_pillow_equals_stored(name):
    path, stored = _fixture(name)
    im = Image.open(path)
    pil = [np.asarray(im), _convert(im, "L"), _convert(im, "RGB")]
    same = all((a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and a.shape == b.shape and np.array_equal(a, b, equal_nan=True))
        for a, b in zip(pil, stored))
    if not same and PIL.__version__ != META["pillow"]:
        pytest.skip(f"Pillow {PIL.__version__} reads {name} otherwise than "
                    f"Pillow {META['pillow']}, which made the fixtures")
    for a, b in zip(pil, stored):
        assert (a is None) == (b is None)
        if a is not None:
            _same(a, b)


def test_large_fixtures_equal_stored_digests():
    for name, rec in META["large"].items():
        path = str(FIXTURES / rec["file"])
        for key, arr in (("samples", imgio.read_samples(path)),
                         ("L", imgio.imread(path, grayscale=True))):
            assert image_files.digest(arr) == rec[key], (name, key)


def test_fixtures_cover_the_catalogue():
    assert set(META["files"]) >= set(NAMES)
