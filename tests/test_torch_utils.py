"""PyTorch port: ``utils`` (Capture and the drawing and extrinsic
helpers) and ``v4l2`` against the JAX package's copies.

Capture's driver, callable, file-sequence, video, flipY and error cases
are the JAX tests' (tests/test_unwrapping_utils.py, tests/test_videoio.py)
run on the port, and where both packages give a frame the frames are
equal: file sequences decode through the port's imgio (PNG, JPEG, BMP,
TIFF) as the JAX package's decode through Pillow, and a file imgio
refuses (a GIF) surfaces from ``get()`` as the driver error. The numpy
helpers and ``yuyv_to_bgr`` are exactly equal.
"""

import io
import time

import numpy as np
import pytest
from PIL import Image

import simplestereo_tpu as jss
import simplestereo_tpu_torch as tss
from simplestereo_tpu import v4l2 as jv4l2
from simplestereo_tpu_torch import utils, v4l2, videoio


def _first(cap, tries=300):
    for _ in range(tries):
        f = cap.get()
        if f is not None:
            return f
        time.sleep(0.01)
    return None


def _grab(mod, source, **kw):
    with mod.utils.Capture(source, **kw) as cap:
        return _first(cap)


def _files(tmp_path, rng, mode, ext, n=3):
    paths = []
    for i in range(n):
        img = rng.integers(0, 255, (8, 10, 3), np.uint8)
        p = str(tmp_path / f"{i}{ext}")
        Image.fromarray(img).convert(mode).save(p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("mode,ext", [("RGB", ".png"), ("L", ".png"),
                                      ("RGBA", ".png"), ("LA", ".png"),
                                      ("RGB", ".jpg"), ("L", ".jpg"),
                                      ("RGB", ".bmp"), ("P", ".bmp"),
                                      ("RGB", ".tif"), ("I;16", ".tif")])
def test_file_sequence_frames_equal_jax(tmp_path, rng, mode, ext):
    paths = _files(tmp_path, rng, mode, ext, n=1)
    ours = _grab(tss, paths)
    theirs = _grab(jss, paths)
    assert ours is not None and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_directory_and_single_file(tmp_path, rng):
    paths = _files(tmp_path, rng, "RGB", ".png")
    f = _grab(tss, str(tmp_path))
    assert f is not None and f.shape == (8, 10, 3)
    assert any(np.array_equal(f, _grab(jss, p)) for p in paths)
    with utils.Capture(paths[0]) as cap:
        assert cap.isFile
        np.testing.assert_array_equal(_first(cap), _grab(jss, paths[0]))


def test_unreadable_file_is_a_driver_error(tmp_path, rng):
    """A TGA file (a format outside the port's: ROADMAP A.3): Pillow reads
    it, the port's imgio refuses it, and the grab thread's error
    surfaces from get() instead of giving no frame."""
    p = str(tmp_path / "f.tga")
    Image.fromarray(rng.integers(0, 255, (8, 10, 3), np.uint8)).save(p)
    cap = utils.Capture([p])
    cap._max_consecutive_errors = 3
    cap.start()
    for _ in range(300):
        if not cap._running:
            break
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="not supported"):
        cap.get()
    cap.stop()


def test_file_sources_refuse_control(tmp_path, rng):
    cap = utils.Capture(_files(tmp_path, rng, "RGB", ".png", n=1))
    assert cap.isFile
    assert cap.setResolution(640, 480) is False
    assert cap.setFrameRate(30) is False


def test_callable_source():
    import itertools
    counter = itertools.count()
    cap = utils.Capture(lambda: np.full((4, 4), next(counter), np.uint8))
    cap.start()
    f = _first(cap)
    cap.stop()
    assert f is not None and f.shape == (4, 4)


class SynthCamera:
    """Synthetic camera implementing the Capture driver protocol."""

    def __init__(self):
        self.w, self.h, self.fps = 16, 12, 30
        self.n = 0

    def read(self):
        self.n += 1
        f = np.zeros((self.h, self.w, 3), np.uint8)
        f[:, : self.w // 2] = (self.n % 255, 0, 0)
        return f

    def get_resolution(self):
        return (self.w, self.h)

    def set_resolution(self, w, h):
        self.w, self.h = int(w), int(h)
        return True

    def set_frame_rate(self, fps):
        self.fps = int(fps)
        return True


def test_driver_object_end_to_end():
    cap = utils.Capture(SynthCamera())
    assert cap.setResolution(32, 24) is True
    assert cap.setFrameRate(15) is True
    assert cap.getResolution() == (32, 24)
    cap.start()
    assert cap.setResolution(64, 48) is False
    assert cap.setFrameRate(60) is False
    f = _first(cap)
    cap.stop()
    assert f is not None and f.shape == (24, 32, 3)
    assert cap.setResolution(16, 12) is True  # again once stopped


def test_flipY_matches_jax():
    frame = np.zeros((4, 6, 3), np.uint8)
    frame[:, 0] = 255
    ours = _grab(tss, lambda: frame,
                 flipY=True)
    assert (ours[:, -1] == 255).all() and (ours[:, 0] == 0).all()
    np.testing.assert_array_equal(ours, _grab(jss, lambda: frame,
                                              flipY=True))


def test_driver_errors():
    class Broken:
        def read(self):
            raise OSError("bus glitch")

        def release(self):
            pass

    cap = utils.Capture(Broken())
    cap._max_consecutive_errors = 3
    cap.start()
    for _ in range(300):
        if not cap._running:
            break
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="bus glitch"):
        cap.get()

    class Flaky:
        def __init__(self):
            self.n = 0

        def read(self):
            self.n += 1
            if self.n < 3:
                raise OSError("transient")
            return np.full((4, 4, 3), 7, np.uint8)

        def get_resolution(self):
            return (4, 4)

    f = _grab(tss, Flaky())
    assert f is not None and (f == 7).all()


def test_routing_and_open_errors(tmp_path):
    assert not utils.Capture._is_driver(io.BytesIO(b"x"))
    assert utils.Capture._is_driver(SynthCamera())
    with pytest.raises(ValueError, match="Cannot open device"):
        utils.Capture(87)  # no /dev/video87 here
    with pytest.raises(ValueError, match="Cannot open device"):
        utils.Capture("rtsp://example/stream")
    with pytest.raises(ValueError, match="Cannot open device"):
        utils.Capture(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("codec", ["DIB ", "MJPG"])
def test_capture_video_file(tmp_path, codec):
    base = np.linspace(0, 200, 32, dtype=np.float32)
    frames = [np.clip(base[None, :, None] + 10 * i, 0, 255).astype(np.uint8)
              .repeat(3, axis=2).repeat(24, axis=0).reshape(24, 32, 3)
              for i in range(3)]
    p = str(tmp_path / "v.avi")
    with videoio.VideoWriter(p, codec=codec) as wr:
        for f in frames:
            wr.write(f)
    with utils.Capture(p) as cap:
        assert cap.isFile and cap.getResolution() == (32, 24)
        assert isinstance(cap._source, videoio.VideoFileSource)
        got = _first(cap)
    assert min(np.abs(got.astype(int) - f).mean() for f in frames) < 4


def test_move_extrinsic_origin_equals_jax(rng):
    from simplestereo_tpu_torch.geometry.npgeom import rodrigues_to_matrix
    R1 = rodrigues_to_matrix(rng.normal(0, 0.5, 3))
    R2 = rodrigues_to_matrix(rng.normal(0, 0.5, 3))
    t1, t2 = rng.normal(0, 10, 3), rng.normal(0, 10, 3)
    R, t = utils.moveExtrinsicOriginToFirstCamera(R1, R2, t1, t2)
    Rj, tj = jss.utils.moveExtrinsicOriginToFirstCamera(R1, R2, t1, t2)
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    X = rng.normal(0, 5, 3)
    np.testing.assert_allclose(R @ (R1 @ X + t1) + t.ravel(), R2 @ X + t2,
                               atol=1e-9)


@pytest.mark.parametrize("thickness", [1, 3])
def test_draw_epipolar_lines_equals_jax(rng, thickness):
    img1 = rng.integers(0, 255, (72, 128, 3), np.uint8)
    img2 = rng.integers(0, 255, (72, 128, 3), np.uint8)
    img1.setflags(write=False)
    F = np.array([[0, -1e-4, 0.01], [1e-4, 0, -0.02], [-0.01, 0.02, 0.3]])
    kw = dict(x1=[(64, 36), (10, 60)], x2=[(100, 20)], color=(0, 0, 255),
              thickness=thickness)
    o1, o2 = utils.drawCorrespondingEpipolarLines(img1, img2, F, **kw)
    j1, j2 = jss.utils.drawCorrespondingEpipolarLines(img1, img2, F, **kw)
    np.testing.assert_array_equal(o1, j1)
    np.testing.assert_array_equal(o2, j2)
    assert (o1 != img1).any() and (o2 != img2).any()
    a = np.zeros((20, 30, 3), np.uint8)
    b = a.copy()
    utils.drawLine(a, (2, 3), (27.6, 15.2), color=(1, 2, 3), thickness=2)
    jss.utils.drawLine(b, (2, 3), (27.6, 15.2), color=(1, 2, 3), thickness=2)
    np.testing.assert_array_equal(a, b)


def test_cross_product_matrix_equals_jax(rng):
    v = rng.normal(0, 1, 3)
    np.testing.assert_array_equal(utils.getCrossProductMatrix(v),
                                  jss.utils.getCrossProductMatrix(v))


def test_yuyv_to_bgr_equals_jax(rng):
    h, w = 6, 10
    buf = rng.integers(0, 256, (h, w, 2), np.uint8).tobytes()
    np.testing.assert_array_equal(v4l2.yuyv_to_bgr(buf, w, h),
                                  jv4l2.yuyv_to_bgr(buf, w, h))
    y = np.tile(np.arange(0, 255, 26, np.uint8)[:w], (h, 1))
    gray = np.empty((h, w, 2), np.uint8)
    gray[..., 0], gray[..., 1] = y, 128
    out = v4l2.yuyv_to_bgr(gray.tobytes(), w, h)
    for c in range(3):
        np.testing.assert_array_equal(out[..., c], y)
