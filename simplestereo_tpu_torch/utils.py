"""
utils
=====

Host-side helpers: geometry utilities, debug rendering and acquisition,
the port of :mod:`simplestereo_tpu.utils` (numpy only; importing the
original would import jax through its package).

The code is the JAX package's, copied, with one change: :class:`Capture`
decodes image-file sequences with the port's :mod:`.imgio` where the JAX
package uses Pillow, and gives the same frames for every format both
read (a directory is scanned for ``.png .jpg .jpeg .bmp .tif .tiff``
files; a list may name any): ``np.asarray(Image.open(path))`` with the colour channels
reversed to BGR, so the same shape and dtype (bool for bilevel files,
uint16 for 16-bit gray, palette indices for palette files, uint8
otherwise; int32 or float32 for deep PGM, PFM and integer or float
TIFF; a CMYK file's first three channels reversed, Y, M and C, as the
JAX package gives them). A file that :mod:`.imgio` refuses (a TGA, a
JPEG 2000, a 12-bit JPEG, ...) is a driver error, which
:meth:`Capture.get` raises once the grab thread gives up on it, as it does
for any failing source. The threaded grabber is host-only by design; the
drawing helpers are pure numpy so they do not pull OpenCV in.
"""

import threading
import time

import numpy as np


def getCrossProductMatrix(v):
    """3x3 antisymmetric matrix [v]_x representing cross product with ``v``.

    Parity: reference utils.py:213-232 (which returns float32; we keep
    float64 for downstream rectification accuracy).
    """
    v = np.asarray(v, np.float64).ravel()
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )


def moveExtrinsicOriginToFirstCamera(R1, R2, t1, t2):
    """Re-center two cameras' extrinsics into the first camera's frame.

    Given world->camera transforms (R1, t1), (R2, t2), returns the relative
    (R, T) from camera 1 to camera 2 as used by :class:`StereoRig`.
    Parity: reference utils.py:184-210.
    """
    R1 = np.asarray(R1, np.float64)
    R2 = np.asarray(R2, np.float64)
    t1 = np.asarray(t1, np.float64).reshape(-1, 1)
    t2 = np.asarray(t2, np.float64).reshape(-1, 1)
    R = R2 @ R1.T
    t = t2 - R @ t1
    return R, t


def drawLine(img, pt1, pt2, color=(0, 0, 255), thickness=1):
    """Rasterize a line segment into ``img`` in place (numpy Bresenham).

    Minimal replacement for ``cv2.line`` used by the epipolar debug helper.
    """
    h, w = img.shape[:2]
    x0, y0 = int(round(pt1[0])), int(round(pt1[1]))
    x1, y1 = int(round(pt2[0])), int(round(pt2[1]))
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    r = max(int(thickness) // 2, 0)
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xd = np.clip(xs + dx, 0, w - 1)
            yd = np.clip(ys + dy, 0, h - 1)
            inside = (xs + dx >= 0) & (xs + dx < w) & (ys + dy >= 0) & (ys + dy < h)
            img[yd[inside], xd[inside]] = color
    return img


def drawCorrespondingEpipolarLines(img1, img2, F, x1=None, x2=None,
                                   color=(0, 0, 255), thickness=1):
    """Draw corresponding epipolar lines on an (undistorted) image pair.

    For each point in ``x1`` the epipolar line ``F @ p`` is drawn on image 2,
    and the back-correspondence on image 1 (and symmetrically for ``x2``).
    Unlike the reference (utils.py:235-302), which draws in place, copies
    are returned so device-backed (read-only) arrays are accepted.
    """
    F = np.asarray(F, np.float64)
    # inputs may be read-only views of device arrays — make them writable
    img1 = np.array(img1, copy=True)
    img2 = np.array(img2, copy=True)
    x1 = x1 or []
    x2 = x2 or []

    def draw_on(img, line):
        line = np.asarray(line, np.float64).ravel()
        h, w = img.shape[:2]
        if abs(line[1]) < 1e-12:  # vertical
            x = -line[2] / line[0]
            p_from, p_to = (x, 0), (x, h)
        else:
            p_from = (0, -line[2] / line[1])
            p_to = (w, -(line[0] * w + line[2]) / line[1])
        drawLine(img, p_from, p_to, color=color, thickness=thickness)
        return ((p_from[0] + p_to[0]) / 2, (p_from[1] + p_to[1]) / 2)

    for x in x1:
        p = np.array([x[0], x[1], 1.0])
        k = draw_on(img2, F @ p)
        draw_on(img1, F.T @ np.array([k[0], k[1], 1.0]))
    for x in x2:
        p = np.array([x[0], x[1], 1.0])
        k = draw_on(img1, F.T @ p)
        draw_on(img2, F @ np.array([k[0], k[1], 1.0]))
    return img1, img2


class Capture:
    """Threaded continuous frame grabber with pluggable sources.

    TPU-free host-side acquisition, mirroring the reference's ``Capture``
    (utils.py:13-181) which wraps ``cv2.VideoCapture``: a background
    thread continuously grabs the newest frame so ``get()`` never returns
    a stale buffered one. Sources, in place of OpenCV's backends:

    - an ``int`` camera index or a ``/dev/video*`` path — live camera via
      the built-in V4L2 driver (:class:`simplestereo_tpu.v4l2.V4L2Source`;
      raises ``ValueError`` if the device cannot be opened, like the
      reference);
    - a **driver object** implementing the source protocol below (how
      network-stream or vendor-SDK cameras plug in);
    - a callable returning the next frame as a numpy BGR array;
    - a list/iterable of image file paths (decoded with :mod:`.imgio`), or a
      directory path (all images inside, sorted) — the video-file analog
      (control methods return False for these, reference utils.py:131-136).

    Driver/source protocol: ``read() -> frame | None`` (required);
    optional ``release()``, ``get_resolution() -> (w, h)``,
    ``set_resolution(w, h) -> bool``, ``set_frame_rate(fps) -> bool``.

    Parameters
    ----------
    source : int, str, callable, object or list
        See above.
    flipY : bool
        Flip output frames around the y-axis (reference utils.py:42-47).
    loop : bool
        Restart file sequences when exhausted. Default True.

    Use as a context manager, or call :meth:`start` / :meth:`stop`.
    """

    def __init__(self, source, flipY=False, loop=True):
        self._frame = None
        self._lock = threading.Lock()
        self._running = False
        self._thread = None
        self._error = None
        self._error_count = 0
        self._max_consecutive_errors = 100
        self.loop = loop
        self.flipY = flipY
        self._source = None       # driver object, when one is in play
        self.isFile = False       # file-sequence mode (reference parity)

        import os
        if isinstance(source, int) or (
                isinstance(source, str) and source.startswith("/dev/video")):
            from .v4l2 import V4L2Source
            self._source = V4L2Source(source)
            self._next = self._source.read
        elif self._is_driver(source):
            self._source = source
            self._next = source.read
        elif callable(source):
            self._next = source
        elif isinstance(source, str) and self._open_stream(source):
            pass  # _open_stream set self._source / self._next / self.isFile
        else:
            if isinstance(source, (str, bytes)) and os.path.isdir(source):
                exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
                files = sorted(
                    os.path.join(source, f)
                    for f in os.listdir(source)
                    if f.lower().endswith(exts)
                )
            elif isinstance(source, (str, bytes)) and os.path.isfile(source):
                files = [source]
            elif isinstance(source, (str, bytes)):
                raise ValueError(
                    f"Cannot open device! ({source!r} is not a camera "
                    "index, /dev/video* path, video file, stream URL, "
                    "directory or file list)")
            else:
                files = list(source)
            self.isFile = True
            self._files = files
            self._idx = 0

            def next_frame():
                from . import imgio
                from .formats import reversed_rgb
                if self._idx >= len(self._files):
                    if not self.loop or not self._files:
                        return None
                    self._idx = 0
                path = self._files[self._idx]
                self._idx += 1
                # The file's own samples, as np.asarray(Image.open(path))
                # gives them.
                img = imgio.read_samples(path)
                if img.ndim == 3 and img.shape[2] >= 3:
                    # RGB -> BGR, OpenCV-compatible; contiguous, so that
                    # get()'s copy is a memcpy, not an element-by-element
                    # copy of a reversed view (PERF.md, image formats).
                    img = reversed_rgb(img)
                return img

            self._next = next_frame

    @staticmethod
    def _is_driver(source):
        """True when ``source`` implements the Capture driver protocol.

        ``hasattr(source, 'read')`` alone would misroute file-like objects
        (open handles, BytesIO — whose ``read`` returns bytes, not a
        frame), so a driver must also expose at least one protocol extra
        (``get_resolution`` / ``set_resolution`` / ``release``).
        """
        if isinstance(source, (str, bytes)) or not hasattr(source, "read"):
            return False
        return any(hasattr(source, m) for m in
                   ("get_resolution", "set_resolution", "release"))

    def _open_stream(self, source):
        """Route video files and network URLs to a videoio source.

        Parity: the reference Capture accepts video files and URLs via
        cv2.VideoCapture (reference utils.py:51-58). Returns True when a
        source was installed, False when ``source`` is not a video/stream
        spec (it then falls through to the image-sequence branches).
        """
        import os

        from . import videoio

        low = source.lower()
        if low.startswith(("rtsp://", "rtmp://", "udp://", "tcp://")):
            self._source = videoio.FFmpegSource(source)
        elif low.startswith(("http://", "https://")):
            base = low.split("?", 1)[0]
            if base.endswith(videoio.VIDEO_EXTENSIONS) \
                    and videoio.ffmpeg_available():
                self._source = videoio.FFmpegSource(source)
            else:
                self._source = videoio.HTTPMJPEGSource(source)
        elif low.endswith(videoio.VIDEO_EXTENSIONS) and os.path.isfile(source):
            self.isFile = True  # control methods return False (reference)
            if low.endswith(videoio.NATIVE_VIDEO_EXTENSIONS):
                try:
                    self._source = videoio.VideoFileSource(source,
                                                           loop=self.loop)
                except ValueError:
                    if not videoio.ffmpeg_available():
                        raise
                    self._source = videoio.FFmpegSource(source,
                                                        loop=self.loop)
            else:
                self._source = videoio.FFmpegSource(source, loop=self.loop)
        else:
            return False
        self._next = self._source.read
        return True

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        if self._source is not None and hasattr(self._source, "release"):
            self._source.release()

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()

    def _spin(self):
        while self._running:
            # A raising driver (V4L2 glitch, stream hiccup, decode error)
            # must not silently kill the grab thread — that would leave
            # get() serving the last stale frame forever. Record the
            # error (surfaced by get()) and keep spinning on transients.
            try:
                frame = self._next()
            except Exception as e:  # noqa: BLE001 — driver code is arbitrary
                self._error = e
                self._error_count += 1
                if self._error_count >= self._max_consecutive_errors:
                    self._running = False
                    return
                time.sleep(0.01)
                continue
            self._error = None
            self._error_count = 0
            if frame is None:
                time.sleep(0.005)
                continue
            with self._lock:
                self._frame = frame

    def get(self):
        """Latest grabbed frame (or None if nothing arrived yet).

        Raises the driver's error if the grab thread died on repeated
        source failures (so stalls are loud, not silent stale frames).
        """
        if self._error is not None and not self._running \
                and self._thread is not None:
            raise RuntimeError(
                "Capture source failed repeatedly; last error: "
                f"{self._error!r}") from self._error
        with self._lock:
            frame = None if self._frame is None else self._frame.copy()
        if frame is not None and self.flipY:
            frame = np.ascontiguousarray(frame[:, ::-1])
        return frame

    def getResolution(self):
        """Current (width, height) — from the driver when available."""
        if self._source is not None and hasattr(self._source,
                                                "get_resolution"):
            return tuple(self._source.get_resolution())
        f = self.get()
        return None if f is None else (f.shape[1], f.shape[0])

    def setResolution(self, width, height):
        """Set camera resolution. Reference semantics (utils.py:118-150):
        returns False while the grab thread runs, for file sources, and
        for drivers that cannot honor the request; True only when the
        driver confirms the exact resolution."""
        if self._running or self.isFile:
            return False
        if self._source is not None and hasattr(self._source,
                                                "set_resolution"):
            return bool(self._source.set_resolution(width, height))
        return False

    def setFrameRate(self, fps):
        """Set camera frame rate (reference utils.py:165-181 semantics:
        False while running / for files / unsupported)."""
        if self._running or self.isFile:
            return False
        if self._source is not None and hasattr(self._source,
                                                "set_frame_rate"):
            return bool(self._source.set_frame_rate(fps))
        return False

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
        # Stream off a live driver so control methods work again after a
        # start/stop cycle (reference semantics: False only WHILE
        # running) and the camera frees its bus bandwidth.
        if self._source is not None and hasattr(self._source,
                                                "stop_stream"):
            self._source.stop_stream()
