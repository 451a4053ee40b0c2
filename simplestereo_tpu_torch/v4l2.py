"""
v4l2
====

Minimal Video4Linux2 camera driver (ctypes ioctls, no OpenCV).

The port of :mod:`simplestereo_tpu.v4l2`, copied as it is (importing it
would import jax through its package). Gives :class:`.utils.Capture` a
live-camera backend with
the same capabilities the reference gets from ``cv2.VideoCapture``
(reference utils.py:13-181): open by device index or ``/dev/video*``
path, MMAP streaming capture, resolution and frame-rate control.

Scope: YUYV (``V4L2_PIX_FMT_YUYV``) and raw BGR/RGB formats — the
baseline formats every UVC webcam exposes. The YUYV->BGR conversion is a
vectorized numpy BT.601 transform (testable without hardware:
:func:`yuyv_to_bgr`).
"""

import ctypes
import fcntl
import mmap
import os
import select

import numpy as np


# ---------------------------------------------------------------------------
# ioctl plumbing (linux/videodev2.h)
# ---------------------------------------------------------------------------

_IOC_NRBITS, _IOC_TYPEBITS, _IOC_SIZEBITS = 8, 8, 14
_IOC_NRSHIFT = 0
_IOC_TYPESHIFT = _IOC_NRSHIFT + _IOC_NRBITS
_IOC_SIZESHIFT = _IOC_TYPESHIFT + _IOC_TYPEBITS
_IOC_DIRSHIFT = _IOC_SIZESHIFT + _IOC_SIZEBITS
_IOC_WRITE, _IOC_READ = 1, 2


def _IOC(d, t, nr, size):
    return ((d << _IOC_DIRSHIFT) | (ord(t) << _IOC_TYPESHIFT)
            | (nr << _IOC_NRSHIFT) | (size << _IOC_SIZESHIFT))


def _IOWR(t, nr, struct):
    return _IOC(_IOC_READ | _IOC_WRITE, t, nr, ctypes.sizeof(struct))


def _IOW(t, nr, struct):
    return _IOC(_IOC_WRITE, t, nr, ctypes.sizeof(struct))


def _fourcc(code):
    return (ord(code[0]) | (ord(code[1]) << 8) | (ord(code[2]) << 16)
            | (ord(code[3]) << 24))


V4L2_PIX_FMT_YUYV = _fourcc("YUYV")
V4L2_PIX_FMT_BGR24 = _fourcc("BGR3")
V4L2_PIX_FMT_RGB24 = _fourcc("RGB3")

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_BUF_FLAG_ERROR = 0x0040
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_NONE = 1
V4L2_CAP_VIDEO_CAPTURE = 0x00000001


class _v4l2_capability(ctypes.Structure):
    _fields_ = [("driver", ctypes.c_char * 16),
                ("card", ctypes.c_char * 32),
                ("bus_info", ctypes.c_char * 32),
                ("version", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("device_caps", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 3)]


class _v4l2_pix_format(ctypes.Structure):
    _fields_ = [("width", ctypes.c_uint32),
                ("height", ctypes.c_uint32),
                ("pixelformat", ctypes.c_uint32),
                ("field", ctypes.c_uint32),
                ("bytesperline", ctypes.c_uint32),
                ("sizeimage", ctypes.c_uint32),
                ("colorspace", ctypes.c_uint32),
                ("priv", ctypes.c_uint32),
                ("flags", ctypes.c_uint32),
                ("enc", ctypes.c_uint32),
                ("quantization", ctypes.c_uint32),
                ("xfer_func", ctypes.c_uint32)]


class _v4l2_format(ctypes.Structure):
    class _fmt(ctypes.Union):
        _fields_ = [("pix", _v4l2_pix_format),
                    ("raw_data", ctypes.c_uint8 * 200)]

    _fields_ = [("type", ctypes.c_uint32), ("fmt", _fmt)]


class _v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [("count", ctypes.c_uint32),
                ("type", ctypes.c_uint32),
                ("memory", ctypes.c_uint32),
                ("capabilities", ctypes.c_uint32),
                ("flags", ctypes.c_uint8),
                ("reserved", ctypes.c_uint8 * 3)]


class _v4l2_timecode(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
                ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
                ("userbits", ctypes.c_uint8 * 4)]


class _timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _v4l2_buffer(ctypes.Structure):
    class _m(ctypes.Union):
        _fields_ = [("offset", ctypes.c_uint32),
                    ("userptr", ctypes.c_ulong),
                    ("planes", ctypes.c_void_p),
                    ("fd", ctypes.c_int32)]

    _fields_ = [("index", ctypes.c_uint32), ("type", ctypes.c_uint32),
                ("bytesused", ctypes.c_uint32), ("flags", ctypes.c_uint32),
                ("field", ctypes.c_uint32), ("timestamp", _timeval),
                ("timecode", _v4l2_timecode), ("sequence", ctypes.c_uint32),
                ("memory", ctypes.c_uint32), ("m", _m),
                ("length", ctypes.c_uint32), ("reserved2", ctypes.c_uint32),
                ("request_fd", ctypes.c_uint32)]


class _v4l2_fract(ctypes.Structure):
    _fields_ = [("numerator", ctypes.c_uint32),
                ("denominator", ctypes.c_uint32)]


class _v4l2_captureparm(ctypes.Structure):
    _fields_ = [("capability", ctypes.c_uint32),
                ("capturemode", ctypes.c_uint32),
                ("timeperframe", _v4l2_fract),
                ("extendedmode", ctypes.c_uint32),
                ("readbuffers", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 4)]


class _v4l2_streamparm(ctypes.Structure):
    class _parm(ctypes.Union):
        _fields_ = [("capture", _v4l2_captureparm),
                    ("raw_data", ctypes.c_uint8 * 200)]

    _fields_ = [("type", ctypes.c_uint32), ("parm", _parm)]


VIDIOC_QUERYCAP = _IOC(_IOC_READ, 'V', 0, ctypes.sizeof(_v4l2_capability))
VIDIOC_S_FMT = _IOWR('V', 5, _v4l2_format)
VIDIOC_G_FMT = _IOWR('V', 4, _v4l2_format)
VIDIOC_REQBUFS = _IOWR('V', 8, _v4l2_requestbuffers)
VIDIOC_QUERYBUF = _IOWR('V', 9, _v4l2_buffer)
VIDIOC_QBUF = _IOWR('V', 15, _v4l2_buffer)
VIDIOC_DQBUF = _IOWR('V', 17, _v4l2_buffer)
VIDIOC_STREAMON = _IOW('V', 18, ctypes.c_int)
VIDIOC_STREAMOFF = _IOW('V', 19, ctypes.c_int)
VIDIOC_S_PARM = _IOWR('V', 22, _v4l2_streamparm)


def yuyv_to_bgr(buf, width, height):
    """YUYV 4:2:2 packed -> (H, W, 3) BGR uint8 (BT.601 full-range).

    Pure numpy, hardware-independent (unit-testable)."""
    a = np.frombuffer(buf, np.uint8, count=width * height * 2)
    a = a.reshape(height, width // 2, 4).astype(np.int32)
    y0, u, y1, v = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    y = np.stack([y0, y1], axis=-1).reshape(height, width)
    u = np.repeat(u, 2, axis=1) - 128
    v = np.repeat(v, 2, axis=1) - 128
    r = y + ((91881 * v) >> 16)
    g = y - ((22554 * u + 46802 * v) >> 16)
    b = y + ((116130 * u) >> 16)
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


class V4L2Source:
    """MMAP-streaming V4L2 capture source (``Capture`` driver protocol:
    ``read``, ``release``, ``get_resolution``, ``set_resolution``,
    ``set_frame_rate``).

    Parameters
    ----------
    device : int or str
        Camera index (``/dev/video<N>``) or device path.
    n_buffers : int
        MMAP ring size. Default 4.
    """

    def __init__(self, device=0, n_buffers=4):
        if isinstance(device, int):
            device = f"/dev/video{device}"
        self.path = device
        self.n_buffers = n_buffers
        self._fd = None
        self._bufs = []
        self._streaming = False
        try:
            self._fd = os.open(device, os.O_RDWR | os.O_NONBLOCK)
        except OSError as e:
            raise ValueError(f"Cannot open device! ({device}: {e})")
        cap = _v4l2_capability()
        try:
            fcntl.ioctl(self._fd, VIDIOC_QUERYCAP, cap)
        except OSError as e:
            os.close(self._fd)
            self._fd = None
            raise ValueError(f"Cannot open device! (not V4L2: {e})")
        if not cap.capabilities & V4L2_CAP_VIDEO_CAPTURE:
            os.close(self._fd)
            self._fd = None
            raise ValueError("Cannot open device! (no capture capability)")
        self._set_format()

    def _set_format(self, width=None, height=None):
        fmt = _v4l2_format()
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        fcntl.ioctl(self._fd, VIDIOC_G_FMT, fmt)
        if width:
            fmt.fmt.pix.width = width
            fmt.fmt.pix.height = height
        # prefer raw BGR, fall back to YUYV (every UVC cam supports it);
        # the driver adjusts the struct to what it actually granted
        for pf in (V4L2_PIX_FMT_BGR24, V4L2_PIX_FMT_YUYV):
            fmt.fmt.pix.pixelformat = pf
            fmt.fmt.pix.field = V4L2_FIELD_NONE
            fcntl.ioctl(self._fd, VIDIOC_S_FMT, fmt)
            if fmt.fmt.pix.pixelformat == pf:
                break
        else:
            # the driver granted something read() cannot decode (e.g. an
            # MJPEG-only camera) — fail at open time like the capability
            # checks, not with a garbled frame later
            raise ValueError(
                "Cannot open device! (camera offers neither BGR24 nor "
                "YUYV; granted fourcc "
                f"0x{int(fmt.fmt.pix.pixelformat):08x})")
        self._fmt = fmt
        self._w = int(fmt.fmt.pix.width)
        self._h = int(fmt.fmt.pix.height)
        self._pf = int(fmt.fmt.pix.pixelformat)
        self._stride = int(fmt.fmt.pix.bytesperline)

    def _start_stream(self):
        req = _v4l2_requestbuffers()
        req.count, req.type, req.memory = (
            self.n_buffers, V4L2_BUF_TYPE_VIDEO_CAPTURE, V4L2_MEMORY_MMAP)
        fcntl.ioctl(self._fd, VIDIOC_REQBUFS, req)
        self._bufs = []
        for i in range(req.count):
            b = _v4l2_buffer()
            b.index, b.type, b.memory = (
                i, V4L2_BUF_TYPE_VIDEO_CAPTURE, V4L2_MEMORY_MMAP)
            fcntl.ioctl(self._fd, VIDIOC_QUERYBUF, b)
            m = mmap.mmap(self._fd, b.length, mmap.MAP_SHARED,
                          mmap.PROT_READ | mmap.PROT_WRITE,
                          offset=b.m.offset)
            self._bufs.append(m)
            fcntl.ioctl(self._fd, VIDIOC_QBUF, b)
        fcntl.ioctl(self._fd, VIDIOC_STREAMON,
                    ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        self._streaming = True

    def read(self, timeout=2.0):
        """Next frame as (H, W, 3) BGR uint8, or None on timeout."""
        if not self._streaming:
            self._start_stream()
        r, _, _ = select.select([self._fd], [], [], timeout)
        if not r:
            return None
        b = _v4l2_buffer()
        b.type, b.memory = V4L2_BUF_TYPE_VIDEO_CAPTURE, V4L2_MEMORY_MMAP
        fcntl.ioctl(self._fd, VIDIOC_DQBUF, b)
        # QBUF must happen even when decoding fails (short/error frames on
        # USB glitches): a dequeued-but-never-requeued buffer leaks out of
        # the MMAP ring, and after n_buffers such events every read times
        # out forever.
        try:
            bpp = 2 if self._pf == V4L2_PIX_FMT_YUYV else 3
            # honor the driver-reported row stride (drivers may pad rows
            # for alignment; V4L2 permits bytesperline > width * bpp)
            stride = max(self._stride, self._w * bpp)
            if (b.flags & V4L2_BUF_FLAG_ERROR) or \
                    b.bytesused < stride * self._h:
                return None
            raw = self._bufs[b.index][: b.bytesused]
            rows = np.frombuffer(raw, np.uint8,
                                 count=stride * self._h).reshape(self._h,
                                                                 stride)
            packed = np.ascontiguousarray(rows[:, : self._w * bpp])
            if self._pf == V4L2_PIX_FMT_YUYV:
                frame = yuyv_to_bgr(packed, self._w, self._h)
            else:
                frame = packed.reshape(self._h, self._w, 3)
                if self._pf == V4L2_PIX_FMT_RGB24:
                    frame = np.ascontiguousarray(frame[:, :, ::-1])
            return frame
        finally:
            fcntl.ioctl(self._fd, VIDIOC_QBUF, b)

    def get_resolution(self):
        return (self._w, self._h)

    def set_resolution(self, width, height):
        if self._streaming:
            return False
        self._set_format(int(width), int(height))
        return (self._w, self._h) == (int(width), int(height))

    def set_frame_rate(self, fps):
        if self._streaming:
            return False
        parm = _v4l2_streamparm()
        parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        parm.parm.capture.timeperframe.numerator = 1
        parm.parm.capture.timeperframe.denominator = int(fps)
        try:
            fcntl.ioctl(self._fd, VIDIOC_S_PARM, parm)
        except OSError:
            return False
        tf = parm.parm.capture.timeperframe
        return tf.denominator == int(fps) and tf.numerator == 1

    def stop_stream(self):
        """Stream off and free the MMAP ring (keeps the device open).

        Called by ``Capture.stop()`` so the camera releases USB bandwidth
        and control methods (``set_resolution``/``set_frame_rate``) work
        again after a start/stop cycle; the next :meth:`read` negotiates
        a fresh ring and streams back on.
        """
        if self._fd is None or not self._streaming:
            return
        try:
            fcntl.ioctl(self._fd, VIDIOC_STREAMOFF,
                        ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        self._streaming = False
        for m in self._bufs:
            m.close()
        self._bufs = []
        req = _v4l2_requestbuffers()
        req.count, req.type, req.memory = (
            0, V4L2_BUF_TYPE_VIDEO_CAPTURE, V4L2_MEMORY_MMAP)
        try:
            fcntl.ioctl(self._fd, VIDIOC_REQBUFS, req)  # free kernel bufs
        except OSError:
            pass

    def release(self):
        if self._fd is None:
            return
        self.stop_stream()
        for m in self._bufs:
            m.close()
        self._bufs = []
        os.close(self._fd)
        self._fd = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
