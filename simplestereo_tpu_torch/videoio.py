"""
videoio
=======

Video file and network-stream sources for :class:`.utils.Capture`, plus a
matching writer: the port of :mod:`simplestereo_tpu.videoio`.

The code is the JAX package's, copied (importing it would import jax
through its package), with one change: Motion-JPEG frames are decoded and
encoded by the port's own baseline JPEG codec (:mod:`.native`, host C++
built at first use) where the JAX package uses Pillow. Frames that carry
no Huffman tables, as webcam and IP-camera MJPEG frames usually do, decode
with the standard tables, as libjpeg decodes them.

- :class:`VideoFileSource` - pure-Python AVI reader (RIFF parser) for
  MJPG (Motion-JPEG) and uncompressed BGR DIB streams. These are the
  formats :class:`VideoWriter` below produces and what
  ``cv2.VideoWriter(..., 'MJPG'/'DIB ')`` writes, so capture -> write ->
  re-read round-trips inside the framework.
- :class:`HTTPMJPEGSource` - network streams: the standard IP-camera
  ``multipart/x-mixed-replace`` MJPEG-over-HTTP protocol via urllib.
- :class:`FFmpegSource` - any container/codec/protocol (mp4, mkv, rtsp,
  ...) by piping ``ffmpeg -i X -f rawvideo -pix_fmt bgr24 -``; used
  automatically when an ``ffmpeg`` binary is on PATH. Without one it
  raises the same ``ValueError`` as the JAX package.
- :class:`VideoWriter` - AVI writer (MJPG, or lossless raw BGR DIB), the
  ``cv2.VideoWriter`` analog.

All sources implement the Capture driver protocol
(``read() -> frame | None``, optional ``release`` /
``get_resolution``); frames are (H, W, 3) BGR uint8 arrays
(cv2-compatible, see imgio.py).
"""

import os
import shutil
import struct
import subprocess
import urllib.request

import numpy as np

from . import native

__all__ = [
    "VideoFileSource",
    "HTTPMJPEGSource",
    "FFmpegSource",
    "VideoWriter",
    "VIDEO_EXTENSIONS",
]

# Extensions routed to a video source by Capture. AVI/MJPEG are handled
# natively; the rest need an ffmpeg binary on PATH.
NATIVE_VIDEO_EXTENSIONS = (".avi", ".mjpg", ".mjpeg")
FFMPEG_VIDEO_EXTENSIONS = (".mp4", ".m4v", ".mkv", ".mov", ".webm",
                           ".wmv", ".mpg", ".mpeg", ".ts", ".flv")
VIDEO_EXTENSIONS = NATIVE_VIDEO_EXTENSIONS + FFMPEG_VIDEO_EXTENSIONS


def _jpeg_decode_bgr(data):
    img = native.jpeg_decode(data, bgr=True)
    if img.ndim == 2:  # a grayscale frame, as Pillow's convert("RGB")
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img


def _jpeg_encode(frame_bgr, quality):
    return native.jpeg_encode(frame_bgr, quality=quality, bgr=True)


# --------------------------------------------------------------------------
# AVI (RIFF) container
# --------------------------------------------------------------------------

class _RiffChunk:
    __slots__ = ("fourcc", "offset", "size", "list_type")

    def __init__(self, fourcc, offset, size, list_type=None):
        self.fourcc = fourcc
        self.offset = offset          # offset of the chunk DATA in file
        self.size = size
        self.list_type = list_type


def _iter_chunks(f, start, end):
    """Yield RIFF chunks in [start, end); chunks are word-aligned."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        fourcc = hdr[:4]
        size = struct.unpack("<I", hdr[4:8])[0]
        if fourcc in (b"RIFF", b"LIST"):
            list_type = f.read(4)
            yield _RiffChunk(fourcc, pos + 12, size - 4, list_type)
        else:
            yield _RiffChunk(fourcc, pos + 8, size)
        pos += 8 + size + (size & 1)


class VideoFileSource:
    """Pure-Python AVI video-file source (Capture driver protocol).

    Supports the two stream formats :class:`VideoWriter` emits — MJPG
    (each frame an independent JPEG, decoded by the native codec) and
    uncompressed
    bottom-up BGR DIB (biCompression=0, 24 bpp) — which are also the
    ubiquitous cv2.VideoWriter formats. For other codecs (H.264 in
    .mp4, …) use :class:`FFmpegSource` / install ffmpeg.

    Parameters
    ----------
    path : str
        AVI file path.
    loop : bool
        Restart at EOF (matches Capture's file-sequence behavior).
    """

    def __init__(self, path, loop=True):
        self.path = path
        self.loop = loop
        self._f = open(path, "rb")
        self._frames = []            # (offset, size) of '00dc'/'00db'
        self._idx = 0
        self._parse()

    def _parse(self):
        f = self._f
        f.seek(0, os.SEEK_END)
        file_end = f.tell()
        f.seek(0)
        root = next(_iter_chunks(f, 0, file_end), None)
        if root is None or root.fourcc != b"RIFF" or root.list_type != b"AVI ":
            raise ValueError(f"Cannot open device! ({self.path!r} is not "
                             "an AVI file)")
        self._w = self._h = None
        self._compression = 0
        self.fps = 25.0
        vids_seen = 0
        self._vid_stream = None      # stream number of the video stream

        def walk(start, end):
            nonlocal vids_seen
            for ch in _iter_chunks(f, start, end):
                if ch.fourcc == b"LIST":
                    if ch.list_type == b"movi":
                        self._scan_movi(ch.offset, ch.offset + ch.size)
                    else:
                        walk(ch.offset, ch.offset + ch.size)
                elif ch.fourcc == b"strh":
                    f.seek(ch.offset)
                    data = f.read(min(ch.size, 56))
                    if data[:4] == b"vids" and self._vid_stream is None:
                        self._vid_stream = vids_seen
                        scale, rate = struct.unpack("<II", data[20:28])
                        if scale and rate:
                            self.fps = rate / scale
                    vids_seen += 1
                elif ch.fourcc == b"strf" and self._w is None \
                        and self._vid_stream is not None:
                    f.seek(ch.offset)
                    bih = f.read(min(ch.size, 40))
                    if len(bih) >= 20:
                        self._w = struct.unpack("<i", bih[4:8])[0]
                        self._h = abs(struct.unpack("<i", bih[8:12])[0])
                        self._top_down = struct.unpack(
                            "<i", bih[8:12])[0] < 0
                        self._compression = struct.unpack(
                            "<I", bih[16:20])[0]

        walk(root.offset, root.offset + root.size)
        if not self._frames:
            raise ValueError(f"Cannot open device! (no video frames in "
                             f"{self.path!r})")
        comp = struct.pack("<I", self._compression)
        if comp not in (b"\x00\x00\x00\x00", b"MJPG", b"mjpg", b"jpeg"):
            raise ValueError(
                "Cannot open device! (AVI codec "
                f"{comp!r} unsupported by the native reader; supported: "
                "MJPG, uncompressed DIB. Install ffmpeg for other codecs)")
        self._is_mjpg = comp != b"\x00\x00\x00\x00"

    def _scan_movi(self, start, end):
        f = self._f
        want = (b"%02ddc" % (self._vid_stream or 0),
                b"%02ddb" % (self._vid_stream or 0))
        for ch in _iter_chunks(f, start, end):
            if ch.fourcc == b"LIST" and ch.list_type == b"rec ":
                self._scan_movi(ch.offset, ch.offset + ch.size)
            elif ch.fourcc in want and ch.size > 0:
                self._frames.append((ch.offset, ch.size))

    def __len__(self):
        return len(self._frames)

    def read(self):
        """Next frame as (H, W, 3) BGR uint8, or None at EOF (loop=False)."""
        if self._idx >= len(self._frames):
            if not self.loop:
                return None
            self._idx = 0
        off, size = self._frames[self._idx]
        self._idx += 1
        self._f.seek(off)
        data = self._f.read(size)
        if self._is_mjpg:
            return _jpeg_decode_bgr(data)
        # uncompressed DIB: rows padded to 4 bytes, bottom-up unless the
        # header height was negative
        stride = (self._w * 3 + 3) & ~3
        rows = np.frombuffer(data, np.uint8,
                             count=stride * self._h).reshape(self._h,
                                                             stride)
        frame = rows[:, : self._w * 3].reshape(self._h, self._w, 3)
        if not self._top_down:
            frame = frame[::-1]
        return np.ascontiguousarray(frame)

    def get_resolution(self):
        return (self._w, self._h)

    def release(self):
        self._f.close()


class HTTPMJPEGSource:
    """Network MJPEG stream source (multipart/x-mixed-replace over HTTP).

    The standard IP-camera / motion-style streaming protocol. Parity:
    the reference's Capture accepts network URLs via cv2.VideoCapture
    (reference utils.py:51-58).

    Parameters
    ----------
    url : str
        ``http://`` / ``https://`` stream URL.
    timeout : float
        Socket timeout in seconds.
    """

    _CHUNK = 65536

    def __init__(self, url, timeout=10.0):
        self.url = url
        try:
            self._resp = urllib.request.urlopen(url, timeout=timeout)
        except Exception as e:
            raise ValueError(f"Cannot open device! ({url!r}: {e})") from e
        ctype = self._resp.headers.get("Content-Type", "")
        self._boundary = None
        for part in ctype.split(";"):
            part = part.strip()
            if part.startswith("boundary="):
                b = part[len("boundary="):].strip('"')
                self._boundary = ("--" + b.lstrip("-")).encode()
        if "multipart" not in ctype or self._boundary is None:
            self._resp.close()
            raise ValueError(
                f"Cannot open device! ({url!r} is not a multipart MJPEG "
                f"stream; Content-Type: {ctype!r}. For other protocols "
                "install ffmpeg)")
        self._buf = b""
        self._res = None

    def _fill(self):
        data = self._resp.read(self._CHUNK)
        if not data:
            return False
        self._buf += data
        return True

    def read(self):
        """Next decoded frame, or None when the stream ends."""
        while True:
            # find a complete part: boundary ... headers ... body
            start = self._buf.find(self._boundary)
            if start < 0:
                if not self._fill():
                    return None
                continue
            hdr_end = self._buf.find(b"\r\n\r\n",
                                     start + len(self._boundary))
            if hdr_end < 0:
                if not self._fill():
                    return None
                continue
            headers = self._buf[start:hdr_end].decode("latin-1")
            clen = None
            for line in headers.split("\r\n"):
                if line.lower().startswith("content-length:"):
                    clen = int(line.split(":", 1)[1])
            body_start = hdr_end + 4
            if clen is not None:
                while len(self._buf) < body_start + clen:
                    if not self._fill():
                        return None
                body = self._buf[body_start:body_start + clen]
                self._buf = self._buf[body_start + clen:]
            else:
                # no Content-Length: scan to the next boundary
                nxt = self._buf.find(self._boundary, body_start)
                while nxt < 0:
                    if not self._fill():
                        return None
                    nxt = self._buf.find(self._boundary, body_start)
                body = self._buf[body_start:nxt].rstrip(b"\r\n")
                self._buf = self._buf[nxt:]
            if not body:
                continue
            frame = _jpeg_decode_bgr(body)
            self._res = (frame.shape[1], frame.shape[0])
            return frame

    def get_resolution(self):
        return self._res

    def release(self):
        try:
            self._resp.close()
        except Exception:
            pass


class FFmpegSource:
    """Any-container/protocol source via an ``ffmpeg`` rawvideo pipe.

    ``ffmpeg -i URL -f rawvideo -pix_fmt bgr24 -`` — covers mp4/mkv/rtsp
    and everything else ffmpeg can demux. Only constructed when an
    ffmpeg binary is on PATH (:func:`ffmpeg_available`).

    Parameters
    ----------
    url : str
        File path or stream URL.
    loop : bool
        Restart file inputs at EOF.
    """

    def __init__(self, url, loop=False):
        if not ffmpeg_available():
            raise ValueError(
                "Cannot open device! (no ffmpeg binary on PATH for "
                f"{url!r}; native support covers AVI/MJPG files and "
                "HTTP-MJPEG streams)")
        self.url = url
        self.loop = loop
        self._w = self._h = None
        self._proc = None
        self._spawn()

    def _spawn(self):
        cmd = [shutil.which("ffmpeg"), "-nostdin", "-hide_banner",
               "-i", self.url, "-f", "rawvideo", "-pix_fmt", "bgr24",
               "-an", "-sn", "pipe:1"]
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            bufsize=10**7)
        if self._w is None:
            # parse "Stream #0:0 ... Video: ..., 640x480" from stderr;
            # ffmpeg prints the header before the first output bytes.
            import re
            import threading
            lines = []

            def drain():
                for raw in self._proc.stderr:
                    lines.append(raw.decode("latin-1", "replace"))
                    m = re.search(r"Video:.*?(\d{2,5})x(\d{2,5})",
                                  lines[-1])
                    if m:
                        self._w, self._h = int(m.group(1)), int(m.group(2))
                        break
                # keep draining so ffmpeg never blocks on stderr
                for _ in self._proc.stderr:
                    pass

            t = threading.Thread(target=drain, daemon=True)
            t.start()
            t.join(timeout=15.0)
            if self._w is None:
                self.release()
                raise ValueError(
                    f"Cannot open device! ({self.url!r}: ffmpeg found no "
                    f"video stream; stderr tail: {''.join(lines)[-300:]!r})")
        else:
            import threading
            threading.Thread(
                target=lambda: [None for _ in self._proc.stderr],
                daemon=True).start()

    def read(self):
        n = self._w * self._h * 3
        data = self._proc.stdout.read(n)
        if data is None or len(data) < n:
            if self.loop:
                self.release()
                self._spawn()
                data = self._proc.stdout.read(n)
                if data is None or len(data) < n:
                    return None
            else:
                return None
        return np.frombuffer(data, np.uint8).reshape(self._h, self._w, 3)

    def get_resolution(self):
        return (self._w, self._h)

    def release(self):
        if self._proc is not None:
            try:
                self._proc.kill()
                self._proc.wait(timeout=5)
            except Exception:
                pass
            self._proc = None


def ffmpeg_available():
    return shutil.which("ffmpeg") is not None


# --------------------------------------------------------------------------
# Writer
# --------------------------------------------------------------------------

class VideoWriter:
    """AVI video writer (the ``cv2.VideoWriter`` analog).

    codec="MJPG" writes Motion-JPEG (baseline 4:2:0, ``quality``);
    codec="DIB " writes lossless uncompressed bottom-up BGR. Both are
    readable by :class:`VideoFileSource`, OpenCV, and ffmpeg.

    Use as a context manager or call :meth:`release`.
    """

    def __init__(self, path, fps=25.0, codec="MJPG", quality=90):
        if codec not in ("MJPG", "DIB "):
            raise ValueError("codec must be 'MJPG' or 'DIB '!")
        self.path = path
        self.fps = float(fps)
        self.codec = codec
        self.quality = int(quality)
        self._chunks = []            # encoded frame payloads
        self._size = None

    def write(self, frame):
        """Append one (H, W, 3) BGR uint8 frame."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError("Frames must be (H, W, 3) BGR uint8!")
        if self._size is None:
            self._size = (frame.shape[1], frame.shape[0])
        elif (frame.shape[1], frame.shape[0]) != self._size:
            raise ValueError("All frames must share one resolution!")
        if self.codec == "MJPG":
            self._chunks.append(_jpeg_encode(frame, self.quality))
        else:
            w, h = self._size
            stride = (w * 3 + 3) & ~3
            rows = np.zeros((h, stride), np.uint8)
            rows[:, : w * 3] = frame[::-1].reshape(h, w * 3)
            self._chunks.append(rows.tobytes())

    def release(self):
        if self._size is None:
            raise ValueError("No frames written!")
        w, h = self._size
        n = len(self._chunks)
        us_per_frame = int(round(1e6 / self.fps))
        is_mjpg = self.codec == "MJPG"
        comp = b"MJPG" if is_mjpg else b"\x00\x00\x00\x00"
        max_bytes = max(len(c) for c in self._chunks)

        def chunk(fourcc, payload):
            pad = b"\x00" if len(payload) & 1 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(list_type, payload):
            return chunk(b"LIST", list_type + payload)

        avih = struct.pack(
            "<14I", us_per_frame, max_bytes * int(self.fps), 0,
            0x10,                 # AVIF_HASINDEX
            n, 0, 1, max_bytes, w, h, 0, 0, 0, 0)
        strh = (b"vids" + comp + struct.pack(
            "<IHHIIIIIIII", 0, 0, 0, 0, 1000, int(round(self.fps * 1000)),
            0, n, max_bytes, 0xFFFFFFFF, 0)
            + struct.pack("<4H", 0, 0, w, h))
        strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24,
                           struct.unpack("<I", comp)[0] if is_mjpg else 0,
                           len(self._chunks[0]) if not is_mjpg else 0,
                           0, 0, 0, 0)
        hdrl = lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh)
                         + chunk(b"strf", strf)))

        movi_payload = b"".join(chunk(b"00dc", c) for c in self._chunks)
        movi = lst(b"movi", movi_payload)

        # idx1: offsets relative to the start of the 'movi' list type
        idx = b""
        off = 4
        for c in self._chunks:
            idx += b"00dc" + struct.pack("<III", 0x10, off, len(c))
            off += 8 + len(c) + (len(c) & 1)
        idx1 = chunk(b"idx1", idx)

        body = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
        self._chunks = []
        self._size = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._size is not None:
            self.release()
