"""PyTorch port: ``videoio`` (AVI reader and writer, MJPEG over HTTP,
the ffmpeg pipe) against the JAX package's ``videoio``, which codes
Motion-JPEG with Pillow where the port uses its native codec.

DIB files are byte-identical between the two writers; each package reads
the other's DIB files exactly and its MJPG files within the JAX MJPG
test's bar (mean |d| < 4 on smooth frames; the two codecs give the same
pixels, so the port's reading of a JAX file equals the JAX reading); a
localhost MJPEG server streams to both; the error paths raise as in
tests/test_videoio.py.
"""

import http.server
import os
import stat
import struct
import sys
import threading

import numpy as np
import pytest

from simplestereo_tpu import videoio as jvideo
from simplestereo_tpu_torch import utils, videoio


def _frames(seed, n=5, h=24, w=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, 3), np.uint8) for _ in range(n)]


def _smooth(n=4, h=24, w=32):
    base = np.linspace(0, 200, w, dtype=np.float32)
    return [np.clip(base[None, :, None] + 10 * i + np.arange(h)[:, None, None],
                    0, 255).astype(np.uint8).repeat(3, axis=2)
            for i in range(n)]


def _write(mod, path, frames, codec, fps=20.0):
    with mod.VideoWriter(str(path), fps=fps, codec=codec) as wr:
        for f in frames:
            wr.write(f)


def _read_all(mod, path):
    src = mod.VideoFileSource(str(path), loop=False)
    out = []
    while (f := src.read()) is not None:
        out.append(f)
    fps, res = src.fps, src.get_resolution()
    src.release()
    return out, fps, res


@pytest.mark.parametrize("shape", [(24, 32), (7, 13)])
def test_dib_files_byte_identical(tmp_path, shape):
    frames = _frames(0, h=shape[0], w=shape[1])
    _write(videoio, tmp_path / "t.avi", frames, "DIB ", fps=12.5)
    _write(jvideo, tmp_path / "j.avi", frames, "DIB ", fps=12.5)
    assert (tmp_path / "t.avi").read_bytes() == \
        (tmp_path / "j.avi").read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dib_read_across(tmp_path, writer):
    frames = _frames(1)
    mod, other = (videoio, jvideo) if writer == "port" else (jvideo, videoio)
    _write(mod, tmp_path / "x.avi", frames, "DIB ", fps=12.5)
    got, fps, res = _read_all(other, tmp_path / "x.avi")
    assert len(got) == len(frames) and abs(fps - 12.5) < 1e-6
    assert res == (32, 24)
    for f, g in zip(frames, got):
        np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mjpg_read_across(tmp_path, writer):
    frames = _smooth()
    mod = videoio if writer == "port" else jvideo
    _write(mod, tmp_path / "m.avi", frames, "MJPG")
    port, _, _ = _read_all(videoio, tmp_path / "m.avi")
    jax, _, _ = _read_all(jvideo, tmp_path / "m.avi")
    assert len(port) == len(jax) == len(frames)
    for f, p, j in zip(frames, port, jax):
        assert p.shape == f.shape
        assert np.abs(p.astype(int) - f).mean() < 4
        d = np.abs(p.astype(int) - j)
        assert d.max() <= 2 and (d == 0).mean() >= 0.99


def test_mjpg_files_decode_alike(tmp_path):
    """The two writers' MJPG frames decode to the same pixels (the port's
    encoder follows libjpeg's, which Pillow runs)."""
    frames = _smooth(2, h=40, w=56)
    _write(videoio, tmp_path / "t.avi", frames, "MJPG")
    _write(jvideo, tmp_path / "j.avi", frames, "MJPG")
    t, _, _ = _read_all(videoio, tmp_path / "t.avi")
    j, _, _ = _read_all(videoio, tmp_path / "j.avi")
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_loop_and_writer_errors(tmp_path):
    frames = _frames(2, n=2)
    _write(videoio, tmp_path / "loop.avi", frames, "DIB ")
    src = videoio.VideoFileSource(str(tmp_path / "loop.avi"), loop=True)
    for _ in range(2 * len(frames) + 1):
        assert src.read() is not None
    src.release()
    wr = videoio.VideoWriter(str(tmp_path / "x.avi"))
    with pytest.raises(ValueError):
        wr.write(np.zeros((8, 8), np.uint8))
    wr.write(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        wr.write(np.zeros((9, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="codec"):
        videoio.VideoWriter(str(tmp_path / "y.avi"), codec="H264")
    with pytest.raises(ValueError, match="No frames"):
        videoio.VideoWriter(str(tmp_path / "z.avi")).release()


@pytest.mark.parametrize("what", ["not-riff", "no-frames", "codec"])
def test_reader_errors_match_jax(tmp_path, what):
    p = tmp_path / "bad.avi"
    if what == "not-riff":
        p.write_bytes(b"MZ not a riff file at all" * 4)
    else:
        _write(jvideo, p, _frames(3, n=1), "DIB ")
        data = bytearray(p.read_bytes())
        if what == "no-frames":
            data = data.replace(b"00dc", b"01wb")
        else:  # claim an H.264 stream
            i = data.index(b"strf") + 8 + 16
            data[i:i + 4] = b"H264"
        p.write_bytes(bytes(data))
    msgs = []
    for mod in (videoio, jvideo):
        with pytest.raises(ValueError, match="Cannot open device") as e:
            mod.VideoFileSource(str(p))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


class _MJPEGServer:
    """Minimal multipart/x-mixed-replace MJPEG HTTP server on localhost."""

    def __init__(self, payloads, content_type=None):
        ctype = content_type or 'multipart/x-mixed-replace; boundary="frame"'

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.end_headers()
                try:
                    for body in payloads:
                        self.wfile.write(b"--frame\r\nContent-Type: "
                                         b"image/jpeg\r\nContent-Length: "
                                         b"%d\r\n\r\n" % len(body))
                        self.wfile.write(body + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, *a):
                pass

        self.server = http.server.HTTPServer(("127.0.0.1", 0), H)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/stream"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("encoder", ["port", "jax"])
def test_http_mjpeg_stream(encoder):
    frames = [np.full((16, 20, 3), 40 * i, np.uint8) for i in range(3)]
    enc = videoio._jpeg_encode if encoder == "port" else jvideo._jpeg_encode
    srv = _MJPEGServer([enc(f, 90) for f in frames])
    try:
        got = {}
        for name, mod in (("port", videoio), ("jax", jvideo)):
            src = mod.HTTPMJPEGSource(srv.url, timeout=5.0)
            got[name] = []
            while (f := src.read()) is not None:
                got[name].append(f)
            assert src.get_resolution() == (20, 16)
            src.release()
    finally:
        srv.close()
    assert len(got["port"]) == len(got["jax"]) == 3
    for f, p, j in zip(frames, got["port"], got["jax"]):
        np.testing.assert_array_equal(p, j)
        assert np.abs(p.astype(int) - f).mean() < 3


def test_http_capture_and_non_mjpeg_rejected():
    import time
    srv = _MJPEGServer([videoio._jpeg_encode(
        np.full((16, 20, 3), 128, np.uint8), 90)] * 50)
    try:
        with utils.Capture(srv.url) as cap:
            f = None
            for _ in range(300):
                if (f := cap.get()) is not None:
                    break
                time.sleep(0.01)
            assert isinstance(cap._source, videoio.HTTPMJPEGSource)
    finally:
        srv.close()
    assert f is not None and f.shape == (16, 20, 3)
    srv = _MJPEGServer([], content_type="text/html")
    try:
        for mod in (videoio, jvideo):
            with pytest.raises(ValueError, match="Cannot open device"):
                mod.HTTPMJPEGSource(srv.url)
    finally:
        srv.close()


_STUB_FFMPEG_PY = r'''
import struct, sys
args = sys.argv[1:]
inp = args[args.index("-i") + 1]
data = open(inp, "rb").read()
n, h, w = struct.unpack("<III", data[:12])
sys.stderr.write("Input #0, stub, from '%s':\n"
                 "  Stream #0:0: Video: rawvideo, bgr24, %dx%d, 20 fps\n"
                 % (inp, w, h))
sys.stderr.flush()
sys.stdout.buffer.write(data[12:])
sys.stdout.buffer.flush()
'''


def _stub_ffmpeg(tmp_path, monkeypatch):
    """A fake ``ffmpeg`` on PATH that speaks the CLI contract
    FFmpegSource relies on (as tests/test_videoio.py installs it)."""
    d = tmp_path / "stubbin"
    d.mkdir()
    (d / "ffmpeg_stub.py").write_text(_STUB_FFMPEG_PY)
    sh = d / "ffmpeg"
    sh.write_text(f'#!/bin/sh\nexec "{sys.executable}" '
                  f'"{d / "ffmpeg_stub.py"}" "$@"\n')
    sh.chmod(sh.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{d}{os.pathsep}" + os.environ["PATH"])


def test_ffmpeg_pipe_stub(tmp_path, monkeypatch):
    _stub_ffmpeg(tmp_path, monkeypatch)
    frames = _frames(4)
    p = tmp_path / "clip.mp4"
    with open(p, "wb") as f:
        f.write(struct.pack("<III", len(frames), 24, 32))
        for fr in frames:
            f.write(fr.tobytes())
    src = videoio.FFmpegSource(str(p), loop=True)
    assert src.get_resolution() == (32, 24)
    for f in frames + frames[:1]:
        np.testing.assert_array_equal(src.read(), f)
    src.release()
    with utils.Capture(str(p)) as cap:
        assert isinstance(cap._source, videoio.FFmpegSource) and cap.isFile


def test_no_ffmpeg_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg on PATH
    assert not videoio.ffmpeg_available()
    p = tmp_path / "clip.mp4"
    p.write_bytes(b"\x00" * 64)
    msgs = []
    for mod in (videoio, jvideo):
        with pytest.raises(ValueError, match="ffmpeg") as e:
            mod.FFmpegSource(str(p))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="ffmpeg"):
        utils.Capture(str(p))
