"""PyTorch port: the example scripts under
``simplestereo_tpu_torch/examples`` run end to end with ``--device cpu``.

The scripts that need no file outside the repository run here: 002 on
generated AVIs (and on directories of PNGs), 202 and 203 (as the JAX
package's tests/test_examples.py runs them), 001, 007 and 102. The others
read the reference's resources and skip where they are absent, as
tests/test_examples.py does (201, the row-tiled matchers, runs as a gloo
world of one with ``--device cpu``); the files of ``AGAINST_JAX`` run
them, and 001, 007 and 102, on a stand-in tree against the JAX scripts.
Each port keeps its JAX script's name.
"""

import os
import runpy
import sys

import numpy as np
import pytest
import torch

from simplestereo_tpu_torch.examples._cli import REFERENCE_RES as RES
from simplestereo_tpu_torch.videoio import VideoWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "simplestereo_tpu_torch", "examples")
JAX_EXAMPLES = os.path.join(REPO, "examples")

SELF_CONTAINED = ["001_calibration_chessboard.py", "007_use_raw_camera_data.py",
                  "102_cam_proj_capture.py"]
NEEDS_RES = ["003a_calibrate_single_camera.py", "003b_build_stereo_rig.py",
             "004a_undistort_images.py", "004b_draw_epipolar_lines.py",
             "005_rectify_rig.py", "006_rectify_images.py",
             "008_stereo_matching_sgm.py", "009_stereo_matching_asw.py",
             "010_stereo_matching_tsukuba.py", "011_build_3d_point_cloud.py",
             "101_structured_light_rig.py", "103_stereo_ftp.py",
             "201_multichip_tiled_matching.py",
             "204_radiometric_auto_matching.py"]


def _run(name, tmp_path, monkeypatch, argv=()):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv),
                                      "--device", "cpu"])
    # One intra-op thread: the grab threads of 202 contend for the GIL
    # with PyTorch's CPU thread pool, which slows the CPU path many times.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    finally:
        torch.set_num_threads(threads)


# The files that hold each script of NEEDS_RES and SELF_CONTAINED against
# its JAX script on a stand-in resource tree (tests/torch_example_res.py).
AGAINST_JAX = ["test_torch_examples_rig.py", "test_torch_examples_match.py",
               "test_torch_examples_tsukuba.py",
               "test_torch_examples_radiometric.py",
               "test_torch_examples_tiled.py"]


def test_every_example_has_a_port():
    jax = {f for f in os.listdir(JAX_EXAMPLES) if f.endswith(".py")}
    port = {f for f in os.listdir(EXAMPLES) if f[0].isdigit()}
    assert jax - port == set()
    assert port <= jax
    assert set(SELF_CONTAINED + NEEDS_RES) | {
        "002_capture_image_pairs.py", "202_streaming_pipeline.py",
        "203_batch_scanning.py"} == port
    tests = os.path.dirname(os.path.abspath(__file__))
    text = "".join(open(os.path.join(tests, f)).read() for f in AGAINST_JAX)
    missing = [n for n in NEEDS_RES + SELF_CONTAINED if f'"{n}"' not in text]
    assert missing == [], f"no case against the JAX script: {missing}"


@pytest.mark.parametrize("name", SELF_CONTAINED)
def test_self_contained_example_runs(name, tmp_path, monkeypatch):
    _run(name, tmp_path, monkeypatch)
    if name.startswith("001"):
        assert (tmp_path / "chessboard.svg").exists()
    if name.startswith("102"):
        # 42 patterns, then the black and the white image
        assert len(os.listdir(tmp_path / "graycode_patterns")) == 44


@pytest.mark.parametrize("name", NEEDS_RES)
def test_example_with_reference_resources(name, tmp_path, monkeypatch):
    if not os.path.exists(RES):
        pytest.skip("reference resources not available")
    _run(name, tmp_path, monkeypatch, ["4"] if name[:3] in ("008", "009")
         else ())


@pytest.mark.parametrize("codec", ["DIB ", "MJPG"])
def test_example_002_video_sources(tmp_path, monkeypatch, rng, codec):
    paths = []
    for side in ("L", "R"):
        p = tmp_path / f"cam_{side}.avi"
        with VideoWriter(str(p), fps=30.0, codec=codec) as wr:
            for _ in range(4):
                wr.write(rng.integers(0, 255, (12, 16, 3), np.uint8))
        paths.append(str(p))
    _run("002_capture_image_pairs.py", tmp_path, monkeypatch, paths)
    assert (tmp_path / "0_L.png").exists() and (tmp_path / "9_R.png").exists()


def test_example_002_directories(tmp_path, monkeypatch, rng):
    from simplestereo_tpu_torch.imgio import imwrite
    for cam in ("camL", "camR"):
        (tmp_path / cam).mkdir()
        for i in range(3):
            imwrite(str(tmp_path / cam / f"{i}.jpg"),
                    rng.integers(0, 255, (8, 10, 3), np.uint8))
    _run("002_capture_image_pairs.py", tmp_path, monkeypatch,
         [tmp_path / "camL", tmp_path / "camR"])
    assert len(list(tmp_path.glob("*_L.png"))) == 10


def test_example_202_streaming(tmp_path, monkeypatch, capsys):
    _run("202_streaming_pipeline.py", tmp_path, monkeypatch, ["2", "2"])
    out = capsys.readouterr().out
    assert "batch 1: 2 frames" in out and out.strip().endswith("done")


def test_example_203_batch_scanning(tmp_path, monkeypatch, capsys):
    _run("203_batch_scanning.py", tmp_path, monkeypatch, ["2", "96", "72"])
    assert (tmp_path / "scan_batch0.ply").exists()
    assert "frame 1:" in capsys.readouterr().out


def test_device_option(monkeypatch):
    from simplestereo_tpu_torch.examples._cli import device_arg
    monkeypatch.setattr(sys, "argv", ["x", "3", "--device", "cpu", "4"])
    assert device_arg() == "cpu" and sys.argv == ["x", "3", "4"]
    monkeypatch.setattr(sys, "argv", ["x", "--device=cuda:1"])
    assert device_arg() == "cuda:1" and sys.argv == ["x"]
    monkeypatch.setattr(sys, "argv", ["x", "5"])
    assert device_arg() == "cuda" and sys.argv == ["x", "5"]
