"""PyTorch port: the example scripts of rigs, calibration, undistortion and
rectification (003a, 003b, 004a, 004b, 005, 006, 101) and the three that
need no resources (001, 007, 102), each held against the JAX package's
script on the same stand-in resource tree (``tests/torch_example_res.py``,
"small"; its chessboards at the reference's 1280x720) and against the
tree's truth.

Tolerances (``torch_example_res``): rig and rectified-rig JSON and every
printed number rtol 1e-9; uint8 images out of a remap |d| <= 1 on at
most 0.1% of pixels; 003b's rig within tests/test_calibration.py's
bounds for rendered boards (RMS < 0.12, |K - K_true| < 5 px, |R -
R_true| < 2e-3, |T - T_true| < 0.5); 101's points on the camera's ray of
their pixel and at the projector's rectified column (1e-6 px), float64.
"""

import os

import numpy as np
import pytest

import torch_example_res as res
from simplestereo_tpu_torch.imgio import imread


tree = res.tree_fixture("1", "2", "stereoFTP")


def images_close(j, p, *names):
    for n in names:
        res.uint8_close(imread(str(j / n)), imread(str(p / n)))


def test_003a_calibrate_single_camera(tree, tmp_path):
    root, _ = tree
    (j, jo), (p, po) = res.run_both("003a_calibrate_single_camera.py",
                                    root, tmp_path, [root / "1" / "calib"])
    res.numbers_close(jo, po)
    assert "RMS reprojection error" in po


def test_003b_build_stereo_rig(tree, tmp_path):
    root, truth = tree
    (j, jo), (p, po) = res.run_both("003b_build_stereo_rig.py", root,
                                    tmp_path, [root / "1" / "calib"])
    res.numbers_close(jo, po)
    res.json_close(j / "rig.json", p / "rig.json")
    import simplestereo_tpu_torch as ss
    rig = ss.StereoRig.fromFile(str(p / "rig.json"), device="cpu")
    _, _, K1, K2, _, _, R, T = truth["1"]["rig_args"]
    assert rig.reprojectionError < 0.12
    assert np.abs(rig.intrinsic1 - K1).max() < 5.0
    assert np.abs(rig.intrinsic2 - K2).max() < 5.0
    assert np.abs(rig.R - R).max() < 2e-3
    assert np.abs(rig.T.ravel() - T.ravel()).max() < 0.5


def test_004a_undistort_images(tree, tmp_path):
    (j, _), (p, _) = res.run_both("004a_undistort_images.py", tree[0],
                                  tmp_path)
    images_close(j, p, "left_undist.png", "right_undist.png")


def test_004b_draw_epipolar_lines(tree, tmp_path):
    (j, _), (p, _) = res.run_both("004b_draw_epipolar_lines.py", tree[0],
                                  tmp_path)
    images_close(j, p, "left_epilines.png", "right_epilines.png")


def test_005_rectify_rig(tree, tmp_path):
    (j, _), (p, _) = res.run_both("005_rectify_rig.py", tree[0], tmp_path)
    res.json_close(j / "rigRect.json", p / "rigRect.json")
    res.json_close(p / "rigRect.json", tree[0] / "2" / "rigRect.json")


def test_006_rectify_images(tree, tmp_path):
    (j, _), (p, _) = res.run_both("006_rectify_images.py", tree[0],
                                  tmp_path)
    images_close(j, p, "lawn_L_rect.png", "lawn_R_rect.png")


def test_101_structured_light_rig(tree, tmp_path, monkeypatch):
    import simplestereo_tpu_torch as ss
    seen = res.record(monkeypatch, ss.StructuredLightRig, "triangulate")
    (j, jo), (p, po) = res.run_both("101_structured_light_rig.py",
                                    tree[0], tmp_path)
    res.numbers_close(jo, po)
    (rig, cam, proj), _, world = seen[0]
    assert res.triangulation_residual(rig, cam, proj, world) < 1e-6


@pytest.mark.parametrize("name", ["001_calibration_chessboard.py",
                                  "007_use_raw_camera_data.py",
                                  "102_cam_proj_capture.py"])
def test_self_contained_against_jax(name, tmp_path):
    (j, jo), (p, po) = res.run_both(name, tmp_path, tmp_path)
    if name.startswith("001"):
        assert (j / "chessboard.svg").read_bytes() == \
            (p / "chessboard.svg").read_bytes()
    elif name.startswith("007"):
        res.numbers_close(jo, po)
    else:
        files = sorted(os.listdir(j / "graycode_patterns"))
        assert len(files) == 44
        assert files == sorted(os.listdir(p / "graycode_patterns"))
        for f in files:
            a = imread(str(j / "graycode_patterns" / f))
            b = imread(str(p / "graycode_patterns" / f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
