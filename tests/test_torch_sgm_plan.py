"""PyTorch port: the launch plan of the SGM path-aggregation kernels
(``passive/sgm_cuda._plan``) and the frame split shared by the matchers'
wrappers (``_build.frame_pieces``), on the CPU.

The plan picks the kernel (the line kernel, or the first version for
D > 256), the lanes a scan line and the disparities a lane, whether the
directions run one launch after another or side by side into a capped
workspace, and how many frames a launch takes. Nothing here needs a card:
the limits it is held to are the H100's (grid y and z at most 65,535;
the line kernel takes no shared memory, and the first version's two rows a
warp stay far below 227 KB).
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu_torch import _build
from simplestereo_tpu_torch.passive import sgm_cuda

SMEM_MAX = 232_448


@pytest.mark.parametrize("paths", [4, 8])
def test_plan_fits_every_shape(paths):
    """D 1..300, stacks up to 70,000 frames, 720p to one pixel: every grid
    fits, every lane group covers D with the fewest registers a lane, and
    every workspace stays under its cap."""
    ndirs = 8 if paths >= 8 else 4
    for D in range(1, 301):
        for B in (1, 8, 70_000):
            for H, W in ((720, 1280), (1, 1), (45, 150)):
                plan = sgm_cuda._plan(B, H, W, D, paths)
                gx, gy, gz = plan["grid"]
                assert 1 <= gx <= 2**31 - 1 and gy <= 65_535 and gz <= 65_535
                assert gy == plan["frames"] == min(B, gy)
                if D > sgm_cuda.LINES_D_MAX:
                    assert plan["mode"] == "generic" and plan["npl"] == 0
                    assert sgm_cuda.WARPS * 2 * D * 4 <= SMEM_MAX
                    continue
                g, npl = plan["group"], plan["npl"]
                assert npl in sgm_cuda.NPL
                assert g & (g - 1) == 0 and 1 <= g <= 32
                assert g * npl >= D  # the group covers D ...
                assert npl == 1 or 32 * (npl // 2) < D  # ... with no spare lane
                assert npl > 1 or g == 1 or g // 2 < D
                assert plan["vec"] == (D % 4 == 0 and npl >= 4)
                vol = H * W * D * 4
                if plan["mode"] == "concurrent":
                    assert gz == ndirs
                    assert plan["workspace"] == ndirs * -(
                        -plan["frames"] * vol // 16) * 16
                    assert plan["workspace"] <= sgm_cuda.WORKSPACE_CAP
                else:
                    assert gz == 1 and plan["workspace"] == 0
                    assert ndirs * vol > sgm_cuda.WORKSPACE_CAP


@pytest.mark.parametrize("D,npl,group", [
    (1, 1, 1), (2, 1, 2), (3, 1, 4), (11, 1, 16), (16, 1, 16), (17, 1, 32),
    (32, 1, 32), (33, 2, 32), (40, 2, 32), (64, 2, 32), (65, 4, 32),
    (128, 4, 32), (130, 8, 32), (256, 8, 32)])
def test_plan_lane_groups(D, npl, group):
    """D <= 32: one disparity a lane and 32 / group lines a warp (no lane
    idles at D = 16); beyond, a whole warp a line and npl disparities a
    lane."""
    plan = sgm_cuda._plan(1, 45, 150, D, 8)
    assert (plan["npl"], plan["group"]) == (npl, group)
    assert plan["depth"] == (8 if npl <= 4 else 4)
    lines_a_block = sgm_cuda.WARPS * 32 // group
    assert plan["grid"][0] == -(-(45 + 150 - 1) // lines_a_block)


def test_plan_main_configurations():
    """Census 384x288 D = 16 and sgm_batch8 run the directions side by
    side (two lines a warp); so does 1280x720 at D = 128, one frame a
    launch (3.8 GB of L buffers), with 16-byte loads."""
    census = sgm_cuda._plan(1, 288, 384, 16, 8)
    assert census == dict(mode="concurrent", npl=1, group=16, vec=False,
                          depth=8, frames=1, workspace=8 * 288 * 384 * 16 * 4,
                          grid=(-(-(288 + 384 - 1) // 8), 1, 8))
    batch8 = sgm_cuda._plan(8, 288, 384, 16, 8)
    assert batch8["mode"] == "concurrent" and batch8["frames"] == 8
    hd = sgm_cuda._plan(2, 720, 1280, 128, 8)
    assert hd == dict(mode="concurrent", npl=4, group=32, vec=True, depth=8,
                      frames=1, workspace=8 * 720 * 1280 * 128 * 4,
                      grid=(-(-(720 + 1280 - 1) // 4), 1, 8))
    big = sgm_cuda._plan(1, 1080, 1920, 256, 8)  # 17 GB of L buffers
    assert big["mode"] == "sequential" and big["workspace"] == 0


def test_plan_workspace_splits_frames():
    """A stack whose L buffers pass the cap runs in launches of as many
    frames as fit; a frame that alone passes it runs sequentially unless
    the caller asks, and then one frame a launch."""
    plan = sgm_cuda._plan(100, 288, 384, 16, 8)
    per = 8 * 288 * 384 * 16 * 4
    assert plan["frames"] == sgm_cuda.WORKSPACE_CAP // per == 75
    forced = sgm_cuda._plan(3, 1080, 1920, 256, 8, mode="concurrent")
    assert forced["frames"] == 1 and forced["grid"][2] == 8


def test_plan_modes_and_refusals():
    assert sgm_cuda._plan(1, 45, 150, 300, 4)["mode"] == "generic"
    assert sgm_cuda._plan(1, 45, 150, 16, 4, mode="generic")["npl"] == 0
    assert sgm_cuda._plan(1, 45, 150, 16, 4, mode="sequential")[
        "grid"][2] == 1
    with pytest.raises(ValueError, match="D <= 256"):
        sgm_cuda._plan(1, 45, 150, 300, 8, mode="sequential")
    with pytest.raises(ValueError, match="mode"):
        sgm_cuda._plan(1, 45, 150, 16, 8, mode="sideways")


def test_plan_frames_beyond_grid():
    """70,000 frames run as 65,535 + 4,465 (grid y), bit for bit what one
    launch would give, since frames are independent."""
    plan = sgm_cuda._plan(70_000, 2, 3, 1, 8)
    assert plan["frames"] == 65_535
    assert _build.frame_pieces(70_000, plan["frames"]) == [
        (0, 65_535), (65_535, 70_000)]


@pytest.mark.parametrize("B,per", [(1, 1), (1, 65_535), (7, 3), (9, 3),
                                   (65_535, 65_535), (65_536, 65_535),
                                   (200_000, 5_957)])
def test_frame_pieces_cover_each_frame_once(B, per):
    pieces = _build.frame_pieces(B, per)
    covered = np.zeros(B, np.int64)
    for b0, b1 in pieces:
        assert 0 <= b0 < b1 <= B and b1 - b0 <= per
        covered[b0:b1] += 1
    assert (covered == 1).all()
    assert [p[0] for p in pieces] == sorted(p[0] for p in pieces)
    assert len(pieces) == -(-B // per)


def test_frame_pieces_refuses_empty_launch():
    with pytest.raises(ValueError, match="per_launch"):
        _build.frame_pieces(4, 0)


def test_cpu_aggregate_ignores_plan():
    """A CPU tensor runs the twin whatever the plan says; no launch."""
    rng = np.random.default_rng(5)
    C = torch.tensor(rng.integers(0, 60, (2, 7, 9, 5)).astype(np.float32))
    want = sgm_cuda._aggregate(C, 4.0, 20.0, 8)
    n0 = sgm_cuda.launches
    for mode in ("sequential", "concurrent", "generic"):
        plan = sgm_cuda._plan(2, 7, 9, 5, 8, mode=mode)
        assert torch.equal(sgm_cuda.aggregate(C, 4.0, 20.0, 8, plan=plan),
                           want)
    assert sgm_cuda.launches == n0
