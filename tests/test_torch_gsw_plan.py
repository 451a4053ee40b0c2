"""PyTorch port: the launch plan of the GSW kernels
(``passive/gsw_cuda._plan``), on the CPU.

The plan picks the kernel's path (the shared-memory tile kernel, which
builds the volume inside it, or the volume launch and the kernel that
reads its windows through L1, for a window whose tile does not fit), the
disparities a chunk, the dynamic shared memory a block takes, and the
frames a launch takes. Nothing here needs a card: the limits it is held
to are the H100's (227 KB of shared memory a block, grid y and z at most
65,535).
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu_torch import _build
from simplestereo_tpu_torch.passive import gsw_cuda

SMEM_MAX = 232_448


def _layout_bytes(nd, win):
    """Bytes of the tile kernel's shared memory, laid out as
    csrc/gsw_kernel.cu lays it out: BGR(ref) and nd volume planes of the
    32 x 32 pixel tile and its windows."""
    pad = win // 2
    return 4 * (3 + nd) * (32 + 2 * pad) * (32 + 2 * pad)


@pytest.mark.parametrize("step", [1, 2, 3])
def test_plan_fits_every_shape(step):
    """Every odd window 1..111 and D 1..40, 64, 128 at 720p and at one
    pixel: the tile kernel up to win 59 with a compiled chunk and its
    layout's shared memory, the L1 path beyond; every grid fits."""
    for win in range(1, 112, 2):
        for D in list(range(1, 41)) + [64, 128]:
            for H, W in ((720, 1280), (1, 1)):
                plan = gsw_cuda._plan(win, step, D, 2, H, W)
                gx, gy, gz = plan["grid"]
                assert gx <= 2**31 - 1 and gy <= 65_535 and gz <= 65_535
                assert gz == plan["frames"] == 2
                assert plan["chunks"] == -(-D // plan["nd"])
                if win <= 59:
                    assert plan["path"] == "tile", (win, D)
                    assert plan["nd"] in gsw_cuda.CHUNKS
                    assert 0 < plan["smem"] <= SMEM_MAX
                    assert plan["smem"] == _layout_bytes(plan["nd"], win)
                    assert (gx, gy) == (-(-W // 32), -(-H // 32))
                else:
                    assert plan["path"] == "l1" and plan["smem"] == 0
                    assert plan["nd"] == gsw_cuda.CHUNK_L1
                    assert (gx, gy) == (-(-W // 32), -(-H // 8))


@pytest.mark.parametrize("D,nd", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 12),
                                  (11, 12), (12, 12), (13, 16), (16, 16),
                                  (17, 12), (21, 12), (33, 12), (41, 16),
                                  (128, 16)])
def test_plan_fewest_chunks_then_smallest(D, nd):
    """The weights are computed once a chunk, so the fewest chunks win,
    then the smallest chunk that gives that many."""
    plan = gsw_cuda._plan(9, 1, D, 1, 45, 150)
    assert plan["nd"] == nd
    assert plan["chunks"] == min(-(-D // c) for c in gsw_cuda.CHUNKS)


def test_plan_main_configuration():
    """win 23, d 4..14 (D = 11), both directions: one chunk of 12, 174,960
    bytes a block, at both main-path sizes."""
    for H, W in ((288, 384), (720, 1280)):
        plan = gsw_cuda._plan(23, 1, 11, 2, H, W)
        assert plan == dict(path="tile", nd=12, chunks=1, smem=174_960,
                            frames=2, grid=(-(-W // 32), -(-H // 32), 2))
    mi = gsw_cuda._plan(23, 1, 11, 2, 288, 384, ext_vol=True)
    assert mi["path"] == "tile" and mi["smem"] == 174_960


def test_plan_large_window_drops_chunk():
    """win 59 fits only the chunk of 4; 61 and 111 fit none and take the
    L1 path, as does any window without a budget."""
    assert gsw_cuda._plan(59, 1, 11, 1, 45, 150)["nd"] == 4
    for win in (61, 111):
        assert gsw_cuda._plan(win, 1, 6, 2, 45, 150)["path"] == "l1"
    assert gsw_cuda._plan(23, 1, 11, 2, 45, 150, budgets=())["path"] == "l1"


def test_plan_splits_frames_beyond_grid():
    """The L1 path's volume launch puts frames x D on grid z: 512 frames
    (256 consistent pairs) at D = 128 run as 511 + 1 frames. The tile
    path puts frames alone there: 70,000 run as 65,535 + 4,465. With
    ext_vol there is no volume launch."""
    l1 = gsw_cuda._plan(5, 1, 128, 512, 8, 140, budgets=())
    assert l1["frames"] == 65_535 // 128 == 511
    assert _build.frame_pieces(512, l1["frames"]) == [(0, 511), (511, 512)]
    tile = gsw_cuda._plan(5, 1, 128, 512, 8, 140)
    assert tile["path"] == "tile" and tile["frames"] == 512
    big = gsw_cuda._plan(5, 1, 11, 70_000, 8, 140)
    assert big["frames"] == 65_535 and big["grid"][2] == 65_535
    ext = gsw_cuda._plan(5, 1, 128, 70_000, 8, 140, ext_vol=True,
                         budgets=())
    assert ext["frames"] == 65_535


def test_plan_rejects_what_no_grid_holds():
    with pytest.raises(ValueError, match="grid"):
        gsw_cuda._plan(5, 1, 11, 1, 32 * 65_536, 8)
    with pytest.raises(ValueError, match="grid"):
        gsw_cuda._plan(5, 1, 70_000, 1, 8, 8, budgets=())


def test_cpu_pass_ignores_plan():
    """A CPU tensor runs the twin whatever the plan says; no launch."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 11, 19, 3), np.uint8)
    planes = gsw_cuda._build_planes(torch.tensor(img),
                                    torch.tensor(np.roll(img, -2, axis=2)),
                                    5)
    kw = dict(H=11, W=19, win_size=5, min_disp=0, max_disp=3, gamma=10.0,
              f_max=20.0, return_cost=True)
    want = gsw_cuda._gsw_pass_plain(planes, **kw)
    n0 = gsw_cuda.launches
    for plan in (gsw_cuda._plan(5, 1, 4, 2, 11, 19),
                 gsw_cuda._plan(5, 1, 4, 2, 11, 19, budgets=())):
        got = gsw_cuda._gsw_pass(planes, plan=plan, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert gsw_cuda.launches == n0
