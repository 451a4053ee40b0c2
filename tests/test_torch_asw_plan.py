"""PyTorch port: the launch plan of the ASW cost kernel
(``passive/asw_cuda._plan``), on the CPU.

The plan picks the kernel's path (the wide tile kernel that walks the
window once for a chunk of up to 128 disparities, the tile kernel of
chunks of at most 12, or the kernel that reads device memory through
L1), the disparities a block keeps in registers, the window columns
whose e2 one shared-memory group holds, and the dynamic shared memory a
block takes. Nothing here needs a card: the limits it is held to are the
H100's (227 KB of shared memory a block, grid y and z at most 65,535).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from portbench.metrics import k1_roofline
from simplestereo_tpu_torch import _build
from simplestereo_tpu_torch.passive import asw_cuda

SMEM_MAX = 232_448
THREE_BLOCKS = 76_800  # a block's share when three fit one SM
SOURCE = (pathlib.Path(asw_cuda.__file__).resolve().parents[1] / "csrc"
          / "asw_kernel.cu")


def _layout_bytes(plan, win, step):
    """Bytes of the tile kernel's shared-memory regions, laid out as
    csrc/asw_kernel.cu lays them out: the tad ring, the Lab1 and Lab2
    rings, Lab2 at the centres, the BGR rows being staged, prox of one
    window row and the e2 group. The wide kernel (a ring of 4 rows, its
    tad rows 4 step floats longer every 2 step columns) stages up to 4
    rows at once and holds Lab1 at its pixels and e1 of the group too,
    the rows of e1 and e2 padded to = step mod 2 step floats."""
    pad = win // 2
    tw, th = asw_cuda.TILE_W, asw_cuda.TILE_H
    cw = tw + 2 * pad
    sw = tw + plan["chunk"] - 1
    nl = 2 * (pad // step) + 1
    if plan["path"] == "wide":
        th = asw_cuda.WIDE_TILE_H
        slot = cw * plan["dcp"] + (cw - 1) // (2 * step) * 4 * step
        e2_row = next(n for n in range(sw, sw + 2 * step)
                      if n % (2 * step) == step)
        floats = (th * slot + 3 * th * cw
                  + 3 * th * (sw + 2 * pad) + 3 * th * tw + 3 * th * sw
                  + 3 * th * cw + 3 * th * (cw + plan["chunk"] - 1) + nl
                  + plan["jg"] * th * (tw + step + e2_row))
        return 4 * floats
    floats = (th * cw * plan["dcp"] + 3 * th * cw + 3 * th * (sw + 2 * pad)
              + 3 * th * sw + 3 * cw + 3 * (cw + plan["chunk"] - 1) + nl
              + plan["jg"] * th * sw)
    return 4 * floats


@pytest.mark.parametrize("step", [1, 2, 3])
def test_plan_fits_every_shape(step):
    """Every odd window 1..111, D 1..128 and B 1..8 gets a tile plan
    within the card's limits, at 720p and at one pixel: the wide kernel
    for D > 12 at steps 1 and 2, else the tile kernel."""
    for win in range(1, 112, 2):
        nl = 2 * ((win // 2) // step) + 1
        for D in range(1, 129):
            for B in range(1, 9):
                for H, W in ((720, 1280), (1, 1)):
                    plan = asw_cuda._plan(win, step, D, B, H, W)
                    wide = D > 12 and step in asw_cuda.WIDE_STEPS
                    assert plan["path"] == ("wide" if wide else "tile"), (
                        win, D, B)
                    assert 0 < plan["smem"] <= SMEM_MAX
                    assert plan["smem"] == _layout_bytes(plan, win, step)
                    assert plan["chunk"] <= plan["dcp"]
                    assert 1 <= plan["jg"] <= nl
                    gx, gy, gz = plan["grid"]
                    assert gz == B * -(-D // plan["chunk"])
                    assert gx <= 2**31 - 1 and gy <= 65_535 and gz <= 65_535
                    if wide:
                        assert plan["chunk"] in asw_cuda.WIDE_CHUNKS
                        assert gx == -(-W // 32) and gy == -(-H // 4)
                        continue
                    assert plan["chunk"] in asw_cuda.CHUNKS
                    assert plan["chunk"] >= min(D, 4)
                    assert plan == asw_cuda._tile_plan(win, step, D, B, H, W)
                    assert plan["dcp"] == (4 if plan["chunk"] == 4 else 12)
                    assert gx == -(-W // 32) and gy == -(-H // 8)


def test_plan_main_configuration():
    """win 35, d 4..14 (D = 11) at both main-path sizes: the tile kernel,
    one chunk of 12 holding all 11 disparities, two groups of e2 columns,
    three blocks of 8 warps an SM."""
    for H, W in ((288, 384), (720, 1280)):
        plan = asw_cuda._plan(35, 1, 11, 1, H, W)
        assert plan == dict(path="tile", chunk=12, dcp=12, jg=18,
                            smem=69_824, frames=1,
                            grid=(-(-W // 32), -(-H // 8), 1))
        assert plan["smem"] <= THREE_BLOCKS


@pytest.mark.parametrize("D,chunk", [(1, 4), (4, 4), (5, 8), (8, 8),
                                     (9, 12), (12, 12), (13, 12),
                                     (128, 12)])
def test_plan_chunk_holds_d(D, chunk):
    """The tile kernel's plan: the smallest compiled chunk that holds D,
    12 at most; the grid's z covers every chunk. It is the plan for D up
    to 12."""
    plan = asw_cuda._tile_plan(9, 1, D, 2, 45, 150)
    assert plan["chunk"] == chunk
    assert plan["grid"][2] == 2 * -(-D // chunk)
    if D <= 12:
        assert asw_cuda._plan(9, 1, D, 2, 45, 150) == plan


def test_plan_l1_path_where_no_tile_fits():
    """A window whose tile cannot fit 227 KB, or no budget at all, takes
    the L1 kernel: no shared memory, 16 disparities a walk."""
    for win in (1001, 2001):
        plan = asw_cuda._plan(win, 1, 11, 2, 45, 150)
        assert plan["path"] == "l1" and plan["smem"] == 0
        assert plan["grid"] == (5, 6, 2)
    plan = asw_cuda._plan(35, 1, 11, 1, 288, 384, budgets=())
    assert plan["path"] == "l1" and plan["smem"] == 0


def test_plan_budget_order():
    """The tile kernel's plan, occupancy first: win 111 drops the chunk to
    4 to keep three blocks an SM; with only the two-block budget it keeps
    12 disparities."""
    three = asw_cuda._tile_plan(111, 1, 20, 1, 45, 150)
    assert (three["chunk"], three["dcp"]) == (4, 4)
    assert three["smem"] <= THREE_BLOCKS
    two = asw_cuda._tile_plan(111, 1, 20, 1, 45, 150, budgets=(115_712,))
    assert (two["chunk"], two["dcp"]) == (12, 12)
    assert THREE_BLOCKS < two["smem"] <= 115_712


@pytest.mark.parametrize("win,step", [(35, 1), (35, 2), (9, 1), (111, 3)])
def test_plan_groups_even(win, step):
    """The e2 groups split the lattice's columns evenly: the group count
    is the least that the budget allows, and no group is empty."""
    nl = 2 * ((win // 2) // step) + 1
    plan = asw_cuda._plan(win, step, 11, 1, 100, 100)
    groups = -(-nl // plan["jg"])
    assert (groups - 1) * plan["jg"] < nl <= groups * plan["jg"]
    bigger = asw_cuda._plan(win, step, 11, 1, 100, 100,
                            budgets=(SMEM_MAX,))
    assert bigger["jg"] >= plan["jg"]


@pytest.mark.parametrize("D", [1, 4, 6, 11, 40])
def test_plan_tad_rows_conflict_free(D):
    """A quarter-warp's 16-byte loads of tad rows (8 neighbouring threads,
    stride dcp floats) hit eight distinct 16-byte bank groups (of the 32
    four-byte banks), and a row holds the chunk."""
    plan = asw_cuda._plan(35, 1, D, 1, 288, 384)
    dcp = plan["dcp"]
    assert dcp % 4 == 0 and dcp >= plan["chunk"]
    assert len({(t * dcp // 4) % 8 for t in range(8)}) == 8


@pytest.mark.parametrize("case", ["deep_stack", "tall_image"])
def test_plan_rejects_grid_beyond_limits(case):
    """A stack whose frames x chunks pass grid z runs in launches of as
    many frames as fit (65,535 frames at D = 128 in 12 pieces of at most
    5,957 on the tile kernel; at D = 256 in 3 pieces of 21,845 on the
    wide one); an image whose own rows pass grid y is refused."""
    if case == "deep_stack":
        plan = asw_cuda._tile_plan(35, 1, 128, 65_535, 8, 8)
        nchunks = -(-128 // plan["chunk"])
        assert plan["frames"] == 65_535 // nchunks == 5_957
        assert plan["grid"][2] == plan["frames"] * nchunks <= 65_535
        pieces = _build.frame_pieces(65_535, plan["frames"])
        assert len(pieces) == 12 and pieces[-1][1] == 65_535
        wide = asw_cuda._plan(35, 1, 256, 65_535, 8, 8)
        assert (wide["path"], wide["chunk"], wide["frames"]) == (
            "wide", 96, 21_845)
        assert wide["grid"][2] == 65_535
        assert len(_build.frame_pieces(65_535, wide["frames"])) == 3
        l1 = asw_cuda._plan(35, 1, 128, 70_000, 8, 8, budgets=())
        assert l1["frames"] == 65_535 == l1["grid"][2]
    else:
        with pytest.raises(ValueError, match="grid"):
            asw_cuda._plan(35, 1, 11, 1, 8 * 65_536, 8)


def test_cpu_pass_ignores_plan():
    """A CPU tensor runs the twin whatever the plan says; no launch."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1, 11, 19, 3), np.uint8)
    planes = asw_cuda._build_planes(torch.tensor(img),
                                    torch.tensor(np.roll(img, -2, axis=2)),
                                    5, 0, 3)
    kw = dict(H=11, W=19, win_size=5, min_disp=0, max_disp=3, gamma_c=5.0,
              gamma_p=17.5, consistent=True, subpixel=True)
    n0 = asw_cuda.launches
    for plan in (asw_cuda._plan(5, 1, 4, 1, 11, 19),
                 asw_cuda._plan(5, 1, 4, 1, 11, 19, budgets=())):
        got = asw_cuda._asw_pass(planes, plan=plan, **kw)
        want = asw_cuda._asw_pass_plain(planes, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert asw_cuda.launches == n0


@pytest.mark.parametrize("D", [1, 5, 11, 12])
@pytest.mark.parametrize("win,step", [(35, 1), (35, 2), (9, 3), (111, 1)])
def test_plan_small_d_keeps_the_tile_kernel(D, win, step):
    """D <= 12 (the asw_tsukuba cells, D = 11) takes the tile kernel's
    plan as before, and a budget list without the largest budget too."""
    for budgets in (asw_cuda.SMEM_BUDGETS, (115_712,), ()):
        plan = asw_cuda._plan(win, step, D, 2, 288, 384, budgets=budgets)
        assert plan == asw_cuda._tile_plan(win, step, D, 2, 288, 384,
                                           budgets=budgets)
        assert plan["path"] != "wide"


@pytest.mark.parametrize("step", [1, 2, 3])
def test_wide_plan_fits_up_to_d_256(step):
    """D 13..256 at every odd window the tile kernel takes (1..111), at
    720p and at one pixel, B 1 and 3: at steps 1 and 2 a wide plan within
    232,448 bytes of shared memory and CUDA's grid limits, its chunks
    covering D: of the wide blocks that fit, the fewest chunks, then the
    smallest block. The wide kernel has no build for step 3, which keeps
    the tile kernel's chunks of 12."""
    if step not in asw_cuda.WIDE_STEPS:
        for D in (13, 90, 256):
            plan = asw_cuda._plan(35, step, D, 1, 720, 1280)
            assert plan == asw_cuda._tile_plan(35, step, D, 1, 720, 1280)
            assert plan["chunk"] == 12
        return
    for win in range(1, 112, 2):
        nl = 2 * ((win // 2) // step) + 1
        for D in range(13, 257):
            for B in (1, 3):
                for H, W in ((720, 1280), (1, 1)):
                    plan = asw_cuda._plan(win, step, D, B, H, W)
                    assert plan["path"] == "wide", (win, D)
                    assert plan["step"] == step
                    chunk = plan["chunk"]
                    nchunks = -(-D // chunk)
                    for c in asw_cuda.WIDE_CHUNKS:
                        if (-(-D // c), c) < (nchunks, chunk):
                            fixed, per_j = asw_cuda._wide_floats(win, step, c)
                            assert 4 * (fixed + per_j) > SMEM_MAX, (win, D, c)
                    assert 0 < plan["smem"] <= SMEM_MAX
                    assert plan["smem"] == _layout_bytes(plan, win, step)
                    assert chunk % (4 * asw_cuda.WIDE_GROUPS) == 0
                    assert 1 <= plan["jg"] <= nl
                    assert plan["grid"] == (-(-W // 32), -(-H // 4),
                                            B * nchunks)
                    assert max(plan["grid"][1:]) <= 65_535


@pytest.mark.parametrize("D", [13, 24, 90, 128, 200])
@pytest.mark.parametrize("step", asw_cuda.WIDE_STEPS)
def test_wide_plan_tad_rows_conflict_free(D, step):
    """The wide kernel's tad row stride is 4 x an odd number of floats
    and holds the block's disparities; each group's run starts on a
    16-byte word. A quarter-warp's 8 pairs (xa, xa + step) of one row,
    xa = (a // step) * 2 step + a % step, load the tad rows of xa's
    window column from 8 distinct 16-byte bank groups at every column
    offset, the rows being 4 step floats longer every 2 step columns."""
    plan = asw_cuda._plan(35, step, D, 1, 720, 1280)
    dcp = plan["dcp"]
    assert plan["path"] == "wide" and dcp % 4 == 0 and (dcp // 4) % 2 == 1
    assert plan["chunk"] <= dcp < plan["chunk"] + 8
    assert (plan["chunk"] // asw_cuda.WIDE_GROUPS) % 4 == 0
    xa = [a // step * 2 * step + a % step for a in range(16)]
    assert sorted(xa + [x + step for x in xa]) == list(range(32))
    for first in (0, 8):
        for shift in range(64 + 2 * step):
            cols = [x + shift for x in xa[first:first + 8]]
            words = [(c * dcp + c // (2 * step) * 4 * step) // 4 for c in cols]
            assert len({w % 8 for w in words}) == 8, (first, shift)


def test_wide_plan_gives_way_where_it_cannot_fit():
    """A window too wide for any wide block takes the tile kernel; one
    that fits only a smaller block takes more chunks of it; a frame taller
    than the wide grid's 65,535 rows of 4 takes the tile kernel's rows of
    8; no budget at all takes the L1 kernel."""
    assert asw_cuda._plan(111, 1, 90, 1, 720, 1280)["chunk"] == 64
    assert asw_cuda._plan(201, 1, 90, 1, 720, 1280)["chunk"] == 32
    for win in (301, 901, 1001):
        plan = asw_cuda._plan(win, 1, 90, 1, 45, 150)
        assert plan == asw_cuda._tile_plan(win, 1, 90, 1, 45, 150)
        assert plan["path"] != "wide"
    tall = asw_cuda._plan(35, 2, 90, 1, 4 * 65_536, 8)
    assert tall["path"] == "tile" and tall["grid"][1] == 32_768
    assert asw_cuda._plan(35, 2, 90, 1, 720, 1280, budgets=())["path"] == "l1"


def test_the_kernel_names_are_read_by_k1_roofline():
    """Each cost kernel's name in the source holds one of K1's kernel
    names, so the benchmark counts the wide kernel's time as K1's."""
    src = SOURCE.read_text()
    names = re.findall(r"__global__ void __launch_bounds__\([^)]*\) (\w+)\(",
                       src)
    assert "asw_cost_tile_kernel_wide" in names
    assert "asw_cost_tile_kernel" in names
    for name in names:
        assert any(k in name for k in k1_roofline.KERNELS), name
