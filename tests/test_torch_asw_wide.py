"""The wide ASW tile kernel (``asw_cost_tile_kernel_wide``, the plan's
"wide" path): one walk of the window for a chunk of up to 128
disparities, against the tile kernel's chunks of 12 on the same planes.

Both sum each disparity's terms over the lattice in the same order with
the same float expressions, so the cost volume, the left and right maps
and the sub-pixel neighbourhood must be equal bit for bit
(``torch.equal``). The cases cover D 13, 24 and 90 (one wide chunk of
32 or 96), 128 (two of 64) and 200 (three of 96), both steps the wide
kernel is built for (1 and 2), windows 5, 35 and 111 (seven e2 groups of
columns), min_disp 0, 1 and 4, the left-right maps and the sub-pixel
neighbourhood on and off, stacks of 1, 2 and 3 frames, sizes that are
no multiple of either tile, and the row-tiled matcher's context mode.
Tests marked ``card`` skip without a CUDA card. This file imports no
JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_asw_wide.py
"""

import numpy as np
import pytest
import torch

from cuda_card import card  # noqa: F401 (the fixture)
from simplestereo_tpu_torch.passive import asw_cuda

# (D, step, win, min_disp, consistent, subpixel, B, H, W, context)
CASES = [
    (13, 1, 5, 0, True, False, 1, 37, 150, False),
    (13, 2, 35, 4, False, True, 3, 41, 67, False),
    (24, 2, 35, 1, False, True, 3, 45, 101, False),
    (24, 1, 5, 1, True, False, 1, 19, 45, False),
    (90, 2, 35, 1, True, False, 1, 43, 211, False),
    (90, 1, 35, 0, False, False, 1, 29, 133, False),
    (90, 1, 111, 1, True, True, 1, 45, 150, False),
    (128, 1, 5, 4, True, True, 3, 21, 170, False),
    (128, 2, 35, 0, True, True, 1, 37, 150, False),
    (200, 1, 5, 0, True, False, 2, 13, 230, False),
    (90, 2, 35, 1, True, True, 2, 80, 181, True),
]
IDS = ["D{}-s{}-w{}-m{}-{}{}-B{}-{}x{}{}".format(
    D, s, w, m, "lr" if c else "nolr", "-sub" if sp else "", B, h, wd,
    "-ctx" if ctx else "") for D, s, w, m, c, sp, B, h, wd, ctx in CASES]


def _planes(seed, B, h, w, win, min_disp, max_disp, context, device):
    """Planes of a noise stack and the same stack shifted 3 columns."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (B, h, w, 3), np.uint8)
    right = np.roll(left, -3, axis=2)
    return asw_cuda._build_planes(
        torch.tensor(left, device=device), torch.tensor(right, device=device),
        win, min_disp, max_disp, context=context)


def _pass_kw(D, step, win, min_disp, consistent, subpixel, h, context):
    return dict(H=h - 2 * (win // 2) if context else h, win_size=win,
                min_disp=min_disp, max_disp=min_disp + D - 1, gamma_c=15.0,
                gamma_p=17.5, step=step, consistent=consistent,
                subpixel=subpixel, context=context)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wide_kernel_equals_the_chunks_of_12(card, case):  # noqa: F811
    D, step, win, min_disp, consistent, subpixel, B, h, w, context = case
    kw = _pass_kw(D, step, win, min_disp, consistent, subpixel, h, context)
    planes = _planes(sum(case[:9]), B, h, w, win, min_disp,
                     kw["max_disp"], context, card)
    args = (win, step, D, B, kw["H"], w)
    wide, tile = asw_cuda._plan(*args), asw_cuda._tile_plan(*args)
    assert wide["path"] == "wide" and tile["path"] == "tile"
    n0 = asw_cuda.launches, asw_cuda.wide_launches
    got = asw_cuda._asw_pass(planes, W=w, plan=wide, **kw)
    assert (asw_cuda.launches, asw_cuda.wide_launches) == (n0[0] + 1,
                                                           n0[1] + 1)
    want = asw_cuda._asw_pass(planes, W=w, plan=tile, **kw)
    assert (asw_cuda.launches, asw_cuda.wide_launches) == (n0[0] + 2,
                                                           n0[1] + 1)
    torch.cuda.synchronize()
    for name, g, t in zip(("cost", "dispL", "dispR", "csub"), got, want):
        assert (g is None) == (t is None), name
        if g is not None:
            assert torch.equal(g, t), name
    assert torch.isfinite(got[0]).any()
    # The default plan of the same pass is the wide one.
    n1 = asw_cuda.wide_launches
    again = asw_cuda._asw_pass(planes, W=w, **kw)
    assert asw_cuda.wide_launches == n1 + 1
    assert torch.equal(again[0], got[0])


@pytest.mark.card
def test_small_d_counts_no_wide_launch(card):  # noqa: F811
    """D = 11 (the asw_tsukuba cells) runs the tile kernel: a launch, no
    wide launch."""
    kw = _pass_kw(11, 1, 35, 4, True, False, 40, False)
    planes = _planes(5, 1, 40, 96, 35, 4, kw["max_disp"], False, card)
    n0 = asw_cuda.launches, asw_cuda.wide_launches
    asw_cuda._asw_pass(planes, W=96, **kw)
    torch.cuda.synchronize()
    assert (asw_cuda.launches, asw_cuda.wide_launches) == (n0[0] + 1, n0[1])


@pytest.mark.card
def test_a_wide_plan_runs_only_its_step(card):  # noqa: F811
    """A wide plan holds the step it was laid out for (its shared memory
    depends on it): a pass of another step refuses it before a launch."""
    kw = _pass_kw(24, 1, 5, 1, True, False, 19, False)
    planes = _planes(6, 1, 19, 45, 5, 1, kw["max_disp"], False, card)
    plan = asw_cuda._plan(5, 2, 24, 1, 19, 45)
    n0 = asw_cuda.launches
    with pytest.raises(ValueError, match="step"):
        asw_cuda._asw_pass(planes, W=45, plan=plan, **kw)
    assert asw_cuda.launches == n0


@pytest.mark.parametrize("context", [False, True])
def test_cpu_pass_with_a_wide_plan_runs_the_twin(context):
    """A CPU tensor runs the plain twin whatever the plan: nothing is
    launched or counted."""
    D, step, win, h, w = 14, 2, 5, 11 + 4 * context, 23
    kw = _pass_kw(D, step, win, 1, True, True, h, context)
    planes = _planes(9, 2, h, w, win, 1, kw["max_disp"], context, "cpu")
    plan = asw_cuda._plan(win, step, D, 2, kw["H"], w)
    assert plan["path"] == "wide"
    n0 = asw_cuda.launches, asw_cuda.wide_launches
    got = asw_cuda._asw_pass(planes, W=w, plan=plan, **kw)
    want = asw_cuda._asw_pass_plain(planes, W=w, **kw)
    for g, t in zip(got, want):
        assert torch.equal(g, t)
    assert (asw_cuda.launches, asw_cuda.wide_launches) == n0
