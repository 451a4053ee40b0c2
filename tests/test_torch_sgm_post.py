"""SGM's post: the post kernel (``sgm_cuda.post``) and its twin, the torch
code of ``sgm._sgm_post_plain``, against the JAX package's ``_sgm_post``
through its maps stored by tests/golden/sgm_post/make_golden.py (see
tests/sgm_post_cases.py): path sums with planted ties, signed zeros,
infinities and all-off-image columns at D 9, 13, 40, 150 (16 lanes a
pixel) and 600 (the candidates read from S), and rows of 1280 columns at
D = 96, the benchmark's 720p width and candidates, each under the 12
option sets of the post (left-right check off, 0 and 1; subpixel;
uniqueness 0 and 10). Equal bit for bit: SGM's maps are compared exactly.

Tests marked ``card`` run the kernel and skip without a CUDA card. There
the kernel is also held ``torch.equal`` to its twin on real path sums
(the benchmark's 720p D = 96, one frame and 8; the SGM main path's
384x288 D = 16 and 720p D = 128; an option sweep at 45x150), on planted
S at D = 40, at D 600, on a 20,000-column row and on 70,000 frames, and
``compute`` and ``computeBatch`` launch it once a call. This file imports
no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sgm_post.py
"""

import functools

import numpy as np
import pytest
import torch

import sgm_post_cases as cases
from cuda_card import card  # noqa: F401 (the fixture)
from simplestereo_tpu_torch.passive import sgm, sgm_cuda


@pytest.mark.parametrize("kind", cases.KINDS)
def test_twin_equals_jax(kind):
    S, md = cases.planted(kind)
    want = cases.golden_maps(kind)
    for kw, w in zip(cases.options(md, S.shape[-1]), want):
        got = sgm._sgm_post(torch.tensor(S), **kw)
        assert got.dtype == torch.int16
        assert np.array_equal(got.numpy(), w), kw


# -- on the card ------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("kind", cases.KINDS)
def test_kernel_equals_jax(card, kind):
    S, md = cases.planted(kind)
    S = torch.tensor(S, device=card)
    want = cases.golden_maps(kind)
    for kw, w in zip(cases.options(md, S.shape[-1]), want):
        before = sgm_cuda.post_launches
        got = sgm._sgm_post(S, **kw)
        torch.cuda.synchronize()
        assert sgm_cuda.post_launches == before + 1
        assert got.dtype == torch.int16 and got.device.type == "cuda"
        got = got.cpu().numpy()
        assert np.array_equal(got, w), (kw, int((got != w).sum()))


@pytest.mark.card
@pytest.mark.parametrize("shape", [(0, 4, 8, 16), (2, 0, 8, 16),
                                   (2, 4, 0, 16)])
def test_empty_S_launches_nothing(card, shape):
    before = sgm_cuda.post_launches
    got = sgm_cuda.post(torch.empty(shape, device=card), 0, 16, 10.0, 1,
                        True)
    assert got.shape == shape[:-1] and got.dtype == torch.int16
    assert sgm_cuda.post_launches == before


def test_the_cases_run_every_plan():
    """The card's cases below and the stored kinds reach every (NJ,
    group) plan of the post kernel: NJ 4, 8, 12 and 16 on 8 lanes a
    pixel, 12 on 16, and S read at each use (NJ 0) on 32."""
    plans = {sgm_cuda._post_plan(D) for D in (96, 16, 128, 13, 40, 150,
                                              600, 8, 5)}
    assert plans == {(12, 8), (4, 8), (16, 8), (8, 8), (12, 16), (0, 32)}


# Real path sums: the benchmark's sgm_lawn720 configuration (census 7,
# block 3, P1 120, P2 480) on the stand-in resource tree's layered scenes
# (tests/torch_example_res.py), aggregated by the SGM kernel on the card.
LAWN = dict(minDisparity=1, numDisparities=96, blockSize=3,
            costMethod="census", censusWindow=7, P1=120, P2=480)


@functools.cache
def _hd_scenes():
    import torch_example_res as res
    return [res.tsukuba_scene((1280, 720), seed=50 + i)[:2]
            for i in range(4)]


def _scenes(B, h, w, seed):
    """B layered (w, h) pairs; at 720p the four of ``_hd_scenes``, rows
    rolled."""
    if (h, w) == (720, 1280):
        return [tuple(np.roll(v, seed + i, axis=0)
                      for v in _hd_scenes()[i % 4]) for i in range(B)]
    import torch_example_res as res
    return [res.tsukuba_scene((w, h), seed=seed + i)[:2] for i in range(B)]


def _path_sum(card, B, h, w, seed, min_disp=1, D=96, **kw):
    """S of B layered (w, h) scenes in the LAWN configuration."""
    cfg = {**LAWN, "minDisparity": min_disp, "numDisparities": D, **kw}
    m = sgm.StereoSGM(device="cuda", **cfg)
    views = _scenes(B, h, w, seed)
    C = sgm._cost_from_gray(*(
        sgm._gray_frames(torch.tensor(np.stack([v[i] for v in views]),
                                      device=card)) for i in (0, 1)),
        **{k: v for k, v in m._kwargs(True).items() if k in (
            "min_disp", "num_disp", "block_size", "prefilter_cap",
            "cost_method", "census_window")})
    return sgm_cuda.aggregate(C.contiguous(), m.P1, m.P2, m.paths)


def _opts(min_disp, D, lr=-1, uniqueness=10.0, subpixel=True):
    return dict(min_disp=min_disp, num_disp=D, uniqueness=uniqueness,
                disp12_max_diff=lr, subpixel=subpixel)


def _held(S, kw, on_card=False):
    """The kernel, one counted call, ``torch.equal`` to the twin (on the
    CPU, or on the card)."""
    before = sgm_cuda.post_launches
    got = sgm_cuda.post(S, **kw)
    torch.cuda.synchronize()
    assert sgm_cuda.post_launches == before + 1
    want = sgm._sgm_post_plain(S if on_card else S.cpu(), **kw)
    assert torch.equal(got.cpu(), want.cpu()), (
        kw, int((got.cpu() != want.cpu()).sum()))
    return got


@pytest.mark.card
def test_benchmark_path_sums_at_720p(card):
    """720p D = 96 from min_disp 1, one frame and 8, left-right check off
    and at 1; the twin on the card equals the CPU's on one frame."""
    S1 = _path_sum(card, 1, 720, 1280, 0)
    S8 = _path_sum(card, 8, 720, 1280, 1)
    for lr in (-1, 1):
        got = _held(S1, _opts(1, 96, lr))
        assert torch.equal(sgm._sgm_post_plain(S1, **_opts(1, 96, lr)), got)
        _held(S8, _opts(1, 96, lr), on_card=True)


@pytest.mark.card
@pytest.mark.parametrize("h, w, min_disp, D", [(288, 384, 0, 16),
                                               (720, 1280, 0, 128)])
def test_main_shapes(card, h, w, min_disp, D):
    """The SGM main path's shapes, block 3: uniqueness 0 without the
    left-right check, 10 with it at 1."""
    S = _path_sum(card, 1, h, w, 70, min_disp, D, blockSize=3)
    for lr, uniqueness in ((-1, 0.0), (1, 10.0)):
        _held(S, _opts(min_disp, D, lr, uniqueness))


@pytest.mark.card
@pytest.mark.parametrize("min_disp, D", [(0, 13), (-3, 40), (1, 150)])
def test_option_sweep_on_path_sums(card, min_disp, D):
    """A layered 45x150 pair of 2 frames (D not a multiple of 32; on 8
    and 16 lanes a pixel) under every uniqueness, left-right check and
    subpixel setting."""
    S = _path_sum(card, 2, 45, 150, 80, min_disp, D)
    for lr in (-1, 0, 1):
        for uniqueness in (0.0, 10.0):
            for subpixel in (False, True):
                _held(S, _opts(min_disp, D, lr, uniqueness, subpixel))


@pytest.mark.card
def test_planted_ties_infinities_and_off_image_columns(card):
    """Ties, signed zeros and infinities at D = 40, a row whose every
    candidate is infinite, and min_disp 290: columns 0..289 of 300 have
    every candidate off the image."""
    rng = np.random.default_rng(90)
    planted = rng.integers(0, 4, (2, 7, 300, 40)).astype(np.float32)
    planted[(planted == 0) & (rng.random(planted.shape) < 0.5)] = -0.0
    planted[rng.random(planted.shape) < 0.01] = np.inf
    planted[rng.random(planted.shape) < 0.001] = -np.inf
    planted[:, 3, ::5] = np.inf
    S = torch.tensor(planted, device=card)
    for min_disp in (0, -3, 1, 290):
        for lr in (-1, 0, 1):
            _held(S, _opts(min_disp, 40, lr))


@pytest.mark.card
@pytest.mark.parametrize("shape, min_disp", [
    ((1, 3, 700, 600), 2),        # D 600: the candidates read from S
    ((2, 20_000, 8), 0),          # 20,000 columns: scratch in device memory
    ((70_000, 2, 3, 5), -1),      # 70,000 frames: two launches
], ids=["D600", "20000-columns", "70000-frames"])
def test_past_the_plans_and_the_grid(card, shape, min_disp):
    rng = np.random.default_rng(91)
    high = 1000 if shape[-1] == 600 else 50
    S = torch.tensor(rng.integers(0, high, shape).astype(np.float32),
                     device=card)
    for lr in (-1, 1):
        _held(S, _opts(min_disp, shape[-1], lr))


@pytest.mark.card
def test_one_launch_a_call_on_compute_and_computeBatch(card):
    left, right = _hd_scenes()[0]
    m = sgm.StereoSGM(device="cuda", **LAWN)
    before = sgm_cuda.post_launches
    one = m.compute(left, right)
    batch = m.computeBatch(np.stack([left] * 2), np.stack([right] * 2))
    assert sgm_cuda.post_launches == before + 2
    np.testing.assert_array_equal(batch[0], one)
