"""The frozen references against the port's CPU twins, at small sizes.

The references import nothing of the port; this test imports both and
feeds them the same pairs. SGM's float32 steps are whole numbers, so its
maps must be equal; ASW's float sums differ from the twin's only in
rounding, so at most a near-tie pixel may differ."""

import numpy as np
import pytest
import torch

from portbench.harness import core, scenes, spec
from portbench.harness.core import worst_map_mismatch_pct

SCENE = {"background": 5, "layers": [[8, 0.10, 0.45, 0.15, 0.55],
                                     [11, 0.55, 0.85, 0.10, 0.50],
                                     [14, 0.15, 0.35, 0.60, 0.85]]}
NEAR_TIE_PCT = 0.5


def pairs(n, w, h, scene=SCENE, seed=5):
    made = [scenes.layered_pair(core.rngs(seed)[0] if i == 0 else rng,
                                w, h, scene)[:2]
            for i, rng in enumerate([None] + [core.rngs(seed + i)[0]
                                              for i in range(1, n)])]
    return (np.stack([a for a, _ in made]), np.stack([b for _, b in made]))


def ref(name):
    return spec.Bench().module("reference", name)


@pytest.mark.parametrize("params", [
    dict(winSize=7, minDisparity=4, maxDisparity=14, gammaC=15,
         gammaP=17.5, consistent=True),
    dict(winSize=9, minDisparity=0, maxDisparity=12, gammaC=5,
         gammaP=17.5, consistent=False),
    dict(winSize=11, minDisparity=2, maxDisparity=15, gammaC=15,
         gammaP=17.5, consistent=True, step=2),
], ids=["tsukuba-small", "plain", "step2"])
def test_asw_reference_matches_the_port(params):
    from simplestereo_tpu_torch.passive import StereoASW
    lefts, rights = pairs(2, 64, 40)
    want = StereoASW(**params, device="cpu").computeBatch(lefts, rights)
    got = ref("asw").disparity({"params": params}, lefts, rights, "cpu")
    assert got.dtype == want.dtype == np.int16
    assert worst_map_mismatch_pct(got, want) <= NEAR_TIE_PCT


@pytest.mark.parametrize("params", [
    dict(minDisparity=1, numDisparities=16, blockSize=3, costMethod="census",
         censusWindow=7, P1=120, P2=480, paths=8, uniquenessRatio=10,
         disp12MaxDiff=-1),
    dict(minDisparity=0, numDisparities=20, blockSize=5, costMethod="census",
         censusWindow=5, P1=40, P2=300, paths=4, uniquenessRatio=0,
         disp12MaxDiff=1),
    dict(minDisparity=2, numDisparities=13, blockSize=1, costMethod="census",
         censusWindow=3, P1=8, P2=32, paths=8, uniquenessRatio=15,
         disp12MaxDiff=0),
], ids=["lawn-small", "paths4-lr", "block1"])
def test_sgm_reference_equals_the_port(params):
    from simplestereo_tpu_torch.passive import StereoSGM
    lefts, rights = pairs(3, 72, 36)
    want = StereoSGM(**params, device="cpu").computeBatch(lefts, rights)
    got = ref("sgm").disparity({"params": params}, lefts, rights, "cpu",
                               block=2)
    assert got.dtype == want.dtype == np.int16
    assert np.array_equal(got, want)


def test_reference_imports_nothing_of_the_port():
    for name in ("asw", "sgm"):
        text = (spec.BENCH_DIR / "reference" / f"{name}.py").read_text()
        assert "simplestereo" not in text.replace(
            "imports nothing of the program", "")


def test_asw_right_costs_are_the_left_costs_shifted():
    """cost_R(x, d) = cost(x + d, d): the right image's own volume holds
    the same terms (mirrored here, so summed in another order)."""
    asw = ref("asw")
    lefts, rights = pairs(1, 48, 24)
    l32 = torch.as_tensor(lefts).float()
    r32 = torch.as_tensor(rights).float()
    left = asw.cost_volume(l32, r32, 7, 15.0, 17.5, 0, 8)
    # the right image as reference: mirror both images, swap them
    right = asw.cost_volume(r32.flip(2), l32.flip(2), 7, 15.0, 17.5, 0, 8)
    right = right.flip(2)
    W = lefts.shape[2]
    for d in range(9):
        a = left[0, :, d:, d]
        b = right[0, :, :W - d, d]
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        f = torch.isfinite(a)
        assert torch.allclose(a[f], b[f], rtol=1e-5, atol=0)
