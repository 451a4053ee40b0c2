"""PyTorch port: the SGM slice end to end on the CPU, against the JAX
package's ``StereoSGM`` (its scan aggregator, as the JAX tests run it on
the CPU).

Tolerance: at least 99.9% of pixels equal, the bar of
tests/test_passive_asw.py::test_sgm_compute_pallas_interpret_end_to_end
for two aggregators that differ in the last ulps. Every stage of the
port is bit-equal to the JAX package on the CPU (tests/test_torch_sgm.py),
so in practice the maps are equal. Batches are bit-equal to per-frame
results.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import simplestereo_tpu as jss
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch.convert import sgm_from_jax
from simplestereo_tpu_torch.passive import sgm_cuda

AGREE = 0.999
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed, h, w, shift=2):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, -shift, axis=1)


def _both(**kw):
    return (jss.passive.StereoSGM(**kw),
            tss.passive.StereoSGM(device="cpu", **kw))


@pytest.mark.parametrize("h,w,kw", [
    # tests/test_fuzz_matchers.py::test_sgm_invariants
    (10, 18, dict(numDisparities=4, blockSize=1, paths=4)),
    (9, 17, dict(numDisparities=3, blockSize=3, paths=8)),
    (16, 129, dict(numDisparities=8, blockSize=5, paths=8)),
    (8, 12, dict(numDisparities=16, blockSize=3, paths=4)),
    # tests/test_fuzz_matchers.py::test_sgm_negative_min_disparity
    (14, 22, dict(minDisparity=-4, numDisparities=8, blockSize=3, paths=8)),
])
def test_stereo_sgm_matches_jax(h, w, kw):
    img1, img2 = _pair(20, h, w, shift=min(2, w // 4))
    jm, tm = _both(disp12MaxDiff=1, **kw)
    want = jm.compute(img1, img2)
    got = tm.compute(img1, img2)
    assert isinstance(got, np.ndarray) and got.dtype == np.int16
    assert got.shape == want.shape == (h, w)
    assert (got == want).mean() >= AGREE


def test_negative_min_disparity_true_shift_matches_jax():
    """img2 = img1 rolled right by 2: the true disparity is -2, which the
    LR check must keep (tests/test_fuzz_matchers.py:159-164)."""
    img1, _ = _pair(21, 14, 22)
    img3 = np.roll(img1, 2, axis=1)
    jm, tm = _both(minDisparity=-4, numDisparities=8, blockSize=3, paths=8,
                   disp12MaxDiff=1)
    got = tm.compute(img1, img3)
    assert (got == jm.compute(img1, img3)).mean() >= AGREE
    assert (np.round(got[3:-3, 6:-6] / 16.0) == -2).mean() > 0.9


@pytest.mark.parametrize("method,cw", [
    ("census", 3), ("census", 5), ("census", 7), ("bt+census", 5)])
def test_stereo_sgm_census_matches_jax(method, cw):
    """tests/test_fuzz_matchers.py::test_sgm_census_invariants."""
    img1, img2 = _pair(22, 12, 40)
    jm, tm = _both(minDisparity=0, numDisparities=4, blockSize=3, paths=4,
                   costMethod=method, censusWindow=cw)
    assert (tm.compute(img1, img2) == jm.compute(img1, img2)).mean() \
        >= AGREE


@pytest.mark.parametrize("subpixel", [True, False])
def test_stereo_sgm_options_match_jax(subpixel):
    """Uniqueness, the speckle filter inside compute, and integer output."""
    img1, img2 = _pair(23, 24, 40)
    jm, tm = _both(minDisparity=0, numDisparities=8, blockSize=3,
                   uniquenessRatio=10, speckleWindowSize=50,
                   speckleRange=1)
    got = tm.compute(img1, img2, subpixel=subpixel)
    want = jm.compute(img1, img2, subpixel=subpixel)
    assert (got == want).mean() >= AGREE


@pytest.mark.parametrize("speckle", [0, 50])
def test_compute_on_tensors_equals_numpy(speckle):
    """A tensor pair runs on its own device and gives the numpy path's map
    as an int16 tensor there, with and without the speckle filter."""
    img1, img2 = _pair(23, 24, 40)
    m = tss.passive.StereoSGM(minDisparity=0, numDisparities=8, blockSize=3,
                              uniquenessRatio=10, speckleWindowSize=speckle,
                              speckleRange=1, device="cpu")
    got = m.compute(torch.tensor(img1), torch.tensor(img2))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), m.compute(img1, img2))


@pytest.mark.parametrize("paths", [4, 8])
def test_stereo_sgm_recovers_known_shift(paths):
    """The bar of tests/test_passive_asw.py::test_sgm_recovers_known_shift."""
    img1, img2 = _pair(24, 48, 64, shift=3)
    m = tss.passive.StereoSGM(minDisparity=0, numDisparities=8, blockSize=5,
                              paths=paths, device="cpu")
    d = m.compute(img1, img2).astype(np.float32) / 16.0
    assert (np.abs(d[6:-6, 10:-10] - 3) <= 0.5).mean() > 0.98


@pytest.mark.parametrize("color", [True, False])
def test_compute_batch_matches_per_frame(color):
    rng = np.random.default_rng(25)
    imgs1 = rng.integers(0, 256, (2, 24, 40, 3), np.uint8)
    if not color:
        imgs1 = imgs1[..., 0]
    imgs2 = np.roll(imgs1, -2, axis=2)
    m = tss.passive.StereoSGM(minDisparity=0, numDisparities=8, blockSize=3,
                              disp12MaxDiff=1, speckleWindowSize=20,
                              device="cpu")
    batch = m.computeBatch(imgs1, imgs2)
    assert batch.shape == (2, 24, 40) and batch.dtype == np.int16
    for i in range(2):
        np.testing.assert_array_equal(batch[i],
                                      m.compute(imgs1[i], imgs2[i]))


def test_compute_batch_shape_errors():
    rng = np.random.default_rng(26)
    imgs = rng.integers(0, 256, (2, 12, 20, 3), np.uint8)
    m = tss.passive.StereoSGM(numDisparities=4, device="cpu")
    for a, b in ((imgs[0], imgs[0]),               # one color frame
                 (imgs[:, :, :3, 0], imgs[:, :, :3, 0]),  # (B, H, 3) gray
                 (imgs[..., :2], imgs[..., :2]),   # not 3 channels
                 (imgs, imgs[:1])):                # shapes differ
        with pytest.raises(ValueError, match="Batches"):
            m.computeBatch(a, b)
    with pytest.raises(ValueError, match="identical shapes"):
        m.compute(imgs[0], imgs[1, :6])


def test_stereo_sgm_validation_and_alias():
    for kw in (dict(numDisparities=0), dict(blockSize=4),
               dict(costMethod="sad"), dict(costMethod="census",
                                             censusWindow=4)):
        with pytest.raises(ValueError):
            tss.passive.StereoSGM(device="cpu", **kw)
    m = tss.passive.StereoSGBM_create(blockSize=5, device="cpu")
    assert isinstance(m, tss.passive.StereoSGM)
    assert (m.P1, m.P2) == (200, 800)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.passive.StereoSGM(device="cuda")


def test_sgm_from_jax():
    jm = jss.passive.StereoSGM(minDisparity=-2, numDisparities=8,
                               blockSize=3, uniquenessRatio=5,
                               costMethod="bt+census", censusWindow=3,
                               paths=4)
    tm = sgm_from_jax(jm, device="cpu")
    assert tm.device == torch.device("cpu")
    assert (tm.P1, tm.P2, tm.paths, tm.costMethod) == (72, 288, 4,
                                                       "bt+census")
    img1, img2 = _pair(27, 16, 30)
    before = sgm_cuda.launches
    got = tm.compute(img1, img2)
    assert sgm_cuda.launches == before  # CPU path: no kernel launch
    assert (got == jm.compute(img1, img2)).mean() >= AGREE


def test_sgm_runs_with_jax_blocked():
    """The SGM path imports and runs on the CPU in a process where jax
    (and pillow) cannot be imported, as on the GPU machine."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["PIL"] = None
        import numpy as np
        import simplestereo_tpu_torch as tss
        from simplestereo_tpu_torch.passive import sgm_cuda
        rng = np.random.default_rng(0)
        img1 = rng.integers(0, 256, (24, 40, 3), np.uint8)
        img2 = np.roll(img1, -3, axis=1)
        m = tss.passive.StereoSGM(numDisparities=8, blockSize=5,
                                  speckleWindowSize=20, device="cpu")
        d = m.compute(img1, img2)
        assert d.dtype == np.int16
        assert (np.abs(d[6:-6, 10:-6] / 16.0 - 3) <= 0.5).mean() > 0.95
        assert sgm_cuda.launches == 0
        assert "simplestereo_tpu" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
