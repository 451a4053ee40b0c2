"""PyTorch port: the ASW slice end to end on the CPU, against the JAX
package (its Pallas kernel in interpret mode, as tests/test_passive_asw.py
runs it).

Tolerances: disparity mismatch <= 1.2% (the budget of
tests/test_passive_asw.py: argmin near-ties flip on last-ulp cost
differences); sub-pixel values within 1e-4 where the integer parts agree;
batches bit-equal to per-frame results.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import simplestereo_tpu as jss
from simplestereo_tpu.passive import asw_disparity as jax_asw_disparity
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch.convert import asw_from_jax
from simplestereo_tpu_torch.passive import asw_cuda

MISMATCH = 0.012
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed, h=21, w=37, shift=3):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, (h, w, 3), np.uint8)
    return img1, np.roll(img1, -shift, axis=1)


def _port(img1, img2, **kw):
    return asw_cuda.asw_disparity(torch.tensor(img1), torch.tensor(img2),
                                  **kw).numpy()


@pytest.mark.parametrize("kw,cols", [
    (dict(win_size=7, min_disp=1, max_disp=6, consistent=False), None),
    (dict(win_size=7, min_disp=1, max_disp=6, consistent=True), None),
    (dict(win_size=7, min_disp=1, max_disp=6, consistent=True, step=2), None),
    (dict(win_size=7, min_disp=0, max_disp=17, consistent=True), None),
    # min_disp < 0: the JAX functions disagree on the right map at columns
    # x < -min_disp (see ROADMAP section C); the port marks those
    # candidates invalid, so compare from column -min_disp on.
    (dict(win_size=5, min_disp=-3, max_disp=16, consistent=True), 3),
])
def test_asw_disparity_matches_jax(kw, cols):
    img1, img2 = _pair(10, h=24, w=48) if cols else _pair(11)
    want = np.asarray(jax_asw_disparity(img1, img2, **kw))
    got = _port(img1, img2, **kw)
    assert got.dtype == np.int16 and got.shape == want.shape
    assert (got[:, cols:] != want[:, cols:]).mean() <= MISMATCH


@pytest.mark.parametrize("consistent", [False, True])
def test_subpixel_matches_jax(consistent):
    img1, img2 = _pair(12)
    kw = dict(win_size=5, min_disp=1, max_disp=6, consistent=consistent,
              subpixel=True)
    want = np.asarray(jax_asw_disparity(img1, img2, **kw))
    got = _port(img1, img2, **kw)
    assert got.dtype == np.float32
    same = np.floor(got) == np.floor(want)
    assert 1 - same.mean() <= MISMATCH
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(win_size=5, min_disp=0, max_disp=4, consistent=True),
    dict(win_size=5, min_disp=1, max_disp=20, consistent=False,
         subpixel=True),
])
def test_batch_matches_single(kw):
    rng = np.random.default_rng(13)
    imgs1 = rng.integers(0, 256, (3, 16, 24, 3), np.uint8)
    imgs2 = np.roll(imgs1, -2, axis=2)
    batch = asw_cuda.asw_disparity_batch(torch.tensor(imgs1),
                                         torch.tensor(imgs2), **kw).numpy()
    assert batch.shape == (3, 16, 24)
    for i in range(3):
        np.testing.assert_array_equal(batch[i], _port(imgs1[i], imgs2[i],
                                                      **kw))


def test_stereo_asw_matches_jax_on_known_shift():
    """The slice through the matcher classes: the JAX StereoASW converted
    with asw_from_jax, on a 24x48 pair with a known shift of 3."""
    img1, img2 = _pair(14, h=24, w=48)
    jm = jss.passive.StereoASW(winSize=5, maxDisparity=6, minDisparity=1,
                               gammaC=15, gammaP=17.5, consistent=True)
    tm = asw_from_jax(jm, device="cpu")
    assert tm.device == torch.device("cpu")
    before = asw_cuda.launches
    got = tm.compute(img1, img2)
    assert asw_cuda.launches == before  # CPU path: no kernel launch
    want = jm.compute(img1, img2)
    assert isinstance(got, np.ndarray) and got.dtype == np.int16
    assert (got != want).mean() <= MISMATCH
    assert (got[5:-5, 8:-8] == 3).mean() > 0.95

    batch = tm.computeBatch(np.stack([img1, img2]), np.stack([img2, img1]))
    np.testing.assert_array_equal(batch[0], got)
    np.testing.assert_array_equal(batch[1], tm.compute(img2, img1))


def test_stereo_asw_api():
    img1, img2 = _pair(15)
    m = tss.passive.StereoASW(winSize=7, maxDisparity=6, minDisparity=1,
                              consistent=True, subpixel=True, device="cpu")
    out = m.compute(img1, img2)
    assert out.shape == img1.shape[:2] and out.dtype == np.float32
    with pytest.raises(ValueError):
        tss.passive.StereoASW(winSize=8, device="cpu")
    with pytest.raises(ValueError):
        tss.passive.StereoASW(step=0, device="cpu")
    with pytest.raises(ValueError):
        m.compute(img1[..., 0], img2[..., 0])
    with pytest.raises(ValueError):
        m.computeBatch(img1, img2)
    with pytest.raises(NotImplementedError):
        asw_cuda.asw_disparity(torch.tensor(img1), torch.tensor(img2),
                               context=True)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.passive.StereoASW(device="cuda")
    assert tss.resolve_device("cpu") == torch.device("cpu")


def test_port_runs_with_jax_blocked():
    """The port imports and runs its CPU path in a process where jax (and
    pillow) cannot be imported, as on the GPU machine."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["PIL"] = None
        import numpy as np
        import simplestereo_tpu_torch as tss
        from simplestereo_tpu_torch.passive import asw_cuda
        rng = np.random.default_rng(0)
        img1 = rng.integers(0, 256, (16, 32, 3), np.uint8)
        img2 = np.roll(img1, -2, axis=1)
        m = tss.passive.StereoASW(winSize=5, maxDisparity=4,
                                  consistent=True, device="cpu")
        d = m.compute(img1, img2)
        assert d.dtype == np.int16 and (d[3:-3, 6:-3] == 2).mean() > 0.95
        assert asw_cuda.launches == 0
        assert "simplestereo_tpu" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_evaluation_copy_matches_jax_package():
    rng = np.random.default_rng(16)
    disp = rng.integers(-1, 12, (20, 30)).astype(np.int16)
    gt = rng.integers(0, 12 * 16, (20, 30)).astype(np.uint8)
    mask = rng.random((20, 30)) < 0.8
    for kw in (dict(), dict(mask=mask, invalid=-1, gt_scale=1 / 16),
               dict(mask=mask, invalid=-1, count_invalid_as_bad=False)):
        assert tss.evaluation.evaluate_disparity(disp, gt, **kw) == \
            jss.evaluation.evaluate_disparity(disp, gt, **kw)
