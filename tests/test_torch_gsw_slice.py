"""PyTorch port: the GSW slice end to end on the CPU, ``StereoGSW(device=
"cpu")`` against the JAX package's ``StereoGSW`` (its XLA path, as the JAX
tests run it on the CPU).

Tolerances:
- SD and consistent maps: at least 99% of pixels equal. The twin sums
  the window in another order than XLA and its exp differs in the last
  ulps, so last-ulp ties can flip (tests/test_torch_gsw.py bounds each
  flip as a near-tie); measured: 100% equal on every case below;
- MI with the JAX bootstrap field passed in as ``disp0``: at least 99%
  equal; measured: 100% equal on every case below;
- the reference-C++ golden map ``gsw_w5_d0_4``: at most 0.5% mismatch,
  the bar of tests/test_passive_asw.py::test_reference_cpp_golden_fixture;
- batches are bit-equal to per-frame results.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import simplestereo_tpu as jss
import simplestereo_tpu_torch as tss
from simplestereo_tpu_torch.convert import gsw_from_jax
from simplestereo_tpu_torch.passive import gsw_cuda

AGREE = 0.99
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed, h, w, shift=2, gamma=None):
    """img2(x) = img1(x + shift), optionally through a gamma response."""
    img1 = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    img2 = np.roll(img1, -shift, axis=1)
    if gamma is not None:
        img2 = np.clip(255.0 * (img2 / 255.0) ** gamma, 0,
                       255).astype(np.uint8)
    return img1, img2


def _both(**kw):
    return (jss.passive.StereoGSW(**kw),
            tss.passive.StereoGSW(device="cpu", **kw))


def _jax_bootstrap(h, w, min_disp, max_disp):
    """The JAX package's MI bootstrap field (gsw.py, gsw_pallas.py)."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(0), (h, w),
                                         min_disp, max_disp + 1,
                                         dtype=jnp.int32))


@pytest.mark.parametrize("h,w,kw", [
    (20, 32, dict(winSize=5, maxDisparity=4, iterations=2)),
    (20, 32, dict(winSize=5, maxDisparity=4, iterations=2,
                  consistent=True)),
    (24, 52, dict(winSize=7, maxDisparity=9, minDisparity=2, gamma=12.5,
                  fMax=20, consistent=True)),
    (17, 33, dict(winSize=5, maxDisparity=4, minDisparity=-3,
                  consistent=True)),
    (24, 52, dict(winSize=9, maxDisparity=9, minDisparity=2, step=2,
                  consistent=True)),
    (16, 48, dict(winSize=3, maxDisparity=20, fMax=60)),
    (20, 40, dict(winSize=7, maxDisparity=5, normalize=True,
                  consistent=True)),
])
def test_stereo_gsw_matches_jax(h, w, kw):
    img1, img2 = _pair(30, h, w)
    jm, tm = _both(**kw)
    want = jm.compute(img1, img2)
    got = tm.compute(img1, img2)
    assert isinstance(got, np.ndarray) and got.dtype == np.int16
    assert got.shape == want.shape == (h, w)
    assert (got == want).mean() >= AGREE
    assert tm.lastCostMethod == jm.lastCostMethod == "sd"


@pytest.mark.parametrize("h,w,kw", [
    (24, 40, dict(winSize=5, maxDisparity=4, bins=16, consistent=True)),
    (24, 52, dict(winSize=7, maxDisparity=9, minDisparity=2, bins=16,
                  consistent=True)),
    (17, 33, dict(winSize=5, maxDisparity=4, minDisparity=-3, bins=8,
                  miIterations=3, consistent=True)),
    (16, 48, dict(winSize=3, maxDisparity=20, bins=24)),
])
def test_stereo_gsw_mi_matches_jax(h, w, kw):
    """MI under a gamma-0.5 response with JAX's bootstrap as ``disp0``."""
    img1, img2 = _pair(31, h, w, gamma=0.5)
    jm, tm = _both(costMethod="mi", **kw)
    d0 = _jax_bootstrap(h, w, kw.get("minDisparity", 0), kw["maxDisparity"])
    want = jm.compute(img1, img2)
    got = tm.compute(img1, img2, disp0=d0)
    assert (got == want).mean() >= AGREE
    assert tm.lastCostMethod == "mi"


def test_mi_recovers_shift_under_inversion():
    """The bar of tests/test_passive_asw.py::
    test_gsw_mutual_information_radiometric_robustness, on the port's own
    bootstrap field."""
    img1 = np.random.default_rng(32).integers(0, 256, (24, 40, 3), np.uint8)
    img2 = 255 - np.roll(img1, -2, axis=1)  # shifted AND inverted
    kw = dict(winSize=5, maxDisparity=4, iterations=2, device="cpu")
    sd = tss.passive.StereoGSW(**kw).compute(img1, img2)
    mi = tss.passive.StereoGSW(costMethod="mi", bins=16, miIterations=3,
                               **kw).compute(img1, img2)
    inner = np.s_[4:-4, 6:-6]
    assert (mi[inner] == 2).mean() > 0.9
    assert (mi[inner] == 2).mean() > (sd[inner] == 2).mean() + 0.3


def test_reference_cpp_golden_fixture():
    """The reference C++ GSW map in tests/golden/matcher_golden.npz."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "matcher_golden.npz"))
    m = tss.passive.StereoGSW(winSize=5, maxDisparity=4, minDisparity=0,
                              gamma=10.0, fMax=120.0, iterations=2,
                              device="cpu")
    ours = m.compute(g["img1"], g["img2"])
    mismatch = (ours != g["gsw_w5_d0_4"]).mean()
    assert mismatch <= 0.005, f"gsw: {mismatch:.2%} vs reference C++"


@pytest.mark.parametrize("kw", [
    dict(consistent=True),
    dict(consistent=False, normalize=True),
    dict(consistent=True, costMethod="mi", bins=8),
])
def test_compute_batch_matches_per_frame(kw):
    rng = np.random.default_rng(33)
    imgs1 = rng.integers(0, 256, (3, 16, 24, 3), np.uint8)
    imgs2 = np.roll(imgs1, -2, axis=2)
    m = tss.passive.StereoGSW(winSize=5, maxDisparity=4, device="cpu", **kw)
    batch = m.computeBatch(imgs1, imgs2)
    assert batch.shape == (3, 16, 24) and batch.dtype == np.int16
    for i in range(3):
        np.testing.assert_array_equal(batch[i],
                                      m.compute(imgs1[i], imgs2[i]))


def test_auto_resolves_as_jax():
    img1, img2 = _pair(34, 16, 40)
    g05 = np.clip(255.0 * (img2 / 255.0) ** 0.5, 0, 255).astype(np.uint8)
    jm, tm = _both(winSize=5, maxDisparity=4, costMethod="auto", bins=8,
                   consistent=True)
    d = tm.compute(img1, img2)
    jm.compute(img1, img2)
    assert tm.lastCostMethod == jm.lastCostMethod == "sd"
    assert (d[4:-4, 6:-6] == 2).mean() > 0.9
    tm.compute(img1, g05)
    jm.compute(img1, g05)
    assert tm.lastCostMethod == jm.lastCostMethod == "mi"
    tm.computeBatch(np.stack([img1, img1]), np.stack([g05, g05]))
    assert tm.lastCostMethod == "mi"
    tm.step = 2  # auto with step > 1 never resolves to MI
    tm.compute(img1, g05)
    assert tm.lastCostMethod == "sd"


def _raises(make, call):
    try:
        call(make())
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("kw,call", [
    (dict(winSize=4), "compute"),
    (dict(winSize=0), "compute"),
    (dict(costMethod="nope"), "compute"),
    (dict(step=0), "compute"),
    (dict(step=0), "batch"),
    (dict(costMethod="mi", step=2), "compute"),
    (dict(costMethod="mi", miIterations=0), "compute"),
    (dict(costMethod="mi", miIterations=0), "batch"),
    (dict(costMethod="mi", bins=5), "compute"),
    (dict(), "shapes"),
    (dict(), "gray"),
    (dict(), "batch_of_one_frame"),
    (dict(), "ok"),
])
def test_validation_errors_match_jax(kw, call):
    img1, img2 = _pair(35, 12, 24)
    base = dict(winSize=5, maxDisparity=4)
    calls = {
        "compute": lambda m: m.compute(img1, img2),
        "batch": lambda m: m.computeBatch(img1[None], img2[None]),
        "shapes": lambda m: m.compute(img1, img2[:6]),
        "gray": lambda m: m.compute(img1[..., 0], img2[..., 0]),
        "batch_of_one_frame": lambda m: m.computeBatch(img1, img2),
        "ok": lambda m: m.compute(img1, img2),
    }
    args = dict(base, **kw)
    want = _raises(lambda: jss.passive.StereoGSW(**args), calls[call])
    got = _raises(lambda: tss.passive.StereoGSW(device="cpu", **args),
                  calls[call])
    assert got == want == (call != "ok")


def test_gsw_from_jax():
    jm = jss.passive.StereoGSW(winSize=7, maxDisparity=9, minDisparity=2,
                               gamma=12.5, fMax=20, iterations=1,
                               consistent=True, costMethod="sd",
                               normalize=True, step=2, bins=12,
                               miIterations=3)
    tm = gsw_from_jax(jm, device="cpu")
    assert tm.device == torch.device("cpu")
    assert (tm.winSize, tm.maxDisparity, tm.minDisparity, tm.gamma,
            tm.fMax, tm.step, tm.normalize, tm.bins, tm.miIterations) \
        == (7, 9, 2, 12.5, 20, 2, True, 12, 3)
    img1, img2 = _pair(36, 24, 52)
    before = gsw_cuda.launches
    got = tm.compute(img1, img2)
    assert gsw_cuda.launches == before  # CPU path: no kernel launch
    assert (got == jm.compute(img1, img2)).mean() >= AGREE


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        tss.passive.StereoGSW()


def test_gsw_runs_with_jax_blocked():
    """The GSW path (SD and MI) imports and runs on the CPU in a process
    where jax (and pillow) cannot be imported, as on the GPU machine."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["PIL"] = None
        import numpy as np
        import simplestereo_tpu_torch as tss
        from simplestereo_tpu_torch.passive import gsw, gsw_cuda
        rng = np.random.default_rng(0)
        img1 = rng.integers(0, 256, (20, 36, 3), np.uint8)
        img2 = np.roll(img1, -3, axis=1)
        for kw in (dict(consistent=True), dict(costMethod="mi", bins=16)):
            m = tss.passive.StereoGSW(winSize=5, maxDisparity=6,
                                      device="cpu", **kw)
            d = m.compute(img1, img2)
            assert d.dtype == np.int16
            assert (d[4:-4, 10:-4] == 3).mean() > 0.9, kw
        assert gsw_cuda.launches == 0
        assert "simplestereo_tpu" not in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
