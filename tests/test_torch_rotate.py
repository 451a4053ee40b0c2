"""PyTorch port: kernel K4, the per-plane dynamic roll
(``simplestereo_tpu_torch/probes/rotate.py``), on the CPU through its
plain twin.

The JAX probe (benchmarks/probe_dynamic_rotate.py) runs only on a TPU,
so the twin is held to the probe's own expectation,
``np.roll(x[d], -d, axis=1)`` (exact, every amount form), and to
``np.roll`` at a ragged shape with negative amounts and amounts larger
than W. What the probe guards, the ASW right map derived from the left
volume, must equal ``asw_cuda._select_plain``'s ``dispR`` bit for bit.
"""

import numpy as np
import pytest
import torch

from simplestereo_tpu_torch.passive import asw_cuda
from simplestereo_tpu_torch.probes import rotate


@pytest.mark.parametrize("mode", rotate.MODES)
def test_probe_forms_exact(mode):
    D, TH, W = rotate.PROBE_SHAPE
    assert (D, TH, W) == (17, 8, 384)
    xn = rotate.probe_input()
    expect = np.stack([np.roll(xn[d], -d, axis=1) for d in range(D)])
    before = rotate.launches
    out = rotate.roll_planes(torch.tensor(xn),
                             rotate.probe_amounts(mode, D, W))
    assert rotate.launches == before  # CPU: the twin, no launch
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), expect)


def test_probe_reports_all_exact_on_cpu():
    assert rotate.probe(device="cpu") == {"pos": True, "neg": True,
                                          "rem": True}


def test_probe_amount_forms():
    W = 384
    np.testing.assert_array_equal(rotate.probe_amounts("pos", 3, W),
                                  [384, 383, 382])
    np.testing.assert_array_equal(rotate.probe_amounts("neg", 3, W),
                                  [0, -1, -2])
    np.testing.assert_array_equal(rotate.probe_amounts("rem", 3, W),
                                  [0, 383, 382])
    with pytest.raises(ValueError):
        rotate.probe_amounts("abs", 3, W)


@pytest.mark.parametrize("shifts", [
    [0, -1, -36, 5, 36],
    [37, -37, 74, -75, 1000],
    [2**31 - 1, -2**31, 38, -38, -1000003],
])
def test_ragged_shape_any_amount(shifts):
    rng = np.random.default_rng(40)
    x = rng.standard_normal((5, 3, 37)).astype(np.float32)
    out = rotate.roll_planes(torch.tensor(x), shifts).numpy()
    expect = np.stack([np.roll(x[n], s, axis=1) for n, s in enumerate(shifts)])
    np.testing.assert_array_equal(out, expect)


def test_shifts_as_tensor():
    x = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    a = rotate.roll_planes(x, torch.tensor([-1, 7], dtype=torch.int64))
    b = rotate.roll_planes(x, [-1, 7])
    assert torch.equal(a, b)


def test_roll_planes_rejects():
    x = torch.zeros((3, 2, 8))
    with pytest.raises(ValueError):
        rotate.roll_planes(x.double(), [0, 0, 0])
    with pytest.raises(ValueError):
        rotate.roll_planes(x, [0, 0])
    with pytest.raises(ValueError):
        rotate.roll_planes(x[:, :, ::2], [0, 0, 0])
    with pytest.raises(ValueError):
        rotate.roll_planes(x[0], [0, 0])
    with pytest.raises(ValueError):
        rotate.roll_planes(torch.zeros((0, 2, 8)), [])


@pytest.mark.parametrize("kw", [
    dict(win_size=7, min_disp=1, max_disp=6),
    dict(win_size=5, min_disp=0, max_disp=17),
    dict(win_size=5, min_disp=-3, max_disp=16),
    dict(win_size=9, min_disp=4, max_disp=14, B=2),
])
def test_right_map_equals_select(kw):
    """The right map through the roll equals the ASW select step's dispR
    on the same twin volume, at a ragged size, edges included."""
    kw = dict(kw)
    B = kw.pop("B", 1)
    h, w = 13, 41
    rng = np.random.default_rng(41)
    l = rng.integers(0, 256, (B, h, w, 3), np.uint8)
    r = np.roll(l, -5, axis=2)
    planes = asw_cuda._build_planes(torch.tensor(l), torch.tensor(r),
                                    kw["win_size"], kw["min_disp"],
                                    kw["max_disp"])
    cost, _, dispR, _ = asw_cuda._asw_pass_plain(
        planes, H=h, W=w, gamma_c=15.0, gamma_p=17.5, consistent=True, **kw)
    got = rotate.right_map(cost, kw["min_disp"])
    assert got.dtype == torch.int32 and got.shape == (B, h, w)
    assert torch.equal(got, dispR)


def test_cuda_probe_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        rotate.probe(device="cuda")
