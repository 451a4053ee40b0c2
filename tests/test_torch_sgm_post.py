"""SGM's post: the post kernel (``sgm_cuda.post``) and its twin, the torch
code of ``sgm._sgm_post_plain``, against the JAX package's ``_sgm_post``
through its maps stored by tests/golden/sgm_post/make_golden.py (see
tests/sgm_post_cases.py): path sums with planted ties, signed zeros,
infinities and all-off-image columns at D 9, 13, 40, 150 (16 lanes a
pixel) and 600 (the candidates read from S), and rows of 1280 columns at
D = 96, the benchmark's 720p width and candidates, each under the 12
option sets of the post (left-right check off, 0 and 1; subpixel;
uniqueness 0 and 10). Equal bit for bit: SGM's maps are compared exactly.

Tests marked ``card`` run the kernel and skip without a CUDA card. This
file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sgm_post.py
"""

import numpy as np
import pytest
import torch

import sgm_post_cases as cases
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

@pytest.fixture
def card():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 only")
    return torch.device("cuda:0")


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
