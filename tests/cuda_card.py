"""The ``card`` fixture of the tests that run a hand kernel on a CUDA
card (``@pytest.mark.card``): a file imports it with
``from cuda_card import card``. Imports no JAX, since on the card those
files run with ``--noconftest``."""

import pytest
import torch


@pytest.fixture
def card():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the H100 only")
    return torch.device("cuda:0")
