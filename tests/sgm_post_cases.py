"""Path sums for SGM's post (``sgm._sgm_post``) and the JAX package's maps
of them, shared by tests/test_torch_sgm.py (which holds the stored maps
to JAX) and tests/test_torch_sgm_post.py (which holds the post kernel and
its twin to them, also on the card, where there is no JAX). Imports no
JAX.

The maps are in tests/golden/sgm_post/jax_post.npz, written on a host
with JAX by

    python tests/golden/sgm_post/make_golden.py

``map/<kind>``: (len(OPTIONS), ..., H, W) int16, JAX's ``_sgm_post`` of
the kind's S under each set of OPTIONS, frame by frame; ``S/<kind>``:
the path sums that come from JAX's own aggregation (``STORED``);
``sha256/<kind>``: the digest of each generated S, so that a numpy whose
generator gives other inputs fails loudly instead of comparing the wrong
maps.
"""

import hashlib
import itertools
import pathlib

import numpy as np

GOLDEN = (pathlib.Path(__file__).resolve().parent / "golden" / "sgm_post"
          / "jax_post.npz")

# (disp12_max_diff, subpixel, uniqueness): every option of the post.
OPTIONS = tuple(itertools.product((-1, 0, 1), (False, True), (0.0, 10.0)))

# JAX path sums of a noise pair (D = 9), at min_disp 0 and -3.
STORED = {"path0": 0, "path-3": -3}
KINDS = (*STORED, "ties", "signed", "inf", "wide", "hd")


def options(min_disp, num_disp):
    """The keyword sets of ``_sgm_post`` in OPTIONS' order."""
    return [dict(min_disp=min_disp, num_disp=num_disp, uniqueness=u,
                 disp12_max_diff=lr, subpixel=sp) for lr, sp, u in OPTIONS]


def generate(kind):
    """(S, min_disp) of a generated kind: planted ties, signed zeros,
    negative values, infinities and all-off-image columns, at D on each
    of the kernel's plans."""
    rng = np.random.default_rng(14)
    if kind == "ties":  # D 13; columns 0..4 have every candidate off-image
        S = rng.integers(0, 4, (2, 7, 30, 13)).astype(np.float32)
        S[(S == 0) & (rng.random(S.shape) < 0.5)] = -0.0
        return S, 5
    if kind == "signed":  # D 40, negative min_disp
        S = (rng.integers(-100, 100, (1, 6, 50, 40)) / 2).astype(np.float32)
        zero = rng.random(S.shape) < 0.2
        S[zero] = np.where(rng.random(zero.sum()) < 0.5, -0.0, 0.0)
        return S, -3
    if kind == "inf":  # D 150: 16 lanes a pixel
        S = rng.uniform(0, 100, (1, 5, 60, 150)).astype(np.float32)
        S[rng.random(S.shape) < 0.05] = np.inf
        S[rng.random(S.shape) < 0.002] = -np.inf
        S[:, 1, ::7] = np.inf  # every candidate infinite
        return S, 0
    if kind == "wide":  # D 600: the candidates read from S (NJ 0)
        return rng.integers(0, 1000, (1, 2, 700, 600)).astype(
            np.float32), 2
    if kind == "hd":
        # Rows of 1280 columns at D = 96 from min_disp 1, the benchmark's
        # 720p width and candidates (2 frames of 8 rows: a block of the
        # kernel takes one row). Integer costs that tie often, and under
        # them a valley at a disparity constant along runs of 64 columns,
        # so the winner, uniqueness, subpixel fit and the left-right check
        # each pass in some pixels and fail in others.
        B, H, W, D = 2, 8, 1280, 96
        S = rng.integers(200, 600, (B, H, W, D)).astype(np.float32)
        x = np.arange(W)
        d = ((x // 64) * 37 + np.arange(B * H)[:, None] * 11) % (D - 2) + 1
        d = d.reshape(B, H, W)
        b, y = np.meshgrid(np.arange(B), np.arange(H), indexing="ij")
        b, y, x = b[..., None], y[..., None], x
        low = rng.integers(0, 150, (B, H, W)).astype(np.float32)
        S[b, y, x, d] = low
        S[b, y, x, d - 1] = low + rng.integers(0, 60, (B, H, W))
        S[b, y, x, d + 1] = low + rng.integers(0, 60, (B, H, W))
        return S, 1
    raise KeyError(kind)


def digest(S):
    return hashlib.sha256(np.ascontiguousarray(S).tobytes()).hexdigest()


def planted(kind):
    """(S, min_disp) of a kind: the stored S, or the generated one checked
    against the digest it had when the maps were written."""
    golden = np.load(GOLDEN)
    if kind in STORED:
        return golden[f"S/{kind}"], STORED[kind]
    S, md = generate(kind)
    assert digest(S) == str(golden[f"sha256/{kind}"]), (
        f"numpy {np.__version__} generated another S for {kind!r} than the "
        f"one the stored maps were made from; rerun make_golden.py")
    return S, md


def golden_maps(kind):
    """JAX's maps of ``planted(kind)``: (len(OPTIONS), ..., H, W) int16."""
    return np.load(GOLDEN)[f"map/{kind}"]
