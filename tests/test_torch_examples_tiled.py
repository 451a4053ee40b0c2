"""PyTorch port: example 201, ASW, SGM and GSW row-tiled over a mesh,
held against the JAX package's script on the same stand-in resource tree
(``tests/torch_example_res.py``, "small": 144 rows, 18 a tile on the
tests' 8 JAX devices, above the ASW window's 17-row halo) and against
the single-call matchers.

The port runs as a gloo world of one on the CPU. The JAX script's tiled
matchers run under ``jax.jit``: called eagerly, ``shard_map`` traces and
dispatches every primitive anew on each call (about 65 s for the SGM
alone on this host, 3 s jitted), and jit computes the same maps.
Tolerances: the printed shapes equal; each tiled map (kept by a spy)
equal to the single-call matcher's on the same pair, and differing from
the JAX script's on at most 1% of pixels (near-ties).
"""

import jax
import numpy as np
import torch

import simplestereo_tpu.parallel as jparallel
import torch_example_res as res
from simplestereo_tpu_torch import parallel

NAME = "201_multichip_tiled_matching.py"
FNS = ("tiled_asw_disparity", "tiled_sgm_disparity", "tiled_gsw_disparity")


tree = res.tree_fixture("tsukuba")


def jitted(fn):
    """``fn(img1, img2, mesh, **kw)`` as one jitted program."""
    def call(img1, img2, mesh, **kw):
        return jax.jit(lambda a, b: fn(a, b, mesh, **kw))(img1, img2)
    return call


def test_201_multichip_tiled_matching(tree, tmp_path, monkeypatch):
    root, _ = tree
    for f in FNS:
        monkeypatch.setattr(jparallel, f, jitted(getattr(jparallel, f)))
    real = {f: getattr(parallel, f) for f in FNS}
    seen = {f: [res.record(monkeypatch, pkg, f) for pkg in (jparallel,
                                                            parallel)]
            for f in FNS}
    (j, jo), (p, po) = res.run_both(NAME, root, tmp_path)
    assert jo.splitlines() == po.splitlines() and len(po.splitlines()) == 3
    for f in FNS:
        ((_, _, want),), ((args, kwargs, out),) = seen[f]
        single = res.single_call(real[f], args, kwargs, out.device)
        assert torch.equal(out, single), f
        res.maps_close(np.asarray(want), out.numpy())
