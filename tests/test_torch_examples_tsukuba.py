"""PyTorch port: example 010, ASW, SGM and GSW and the quality preset on
the Tsukuba pair, held against the JAX package's script on the same
stand-in resource tree (``tests/torch_example_res.py``, "small": layers
at disparities 5..14, 128x144) and against the tree's ground truth.

Tolerances (``torch_example_res``): each matcher's map (kept by a spy on
``compute``, and the preset's) and the PNG made of it differ on at most
1% of pixels (near-ties); every printed bad-2.0 and density within 0.5
percentage points, avgerr and rms within 0.05 px; each map's bad-2.0
under ``TSUKUBA_BAD2``.
"""

import numpy as np

import simplestereo_tpu as jss
import simplestereo_tpu_torch as ss
import torch_example_res as res
from simplestereo_tpu_torch.imgio import imread

NAME = "010_stereo_matching_tsukuba.py"


tree = res.tree_fixture("tsukuba")


def test_010_stereo_matching_tsukuba(tree, tmp_path, monkeypatch):
    root, truth = tree
    maps = {}
    for cls in ("StereoASW", "StereoSGM", "StereoGSW"):
        maps[cls] = [res.record(monkeypatch, getattr(pkg.passive, cls),
                                "compute") for pkg in (jss, ss)]
    maps["preset"] = [res.record(monkeypatch, pkg.passive,
                                 "quality_disparity") for pkg in (jss, ss)]
    (j, jo), (p, po) = res.run_both(NAME, root, tmp_path)
    for name, (jm, pm) in maps.items():
        assert len(jm) == len(pm) == 1, name
        res.maps_close(np.asarray(jm[0][2]), pm[0][2])
    for png in ("tsukuba_asw.png", "tsukuba_sgm.png", "tsukuba_gsw.png",
                "tsukuba_quality.png"):
        res.maps_close(imread(str(j / png)), imread(str(p / png)))
    jl, pl = res.tsukuba_lines(jo), res.tsukuba_lines(po)
    assert list(jl) == list(pl) == ["ASW", "SGM", "GSW", "quality preset"]
    for name in jl:
        res.tsukuba_close(jl[name], pl[name])
        assert pl[name]["bad2"] < res.TSUKUBA_BAD2[name], (name, pl[name])
