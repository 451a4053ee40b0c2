"""PyTorch port: example 204, ``StereoGSW(costMethod="auto")`` on the
Tsukuba pair and on the same pair under a gamma-0.5 mismatch, held
against the JAX package's script on the same stand-in resource tree
(``tests/torch_example_res.py``, "small", 128x144) and against the
tree's ground truth.

Tolerances (``torch_example_res``): each of the three maps (kept by a
spy on ``compute``) differs on at most 1% of pixels (near-ties); the
printed probe distances within 0.05 gray levels, each printed bad-2.0
within 0.5 percentage points and the cost picked ("sd", then "mi")
equal; "auto"'s bad-2.0 under ``AUTO_BAD2`` on both pairs, the fixed
"sd" under the mismatch above ``SD_COLLAPSE`` (the collapse the script
shows).
"""

import numpy as np

import simplestereo_tpu as jss
import simplestereo_tpu_torch as ss
import torch_example_res as res

NAME = "204_radiometric_auto_matching.py"


tree = res.tree_fixture("tsukuba")


def test_204_radiometric_auto_matching(tree, tmp_path, monkeypatch):
    root, _ = tree
    jm, pm = [res.record(monkeypatch, pkg.passive.StereoGSW, "compute")
              for pkg in (jss, ss)]
    (j, jo), (p, po) = res.run_both(NAME, root, tmp_path,
                                    [root / "tsukuba"])
    assert len(jm) == len(pm) == 3
    for a, b in zip(jm, pm):
        res.maps_close(np.asarray(a[2]), b[2])
    jr, pr = res.auto_lines(jo), res.auto_lines(po)
    for a, b in zip(jr, pr):
        assert a["pick"] == b["pick"]
        assert abs(a.get("emd", 0) - b.get("emd", 0)) <= res.ERR_PX
        assert abs(a["bad2"] - b["bad2"]) <= res.BAD2_POINTS
    (matched, mismatch, fixed) = pr
    assert [matched["pick"], mismatch["pick"]] == ["sd", "mi"]
    assert matched["bad2"] < res.AUTO_BAD2 and mismatch["bad2"] < \
        res.AUTO_BAD2, pr
    assert fixed["bad2"] > res.SD_COLLAPSE, pr
