"""What decides ``correct``: the control (the reference one precision
step below the configuration's, in the program's place) must fail the
limit, and a whole run with the timed path broken underneath must come
out not correct, once for each fault a cell can have. CPU sizes."""

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY_CELLS
from portbench.harness import core, scenes, spec
from portbench.harness.faults import FAULTS, plant


def control_reading(cell_name, w, h, frames=2, seed=3_000_000_007):
    """Worst-map mismatch (%) of the bfloat16 reference against the
    float32 one, on the cell's settings and scenes at (w, h)."""
    cell = spec.Bench().cell(cell_name)
    ref = cell.reference()
    rng = core.rngs(seed)[0]
    made = [scenes.layered_pair(rng, w, h, cell.traffic["scene"])[:2]
            for _ in range(frames)]
    lefts = np.stack([a for a, _ in made])
    rights = np.stack([b for _, b in made])
    want = ref.disparity(cell.config, lefts, rights, "cpu")
    low = ref.disparity(cell.config, lefts, rights, "cpu",
                        dtype=torch.bfloat16)
    return core.worst_map_mismatch_pct(low, want), cell


@pytest.mark.parametrize("cell_name,w,h", [
    ("asw_tsukuba.frame", 96, 64),
    ("sgm_lawn720.frame", 224, 64),
])
def test_the_control_fails_the_limit(cell_name, w, h):
    reading, cell = control_reading(cell_name, w, h)
    assert reading > cell.config["limits"]["mismatch_pct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell_name", [c[0] for c in TINY_CELLS])
def test_a_broken_timed_path_is_not_correct(tiny_bench, cell_name, fault):
    cell = tiny_bench.cell(cell_name)
    mend = plant(cell, fault)
    if mend is None:
        pytest.skip(f"{fault} needs a stack of pairs a call")
    try:
        r = core.run(cell, 2**31 + 11, 0.3, False, "cpu", 0.0)
    finally:
        mend()
    assert not r["correct"]
    assert r["checks"]["mismatch_pct"]["value"] \
        > r["checks"]["mismatch_pct"]["limit"]


@pytest.mark.parametrize("cell_name", [c[0] for c in TINY_CELLS])
def test_the_same_run_unbroken_is_correct(tiny_bench, cell_name):
    r = core.run(tiny_bench.cell(cell_name), 2**31 + 11, 0.3, False, "cpu",
                 0.0)
    assert r["correct"] and r["failed"] == 0


def test_a_map_that_never_comes_is_not_correct(tiny_bench, monkeypatch):
    from simplestereo_tpu_torch.passive import StereoASW
    calls = {"n": 0}
    real = StereoASW.compute

    def flaky(self, a, b):
        calls["n"] += 1
        if calls["n"] == 3:  # the window's first call, after two warm ones
            raise RuntimeError("lost")
        return real(self, a, b)

    monkeypatch.setattr(StereoASW, "compute", flaky)
    r = core.run(tiny_bench.cell("tiny_asw.frame"), 1, 0.3, False, "cpu",
                 0.0, log=lambda msg: None)
    assert r["failed"] == 1 and not r["correct"]


def test_the_benchmark_root_is_the_repository():
    assert spec.Bench().root == ROOT
