"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the references load nothing of the port."""

import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness.modcheck import loaded_forbidden

LOAD_A_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import core, modcheck, spec, trace
bench = spec.Bench()
for w in bench.spec["workloads"]:
    cell = bench.cell(w["name"])
    cell.entry().make(cell.config, "cpu")
    cell.reference()
    for m in cell.per_layer + cell.end_to_end:
        bench.module("metrics", m["name"])
print(json.dumps(modcheck.loaded_forbidden()))
"""

LOAD_REFERENCES = """
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import spec
bench = spec.Bench()
for c in bench.spec["configs"]:
    for w in bench.spec["workloads"]:
        if w["config"] == c["name"]:
            bench.cell(w["name"]).reference()
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def run(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax():
    assert run(LOAD_A_RUN) == "[]"


def test_the_references_load_nothing_of_the_port():
    names = run(LOAD_REFERENCES)
    assert "simplestereo_tpu_torch" not in names
    assert '"simplestereo_tpu"' not in names and '"jax"' not in names


@pytest.mark.parametrize("names,found", [
    ({"simplestereo_tpu_torch": 1, "simplestereo_tpu_torch.passive": 1},
     []),
    ({"jaxlib2": 1, "flaxen": 1, "portbench.harness": 1}, []),
    ({"jax.numpy": 1, "simplestereo_tpu.passive": 1, "flax": 1},
     ["flax", "jax", "simplestereo_tpu"]),
    ({"jaxlib": 1}, ["jaxlib"]),
])
def test_names_are_compared_whole(names, found):
    assert loaded_forbidden(names) == found


def test_run_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "asw_tsukuba.frame", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
