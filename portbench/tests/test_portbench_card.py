"""One short run of each cell on the card, through the benchmark's command."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench.harness import spec

CELLS = [w["name"] for w in spec.Bench().spec["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "3000000001", "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    group = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in getattr(spec.Bench().cell(cell), group)}
    assert set(result["metrics"]) == want
