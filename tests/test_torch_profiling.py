"""PyTorch port: ``profiling`` against :mod:`simplestereo_tpu.profiling`.

``Throughput`` gives the JAX meter's report, key for key and value for
value, on the same injected samples; a trace on ``device="cpu"`` writes a
TensorBoard-named trace and a Chrome/Perfetto JSON holding the
``annotate`` ranges (and ``StereoASW``'s upload/match/readback ranges);
``device_memory`` has one ``"cpu"`` entry of ``None``s without a card;
``trace`` refuses a CUDA device without one.
"""

import json
import os

import numpy as np
import pytest
import torch

from simplestereo_tpu import profiling as jprof
from simplestereo_tpu_torch import profiling
from simplestereo_tpu_torch.passive import StereoASW


@pytest.mark.parametrize("samples", [
    [], [(0.5, 1.0)], [(0.25, 8.0), (0.5, 8.0), (0.125, 4.0)],
    [(1e-3, 3.3), (2e-3, 1.1), (5e-4, 7.7), (4e-3, 2.2)]])
def test_throughput_report_equals_jax(samples):
    ours = profiling.Throughput("asw", unit="Mpix*disp")
    theirs = jprof.Throughput("asw", unit="Mpix*disp")
    ours.samples = list(samples)
    theirs.samples = list(samples)
    assert ours.report() == theirs.report()


def test_throughput_measure():
    meter = profiling.Throughput("warp", unit="Mpix")
    for _ in range(3):
        with meter.measure(0.5):
            torch.arange(16).sum()
    rep = meter.report()
    assert rep["samples"] == 3 and rep["median_s"] > 0
    assert set(rep) == {"name", "samples", "median_s", "Mpix_per_s",
                        "total_s"}


def test_trace_on_cpu_holds_annotations(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (12, 24, 3), np.uint8)
    m = StereoASW(winSize=5, maxDisparity=3, device="cpu")
    with profiling.trace(tmp_path, device="cpu") as prof:
        with profiling.annotate("grab"):
            frames = np.stack([img, img])
        m.computeBatch(frames, frames)
    names = os.listdir(tmp_path)
    assert profiling.PERFETTO_FILE in names
    assert any(n.endswith(".pt.trace.json") for n in names)
    with open(tmp_path / profiling.PERFETTO_FILE) as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"grab", "upload", "match", "readback"} <= ranges
    assert any(e.key == "grab" for e in prof.key_averages())


def test_trace_without_perfetto(tmp_path):
    with profiling.trace(tmp_path, perfetto=False, device="cpu"):
        torch.ones(4).sum()
    names = os.listdir(tmp_path)
    assert profiling.PERFETTO_FILE not in names and len(names) == 1


def test_device_memory_and_cuda_refusal(tmp_path):
    mem = profiling.device_memory()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    assert mem == {"cpu": {"bytes_in_use": None, "peak_bytes_in_use": None,
                           "bytes_limit": None}}
    with pytest.raises(RuntimeError, match="cuda"):
        with profiling.trace(tmp_path):
            pass
