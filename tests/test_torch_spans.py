"""PyTorch port: the spans of the matchers' calls, which the benchmark's
per-layer metrics read by name.

Under ``profiling.trace`` each numpy ``compute``/``computeBatch`` call of
``StereoASW`` and ``StereoSGM`` gives one ``upload``, ``match`` and
``readback`` span, and ``match`` holds the glue's two spans in order
(``asw.planes`` then ``asw.finish``; ``sgm.cost`` then ``sgm.post``).
With no profiler recording, ``annotate`` never enters
``torch.profiler.record_function``. The package's import is kept as the
set-up span ``import``.
"""

import json

import numpy as np
import pytest
import torch

import simplestereo_tpu_torch
from simplestereo_tpu_torch import profiling
from simplestereo_tpu_torch.passive import StereoASW, StereoSGM

HOT = ("upload", "match", "readback", "asw.planes", "asw.finish",
       "sgm.cost", "sgm.post")
GLUE = {"asw": ("asw.planes", "asw.finish"), "sgm": ("sgm.cost", "sgm.post")}
CALLS = [(m, c) for m in GLUE for c in ("compute", "computeBatch")]


def _matcher(kind):
    if kind == "asw":
        return StereoASW(winSize=5, maxDisparity=5, minDisparity=1,
                         consistent=True, device="cpu")
    return StereoSGM(minDisparity=1, numDisparities=6, blockSize=3,
                     costMethod="census", censusWindow=5, device="cpu")


def _pairs(call, seed=0):
    rng = np.random.default_rng(seed)
    shape = (12, 20, 3) if call == "compute" else (2, 12, 20, 3)
    return (rng.integers(0, 256, shape, np.uint8),
            rng.integers(0, 256, shape, np.uint8))


def _spans(logdir):
    """The hot spans of the trace in ``logdir``, sorted by start."""
    with open(logdir / profiling.PERFETTO_FILE) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] in HOT), key=lambda e: e["ts"])


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("kind,call", CALLS)
def test_each_call_gives_its_spans_in_order(tmp_path, kind, call):
    m = _matcher(kind)
    left, right = _pairs(call)
    getattr(m, call)(left, right)  # before the trace: recorded nowhere
    with profiling.trace(tmp_path, device="cpu"):
        for _ in range(2):
            getattr(m, call)(left, right)
    spans = _spans(tmp_path)
    first, then = GLUE[kind]
    per_call = ["upload", "match", first, then, "readback"]
    assert [e["name"] for e in spans] == per_call * 2
    for i in range(2):
        upload, match, a, b, readback = spans[5 * i:5 * i + 5]
        assert _inside(a, match) and _inside(b, match)
        assert a["ts"] + a["dur"] <= b["ts"]
        assert upload["ts"] + upload["dur"] <= match["ts"]
        assert match["ts"] + match["dur"] <= readback["ts"]


@pytest.mark.parametrize("kind,call", CALLS)
def test_no_record_function_while_no_profiler_records(monkeypatch, kind,
                                                      call):
    m = _matcher(kind)
    left, right = _pairs(call, seed=1)
    want = getattr(m, call)(left, right)

    def refuse(name, args=None):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    np.testing.assert_array_equal(getattr(m, call)(left, right), want)
    with profiling.annotate("match"):
        pass


def test_spans_nest_only_while_a_profiler_records(tmp_path):
    with profiling.annotate("readback"):  # off: in no trace
        pass
    with profiling.trace(tmp_path, device="cpu") as prof:
        with profiling.annotate("match"):
            with profiling.annotate("sgm.cost"):
                torch.ones(3).sum()
    spans = _spans(tmp_path)
    assert [e["name"] for e in spans] == ["match", "sgm.cost"]
    assert _inside(spans[1], spans[0])
    inner = next(e for e in prof.events() if e.name == "sgm.cost")
    assert inner.cpu_parent.name == "match"


def test_sgm_tensor_input_gives_a_tensor_and_only_match(tmp_path):
    m = _matcher("sgm")
    left, right = _pairs("compute", seed=2)
    want = m.compute(left, right)
    with profiling.trace(tmp_path, device="cpu"):
        got = m.compute(torch.tensor(left), right)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    assert [e["name"] for e in _spans(tmp_path)] == [
        "match", "sgm.cost", "sgm.post"]


def test_sgm_compute_refuses_unlike_pairs_numpy_or_tensor():
    m = _matcher("sgm")
    left, right = _pairs("compute")
    for a, b in ((left, right[:, :-1]), (left[None], right[None])):
        with pytest.raises(ValueError, match="identical shapes"):
            m.compute(a, b)
        with pytest.raises(ValueError, match="identical shapes"):
            m.compute(torch.tensor(a), b)


def test_the_import_is_a_set_up_span():
    spans = profiling.setup_spans()
    names = [name for name, _, _ in spans]
    assert names.count("import") == 1
    _, start, end = spans[names.index("import")]
    assert end > start > 0
    assert not hasattr(simplestereo_tpu_torch, "_import_start")
    spans.clear()  # a copy: the kept list is untouched
    assert profiling.setup_spans()


def test_the_card_check_is_made_once(monkeypatch):
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available",
                        lambda: asked.append(1) or False)
    profiling._nvtx.cache_clear()
    try:
        for _ in range(3):
            with profiling.annotate("upload"):
                pass
        assert len(asked) == 1
    finally:
        profiling._nvtx.cache_clear()
