"""The readers of the port's spans, on hand-made events: kernels put down
to the span their launch was issued in, idle time split at ``match``,
the readback's host time, the set-up span, and nothing where the spans
are missing."""

import sys
import types

import pytest

from portbench.harness import spans, spec
from portbench.harness.trace import CALL_RANGE, Trace, gaps

H100 = "NVIDIA H100 80GB HBM3"
NEW = ("cost_device_ms", "finish_device_ms", "idle_in_match_ms",
       "readback_wait_ms", "package_import_s")


def ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur):
    return ev("user_annotation", name, ts, dur)


def one_call(t0, glue=("sgm.cost", "sgm.post")):
    """A call of 100 us at ``t0``: upload [0, 10), match [10, 70) holding
    the cost [12, 30) and the post [50, 68), readback [70, 100). Kernels:
    c1 (cost, runtime launch), c2 (cost, driver launch), k (the matcher's
    kernel, in match only), p (post), r (launched in the readback), x
    (no launch event)."""
    first, then = glue
    n = t0 * 10
    return [
        span(CALL_RANGE, t0, 100),
        span("upload", t0, 10),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t0 + 2, 6),
        span("match", t0 + 10, 60),
        span(first, t0 + 12, 18),
        ev("cpu_op", "aten::gt", t0 + 13, 5),
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 14, 2, n + 1),
        ev("cuda_driver", "cuLaunchKernel", t0 + 20, 2, n + 2),
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 35, 2, n + 3),
        span(then, t0 + 50, 18),
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 52, 2, n + 4),
        span("readback", t0 + 70, 30),
        ev("cuda_runtime", "cudaLaunchKernel", t0 + 71, 2, n + 5),
        ev("kernel", "vectorized_elementwise_kernel", t0 + 16, 4, n + 1),
        ev("kernel", "triton_census", t0 + 22, 6, n + 2),
        ev("kernel", "sgm_lines_kernel<4, true>", t0 + 37, 20, n + 3),
        ev("kernel", "reduce_kernel", t0 + 60, 5, n + 4),
        ev("kernel", "fill_kernel", t0 + 75, 3, n + 5),
        ev("kernel", "orphan_kernel", t0 + 90, 2, n + 6),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t0 + 80, 10),
    ]


def two_calls(glue=("sgm.cost", "sgm.post")):
    return Trace(one_call(0, glue) + one_call(200, glue))


def ctx_of(t, cell="sgm_lawn720.frame"):
    bench = spec.Bench()
    return types.SimpleNamespace(trace=t, kind=H100,
                                 hand_kernels=bench.hand_kernels(),
                                 cell=bench.cell(cell)), bench


def read(name, ctx, bench):
    return bench.module("metrics", name).read(ctx)


@pytest.mark.parametrize("glue,cell", [
    (("sgm.cost", "sgm.post"), "sgm_lawn720.frame"),
    (("asw.planes", "asw.finish"), "asw_tsukuba.batch8")])
def test_kernels_go_to_the_span_of_their_launch(glue, cell):
    ctx, bench = ctx_of(two_calls(glue), cell)
    # cost: c1 4 us (runtime launch) + c2 6 us (driver launch) a call
    assert read("cost_device_ms", ctx, bench) == pytest.approx(0.010)
    # post: p 5 us; k (in match, outside both) and r (readback) in neither
    assert read("finish_device_ms", ctx, bench) == pytest.approx(0.005)
    # the glue metric reads every non-hand kernel: c1, c2, p, r, x
    assert read("glue_device_ms", ctx, bench) == pytest.approx(0.020)


def test_a_launch_outside_every_span_counts_in_neither():
    events = one_call(0)
    events.append(ev("cuda_runtime", "cudaLaunchKernel", 101, 1, 77))
    events.append(span(CALL_RANGE, 200, 10))
    events.append(ev("kernel", "late_kernel", 102, 50, 77))
    t = Trace(events)
    assert spans.kernel_ms(t, ("sgm.cost",)) == pytest.approx(0.010 / 2)
    assert spans.kernel_ms(t, ("sgm.post",)) == pytest.approx(0.005 / 2)


def test_idle_time_splits_exactly_at_match():
    t = two_calls()
    ctx, bench = ctx_of(t)
    # busy a call: 2-8, 16-20, 22-28, 37-57, 60-65, 75-78, 80-90, 90-92
    # idle inside match [10, 70): 10-16, 20-22, 28-37, 57-60, 65-70 = 25
    assert read("idle_in_match_ms", ctx, bench) == pytest.approx(0.025)
    idle = gaps(t.busy(), t.lo, t.hi)
    match = spans.intervals(t, "match")
    rest = gaps(match, t.lo, t.hi)
    # outside: upload 0-2, 8-10; readback 70-75, 78-80, 92-100; 100-200
    assert spans.overlap_us(idle, rest) == pytest.approx(2 * 19 + 100)
    assert spans.overlap_us(idle, match) + spans.overlap_us(idle, rest) \
        == pytest.approx(1e6 * (t.window_s - t.busy_s))


def test_readback_wait_is_the_span_per_call():
    ctx, bench = ctx_of(two_calls())
    assert read("readback_wait_ms", ctx, bench) == pytest.approx(0.030)
    events = one_call(0) + one_call(200)
    events[11] = span("readback", 70, 12)  # the first call's, shorter
    ctx, bench = ctx_of(Trace(events))
    assert read("readback_wait_ms", ctx, bench) == pytest.approx(0.021)


def test_nothing_where_the_spans_are_missing(monkeypatch):
    bare = [e for e in one_call(0) + one_call(200)
            if e["cat"] != "user_annotation" or e["name"] == CALL_RANGE]
    ctx, bench = ctx_of(Trace(bare))
    monkeypatch.setitem(sys.modules, "simplestereo_tpu_torch.profiling",
                        types.SimpleNamespace())
    for name in NEW:
        assert read(name, ctx, bench) is None, name
    ctx.trace = None
    for name in NEW:
        assert read(name, ctx, bench) is None, name


def test_the_import_span_is_read_from_the_program(monkeypatch):
    ctx, bench = ctx_of(two_calls())
    kept = [("import", 10.0, 11.25)]
    monkeypatch.setitem(sys.modules, "simplestereo_tpu_torch.profiling",
                        types.SimpleNamespace(setup_spans=lambda: kept))
    assert read("package_import_s", ctx, bench) == pytest.approx(1.25)
    kept[:] = [("other", 0.0, 1.0)]
    assert read("package_import_s", ctx, bench) is None


def test_the_new_readers_leave_the_hand_kernels_alone():
    bench = spec.Bench()
    assert bench.hand_kernels() == (
        "asw_cost_tile_kernel", "asw_cost_l1_kernel", "asw_select_kernel",
        "sgm_lines_kernel", "sgm_sum_kernel", "sgm_path_kernel")
    for name in NEW:
        assert not hasattr(bench.module("metrics", name), "KERNELS")
        m = next(m for m in bench.spec["per_layer"] if m["name"] == name)
        assert m["source"] == "program_span"
        assert m["workloads"] == [w["name"]
                                  for w in bench.spec["workloads"]]
