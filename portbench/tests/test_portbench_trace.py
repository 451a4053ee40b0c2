"""The reduction of a trace to metrics, on hand-made events, and the
kernels' counts and roofline arithmetic."""

import types

import pytest

from portbench.harness import roofline, spec
from portbench.harness.trace import (BETWEEN_CALLS, CALL_RANGE, IN_CALL,
                                     Trace, gaps, short, union)

H100 = "NVIDIA H100 80GB HBM3"


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def two_calls():
    """Two calls of 100 us: [0, 100) and [150, 250)."""
    return [
        ev("user_annotation", CALL_RANGE, 0, 100),
        ev("user_annotation", CALL_RANGE, 150, 100),
        ev("cpu_op", "aten::copy_", 0, 20),
        ev("cuda_runtime", "cudaMemcpyAsync", 2, 15),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5, 10),
        ev("cpu_op", "aten::add", 30, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 35, 5),
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)",
           40, 20),
        ev("kernel", "void (anonymous namespace)::asw_select_kernel(float*)",
           50, 30),                                   # overlaps: busy 40-80
        ev("gpu_memset", "Memset (Device)", 85, 5),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 90, 8),
        ev("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 160, 4),
        ev("kernel", "void (anonymous namespace)::asw_cost_tile_kernel<12>"
           "(float const*)", 170, 60),
        ev("kernel", "void early(int)", -50, 20),     # before the window
        ev("gpu_user_annotation", CALL_RANGE, 0, 100),  # not device work
    ]


def test_union_and_gaps():
    assert union([(5, 9), (0, 3), (2, 4), (10, 12), (11, 11)], 1, 11) == [
        (1, 4), (5, 9), (10, 11)]
    assert gaps([(1, 4), (5, 9)], 0, 12) == [(0, 1), (4, 5), (9, 12)]
    assert gaps([], 0, 3) == [(0, 3)]


def test_busy_idle_and_counts():
    t = Trace(two_calls())
    assert t.calls == 2 and (t.lo, t.hi) == (0, 250)
    # busy: 5-15, 40-80, 85-90, 90-98, 160-164, 170-230
    assert t.busy() == [(5, 15), (40, 80), (85, 98), (160, 164), (170, 230)]
    assert t.busy_s == pytest.approx(127e-6)
    assert t.window_s == pytest.approx(250e-6)
    assert len(t.kernels()) == 3
    assert t.kernel_s(["asw_"]) == pytest.approx(90e-6)
    assert t.kernel_s(["asw_"], others=True) == pytest.approx(20e-6)
    assert t.copy_s() == pytest.approx(18e-6)  # DtoD is not a transfer


def test_metric_readers_on_the_trace():
    bench = spec.Bench()
    t = Trace(two_calls())
    ctx = types.SimpleNamespace(trace=t, kind=H100,
                                hand_kernels=bench.hand_kernels(),
                                cell=bench.cell("asw_tsukuba.frame"))
    read = lambda name: bench.module("metrics", name).read(ctx)  # noqa: E731
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 127 / 250))
    assert read("launches_per_call") == 1.5
    assert read("glue_device_ms") == pytest.approx(0.010)
    assert read("copy_device_ms") == pytest.approx(0.009)
    ops, nbytes = bench.module("metrics", "k1_roofline").count(
        ctx.cell.config["params"], 288, 384, 1)
    assert read("k1_roofline") == pytest.approx(
        100 * max(ops / 67e12, nbytes / 3.35e12) / 45e-6)
    assert read("k2_roofline") is None  # no K2 kernel ran


def test_readers_find_nothing_without_device_work():
    bench = spec.Bench()
    t = Trace([ev("user_annotation", CALL_RANGE, 0, 10),
               ev("cpu_op", "aten::add", 1, 2)])
    ctx = types.SimpleNamespace(trace=t, kind=H100, hand_kernels=(),
                                cell=bench.cell("sgm_lawn720.frame"))
    for m in bench.spec["per_layer"]:
        assert bench.module("metrics", m["name"]).read(ctx) is None


def test_gap_labels_and_breakdown():
    t = Trace(two_calls())
    assert t.label(32) == "aten::add"
    assert t.label(99) == IN_CALL
    assert t.label(120) == BETWEEN_CALLS
    assert t.label(3) == "cudaMemcpyAsync"
    b = t.breakdown()
    assert b["device_ops"][0] == ["asw_cost_tile_kernel<12>", 60e-6]
    assert len(b["device_ops"]) == 7
    idle = dict(b["idle_gaps"])
    # the gap 98-160 is labelled whole by its middle, between the calls
    assert idle[BETWEEN_CALLS] == pytest.approx(62e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)


def test_short_names():
    assert short("void (anonymous namespace)::sgm_lines_kernel<4, true>"
                 "(float const*, float*)") == "sgm_lines_kernel<4, true>"
    assert short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_trace_needs_the_call_ranges():
    with pytest.raises(ValueError):
        Trace([ev("kernel", "k", 0, 1)])


def test_counts_and_bounds():
    bench = spec.Bench()
    k1 = bench.module("metrics", "k1_roofline")
    k2 = bench.module("metrics", "k2_roofline")
    asw = bench.cell("asw_tsukuba.frame").config["params"]
    sgm = bench.cell("sgm_lawn720.frame").config["params"]
    ops, nbytes = k1.count(asw, 288, 384, 1)
    # 1225 window offsets, 11 candidates, both maps
    assert ops == 288 * 384 * (1225 * (23 + 4 * 11) + 11 * 12)
    assert nbytes == 288 * 384 * (48 + 8)
    assert k1.count(asw, 288, 384, 8) == (8 * ops, 8 * nbytes)
    assert roofline.bound_s(ops, nbytes, H100) == pytest.approx(ops / 67e12)
    ops2, nbytes2 = k2.count(sgm, 720, 1280, 1)
    assert ops2 == 8 * 8 * 720 * 1280 * 96
    assert nbytes2 == 2 * 720 * 1280 * 96 * 4
    assert roofline.bound_s(ops2, nbytes2, H100) == pytest.approx(
        nbytes2 / 3.35e12)
    assert roofline.share_pct(ops2, nbytes2, H100, 2 * nbytes2 / 3.35e12) \
        == pytest.approx(50.0)
    assert roofline.share_pct(1, 1, "some other card", 1.0) is None
    assert roofline.share_pct(1, 1, H100, 0.0) is None
