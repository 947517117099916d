"""The benchmark's arithmetic on fixed inputs: the window count, the p90
over all calls, the trace's union idle share, K2's bound, and the
breakdown."""

import json
import os

import pytest

from roh_bench import harness
from roh_bench.metrics import (call_p90_s, call_p90_traced_s,
                               device_idle_pct, h2d_ms, k2_roofline_pct,
                               phase3_ms, windows_per_s)
from roh_bench.metrics.common import CallRecord, Window
from roh_bench.trace import kernel_name, trace_summary

HERE = os.path.dirname(os.path.abspath(__file__))
H100 = {"sms": 132, "f32_lanes_per_sm": 128, "clock_hz": 1.98e9,
        "hbm_bytes_per_s": 3.35e12}


def window(walls, rcs=None, seconds=10.0, **kw):
    rcs = rcs or [0] * len(walls)
    return Window(calls=[CallRecord(wall=w, rc=r, panel=0)
                         for w, r in zip(walls, rcs)],
                  seconds=seconds, setup_s=1.0, peak_bytes=2 ** 30,
                  nind=45, winsize=60, snps=[100, 200],
                  kept=[[90, 200]], **kw)


def small_trace():
    with open(os.path.join(HERE, "data", "trace_small.json")) as f:
        return trace_summary(json.load(f))


def test_windows_per_s_counts_completed_calls_over_the_window():
    # 45 * (41 + 141) windows a call, 3 of 4 calls completed, 10 s
    w = window([1.0, 2.0, 3.0, 4.0], rcs=[0, 0, 1, 0])
    assert windows_per_s.read(w) == 45 * 182 * 3 / 10.0


@pytest.mark.parametrize("walls,want", [
    ([5.0], 5.0), (list(range(1, 11)), 9), (list(range(1, 21)), 18),
    ([0.3, 0.1, 0.2, 10.0, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0], 1.0)])
@pytest.mark.parametrize("reader", [call_p90_s, call_p90_traced_s])
def test_call_p90_is_nearest_rank_over_every_call(reader, walls, want):
    assert reader.read(window(walls)) == want


def test_trace_union_idle_share():
    t = small_trace()
    # window 0..1000 us; busy [100, 180] + [300, 320] (the memset at
    # 500..510 too): 110 us
    assert t["window"] == 1.0 and t["busy"] == pytest.approx(0.11)
    assert t["kinds"]["H2D"] == pytest.approx(0.05)
    assert t["ops"]["K2"] == [2, pytest.approx(0.06)]
    assert t["marks"] == ["load", "phase1-lod", "write-bed"]
    longest = t["gaps"][0]
    assert longest[0] == pytest.approx(0.49) and longest[1] == "write-bed"
    assert longest[2] == "aten::nonzero"
    w = window([1.0])
    w.calls[0].trace = t
    assert device_idle_pct.read(w) == pytest.approx(89.0)
    assert h2d_ms.read(w) == pytest.approx(0.05)


def test_trace_without_marks_raises():
    with pytest.raises(ValueError):
        trace_summary({"traceEvents": [{"ph": "X", "cat": "kernel",
                                        "name": "k", "ts": 0, "dur": 1}]})


@pytest.mark.parametrize("symbol,name", [
    ("void covered_kernel<60>(unsigned char const*)", "K2"),
    ("_Z14covered_kernelILi60EEvPKhPKf", "K2"),
    ("void covered_kernel<PlaneTerms>(float const*)", "K4"),
    ("void lod_windows_kernel<60>(unsigned char const*)", "K1"),
    ("void k7_gather_kernel(float const*)", "K7"),
    ("void em_kernel<3>(double const*)", "K8"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, at::detail::Array<char*, 3> >"
     "(int, at::native::CUDAFunctor_add<float>)",
     "vectorized_elementwise_kernel[CUDAFunctor_add]")])
def test_kernel_names(symbol, name):
    assert kernel_name(symbol) == name


def test_k2_bound_from_shapes():
    # one chromosome of 1000 kept loci, 10 individuals, W = 60
    need = k2_roofline_pct.bound_s(H100, 10, [1000], 60)
    # the rolling sums' adds: 59 for a row's first window, 2 for each of
    # the other 940
    adds = 10 * (59 + 2 * 940) / (132 * 128 * 1.98e9)
    nbytes = (10 * 250 + 12 * 1000 + 941 + 10 * 1000 + 2 * 10 * 941)
    assert need == max(adds, nbytes / 3.35e12) == nbytes / 3.35e12
    w = window([1.0], peaks=H100)
    w.calls[0].trace = {"ops": {"K2": [2, 0.5]}}
    share = k2_roofline_pct.read(w)
    assert share == pytest.approx(
        100 * k2_roofline_pct.bound_s(H100, 45, [90, 200], 60) / 5e-4)
    w.calls[0].trace = {"ops": {}}
    assert k2_roofline_pct.read(w) is None


def test_phase_means_and_breakdown():
    w = window([1.0, 1.0])
    w.calls[0].phases = {"phase3-assembly": 0.1, "write-bed": 0.02}
    w.calls[1].phases = {"phase3-assembly": 0.3, "write-bed": 0.04}
    assert phase3_ms.read(w) == pytest.approx(230.0)
    for c in w.calls:
        c.trace = small_trace()
    b = harness.breakdown(w.calls)
    assert b["device_ops"][0] == ["K2", pytest.approx(1.2e-4)]
    assert b["idle_gaps"][0] == ["write-bed: aten::nonzero",
                                 pytest.approx(0.98e-3)]
