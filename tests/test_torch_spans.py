"""--tpu-profile's spans and counters (runtime.PhaseProfiler, runtime.span
and runtime.count): spans nest under their phase with their self times,
nothing is recorded or traced without the flag, a traced run holds each
span and phase as a range between its marks, the benchmark's reader names
idle gaps by them and parses the span breakdown beside the phases, and
the counters are each call's own."""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import re
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from util import make_panel, write_tped  # noqa: E402

from garlic_tpu_torch import runtime  # noqa: E402
from garlic_tpu_torch.pipeline import run_main as port_main  # noqa: E402
from roh_bench.harness import _PHASE  # noqa: E402
from roh_bench.trace import trace_summary  # noqa: E402

PINNED = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
          "--kde-subsample", "0", "--lod-cutoff", "1.3", "--size-bounds",
          "300000", "800000"]
# an automatic cutoff (Phase II's pool and KDE), pinned bounds: a small
# panel's GMM may collapse
AUTO = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
        "--kde-subsample", "0", "--size-bounds", "300000", "800000"]
FAST = ["--tpu-engine", "fast"]
SPAN = "garlic::span:"
MARK = "garlic::mark:"


@pytest.fixture(scope="module")
def wd(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    panel = make_panel(nind=30, nloci_per_chr=(4000, 3000), seed=23,
                       big_gap_every=700)
    write_tped(panel, str(d / "p.tped.gz"), str(d / "p.tfam"))
    return str(d)


def _port(wd, args, trace_dir=None):
    """(exit code, stderr) of one in-process fast run on "cpu" from wd."""
    old, saved = os.getcwd(), os.environ.pop("GARLIC_TPU_TRACE_DIR", None)
    err = io.StringIO()
    os.chdir(wd)
    if trace_dir is not None:
        os.environ["GARLIC_TPU_TRACE_DIR"] = trace_dir
    try:
        with contextlib.redirect_stderr(err):
            rc = port_main(["--tped", "p.tped.gz", "--tfam", "p.tfam"]
                           + FAST + args, prog="garlic", device="cpu")
    finally:
        os.chdir(old)
        os.environ.pop("GARLIC_TPU_TRACE_DIR", None)
        if saved is not None:
            os.environ["GARLIC_TPU_TRACE_DIR"] = saved
    return rc, err.getvalue()


def _counters(err):
    return [json.loads(m) for m in
            re.findall(r"^\[profile\] counters (\{.*\})$", err, flags=re.M)]


def _phase_block(err):
    return err.split("[profile] phase breakdown:")[-1].split(
        "[profile] span breakdown:")[0]


def _span_block(err):
    return err.split("[profile] span breakdown:")[-1].split(
        "[profile] counters")[0]


@pytest.fixture(scope="module")
def traced(wd):
    """A traced --tpu-profile pinned run: (its stderr, the trace)."""
    tdir = os.path.join(wd, "tr")
    rc, err = _port(wd, PINNED + ["--tpu-profile", "--out", "t"], tdir)
    assert rc == 0, err
    (path,) = glob.glob(os.path.join(tdir, "*.json"))
    with open(path) as f:
        return err, json.load(f)


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

def test_spans_nest_under_their_phase_with_self_times():
    prof = runtime.PhaseProfiler(True)
    prof.start()
    try:
        with runtime.span("outer"):
            time.sleep(0.002)
            with runtime.span("inner"):
                time.sleep(0.003)
            with runtime.span("inner"):
                time.sleep(0.001)
        prof.mark("load")
        with runtime.span("step"):
            with runtime.span("wait"):
                pass
        with runtime.span("call/absolute"):
            pass
        prof.mark("freq")
    finally:
        prof.close()
    t = prof.span_table()
    assert list(t) == ["call/start", "load", "load/outer", "load/outer/inner",
                       "freq", "freq/step", "freq/step/wait",
                       "call/absolute", "filter"]
    assert t["load/outer/inner"][2] == 2 and t["load/outer"][2] == 1
    outer, inner = t["load/outer"], t["load/outer/inner"]
    assert outer[1] == pytest.approx(outer[0] - inner[0], abs=1e-9)
    assert inner[1] == pytest.approx(inner[0], abs=1e-9)
    assert t["load"][1] == pytest.approx(t["load"][0] - outer[0], abs=1e-9)
    assert outer[1] >= 0.002 and inner[0] >= 0.004
    # the phases' seconds are their spans'
    assert [p[0] for p in prof.phases] == ["load", "freq"]
    assert prof.phases[0][1] == pytest.approx(t["load"][0], abs=1e-9)
    parents = {path: parent for path, parent, *_ in prof.spans}
    assert parents["freq/step/wait"] == "freq/step"
    assert parents["call/absolute"] is None and parents["load"] is None
    assert runtime._REC is None  # close() stopped the recorder


def test_a_thread_without_open_spans_records_at_the_root():
    import threading
    prof = runtime.PhaseProfiler(True)
    prof.start()
    try:
        th = threading.Thread(target=lambda: runtime.span("writer")
                              .__enter__().__exit__(None, None, None))
        th.start()
        th.join()
        prof.mark("load")
    finally:
        prof.close()
    assert {p for p, *_ in prof.spans} >= {"writer", "load"}
    (writer,) = [s for s in prof.spans if s[0] == "writer"]
    assert writer[1] is None and writer[2] != threading.get_ident()


def test_counters_count_a_call_and_bytes_to_a_device(monkeypatch):
    from garlic_tpu_torch.ops import cuda_lod
    n = cuda_lod.LAUNCHES["covered"]
    monkeypatch.setitem(cuda_lod.LAUNCHES, "covered", n + 5)  # earlier calls
    prof = runtime.PhaseProfiler(True)
    prof.start()
    try:
        cuda_lod.LAUNCHES["covered"] += 2
        runtime.count("sidecar.hit")
        runtime.count("patrol.suspects", 7)
        runtime.count("pack.device", 2)
        runtime.to_device(torch.zeros(10, dtype=torch.float64), "meta")
        runtime.to_device(torch.zeros(4, dtype=torch.uint8), "cpu")
    finally:
        prof.close()
    c = prof.counters()
    assert c["launches"]["covered"] == 2 and c["launches"]["lod_windows"] == 0
    assert c["sidecar"] == {"hit": 1, "miss": 0}
    assert c["patrol"] == {"suspects": 7, "flip_rows": 0}
    assert c["pack"] == {"device": 2, "host": 0}
    assert c["h2d_bytes"] == 80 and c["d2h_bytes"] == 0
    assert c["cutoff"] == {"scans": 0}
    assert set(c) == {"launches", "h2d_bytes", "d2h_bytes", "pool",
                      "sidecar", "freq_blob", "patrol", "pack", "cutoff"}


def test_disabled_recorder_is_one_shared_no_op(monkeypatch):
    assert runtime._REC is None
    assert runtime.span("a") is runtime.span("b") is runtime._OFF
    assert runtime.kernel_range("covered") is runtime._OFF

    def no_clock():
        raise AssertionError("a clock read")
    monkeypatch.setattr(runtime.time, "time_ns", no_clock)
    with runtime.span("a"):
        runtime.count("pool.pooled")


def test_disabled_run_records_nothing_and_enters_no_range(wd, monkeypatch,
                                                          tmp_path):
    entered = []
    real = torch.profiler.record_function

    def record_function(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    made = []
    real_span = runtime._Span

    class Span(real_span):
        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(runtime, "_Span", Span)
    # the trace directory alone starts nothing
    rc, err = _port(wd, PINNED + ["--out", "d"], str(tmp_path / "tr"))
    assert rc == 0
    assert entered == [] and made == []
    assert "[profile]" not in err and not (tmp_path / "tr").exists()
    assert runtime._REC is None


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _x(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


def test_trace_holds_spans_on_the_main_thread_phases_inside_marks(traced):
    err, doc = traced
    ev = _x(doc)
    marks = sorted((e for e in ev if e["name"].startswith(MARK)),
                   key=lambda e: e["ts"])
    spans = [e for e in ev if e["name"].startswith(SPAN)]
    assert spans and {e["cat"] for e in spans} == {"user_annotation"}
    assert {e["tid"] for e in spans} == {marks[0]["tid"]}
    names = {e["name"][len(SPAN):] for e in spans}
    assert {"load/parse", "load/tfam", "filter/monomorphic",
            "phase1-lod/tie-band", "phase1-lod/inputs",
            "phase1-lod/inputs/upload", "phase1-lod/dispatch",
            "phase3-assembly/edges", "phase3-assembly/patrol",
            "phase3-assembly/scan", "phase3-assembly/calls",
            "call/finish"} <= names
    # call/start and call/export run outside the trace, the writer thread
    # is not traced
    assert not names & {"call/start", "call/export", "freq-writer"}
    # the range of the traced call holds every other
    (call,) = [e for e in spans if e["name"] == SPAN + "call"]
    assert all(call["ts"] <= e["ts"] and e["ts"] + e["dur"] <=
               call["ts"] + call["dur"] for e in spans + marks)
    start = min(e["ts"] for e in ev)
    for i, m in enumerate(marks):
        phase = m["name"][len(MARK):]
        (rng,) = [e for e in spans if e["name"] == SPAN + phase]
        lo = marks[i - 1]["ts"] + marks[i - 1]["dur"] if i else start
        assert lo <= rng["ts"] and rng["ts"] + rng["dur"] <= m["ts"]
        # each step lies in its phase's range
        for e in spans:
            if e["name"].startswith(SPAN + phase + "/"):
                assert rng["ts"] <= e["ts"]
                assert e["ts"] + e["dur"] <= rng["ts"] + rng["dur"]


def test_trace_summary_names_gaps_by_spans(traced):
    """With a device event at each phase mark the idle gaps are the
    phases: each is named by the innermost span over half of it."""
    _, doc = traced
    ev = _x(doc)
    marks = [e for e in ev if e["name"].startswith(MARK)]
    dev = [{"ph": "X", "cat": "kernel", "name": "k", "pid": 0, "tid": 7,
            "ts": m["ts"], "dur": 0.5} for m in marks]
    s = trace_summary({"traceEvents": doc["traceEvents"] + dev},
                      top_gaps=100)
    assert s["gaps"]
    for _, phases, host, share in s["gaps"]:
        assert host.startswith(SPAN), (phases, host)
        assert share >= 0.5


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def test_span_block_parses_beside_the_phases(traced):
    err, _ = traced
    got = {n: float(v) for n, v in _PHASE.findall(err) if n != "TOTAL"}
    phases = {n: float(v) for n, v in _PHASE.findall(_phase_block(err))
              if n != "TOTAL"}
    assert list(phases) == list(runtime.PHASES)
    lines = [ln for ln in _span_block(err).splitlines()
             if ln.startswith("[profile]   ")]
    spans = {ln.split()[1]: float(ln.split()[2][:-1]) for ln in lines}
    assert all(ln.rstrip().endswith(" spans") for ln in lines)
    assert not set(spans) & set(phases)
    assert {"call/start", "call/finish", "call/export", "freq-writer",
            "phase1-lod/inputs"} <= set(spans)
    assert got == {**phases, **spans}


def test_report_prints_after_the_writer_joined(wd):
    rc, err = _port(wd, PINNED + ["--tpu-profile", "--out", "j"])
    assert rc == 0
    spans = {ln.split()[1]: float(ln.split()[2][:-1])
             for ln in _span_block(err).splitlines()
             if ln.startswith("[profile]   ")}
    assert spans["freq-writer"] > 0 and spans["call/finish"] >= 0
    assert len(_counters(err)) == 1


def test_identical_warm_calls_print_identical_counters(wd):
    cache = ["--tpu-panel-cache", "--tpu-profile"]
    got = []
    for out in ("c0", "c1", "c2"):
        rc, err = _port(wd, AUTO + cache + ["--out", out])
        assert rc == 0, err
        (c,) = _counters(err)
        got.append(c)
    cold, warm1, warm2 = got
    assert warm1 == warm2
    assert cold["sidecar"] == {"hit": 0, "miss": 1}
    assert warm1["sidecar"] == {"hit": 1, "miss": 0}
    assert cold["freq_blob"] == {"hit": 0, "miss": 1}
    assert warm1["freq_blob"] == {"hit": 1, "miss": 0}
    assert cold["pool"] == {"pooled": 1, "replayed": 0}
    assert warm1["pool"] == {"pooled": 0, "replayed": 1}


def test_cutoff_search_splits_its_span_and_counts_its_scans(wd):
    """An automatic cutoff's search: the selection (search/modes) and its
    rivals' probe (search/rivals), 1 + 41 density scans; a pinned cutoff
    scans none."""
    rc, err = _port(wd, AUTO + ["--tpu-profile", "--out", "s0"])
    assert rc == 0, err
    spans = {ln.split()[1] for ln in _span_block(err).splitlines()
             if ln.startswith("[profile]   ")}
    assert {"phase2-cutoff/search", "phase2-cutoff/search/modes",
            "phase2-cutoff/search/rivals"} <= spans
    (c,) = _counters(err)
    assert c["cutoff"] == {"scans": 42}
    rc, err = _port(wd, PINNED + ["--tpu-profile", "--out", "s1"])
    assert rc == 0, err
    (c,) = _counters(err)
    assert c["cutoff"] == {"scans": 0}
    assert "phase2-cutoff/search" not in _span_block(err)


def test_warm_sidecar_call_counts_a_hit(wd):
    argv = PINNED + ["--tpu-panel-cache", "--tpu-profile"]
    assert _port(wd, argv + ["--out", "h0"])[0] == 0
    rc, err = _port(wd, argv + ["--out", "h1"])
    assert rc == 0
    (c,) = _counters(err)
    assert c["sidecar"]["hit"] == 1 and c["sidecar"]["miss"] == 0
    assert "load/sidecar" in _span_block(err)
