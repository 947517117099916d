"""The port's device trace: --tpu-profile with GARLIC_TPU_TRACE_DIR set
writes one torch.profiler Chrome trace per run (runtime.PhaseProfiler),
marks each phase in it, closes it on every exit of a run and changes no
output; chip_smoke.py's reader of such traces (phase 12) on a trace with
known intervals; and GT_FREQ_DEBUG's [gt_freq] lines against
garlic_tpu's.

On the CPU the trace holds the host's operators only (the exact engine,
and the fast engine's plain versions on "cpu"); the `gpu` test traces a
fast run on the card."""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import shutil
import socket
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
import chip_smoke  # noqa: E402
from util import make_panel, read_text, write_tped  # noqa: E402

from garlic_tpu_torch.pipeline import run_main as port_main  # noqa: E402

PINNED = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
          "--kde-subsample", "0", "--lod-cutoff", "1.3", "--size-bounds",
          "300000", "800000"]
ENGINES = {"exact": (["--tpu-engine", "exact"], None),
           "fast": (["--tpu-engine", "fast"], "cpu")}
PHASES = ["load", "freq", "filter", "phase1-lod", "phase2-cutoff",
          "phase3-assembly", "phase4-gmm", "write-bed"]


@pytest.fixture(scope="module")
def panel_dir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("trace_panel")
    panel = make_panel(nind=35, nloci_per_chr=(5000, 4000), seed=17,
                       big_gap_every=700)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    return str(wd)


def _base(wd):
    return ["--tped", f"{wd}/p.tped.gz", "--tfam", f"{wd}/p.tfam"] + PINNED


def _port(wd, args, device=None, trace_dir=None):
    """(exit code, stderr) of one in-process run from wd, with
    GARLIC_TPU_TRACE_DIR set to trace_dir (unset for None)."""
    old, saved = os.getcwd(), os.environ.pop("GARLIC_TPU_TRACE_DIR", None)
    err = io.StringIO()
    os.chdir(wd)
    if trace_dir is not None:
        os.environ["GARLIC_TPU_TRACE_DIR"] = trace_dir
    try:
        with contextlib.redirect_stderr(err):
            rc = port_main(args, prog="garlic", device=device)
    finally:
        os.chdir(old)
        os.environ.pop("GARLIC_TPU_TRACE_DIR", None)
        if saved is not None:
            os.environ["GARLIC_TPU_TRACE_DIR"] = saved
    return rc, err.getvalue()


def _traces(tdir):
    return sorted(glob.glob(os.path.join(tdir, "*")))


def _profile_phases(err):
    """The phases of the last --tpu-profile report in err: its phase
    breakdown's lines, not the span breakdown's paths after them."""
    return [line.split()[1]
            for line in chip_smoke.phase_block(err).splitlines()
            if line.startswith("[profile]   ")
            and line.split()[1] != "TOTAL"]


def _marks(path):
    with open(path) as f:
        doc = json.load(f)
    return [e["name"][len(chip_smoke.MARK):] for e in sorted(
        (e for e in doc["traceEvents"] if e.get("ph") == "X"
         and e["name"].startswith(chip_smoke.MARK)), key=lambda e: e["ts"])]


def _outputs(wd, out):
    text = read_text(f"{wd}/{out}.log").replace(out, "OUT")
    return (read_text(f"{wd}/{out}.roh.bed"),
            read_text(f"{wd}/{out}.freq.gz"), text.split("\n", 1)[1])


@pytest.fixture(scope="module")
def traced(panel_dir):
    """Per engine: a traced --tpu-profile run and the same run untraced;
    (trace directory, the traced run's stderr)."""
    out = {}
    for name, (flags, device) in ENGINES.items():
        tdir = os.path.join(panel_dir, f"trace_{name}")
        base = _base(panel_dir) + flags + ["--tpu-profile"]
        rc, err = _port(panel_dir, base + ["--out", f"t_{name}"], device,
                        tdir)
        assert rc == 0, err
        rc, _ = _port(panel_dir, base + ["--out", f"u_{name}"], device)
        assert rc == 0
        out[name] = (tdir, err)
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_traced_run_writes_one_chrome_trace(panel_dir, traced, engine):
    tdir, _ = traced[engine]
    files = _traces(tdir)
    assert len(files) == 1
    name = os.path.basename(files[0])
    assert name.startswith(f"garlic_tpu_torch.{socket.gethostname()}.p0."
                           f"{os.getpid()}.")
    assert name.endswith(".pt.trace.json")
    with open(files[0]) as f:
        doc = json.load(f)
    assert any(e.get("cat") == "user_annotation"
               for e in doc["traceEvents"])
    assert not torch.autograd.profiler._is_profiler_enabled


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_marks_are_the_profile_phases(traced, engine):
    tdir, err = traced[engine]
    assert _profile_phases(err) == PHASES
    assert _marks(_traces(tdir)[0]) == PHASES


@pytest.mark.parametrize("engine", ENGINES)
def test_traced_outputs_equal_untraced(panel_dir, traced, engine):
    """.roh.bed, .freq.gz and .log after line 1 (the output name
    normalized) are the untraced run's."""
    assert _outputs(panel_dir, f"t_{engine}") == \
        _outputs(panel_dir, f"u_{engine}")


@pytest.mark.parametrize("case", ["no-profile", "no-variable"])
def test_no_trace_without_profile_and_variable(panel_dir, tmp_path,
                                               monkeypatch, case):
    started = []
    real = torch.profiler.profile

    def profile(*a, **k):
        started.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    tdir = str(tmp_path / "tr")
    flags = [] if case == "no-profile" else ["--tpu-profile"]
    rc, err = _port(panel_dir, _base(panel_dir) + ENGINES["exact"][0]
                    + flags + ["--out", f"n_{case}"],
                    trace_dir=tdir if case == "no-profile" else None)
    assert rc == 0
    assert started == [] and not os.path.exists(tdir)
    assert "[profile] trace" not in err


def test_two_runs_write_two_files(panel_dir, tmp_path):
    tdir = str(tmp_path / "tr")
    argv = _base(panel_dir) + ENGINES["exact"][0] + ["--tpu-profile"]
    for i in range(2):
        assert _port(panel_dir, argv + ["--out", f"two{i}"],
                     trace_dir=tdir)[0] == 0
        assert len(_traces(tdir)) == i + 1
    assert [_marks(p) for p in _traces(tdir)] == [PHASES, PHASES]


def test_bench_torch_runs_write_a_trace_each(panel_dir, tmp_path,
                                             monkeypatch):
    """bench_torch.py's in-process runs pass --tpu-profile, so with the
    variable set each writes its own trace."""
    import bench_torch
    for name in ("p.tped.gz", "p.tfam"):
        shutil.copy(os.path.join(panel_dir, name), tmp_path / name)
    monkeypatch.setattr(bench_torch, "CACHE", str(tmp_path))
    tdir = str(tmp_path / "tr")
    monkeypatch.setenv("GARLIC_TPU_TRACE_DIR", tdir)
    for i in range(2):
        assert bench_torch.run_ours("p.tped.gz", "p.tfam", device="cpu") > 0
        assert len(_traces(tdir)) == i + 1
    assert [_marks(p) for p in _traces(tdir)] == [PHASES, PHASES]


@pytest.mark.parametrize("case", ["missing-tfam", "bad-mesh"])
def test_early_return_closes_the_trace(panel_dir, tmp_path, case):
    """A run that returns after the trace started (a load failure, the
    mesh refusal) still writes its trace and stops the profiler; the
    next traced run succeeds."""
    tdir = str(tmp_path / "tr")
    argv = _base(panel_dir) + ["--tpu-profile"]
    if case == "missing-tfam":
        bad = [a if a != f"{panel_dir}/p.tfam" else f"{panel_dir}/no.tfam"
               for a in argv] + ENGINES["exact"][0]
        want, device = 1, None
    else:
        bad = argv + ["--tpu-engine", "fast", "--tpu-mesh", "4x"]
        want, device = -1, "cpu"
    rc, _ = _port(panel_dir, bad + ["--out", f"e_{case}"], device, tdir)
    assert rc == want
    assert not torch.autograd.profiler._is_profiler_enabled
    files = _traces(tdir)
    assert len(files) == 1 and _marks(files[0]) == []
    rc, _ = _port(panel_dir, argv + ENGINES["exact"][0]
                  + ["--out", f"e2_{case}"], trace_dir=tdir)
    assert rc == 0
    assert len(_traces(tdir)) == 2


@pytest.mark.parametrize("case", ["directory-is-a-file", "export-fails"])
def test_failed_trace_is_reported_and_changes_nothing(panel_dir, tmp_path,
                                                      monkeypatch, case):
    tdir = tmp_path / "tr"
    if case == "directory-is-a-file":
        tdir.write_text("")
        said = "[profile] trace: torch.profiler did not start"
    else:
        def fail(self, path):
            raise OSError("disk full")
        monkeypatch.setattr(torch.profiler.profile, "export_chrome_trace",
                            fail)
        said = "[profile] trace: writing "
    argv = _base(panel_dir) + ENGINES["exact"][0] + ["--tpu-profile"]
    rc, err = _port(panel_dir, argv + ["--out", f"f_{case}"],
                    trace_dir=str(tdir))
    assert rc == 0
    assert said in err
    assert _profile_phases(err) == PHASES
    assert not torch.autograd.profiler._is_profiler_enabled
    rc, _ = _port(panel_dir, argv + ["--out", f"g_{case}"])
    assert rc == 0
    assert _outputs(panel_dir, f"f_{case}") == \
        _outputs(panel_dir, f"g_{case}")


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12's reader
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": dur}


K2 = ("void (anonymous namespace)::covered_kernel<(anonymous namespace)::"
      "PackedTerms>((anonymous namespace)::PackedTerms, unsigned char "
      "const*, unsigned char*, unsigned char*, unsigned char*, int, int, "
      "int, int, int, bool, float, float, float)")
FILL = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<unsigned char>, std::array<char*, 1ul> >(int, "
        "at::native::FillFunctor<unsigned char>, std::array<char*, 1ul>)")
# times in microseconds: the window is [0, 900] (the Trace span starts
# it, the last mark ends it); the device is busy in [150, 300] (two
# overlapping K2 launches), [500, 560] (a copy and a memset) and
# [850, 880]; the gaps [560, 850], [300, 500], [0, 150], [880, 900]
KNOWN = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "tid": 0, "ts": 0},
    _x("Trace", "PyTorch Profiler (0)", 0.0, 1000.0),
    _x("cpu_op", "aten::copy_", 100.0, 300.0),
    _x("cuda_runtime", "cudaMemcpyAsync", 110.0, 280.0),
    _x("kernel", K2, 150.0, 100.0),
    _x("kernel", K2, 200.0, 100.0),
    _x("gpu_user_annotation", "garlic::covered", 150.0, 150.0),
    _x("user_annotation", "garlic::mark:load", 400.0, 1.0),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 500.0, 50.0),
    _x("gpu_memset", "Memset (Device)", 540.0, 20.0),
    _x("cuda_runtime", "cudaStreamSynchronize", 600.0, 240.0),
    _x("kernel", FILL, 850.0, 30.0),
    _x("user_annotation", "garlic::mark:phase1-lod", 900.0, 1.0),
]}


def test_trace_summary_of_known_intervals():
    s = chip_smoke.trace_summary(KNOWN)
    assert s["window"] == pytest.approx(0.9)
    assert s["busy"] == pytest.approx(0.24)
    assert s["busy_share"] == pytest.approx(0.24 / 0.9)
    assert s["idle_share"] == pytest.approx(0.66 / 0.9)
    assert s["kinds"] == pytest.approx({
        "kernels": 0.23, "H2D": 0.05, "D2H": 0.0, "D2D": 0.0,
        "memcpy": 0.0, "memset": 0.02})
    assert [(k, n) for k, n, _ in s["ops"]] == [
        ("K2", 2), ("Memcpy HtoD (Pageable -> Device)", 1),
        ("vectorized_elementwise_kernel[FillFunctor]", 1),
        ("Memset (Device)", 1)]
    assert [ms for _, _, ms in s["ops"]] == pytest.approx(
        [0.2, 0.05, 0.03, 0.02])
    assert s["hand"] == {"K2": (2, pytest.approx(0.2))}
    assert s["marks"] == ["load", "phase1-lod"]
    assert s["device_events"] == 5
    gaps = s["gaps"]
    assert [g[1:3] for g in gaps] == [
        ("phase1-lod", "cudaStreamSynchronize"),
        ("load+phase1-lod", "aten::copy_"),
        ("load", "python"), ("phase1-lod", "python")]
    assert [(g[0], g[3]) for g in gaps] == [
        (pytest.approx(0.29), pytest.approx(240 / 290)),
        (pytest.approx(0.2), pytest.approx(0.5)),
        (pytest.approx(0.15), pytest.approx(100 / 150)),
        (pytest.approx(0.02), pytest.approx(1.0))]
    assert len(chip_smoke.trace_summary(KNOWN, top_ops=2,
                                        top_gaps=1)["gaps"]) == 1


def test_trace_summary_needs_a_mark():
    doc = {"traceEvents": [e for e in KNOWN["traceEvents"]
                           if "mark" not in e["name"]]}
    with pytest.raises(ValueError, match="garlic::mark:"):
        chip_smoke.trace_summary(doc)


@pytest.mark.parametrize("symbol,name", [
    (K2, "K2"),
    (K2.replace("PackedTerms", "PlaneTerms"), "K4"),
    ("void (anonymous namespace)::lod_windows_kernel<(anonymous namespace)"
     "::PackedTerms>((anonymous namespace)::PackedTerms, unsigned char "
     "const*, float*, int, int, int, bool)", "K1"),
    ("_ZN12_GLOBAL__N_118lod_windows_kernelINS_10PlaneTermsEEEvT_PKhPfiiib",
     "K3"),
    ("void (anonymous namespace)::pair_counts_kernel<(anonymous namespace)"
     "::Hr2>(unsigned char const*, int*, int*, int, int, int, int)", "K5"),
    ("void (anonymous namespace)::wlod_windows_kernel<true>(unsigned char "
     "const*, float const*, float const*, float const*, unsigned char "
     "const*, float*, unsigned int*, int, int, int, int, int, int, int)",
     "K6"),
    ("(anonymous namespace)::k7_gather_kernel(float const*, float const*, "
     "int, float, int const*, int, double*)", "K7"),
    ("(anonymous namespace)::em_kernel((anonymous namespace)::EmArgs)",
     "K8"),
    ("_ZN12_GLOBAL__N_19em_kernelENS_6EmArgsE", "K8"),
    (FILL, "vectorized_elementwise_kernel[FillFunctor]"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::CUDAFunctor_add<float> >(at::"
     "TensorIteratorBase&, at::native::CUDAFunctor_add<float> const&)::"
     "{lambda(int)#1}>(int, at::native::gpu_kernel_impl_nocast<at::native"
     "::CUDAFunctor_add<float> >(at::TensorIteratorBase&, at::native::"
     "CUDAFunctor_add<float> const&)::{lambda(int)#1})",
     "elementwise_kernel[CUDAFunctor_add]"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "compare_scalar_kernel<float>(at::TensorIteratorBase&, at::native::"
     "(anonymous namespace)::OpType, float)::{lambda(float)#1}, std::"
     "array<char*, 2ul> >(int, at::native::compare_scalar_kernel<float>(at"
     "::TensorIteratorBase&, at::native::(anonymous namespace)::OpType, "
     "float)::{lambda(float)#1}, std::array<char*, 2ul>)",
     "vectorized_elementwise_kernel[compare_scalar_kernel]"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()(at::TensorIterator&)::{lambda(float, "
     "float)#1}>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float,"
     " at::native::func_wrapper_t<float, at::native::sum_functor<float, "
     "float, float>::operator()(at::TensorIterator&)::{lambda(float, "
     "float)#1}>, unsigned int, float, 4, 4>)", "reduce_kernel[sum_functor]"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32_cublas",
     "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32_cublas"),
], ids=["K2", "K4", "K1", "K3-mangled", "K5", "K6", "K7", "K8",
        "K8-mangled", "elementwise", "nocast", "lambda", "reduce", "other"])
def test_kernel_name(symbol, name):
    assert chip_smoke.kernel_name(symbol) == name


def test_traced_runs_on_the_cpu(panel_dir, monkeypatch):
    """Phase 12's child process, on "cpu": each run twice untraced, then
    traced; all three BEDs equal, the budget streams its run, and each
    trace reads as the run's phases with no device event."""
    work = os.path.join(panel_dir, "phase12")
    os.makedirs(work)
    monkeypatch.setattr(chip_smoke, "WORK", work)
    argv = _base(panel_dir) + ["--tpu-engine", "fast", "--tpu-profile"]
    got = chip_smoke.traced_runs({"pinned": (argv, None),
                                  "streamed": (argv, "1000")}, "cpu")
    assert list(got) == ["pinned", "streamed"]
    for name, (runs, err, path) in got.items():
        assert [(r["run"], r["traced"], r["rc"]) for r in runs] == [
            (0, False, 0), (1, False, 0), (2, True, 0)]
        beds = {read_text(f"{work}/traced_{name}.{i}.roh.bed")
                for i in range(3)}
        assert len(beds) == 1
        assert err.count("streaming per chromosome") == \
            (3 if name == "streamed" else 0)
        assert err.count("[profile] counters") == 3
        with open(path) as f:
            s = chip_smoke.trace_summary(json.load(f))
        assert s["marks"] == PHASES == _profile_phases(
            err.split("[profile] phase breakdown:")[-1])
        assert s["device_events"] == 0 and s["busy"] == 0.0
        assert s["idle_share"] == 1.0 and s["window"] > 0


@pytest.mark.gpu
def test_traced_run_on_card_holds_its_kernels(panel_dir, tmp_path):
    """A traced fast run on the card: device events, K2's kernels and
    its garlic::covered launch ranges in the trace, the BED unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tdir = str(tmp_path / "tr")
    argv = _base(panel_dir) + ["--tpu-engine", "fast", "--tpu-profile"]
    assert _port(panel_dir, argv + ["--out", "gpu_t"], trace_dir=tdir)[0] \
        == 0
    assert _port(panel_dir, argv + ["--out", "gpu_u"])[0] == 0
    assert read_text(f"{panel_dir}/gpu_t.roh.bed") == \
        read_text(f"{panel_dir}/gpu_u.roh.bed")
    (path,) = _traces(tdir)
    with open(path) as f:
        doc = json.load(f)
    s = chip_smoke.trace_summary(doc)
    assert s["device_events"] > 0 and s["busy"] > 0
    assert s["hand"]["K2"][0] == 2
    names = {e["name"] for e in doc["traceEvents"]}
    assert "garlic::covered" in names
    assert s["marks"] == PHASES


# ---------------------------------------------------------------------------
# GT_FREQ_DEBUG
# ---------------------------------------------------------------------------

def _freq_lines(err):
    return [line for line in err.splitlines() if line.startswith("[gt_freq]")]


@pytest.mark.parametrize("extra", [[], ["--resample", "50", "--tpu-seed",
                                        "11"]], ids=["plain", "resample"])
def test_freq_debug_lines_equal_garlic_tpus(panel_dir, monkeypatch, capsys,
                                            extra):
    from garlic_tpu.pipeline import run_main as jax_main
    monkeypatch.setenv("GT_FREQ_DEBUG", "1")
    monkeypatch.chdir(panel_dir)
    base = _base(panel_dir) + extra
    assert jax_main(base + ["--tpu-engine", "exact", "--out", "fj"],
                    prog="garlic") == 0
    want = _freq_lines(capsys.readouterr().err)
    assert len(want) == 2
    for flags, device in ENGINES.values():
        assert port_main(base + flags + ["--out", "fp"], prog="garlic",
                         device=device) == 0
        assert _freq_lines(capsys.readouterr().err) == want
    monkeypatch.delenv("GT_FREQ_DEBUG")
    assert port_main(base + ["--tpu-engine", "exact", "--out", "fq"],
                     prog="garlic") == 0
    assert _freq_lines(capsys.readouterr().err) == []
