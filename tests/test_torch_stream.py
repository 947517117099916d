"""Streaming Phase I of the port (garlic_tpu_torch) against its resident
runs and against garlic_tpu's streamed runs, with the device budget
forced down by GARLIC_TPU_HBM_BUDGET.

Under the budget garlic_tpu streams every fast run through LazyWin and
the split path; the port streams split chromosomes (--raw-lod, the GL
file's float form) through LazyWin and keeps the fused route (K2, K4 for
the GQ file's dictionary form) for the rest, dispatching one chromosome
at a time.  The port runs on the CPU here (device="cpu": the kernels'
plain versions).

Tolerances: .roh.bed byte-identical, .log identical after its first
line, .freq.gz equal, .kde x byte-identical and y within 1e-5 * max y
(the f32 transforms of the two packages); --raw-lod values within atol
1e-4 + rtol 1e-5 of garlic_tpu's (f32 sums in another order, printed
with %g) and byte-identical to the port's resident run (the same K1/K3
chain)."""

from __future__ import annotations

import glob
import os
import sys
import weakref

import numpy as np
import pytest
import torch

from garlic_tpu_torch import pipeline as port_pipeline
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.ops import device_win as port_dw
from garlic_tpu_torch.parallel import engine as port_engine
from garlic_tpu_torch.parallel.mesh import make_mesh
from garlic_tpu_torch.pipeline import run_main as port_main

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, write_tgls,  # noqa: E402
                  write_tped)

BUDGET = "1000"  # bytes: every fast run of these panels streams
ONE = make_mesh(1, 1, ["cpu"])  # the fast engine's 1x1 mesh on the CPU
Y_TOL = 1e-5
COMMON = ["--build", "hg18", "--winsize", "60", "--error", "0.001",
          "--kde-subsample", "0"]
PINNED = ["--lod-cutoff", "1.3", "--size-bounds", "300000", "800000"]
RUNS = {  # configuration -> (flags, kernel of its fast route)
    "pinned": (PINNED, "covered"),
    "auto": ([], "covered"),
    "gq": (PINNED + ["--tgls", "GQ.tgls.gz", "--gl-type", "GQ"],
           "covered_terms"),
    "gl": (PINNED + ["--tgls", "GL.tgls.gz", "--gl-type", "GL"],
           "window_sums"),
    "raw_lod": (PINNED + ["--raw-lod"], "lod_windows"),
    "gl_raw_lod": (PINNED + ["--tgls", "GL.tgls.gz", "--gl-type", "GL",
                             "--raw-lod"], "window_sums"),
}


def jax_main(argv, prog):
    # imported here: the gpu tests collect where JAX is absent
    from garlic_tpu.pipeline import run_main
    return run_main(argv, prog=prog)


def _run(main, wd, args, **kw):
    old = os.getcwd()
    os.chdir(wd)
    try:
        return main(args, prog="garlic", **kw)
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def stream_dir(tmp_path_factory):
    """The verify recipe's panel (40 x (8000, 6000), seed 1: its KDE and
    GMM are not degenerate), with GQ and GL TGLS files."""
    wd = tmp_path_factory.mktemp("port_stream")
    panel = make_panel(nind=40, nloci_per_chr=(8000, 6000), seed=1)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    write_tgls(panel, str(wd / "GL.tgls.gz"), gl_type="GL")
    return str(wd)


def _args(wd, name):
    return ["--tped", f"{wd}/p.tped.gz", "--tfam", f"{wd}/p.tfam"] \
        + COMMON + [f if not f.endswith(".tgls.gz") else f"{wd}/{f}"
                    for f in RUNS[name][0]]


class _Live:
    """Counts, through monkeypatched device_win entry points, the coverage
    handles between covered_dispatch and covered_fetch and the DeviceWin
    window matrices alive at once (a weakref finalizer per matrix), and
    the split Phase I calls (lod_windows_sharded)."""

    def __init__(self, monkeypatch):
        self.handles, self.wins = set(), [0]
        self.max_handles = self.max_wins = self.split = 0
        dispatch, fetch = port_dw.covered_dispatch, port_dw.covered_fetch
        split = port_engine.lod_windows_sharded

        def counted_dispatch(*a, **k):
            h = dispatch(*a, **k)
            # a FusedCov pre-enqueued in Phase I hands back the same handle
            self.handles.add(id(h))
            self.max_handles = max(self.max_handles, len(self.handles))
            return h

        def counted_fetch(h):
            self.handles.discard(id(h))
            return fetch(h)

        def counted_split(*a, **k):
            w = split(*a, **k)
            self.split += 1
            self.wins[0] += 1
            self.max_wins = max(self.max_wins, self.wins[0])
            weakref.finalize(w, self._drop)
            return w

        monkeypatch.setattr(port_dw, "covered_dispatch", counted_dispatch)
        monkeypatch.setattr(port_dw, "covered_fetch", counted_fetch)
        monkeypatch.setattr(port_engine, "lod_windows_sharded",
                            counted_split)

    def _drop(self):
        self.wins[0] -= 1


def _raw(wd, out):
    vals = []
    for c in ("chr1", "chr2"):
        text = read_text(f"{wd}/{out}.POP1.{c}.raw.lod.windows.gz")
        vals.append(np.array(text.replace("NA", "nan").split(), dtype=float))
    return np.concatenate(vals)


def _kde_close(wd, out, ref):
    sfx = sorted(p[len(f"{wd}/{ref}"):]
                 for p in glob.glob(f"{wd}/{ref}.*SNPs.kde"))
    assert sfx
    for s in sfx:
        a = [r.split() for r in read_text(f"{wd}/{ref}{s}").splitlines()]
        b = [r.split() for r in read_text(f"{wd}/{out}{s}").splitlines()]
        assert [r[0] for r in a] == [r[0] for r in b]
        ya = np.array([float(r[1]) for r in a])
        yb = np.array([float(r[1]) for r in b])
        assert np.abs(ya - yb).max() <= Y_TOL * ya.max()


def _same(wd, out, ref):
    assert read_text(f"{wd}/{out}.roh.bed") == read_text(f"{wd}/{ref}.roh.bed")
    assert read_text(f"{wd}/{out}.freq.gz") == read_text(f"{wd}/{ref}.freq.gz")
    assert diff_logs(read_text(f"{wd}/{ref}.log"),
                     read_text(f"{wd}/{out}.log"), ref, out) == []


@pytest.mark.parametrize("name", list(RUNS))
def test_streamed_run_matches_resident_and_garlic_tpu(stream_dir, name,
                                                      monkeypatch, capsys):
    """Port streamed = port resident = garlic_tpu streamed, under the same
    budget; the streamed run holds at most one chromosome's coverage
    handle and window matrix at a time, the resident run both."""
    wd, args = stream_dir, _args(stream_dir, name)
    live = _Live(monkeypatch)
    assert _run(port_main, wd, args + ["--tpu-engine", "fast", "--out",
                                       f"{name}_res"], device="cpu") == 0
    assert "streaming" not in capsys.readouterr().err
    resident = (live.max_handles, live.max_wins, live.split)
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", BUDGET)
    live.max_handles = live.max_wins = live.split = 0
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, args + ["--tpu-engine", "fast", "--out",
                                       f"{name}_st"], device="cpu") == 0
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    assert "streaming per chromosome" in capsys.readouterr().err
    streamed = (live.max_handles, live.max_wins, live.split)
    assert _run(jax_main, wd, args + ["--tpu-engine", "fast", "--out",
                                      f"{name}_jst"]) == 0
    assert "streaming per chromosome" in capsys.readouterr().err

    # both chromosomes' handles live at once resident, one streamed; the
    # fused route (and every automatic run) never makes the split path's
    # matrix; a float-form TGLS chromosome makes it inside its dispatch
    # and drops it there; --raw-lod keeps both resident, and streamed
    # makes each twice (written, then counted), one at a time
    assert resident[0] == 2 and streamed[0] == 1
    raw = "raw_lod" in name
    if RUNS[name][1] in ("covered", "covered_terms"):
        assert resident[1:] == streamed[1:] == (0, 0)
    else:
        assert resident[1:] == ((2, 2) if raw else (1, 2))
        assert streamed[1:] == (1, 4 if raw else 2)

    for out in (f"{name}_st", f"{name}_jst"):
        _same(wd, out, f"{name}_res")
    assert read_text(f"{wd}/{name}_res.roh.bed").count("\nchr") >= 10
    if name == "auto":
        _kde_close(wd, f"{name}_st", f"{name}_jst")
        assert read_text(f"{wd}/{name}_st.60SNPs.kde") == \
            read_text(f"{wd}/{name}_res.60SNPs.kde")
    if "raw_lod" in name:
        for c in ("chr1", "chr2"):
            f = f"POP1.{c}.raw.lod.windows.gz"
            assert read_text(f"{wd}/{name}_st.{f}") == \
                read_text(f"{wd}/{name}_res.{f}")
        got, want = _raw(wd, f"{name}_st"), _raw(wd, f"{name}_jst")
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        live_ = ~np.isnan(want)
        np.testing.assert_allclose(got[live_], want[live_], atol=1e-4,
                                   rtol=1e-5)


def _holding(c, W, use_gl, fused):
    """What the gate counts for chromosome c on the 1x1 CPU mesh."""
    held = port_pipeline._device_holdings([c], W, use_gl, fused, ONE)
    assert list(held) == [torch.device("cpu")]
    return held[torch.device("cpu")]


def test_gate_counts_each_route(stream_dir):
    """What the gate sums per chromosome: the u8 planes on the fused
    route, the f32 window matrix on the split route and for a float-form
    TGLS chromosome (the fused dispatch declines it)."""
    from garlic_tpu_torch.io import filters, tgls
    from garlic_tpu_torch.io import tped as port_tped
    ds, _ = port_tped.load_tped(f"{stream_dir}/p.tped.gz")
    chroms, _ = filters.filter_monomorphic(ds.chroms)
    c = chroms[0]
    I, L, W = c.nind, c.nloci, 60
    nwin = L - W + 1
    assert _holding(c, W, False, True) == I * (L + 2 * nwin)
    assert _holding(c, W, False, False) == 4 * I * nwin
    for gl_type, fused_route in (("GQ", True), ("GL", False)):
        ds, _ = port_tped.load_tped(f"{stream_dir}/p.tped.gz")
        tgls.read_tgls(f"{stream_dir}/{gl_type}.tgls.gz", ds.chroms, I,
                       gl_type, None)
        c = filters.filter_monomorphic(ds.chroms)[0][0]
        assert _holding(c, W, True, True) == (
            I * (L + 2 * nwin) if fused_route else 4 * I * nwin)


def test_budget_between_the_routes_streams_only_the_split_one(
        stream_dir, monkeypatch, capsys):
    """A budget that holds both chromosomes' u8 planes but not their f32
    windows: the pinned run stays resident, --raw-lod streams."""
    from garlic_tpu_torch.io import filters
    from garlic_tpu_torch.io import tped as port_tped
    ds, _ = port_tped.load_tped(f"{stream_dir}/p.tped.gz")
    chroms, _ = filters.filter_monomorphic(ds.chroms)
    planes = sum(_holding(c, 60, False, True) for c in chroms)
    wins = sum(_holding(c, 60, False, False) for c in chroms)
    assert planes < wins
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", str(planes + wins))
    wd = stream_dir
    assert _run(port_main, wd, _args(wd, "pinned") + [
        "--tpu-engine", "fast", "--out", "mid_pinned"], device="cpu") == 0
    assert "streaming" not in capsys.readouterr().err
    assert _run(port_main, wd, _args(wd, "raw_lod") + [
        "--tpu-engine", "fast", "--out", "mid_raw"], device="cpu") == 0
    assert "streaming per chromosome" in capsys.readouterr().err
    assert read_text(f"{wd}/mid_raw.roh.bed") == \
        read_text(f"{wd}/mid_pinned.roh.bed")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(RUNS))
def test_streamed_run_on_card_matches_resident(stream_dir, name,
                                               monkeypatch):
    """The same on the card: the streamed run launches its route's kernel
    once per chromosome (K1/K3 twice with --raw-lod: written, then
    counted), as the resident run does, and gives its outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wd, args = stream_dir, _args(stream_dir, name)
    kernel = RUNS[name][1]
    live = _Live(monkeypatch)
    counts = {}
    for tag, budget in (("gres", None), ("gst", BUDGET)):
        if budget is not None:
            monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", budget)
        live.max_handles = 0
        before = dict(cuda_lod.LAUNCHES)
        assert _run(port_main, wd, args + ["--tpu-engine", "fast", "--out",
                                           f"{name}_{tag}"]) == 0
        counts[tag] = {k: cuda_lod.LAUNCHES[k] - before[k]
                       for k in cuda_lod.LAUNCHES}
        assert live.max_handles == (2 if budget is None else 1)
    assert counts["gres"][kernel] == 2
    assert counts["gst"][kernel] == 2 * (1 + ("raw_lod" in name))
    _same(wd, f"{name}_gst", f"{name}_gres")
    if "raw_lod" in name:
        for c in ("chr1", "chr2"):
            f = f"POP1.{c}.raw.lod.windows.gz"
            assert read_text(f"{wd}/{name}_gst.{f}") == \
                read_text(f"{wd}/{name}_gres.{f}")
