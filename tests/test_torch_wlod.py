"""The port's weighted path (--weighted, --phased, --cm) against garlic_tpu.

On the CPU (device="cpu"): the port's plain-torch LD band and wLOD window
programs (garlic_tpu_torch/ops/device_wlod.py) against garlic_tpu's XLA
programs on JAX-CPU and against the f64 host engine; the copied host
modules (ops/ld.py, ops/wlod.py, io/genmap.py) against their sources; and
whole runs of both packages on one panel with a genetic-map scaffold.
Tolerances are stated at each comparison.  The gpu-marked tests hold the
programs on the card to the same programs on the CPU.

garlic_tpu is imported inside the CPU-side tests only: the gpu tests run
where JAX is absent.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, write_map_scaffold,  # noqa: E402
                  write_tgls, write_tped)

from garlic_tpu_torch.core.types import MISSING, ChromData  # noqa: E402
from garlic_tpu_torch.io import genmap  # noqa: E402
from garlic_tpu_torch.ops import cuda_lod, device_wlod, ld, wlod  # noqa: E402
from garlic_tpu_torch.parallel import engine as port_engine  # noqa: E402
from garlic_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from garlic_tpu_torch.pipeline import run_main as port_main  # noqa: E402

ERR, GAP, MU, M = 0.001, 200000, 1e-9, 7


def _band(c, W, phased, sub, device="cpu"):
    """The port's LD band [nwin, W] on the 1x1 mesh over `device`."""
    return port_engine.ld_band_sharded(c, W, phased, sub,
                                       make_mesh(1, 1, [device]))[(0, 0)]


def _weighted(c, centro, W, use_gl, phased, sub, device="cpu"):
    """The port's weighted Phase I (LD band, then wLOD windows) on the
    1x1 mesh over `device`: a DeviceWin with its tie_scale."""
    mesh = make_mesh(1, 1, [device])
    return port_engine.wlod_windows_sharded(
        c, centro, port_engine.ld_band_sharded(c, W, phased, sub, mesh), W,
        ERR, GAP, use_gl, MU, M, mesh)


class _Centro:
    def __init__(self, s=10**9, e=10**9 + 1):
        self._s, self._e = s, e

    def start(self, c):
        return self._s

    def end(self, c):
        return self._e


def _arrays(I, L, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    g[rng.random((I, L)) < 0.04] = -9
    return dict(
        chrom="chr1", positions=np.cumsum(rng.integers(200, 4000, L)),
        gpos=np.cumsum(rng.random(L) * 0.01),
        locus_names=[f"r{i}" for i in range(L)],
        alleles=np.array(["A"] * L), genotypes=g,
        freq=np.clip(rng.beta(1, 1, L), 0.05, 0.95),
        first_copy=rng.random((I, L)) < 0.5,
        gl=10.0 ** -rng.uniform(2, 5, (I, L)))


def _chroms(I=30, L=700, seed=0):
    """(port ChromData, garlic_tpu ChromData) over the same arrays."""
    from garlic_tpu.core.types import ChromData as GtChromData
    a = _arrays(I, L, seed)
    a["positions"] = a["positions"].astype(np.int64)
    return ChromData(**a), GtChromData(**a)


def _sub(I, on):
    return np.array([1, 2, 5, 8, 9, 13, 17, 20, 26], dtype=np.int64) \
        if on else None


# ---------------------------------------------------------------------------
# The device programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("subsample", [False, True], ids=["all", "sub"])
def test_ld_band_matches_garlic_tpu(phased, subsample):
    """Both f32; the prefix sums may run in another order, hence rtol
    1e-5, atol 1e-6.  Against the f64 host band (calc_ld fast): rtol and
    atol 2e-4 (tests/test_device_wlod.py:44)."""
    from garlic_tpu.ops import device_wlod as gt_dwlod
    c, cg = _chroms(seed=1 + phased)
    W = 17
    nwin = c.nloci - W + 1
    sub = _sub(c.nind, subsample)
    got = _band(c, W, phased, sub).numpy()
    want = np.asarray(gt_dwlod.ld_band_device(cg, W, phased, sub))[:nwin]
    assert got.shape == (nwin, W)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    ref = ld.calc_ld(c, W, phased, sub, engine="fast")[:nwin]
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def _check_tie_scale(c, W, phased, sub, use_gl, got, want):
    """The tie scale is the largest |f32 score * f32 (1 / LD)| over every
    row and every window of the chromosome, exactly.  garlic_tpu's also
    spans the windows that start within W - 1 loci of the end and run
    into its power-of-two padding (partial LD rows, so larger terms): it
    is never smaller, up to the band's last f32 bit (rtol 1e-6:
    garlic_tpu's two-step route takes the marginals from the host's
    f64)."""
    score = wlod.wlod_scores(c, ERR, use_gl, MU, M).astype(np.float32)
    inv = (1.0 / _band(c, W, phased, sub)).numpy()
    nwin = c.nloci - W + 1
    tmax = max(float(np.abs(score[:, j:j + nwin] * inv[:, j]).max())
               for j in range(W))
    assert float(got.tie_scale) == tmax
    assert float(got.tie_scale) <= float(want.tie_scale) * (1 + 1e-6)


def _window_case(c, cg, W, phased, sub, use_gl=False):
    from garlic_tpu.ops import device_wlod as gt_dwlod
    centro = _Centro(int(c.positions[200]), int(c.positions[230]))
    got = _weighted(c, centro, W, use_gl, phased, sub)
    want = gt_dwlod.weighted_windows_device(cg, centro, W, ERR, GAP, use_gl,
                                            MU, M, phased, sub)
    return centro, got, want


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("subsample", [False, True], ids=["all", "sub"])
def test_weighted_windows_match_garlic_tpu(phased, subsample):
    """MISSING at the same places; live values within rtol 1e-5, atol
    1e-5 of garlic_tpu's f32 (other prefix-sum order, XLA's contraction)
    and within rtol and atol 3e-3 of the f64 host engine over the exact
    band (tests/test_device_wlod.py:70); the tie scale as
    _check_tie_scale says."""
    c, cg = _chroms(seed=3 + phased)
    W = 13
    sub = _sub(c.nind, subsample)
    centro, got, want = _window_case(c, cg, W, phased, sub)
    g, w = got.to_numpy(), want.to_numpy()
    np.testing.assert_array_equal(g == MISSING, w == MISSING)
    live = w != MISSING
    assert live.sum() > 0 and (~live[:, :c.nloci - W + 1]).sum() > 0
    np.testing.assert_allclose(g[live], w[live], rtol=1e-5, atol=1e-5)
    _check_tie_scale(c, W, phased, sub, False, got, want)
    ref = wlod.wlod_windows(c, centro, ld.calc_ld(c, W, phased, sub), W,
                            ERR, GAP, False, MU, M)
    np.testing.assert_array_equal(g == MISSING, ref == MISSING)
    np.testing.assert_allclose(g[live], ref[live], rtol=3e-3, atol=3e-3)


def test_tgls_two_step_route_matches_garlic_tpu():
    """A per-genotype error plane: the host's f64 scores ship as f32 and
    the window program runs over them (wlod_windows_sharded); the same
    tolerances as the scalar-error route."""
    c, cg = _chroms(I=21, L=500, seed=8)
    W = 11
    centro, got, want = _window_case(c, cg, W, False, None, use_gl=True)
    g, w = got.to_numpy(), want.to_numpy()
    np.testing.assert_array_equal(g == MISSING, w == MISSING)
    live = w != MISSING
    np.testing.assert_allclose(g[live], w[live], rtol=1e-5, atol=1e-5)
    _check_tie_scale(c, W, False, None, True, got, want)


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("subsample", [False, True], ids=["all", "sub"])
def test_chunked_route_bit_identical(phased, subsample, monkeypatch):
    """A tiny device budget splits weighted Phase I into chunks (pair
    counts and windows over 8-row chunks): every window, the tie scale
    and the band equal the one-chunk run's (torch.equal)."""
    c = _chroms(I=30, L=400, seed=9)[0]
    centro = _Centro()
    W = 14
    sub = _sub(c.nind, subsample)

    def run():
        calls = dict(device_wlod.CALLS)
        dw = _weighted(c, centro, W, False, phased, sub)
        band = _band(c, W, phased, sub)
        return dw, band, device_wlod.CALLS["wlod_windows_plain"] - \
            calls["wlod_windows_plain"]

    one, band1, n1 = run()
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "2e4")
    chunked, band2, n2 = run()
    assert (n1, n2) == (1, 4)  # 30 rows in chunks of 8
    assert torch.equal(one.blocks[(0, 0)], chunked.blocks[(0, 0)])
    assert torch.equal(one.tie_scale, chunked.tie_scale)
    assert torch.equal(band1, band2)


def test_score_table_gather_equals_host_scores():
    """The per-class table gather gives the f32 casts of the host's f64
    (lod * nomut) * norec scores bit for bit."""
    c = _chroms(I=11, L=257, seed=4)[0]
    got = device_wlod._wlod_score_from_table(
        torch.from_numpy(c.genotypes),
        torch.from_numpy(device_wlod.score_table(c, ERR, MU, M)))
    want = wlod.wlod_scores(c, ERR, False, MU, M).astype(np.float32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("band", ["slices", "pair_band"])
def test_weighted_patrol_equals_garlic_tpu(phased, band):
    """The tie patrol's f64 verification: the band rows of every suspect
    window, assembled together, equal ops/ld.py's exact engine's bit for
    bit, and each suspect's flip equals garlic_tpu's (rows repeat a
    window; an LD subsample; the sides are drawn so both outcomes
    occur)."""
    from garlic_tpu import pipeline as gt_pipeline

    from garlic_tpu_torch import pipeline
    c, cg = _chroms(I=30, L=400, seed=12 + phased)
    W, sub = 15, _sub(30, True)
    rng = np.random.default_rng(7)
    wins = rng.integers(0, c.nloci - W + 1, 40)
    wins[5:9] = wins[4]
    rows = rng.integers(0, c.nind, wins.size)
    sides = rng.random(wins.size) < 0.5
    P = ld.pair_ld(c, W, phased, sub) if band == "pair_band" else None
    got = pipeline._exact_wlod_band_rows(c, wins, W, phased, sub, P)
    if P is not None:
        np.testing.assert_array_equal(got, ld.assemble_ld_exact(P, W)[wins])
    else:  # each window's pair values from its own locus slice
        for k, w in enumerate(wins):
            g = c.genotypes[:, w:w + W]
            pw = (ld.pair_ld_r2(g, c.first_copy[:, w:w + W],
                                c.freq[w:w + W], W, sub) if phased else
                  ld.pair_ld_hr2(g, ld.geno_hom_freq(g), W, sub))
            np.testing.assert_array_equal(got[k],
                                          ld.assemble_ld_exact(pw, W)[0])
    args = (rows, wins, sides, W, ERR, False, MU, M, phased, sub, 0.05)
    flips = pipeline._exact_wlod_window_flips(c, *args, P=P)
    want = gt_pipeline._exact_wlod_window_flips(cg, *args, P=P)
    np.testing.assert_array_equal(flips, want)
    assert 0 < flips.sum() < flips.size


# ---------------------------------------------------------------------------
# The copied host modules
# ---------------------------------------------------------------------------

_W, _SUB = 9, np.array([0, 3, 4, 9, 15, 22])


def _cen(a):
    return _Centro(int(a["positions"][100]), int(a["positions"][120]))


# name -> f(ld module, wlod module, ChromData, the arrays behind it)
COPIES = {
    "geno_hom_freq": lambda l, w, c, a: l.geno_hom_freq(a["genotypes"]),
    "pair_ld_hr2": lambda l, w, c, a: l.pair_ld_hr2(
        a["genotypes"], l.geno_hom_freq(a["genotypes"]), _W, _SUB),
    "pair_ld_r2": lambda l, w, c, a: l.pair_ld_r2(
        a["genotypes"], a["first_copy"], a["freq"], _W, _SUB),
    "calc_ld_exact": lambda l, w, c, a: l.calc_ld(c, _W, False, _SUB),
    "calc_ld_fast_phased": lambda l, w, c, a: l.calc_ld(
        c, _W, True, None, engine="fast"),
    "assemble_ld_exact_rows": lambda l, w, c, a: l.assemble_ld_exact_rows(
        l.pair_ld(c, _W, True, _SUB), _W, np.arange(0, 292, 7)),
    "wlod_scores": lambda l, w, c, a: w.wlod_scores(c, ERR, False, MU, M),
    "wlod_scores_gl": lambda l, w, c, a: w.wlod_scores(c, ERR, True, MU, M),
    "wlod_windows": lambda l, w, c, a: w.wlod_windows(
        c, _cen(a), l.calc_ld(c, _W, False, _SUB), _W, ERR, GAP, False, MU,
        M),
    "wlod_windows_gl_phased": lambda l, w, c, a: w.wlod_windows(
        c, _cen(a), l.calc_ld(c, _W, True, None), _W, ERR, GAP, True, MU, M),
}


@pytest.mark.parametrize("name", list(COPIES))
def test_copied_ld_and_wlod_equal_garlic_tpu(name):
    """ops/ld.py and ops/wlod.py give array-equal f64 results."""
    from garlic_tpu.core.types import ChromData as GtChromData
    from garlic_tpu.ops import ld as gt_ld
    from garlic_tpu.ops import wlod as gt_wlod
    a = _arrays(24, 300, 5)
    a["positions"] = a["positions"].astype(np.int64)
    got = COPIES[name](ld, wlod, ChromData(**a), a)
    want = COPIES[name](gt_ld, gt_wlod, GtChromData(**a), a)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_copied_genmap_equals_garlic_tpu(tmp_path):
    """io/genmap.py: the same scaffolds and interpolated positions."""
    from garlic_tpu.centromeres import Centromere as GtCentromere
    from garlic_tpu.io import genmap as gt_genmap

    from garlic_tpu_torch.centromeres import Centromere
    panel = make_panel(nind=4, nloci_per_chr=(900, 700), seed=3)
    path = str(tmp_path / "m.gz")
    write_map_scaffold(panel, path)
    outs = []
    for mod, cen in ((genmap, Centromere), (gt_genmap, GtCentromere)):
        centro = cen("hg18", "none", "none", None)
        sc = mod.load_map_scaffold(path, centro)
        interp = [mod.interpolate_genetic_map(
            p[(p >= s.positions[0]) & (p <= s.positions[-1])], s)
            for p, s in zip(panel.positions, sc)]
        outs.append((sc, interp))
    (sa, ia), (sb, ib) = outs
    assert [(s.chrom, s.centro_start, s.centro_end) for s in sa] == \
        [(s.chrom, s.centro_start, s.centro_end) for s in sb]
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x.positions, y.positions)
        np.testing.assert_array_equal(x.gpos, y.gpos)
    for (gx, nx), (gy, ny) in zip(ia, ib):
        np.testing.assert_array_equal(gx, gy)
        assert nx == ny and nx > 0


# ---------------------------------------------------------------------------
# Whole runs: python -m garlic_tpu_torch against python -m garlic_tpu
# ---------------------------------------------------------------------------

PINNED = ["--winsize", "40", "--error", "0.001", "--kde-subsample", "0",
          "--size-bounds", "300000", "800000"]
WCUT = ["--lod-cutoff", "0.1"]   # the weighted windows' scale on this panel
CUT = ["--lod-cutoff", "1.3"]    # plain LOD windows


@pytest.fixture(scope="module")
def wpanel(tmp_path_factory):
    """tests/test_torch_pipeline.py's panel and centromere file, with a
    genetic-map scaffold and a GQ TGLS file."""
    wd = tmp_path_factory.mktemp("wlod_panel")
    panel = make_panel(nind=35, nloci_per_chr=(5000, 4000), seed=17,
                       big_gap_every=700)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_map_scaffold(panel, str(wd / "m.gz"))
    write_tgls(panel, str(wd / "p.tgls.gz"), gl_type="GQ")
    p1, p2 = panel.positions
    with open(wd / "centro.txt", "w") as f:
        f.write(f"1 {int(p1[2000])} {int(p1[2100])}\n"
                f"2 {int(p2[3000])} {int(p2[3050])}\n")
    return str(wd)


@pytest.fixture(scope="module")
def apanel(tmp_path_factory):
    """The 40 x (8000, 6000) panel of the automatic runs, with a map
    whose recombination scale keeps the weighted KDE two-moded."""
    wd = tmp_path_factory.mktemp("wlod_auto")
    panel = make_panel(nind=40, nloci_per_chr=(8000, 6000), seed=1)
    write_tped(panel, str(wd / "a.tped.gz"), str(wd / "a.tfam"))
    write_map_scaffold(panel, str(wd / "m.gz"), rate_cm_per_mb=0.012)
    return str(wd)


def _jax_main(argv, prog):
    from garlic_tpu.pipeline import run_main
    return run_main(argv, prog=prog)


def _run(main, wd, args, **kw):
    old = os.getcwd()
    os.chdir(wd)
    try:
        return main(args, prog="garlic", **kw)
    finally:
        os.chdir(old)


def _wbase(wd):
    return ["--tped", f"{wd}/p.tped.gz", "--tfam", f"{wd}/p.tfam",
            "--centromere", f"{wd}/centro.txt", "--map", f"{wd}/m.gz"] \
        + PINNED


def _abase(wd):
    return ["--tped", f"{wd}/a.tped.gz", "--tfam", f"{wd}/a.tfam",
            "--build", "hg18", "--winsize", "60", "--error", "0.001",
            "--kde-subsample", "0", "--map", f"{wd}/m.gz"]


def _kde(wd, out):
    base = f"{wd}/{out}."
    return sorted(p[len(base):] for p in glob.glob(base + "*SNPs.kde"))


def _same_kde(wd, out, ref):
    """x column byte-identical, y within 1e-5 * max y (the f32 device
    transform)."""
    assert _kde(wd, out) == _kde(wd, ref) != []
    for sfx in _kde(wd, ref):
        a = [r.split() for r in read_text(f"{wd}/{ref}.{sfx}").splitlines()]
        b = [r.split() for r in read_text(f"{wd}/{out}.{sfx}").splitlines()]
        assert [r[0] for r in a] == [r[0] for r in b]
        ya = np.array([float(r[1]) for r in a])
        yb = np.array([float(r[1]) for r in b])
        assert np.abs(ya - yb).max() <= 1e-5 * ya.max()


def _same_outputs(wd, out, ref, bed=True):
    if bed:
        assert read_text(f"{wd}/{out}.roh.bed") == \
            read_text(f"{wd}/{ref}.roh.bed")
        assert read_text(f"{wd}/{out}.freq.gz") == \
            read_text(f"{wd}/{ref}.freq.gz")
    assert diff_logs(read_text(f"{wd}/{ref}.log"),
                     read_text(f"{wd}/{out}.log"), ref, out) == []


def _raw(wd, out):
    vals = []
    for c in ("chr1", "chr2"):
        text = read_text(f"{wd}/{out}.POP1.{c}.raw.lod.windows.gz")
        vals.append(np.array(text.replace("NA", "nan").split(), dtype=float))
    return np.concatenate(vals)


# (panel, flags, drop from the base, what to compare besides .log).  The
# first six are the configurations the port refused until now
# (tests/test_torch_pipeline.py's refusal cases), with a real map and
# TGLS file.
RUNS = {
    "weighted": ("w", ["--weighted"] + WCUT, [], "bed"),
    "weighted_tgls": ("w", ["--weighted", "--tgls", "p.tgls.gz",
                            "--gl-type", "GQ"] + WCUT, [], "bed"),
    "weighted_explore": ("w", ["--weighted", "--winsize-multi", "30", "40"],
                         [], "kde"),
    "weighted_auto_winsize": ("w", ["--weighted", "--auto-winsize"] + WCUT,
                              [], "bed"),
    "cm": ("w", ["--cm"] + CUT, [], "bed"),
    "phased": ("w", ["--phased"] + CUT, [], "bed"),
    "weighted_phased": ("w", ["--weighted", "--phased"] + WCUT, [], "bed"),
    "weighted_ld_subsample": ("w", ["--weighted", "--ld-subsample", "10",
                                    "--tpu-seed", "3"] + WCUT, [], "bed"),
    "weighted_explore_subsets": ("w", [
        "--weighted", "--winsize-multi", "20", "30", "--ld-subsample", "12",
        "--kde-subsample", "15", "--tpu-seed", "4"], ["--kde-subsample"],
        "kde"),
    "weighted_raw_lod": ("w", ["--weighted", "--raw-lod"] + WCUT, [], "raw"),
    "weighted_auto": ("a", ["--weighted"], [], "bed+kde"),
    "cm_auto": ("a", ["--cm"], [], "bed+kde"),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_run_matches_garlic_tpu(wpanel, apanel, name):
    """The port's fast engine (device="cpu") and its exact engine against
    garlic_tpu's exact engine: .roh.bed byte-identical, .freq.gz equal,
    .log identical after line 1; .kde x byte-identical and y within
    1e-5 * max y; --raw-lod values within atol 1e-4 + rtol 1e-5 (f32
    against f64, printed with %g)."""
    which, flags, drop, check = RUNS[name]
    wd = wpanel if which == "w" else apanel
    base = _wbase(wd) if which == "w" else _abase(wd)
    for flag in drop:
        i = base.index(flag)
        del base[i:i + 2]
    args = base + flags
    j, f, x = f"j_{name}", f"f_{name}", f"x_{name}"
    assert _run(_jax_main, wd, args + ["--tpu-engine", "exact",
                                       "--out", j]) == 0
    assert _run(port_main, wd, args + ["--tpu-engine", "fast", "--out", f],
                device="cpu") == 0
    assert _run(port_main, wd, args + ["--tpu-engine", "exact",
                                       "--out", x]) == 0
    for out in (f, x):
        _same_outputs(wd, out, j, bed="bed" in check or check == "raw")
        if "kde" in check:
            _same_kde(wd, out, j)
    if "bed" in check:
        assert read_text(f"{wd}/{j}.roh.bed").count("\nchr") >= 3
    if check == "raw":
        want = _raw(wd, j)
        for out in (f, x):
            got = _raw(wd, out)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            live = ~np.isnan(want)
            np.testing.assert_allclose(got[live], want[live], atol=1e-4,
                                       rtol=1e-5)


def test_pinned_weighted_fast_engines_agree(wpanel, monkeypatch):
    """garlic_tpu's fast engine (its XLA programs on JAX-CPU) gives the
    same files as the port's."""
    wd = wpanel
    args = _wbase(wd) + ["--weighted"] + WCUT
    assert _run(_jax_main, wd, args + ["--tpu-engine", "fast",
                                       "--out", "jfast"]) == 0
    assert _run(port_main, wd, args + ["--tpu-engine", "fast",
                                       "--out", "pfast"], device="cpu") == 0
    _same_outputs(wd, "pfast", "jfast")


def test_phased_panel_cache_warm_run_reads_the_sidecar(wpanel, monkeypatch):
    """A cold phased run under --tpu-panel-cache writes the first-copy
    plane into the sidecar; the warm run reads it without parsing the
    TPED, and garlic_tpu reads the same sidecar: the BEDs are equal."""
    import garlic_tpu_torch.native as native
    wd = wpanel
    shutil.copy(f"{wd}/p.tped.gz", f"{wd}/pc.tped.gz")
    args = _wbase(wd) + ["--weighted", "--phased", "--tpu-panel-cache"] \
        + WCUT
    args[1] = f"{wd}/pc.tped.gz"
    assert _run(port_main, wd, args + ["--tpu-engine", "fast",
                                       "--out", "pc_cold"],
                device="cpu") == 0
    from garlic_tpu_torch.io import panelcache
    cached = panelcache.load_cache(f"{wd}/pc.tped.gz", want_fc=True)
    assert cached is not None and cached[0]["first_copy"] is not None
    parses = []
    parse = native.parse_tped_native

    def counting(*a, **k):
        parses.append(a)
        return parse(*a, **k)

    monkeypatch.setattr(native, "parse_tped_native", counting)
    assert _run(port_main, wd, args + ["--tpu-engine", "fast",
                                       "--out", "pc_warm"],
                device="cpu") == 0
    assert parses == []
    assert _run(_jax_main, wd, args + ["--tpu-engine", "exact",
                                       "--out", "pc_jax"]) == 0
    for out in ("pc_cold", "pc_warm"):
        _same_outputs(wd, out, "pc_jax")


def test_native_phased_parse_matches_the_python_reader(wpanel):
    """The native parser's phased branch (int8 genotypes and first-copy
    bits) gives the pure-Python reader's arrays."""
    from garlic_tpu_torch.io import tped
    path = f"{wpanel}/p.tped.gz"
    nat, _ = tped.load_tped(path, phased=True)
    py, _ = tped._load_tped_python(path, "0", True, True, None)
    for a, b in zip(nat.chroms, py.chroms):
        np.testing.assert_array_equal(a.genotypes, b.genotypes)
        np.testing.assert_array_equal(a.first_copy, b.first_copy)
        np.testing.assert_array_equal(a.freq, b.freq)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _port_chrom(I, L, seed):
    a = _arrays(I, L, seed)
    a["positions"] = a["positions"].astype(np.int64)
    return ChromData(**a)


@pytest.mark.gpu
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_ld_band_on_card_equals_cpu(cuda_device, phased):
    """Integer counts, IEEE f32 element operations and prefix sums in one
    order: the card's band equals the CPU's bit for bit; the counts come
    from one K5 launch."""
    c = _port_chrom(60, 20000, 21)
    sub = np.arange(0, 60, 3)
    cpu = _band(c, 60, phased, sub)
    before = cuda_lod.LAUNCHES["pair_counts"]
    gpu = _band(c, 60, phased, sub, cuda_device)
    assert cuda_lod.LAUNCHES["pair_counts"] == before + 1
    assert torch.equal(gpu.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_weighted_windows_on_card_equal_cpu(cuda_device, phased):
    c = _port_chrom(50, 20000, 22)
    centro = _Centro(int(c.positions[5000]), int(c.positions[5100]))
    cpu = _weighted(c, centro, 60, False, phased, None)
    before = dict(cuda_lod.LAUNCHES)
    gpu = _weighted(c, centro, 60, False, phased, None, cuda_device)
    for k in ("pair_counts", "wlod_windows"):  # K5, K6: one launch each
        assert cuda_lod.LAUNCHES[k] == before[k] + 1
    assert torch.equal(gpu.blocks[(0, 0)].cpu(), cpu.blocks[(0, 0)])
    assert torch.equal(gpu.tie_scale.cpu(), cpu.tie_scale)


@pytest.mark.gpu
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_chunked_route_on_card_equals_one_chunk(cuda_device, phased,
                                                monkeypatch):
    """A device budget that splits the rows into chunks of 16 gives the
    one-chunk run's windows and tie scale; K6 runs once per chunk."""
    c = _port_chrom(40, 20000, 23)
    sub = np.arange(0, 40, 2)

    def run():
        before = cuda_lod.LAUNCHES["wlod_windows"]
        out = _weighted(c, _Centro(), 60, False, phased, sub, cuda_device)
        return out, cuda_lod.LAUNCHES["wlod_windows"] - before

    one, n1 = run()
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "2e7")
    chunked, n2 = run()
    assert (n1, n2) == (1, 3)  # 40 rows in chunks of 16
    assert torch.equal(one.blocks[(0, 0)], chunked.blocks[(0, 0)])
    assert torch.equal(one.tie_scale, chunked.tie_scale)


@pytest.mark.gpu
def test_pinned_weighted_run_on_card_matches_exact(wpanel, cuda_device):
    wd = wpanel
    args = _wbase(wd) + ["--weighted"] + WCUT
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, args + ["--tpu-engine", "fast",
                                       "--out", "wgpu"]) == 0
    for k in ("pair_counts", "wlod_windows"):  # K5, K6 per chromosome
        assert cuda_lod.LAUNCHES[k] == before[k] + 2
    assert _run(port_main, wd, args + ["--tpu-engine", "exact",
                                       "--out", "wgpux"]) == 0
    _same_outputs(wd, "wgpu", "wgpux")
