"""Parity of the port's automatic runs with garlic_tpu: the LOD cutoff
from the KDE (Phase II), the size bounds from the GMM (Phase IV), the
winsize searches (--auto-winsize, --winsize-multi), --auto-overlap-frac,
--kde-subsample and --freq-only; the exact Phase-II sampler, the device
Gauss transform and the device EM; and the port's pool cache with the
three faults of garlic_tpu/io/poolcache.py mended.

The port's fast engine runs here with device="cpu"; garlic_tpu runs its
exact engine and, on runs with one winsize, its fast engine on JAX-CPU.

Tolerances:
- the exact sampler's pool: array-equal (the same f64 code);
- the f32 Gauss transform against garlic_tpu's on JAX-CPU: rtol 1e-5
  (f32 sums in another order); against the f64 host transform: rtol
  5e-4, atol 1e-7 (tests/test_phase24.py:85);
- the .kde x column: byte-identical; the fast engine's y (f32 transform,
  printed with %g): max |dy| <= 1e-5 * max y of the exact engine's; the
  exact engines' y: byte-identical;
- the device EM against the host EM and garlic_tpu's 1x1-mesh EM: the
  same iteration count, the same %g .log lines, bounds within 1e-3;
- whole runs: .roh.bed byte-identical, .log identical after its first
  line, .freq.gz equal.
"""

from __future__ import annotations

import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from garlic_tpu import cli
from garlic_tpu.centromeres import Centromere
from garlic_tpu.core.fmt import g
from garlic_tpu.io import filters, tgls
from garlic_tpu.logger import RunLog
from garlic_tpu.ops import gmm as gt_gmm
from garlic_tpu.ops import kde as gt_kde
from garlic_tpu_torch import pipeline as port_pipeline
from garlic_tpu_torch.io import poolcache
from garlic_tpu_torch.io import tped as port_tped
from garlic_tpu_torch.ops import cuda_lod, gmm, kde
from garlic_tpu_torch.parallel import engine as port_engine
from garlic_tpu_torch.parallel.mesh import make_mesh
from garlic_tpu_torch.pipeline import run_main as port_main

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, write_tgls,  # noqa: E402
                  write_tped)

AUTO = ["--build", "hg18", "--error", "0.001"]
ONE = make_mesh(1, 1, ["cpu"])  # the fast engine's 1x1 mesh on the CPU
Y_TOL = 1e-5  # max |dy| / max y, fast engine against exact


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


def _mixture():
    """tests/test_phase24.py:243-247: a trimodal ROH length mixture of
    5,200 lengths (>= the 4096 gate)."""
    rng = np.random.default_rng(404)
    return np.concatenate([
        rng.normal(2.2e5, 5e4, 2500),
        rng.normal(8.5e5, 1.8e5, 1800),
        rng.normal(2.6e6, 6e5, 900)]).clip(1e4, None)


class _Log:
    """The .log lines select_size_classes writes, %g-formatted."""

    def __init__(self):
        self.lines = []

    def log(self, *a, nl=True):
        self.lines.append(" ".join(v if isinstance(v, str) else g(v)
                                   for v in a))


# ---------------------------------------------------------------------------
# The exact Phase-II sampler
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    """tests/test_torch_tgls.py's panel (30 x (4000, 3000), seed 23) with
    a GQ TGLS file."""
    wd = tmp_path_factory.mktemp("port_auto_small")
    panel = make_panel(nind=30, nloci_per_chr=(4000, 3000), seed=23)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    return str(wd)


def _chroms(wd, use_gl):
    ds, _ = port_tped.load_tped(f"{wd}/p.tped.gz")
    if use_gl:
        tgls.read_tgls(f"{wd}/GQ.tgls.gz", ds.chroms, ds.chroms[0].nind,
                       "GQ", None)
    chroms, _ = filters.filter_monomorphic(ds.chroms)
    return chroms


@pytest.mark.parametrize("use_gl", [False, True], ids=["plain", "gq"])
@pytest.mark.parametrize("rows", [None, [0, 3, 4, 17, 29]],
                         ids=["all", "subset"])
def test_exact_thinned_samples_equal_garlic_tpu(small_dir, use_gl, rows):
    from garlic_tpu.pipeline import _exact_thinned_samples as gt_sampler
    chroms = _chroms(small_dir, use_gl)
    centro = Centromere("hg18", cli.DEFAULT_CENTROMERE_FILE,
                        cli.DEFAULT_CENTROMERE_FILE, RunLog())
    args = (chroms, centro, 40, 0.001, 200000, use_gl, 40, rows)
    got = port_pipeline._exact_thinned_samples(*args)
    assert got.dtype == np.float64 and got.size > 100
    assert np.array_equal(got, gt_sampler(*args))


# ---------------------------------------------------------------------------
# The Gauss transform and the KDE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(20000, kde.BLOCK), (5003, 1000)])
def test_gauss_transform_matches_garlic_tpu(monkeypatch, n, block):
    """One block, and several with a ragged last block (the block size
    lowered so that the CPU temporaries stay small)."""
    monkeypatch.setattr(kde, "BLOCK", block)
    rng = np.random.default_rng(n)
    x = np.concatenate([rng.normal(-3, 1.0, n // 2),
                        rng.normal(2, 0.7, n - n // 2)])
    h, targets, _ = gt_kde._kde_grid(x)
    got = port_engine.gauss_transform_sharded(x, targets, h, ONE) * (1.0 / n)
    np.testing.assert_allclose(
        got, gt_kde.gauss_transform(x, targets, h, device=True), rtol=1e-5)
    np.testing.assert_allclose(
        got, gt_kde.gauss_transform(x, targets, h, device=False),
        rtol=5e-4, atol=1e-7)


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "device"])
def test_compute_kde_grid_is_garlic_tpus(device):
    """x bit for bit (garlic_tpu's _kde_grid), with and without the pool
    cache's replayed grid; y bit for bit on the host transform, rtol 1e-5
    against garlic_tpu's f32 transform on the device one."""
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(-4, 1, 12000), rng.normal(3, 2, 5000)])
    mesh = None if device is None else make_mesh(1, 1, [device])
    want = gt_kde.compute_kde(x, device=device is not None)
    got = kde.compute_kde(x, mesh=mesh)
    h, mn, mx = gt_kde.nrd0(x), float(x.min()), float(x.max())
    replay = kde.compute_kde(x, mesh=mesh, grid=poolcache.PoolEntry(
        None, x.size, h, mn, mx).grid())
    for kr in (got, replay):
        assert np.array_equal(kr.x, want.x)
        if device is None:
            assert np.array_equal(kr.y, want.y)
        else:
            np.testing.assert_allclose(kr.y, want.y, rtol=1e-5)


# ---------------------------------------------------------------------------
# The GMM
# ---------------------------------------------------------------------------

def _init(x, k=3):
    var, mean = float(np.var(x, ddof=1)), float(np.mean(x))
    return (np.full(k, 1.0 / k),
            np.array([mean * (n + 1) / (k + 1) for n in range(k)]),
            np.array([var * (n + 1) / k for n in range(k)]))


def test_fit_gmm_device_matches_host_and_sharded_em():
    """The port's fit_gmm_sharded on the 1x1 CPU mesh against the host
    EM and against garlic_tpu's fit_gmm_sharded on a 1x1 JAX-CPU mesh."""
    import jax
    from garlic_tpu.parallel.engine import fit_gmm_sharded
    from garlic_tpu.parallel.mesh import make_mesh
    x = _mixture()
    assert x.size >= 4096
    w0, mu0, var0 = _init(x)
    dev = port_engine.fit_gmm_sharded(x, 3, w0, mu0, var0, ONE)
    host = gt_gmm.fit_gmm(x, 3, w0, mu0, var0)
    mesh = make_mesh(n_dp=1, n_sp=1, devices=jax.devices()[:1])
    sharded = fit_gmm_sharded(x, 3, w0, mu0, var0, mesh)
    for ref in (host, sharded):
        assert dev.iterations == ref.iterations
        assert dev.converged == ref.converged
        for a, b in ((dev.weights, ref.weights), (dev.means, ref.means),
                     (dev.variances, ref.variances)):
            assert [g(v) for v in a] == [g(v) for v in b]
            np.testing.assert_allclose(a, b, rtol=1e-10)
        assert dev.loglikelihood == pytest.approx(ref.loglikelihood,
                                                  rel=1e-12)


@pytest.mark.parametrize("above", [True, False],
                         ids=["above_gate", "below_gate"])
def test_select_size_classes_log_lines_and_bounds(above):
    """Above the 4096 gate the port's fast engine fits on its device,
    below it on the host (then bit for bit garlic_tpu's); the logged
    lines are the same either way, the bounds within 1e-3."""
    x = _mixture() if above else _mixture()[::3]
    assert (x.size >= 4096) == above
    lh, lp = _Log(), _Log()
    b_host, r_host = gt_gmm.select_size_classes(x, 3, log=lh, device=False)
    b_port, r_port = gmm.select_size_classes(x, 3, log=lp, mesh=ONE)
    assert lp.lines == lh.lines and len(lh.lines) == 15
    assert r_port.iterations == r_host.iterations
    for bh, bp in zip(b_host, b_port):
        assert abs(bh - bp) <= 1e-3
    if not above:
        assert b_port == b_host


def test_fit_gmm_device_collapse_raises():
    x = np.full(50, 1000.0)  # zero variance (tests/test_phase24.py:191)
    with pytest.raises(FloatingPointError):
        port_engine.fit_gmm_sharded(x, 3, *_init(x), ONE)


# ---------------------------------------------------------------------------
# The pool cache, with garlic_tpu's three faults mended
# ---------------------------------------------------------------------------

class _C:
    """The fields pool_key reads."""

    def __init__(self, first_copy):
        self.chrom, self.geno2b_digest = "chr1", b"\x01" * 16
        self.positions = np.arange(10, dtype=np.int64)
        self.freq, self.gpos = np.linspace(0.1, 0.9, 10), np.zeros(10)
        self.first_copy = first_copy
        self.gl_codes = self.gl_lut = self.gl = None


class _NoCentro:
    def start(self, chrom):
        return -1

    def end(self, chrom):
        return -1


def test_pool_key_hashes_first_copy_when_phased():
    """Fault 1 (garlic_tpu/io/poolcache.py:54): a re-phased panel must not
    share its Phase-II pool key; unphased keys ignore first_copy."""
    from garlic_tpu.io.poolcache import pool_key as gt_pool_key
    a = [_C(np.zeros((4, 10), dtype=np.uint8))]
    b = [_C(np.ones((4, 10), dtype=np.uint8))]
    kw = dict(weighted=True, mu=0.5, M=10, phased=True)
    args = (40, 40, 0.001, 200000, False, _NoCentro())
    assert poolcache.pool_key(a, *args, **kw) != \
        poolcache.pool_key(b, *args, **kw)
    assert gt_pool_key(a, *args, **kw) == gt_pool_key(b, *args, **kw)
    assert poolcache.pool_key(a, *args) == poolcache.pool_key(b, *args)


def _cache(tmp_path):
    return poolcache.PoolCache(
        str(tmp_path / "p.tped.gz.gtpc"),
        lambda w, s: bytes([w % 256, s % 256]) * 8)


def test_pool_lookup_rejects_a_replaced_npy(tmp_path):
    """Fault 2 (:151): a .npy written behind a stored meta (another
    store's data, paired with this meta) is refused by its digest."""
    pc = _cache(tmp_path)
    pool = np.random.default_rng(1).normal(size=5000)
    pc.store(40, 40, pool)
    hit = pc.lookup(40, 40)
    assert hit is not None and np.array_equal(hit.pool, pool)
    npy = glob.glob(str(tmp_path / "*.p2pool.*.npy"))
    assert len(npy) == 1
    np.save(npy[0], pool[::-1].copy())
    assert pc.lookup(40, 40) is None


def test_pool_slots_per_winsize_with_a_cap(tmp_path):
    """Fault 3 (:109): each (winsize, step) keeps its own slot, so an
    auto-winsize search does not overwrite the previous candidate's pool;
    at most MAX_SLOTS slots stay, the oldest evicted."""
    pc = _cache(tmp_path)
    rng = np.random.default_rng(2)
    pools = {w: rng.normal(size=1000 + w) for w in (40, 60)}
    for w, p in pools.items():
        pc.store(w, w, p)
    for w, p in pools.items():
        hit = pc.lookup(w, w)
        assert hit is not None and np.array_equal(hit.pool, p)
        assert hit.grid()[3] == p.size
    for w in range(80, 80 + 20 * poolcache.MAX_SLOTS, 20):
        pc.store(w, w, rng.normal(size=500))
    assert len(glob.glob(str(tmp_path / "*.p2pool.*.json"))) == \
        poolcache.MAX_SLOTS
    assert len(glob.glob(str(tmp_path / "*.p2pool.*.npy"))) == \
        poolcache.MAX_SLOTS
    assert pc.lookup(40, 40) is None and pc.lookup(60, 60) is None


def test_pool_store_failure_is_not_a_run_failure(tmp_path):
    pc = poolcache.PoolCache(str(tmp_path / "missing_dir" / "p.gtpc"),
                             lambda w, s: b"k" * 16)
    pool = np.random.default_rng(3).normal(size=800)
    h, targets, spacing, n = pc.store(40, 40, pool)
    assert n == pool.size and np.array_equal(
        targets, gt_kde._kde_grid(pool)[1])
    assert pc.lookup(40, 40) is None


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def auto_dir(tmp_path_factory):
    """The verify recipe's panel (40 x (8000, 6000), seed 1: smaller
    panels give degenerate KDEs), with GQ and GL TGLS files."""
    wd = tmp_path_factory.mktemp("port_auto")
    panel = make_panel(nind=40, nloci_per_chr=(8000, 6000), seed=1)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    write_tgls(panel, str(wd / "GL.tgls.gz"), gl_type="GL")
    return str(wd)


def _base(wd, tped="p.tped.gz"):
    return ["--tped", f"{wd}/{tped}", "--tfam", f"{wd}/p.tfam"] + AUTO


def _kde_files(wd, out):
    return sorted(os.path.basename(p)[len(out):]
                  for p in glob.glob(f"{wd}/{out}.*SNPs.kde"))


def _same_kde(wd, out, ref, fast):
    """x byte-identical; y byte-identical between exact engines, within
    Y_TOL * max y for the fast engine's f32 transform."""
    sfx = _kde_files(wd, ref)
    assert sfx and _kde_files(wd, out) == sfx
    for s in sfx:
        a = [line.split() for line in read_text(f"{wd}/{ref}{s}").splitlines()]
        b = [line.split() for line in read_text(f"{wd}/{out}{s}").splitlines()]
        assert [r[0] for r in a] == [r[0] for r in b]
        ya = np.array([float(r[1]) for r in a])
        yb = np.array([float(r[1]) for r in b])
        if fast:
            assert np.abs(ya - yb).max() <= Y_TOL * ya.max()
        else:
            assert [r[1] for r in a] == [r[1] for r in b]


def _same_outputs(wd, out, ref, bed=True):
    if bed:
        assert read_text(f"{wd}/{out}.roh.bed") == \
            read_text(f"{wd}/{ref}.roh.bed")
        assert read_text(f"{wd}/{out}.freq.gz") == \
            read_text(f"{wd}/{ref}.freq.gz")
    assert diff_logs(read_text(f"{wd}/{ref}.log"),
                     read_text(f"{wd}/{out}.log"), ref, out) == []


@pytest.fixture
def split_routes(monkeypatch):
    """Counts the split path's Phase I (lod_windows_sharded) and the fused
    dispatch (covered_sharded) of the port's fast engine."""
    seen = {"split": 0, "fused": 0}

    def counting(name, fn):
        def f(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return f

    monkeypatch.setattr(port_engine, "lod_windows_sharded",
                        counting("split", port_engine.lod_windows_sharded))
    monkeypatch.setattr(port_engine, "covered_sharded",
                        counting("fused", port_engine.covered_sharded))
    return seen


def test_auto_run_matches_garlic_tpu(auto_dir, split_routes):
    """The reference's default run: no --lod-cutoff, no --size-bounds.
    The port's fast engine takes the fused route (K2's plain version on
    the CPU) for each chromosome, dispatched in assembly once Phase II
    has chosen the cutoff: no window matrix is made (garlic_tpu splits,
    as its Phase II pools the device windows)."""
    wd, base = auto_dir, _base(auto_dir) + ["--winsize", "60",
                                            "--kde-subsample", "0"]
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "jx"]) == 0
    assert _run(jax_main, wd, base + ["--tpu-engine", "fast",
                                      "--out", "jf"]) == 0
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "pf"], device="cpu") == 0
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    assert split_routes == {"split": 0, "fused": 2}
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", "px"]) == 0
    log = read_text(f"{wd}/jx.log")
    assert "Selected LOD score cutoff:" in log
    assert "Selected ROH size boundaries" in log
    assert read_text(f"{wd}/jx.roh.bed").count("\nchr") >= 10
    for out in ("pf", "px"):
        _same_outputs(wd, out, "jx")
        _same_outputs(wd, out, "jf")
    _same_kde(wd, "px", "jx", fast=False)
    _same_kde(wd, "pf", "jx", fast=True)
    _same_kde(wd, "pf", "jf", fast=True)


def test_auto_run_pool_cache_cold_and_warm(auto_dir, monkeypatch):
    """--tpu-panel-cache: the cold run stores the exact pool, the warm
    run reads it and never calls the sampler; both equal garlic_tpu."""
    wd = auto_dir
    shutil.copy(f"{wd}/p.tped.gz", f"{wd}/pc.tped.gz")
    base = _base(wd, "pc.tped.gz") + ["--winsize", "60", "--kde-subsample",
                                      "0", "--tpu-panel-cache"]
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "cjx"]) == 0
    calls = []
    sampler = port_pipeline._exact_thinned_samples_sharded

    def counting(*a, **k):
        calls.append(a[2])
        return sampler(*a, **k)

    monkeypatch.setattr(port_pipeline, "_exact_thinned_samples_sharded",
                        counting)
    for out, ncalls in (("cold", 1), ("warm", 1)):
        assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                           "--out", out], device="cpu") == 0
        assert len(calls) == ncalls  # the warm run adds no call
        _same_outputs(wd, out, "cjx")
        _same_kde(wd, out, "cjx", fast=True)
    assert glob.glob(f"{wd}/pc.tped.gz.gtpc.p2pool.*.npy")
    assert read_text(f"{wd}/warm.60SNPs.kde") == \
        read_text(f"{wd}/cold.60SNPs.kde")


@pytest.mark.parametrize("gl_type", ["GQ", "GL"])
def test_auto_run_with_tgls_matches_garlic_tpu(auto_dir, split_routes,
                                               gl_type):
    """--tgls on the automatic run: the exact sampler takes the f64 TGLS
    windows; the fast engine's Phase I takes the fused route (K4) on the
    GQ file's dictionary form, and on the GL file's float form the fused
    dispatch declines and the split path (K3) runs in its place."""
    wd = auto_dir
    base = _base(wd) + ["--winsize", "60", "--kde-subsample", "0",
                        "--tgls", f"{wd}/{gl_type}.tgls.gz", "--gl-type",
                        gl_type]
    tag = gl_type.lower()
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", f"{tag}_jx"]) == 0
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", f"{tag}_pf"],
                device="cpu") == 0
    assert split_routes == ({"split": 0, "fused": 2} if gl_type == "GQ"
                            else {"split": 2, "fused": 2})
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", f"{tag}_px"]) == 0
    for out, fast in ((f"{tag}_pf", True), (f"{tag}_px", False)):
        _same_outputs(wd, out, f"{tag}_jx")
        _same_kde(wd, out, f"{tag}_jx", fast=fast)


# winsize searches and options: garlic_tpu's exact engine is the
# reference (its fast engine's f32 transform moves the %g smoothness
# digits of the search's .log rows on this panel)
OPTION_RUNS = {
    "auto_winsize": ["--winsize", "20", "--auto-winsize",
                     "--auto-winsize-step", "20", "--kde-subsample", "0"],
    "multi_auto": ["--winsize-multi", "30", "50", "70", "--auto-winsize",
                   "--kde-subsample", "0"],
    "explore": ["--winsize-multi", "40", "60", "--kde-subsample", "0"],
    "overlap_frac": ["--winsize", "50", "--auto-overlap-frac",
                     "--kde-subsample", "0"],
    "kde_subsample": ["--winsize", "50", "--kde-subsample", "20",
                      "--tpu-seed", "3"],
    "search_subsample": ["--winsize", "20", "--auto-winsize",
                         "--auto-winsize-step", "20", "--kde-subsample",
                         "25", "--tpu-seed", "5"],
    # with --tgls the exact sampler sums the f64 TGLS windows
    "auto_winsize_gq": ["--winsize", "5", "--auto-winsize",
                        "--auto-winsize-step", "5", "--kde-subsample", "0",
                        "--tgls", "GQ.tgls.gz", "--gl-type", "GQ"],
    "multi_auto_gl": ["--winsize-multi", "30", "50", "70", "--auto-winsize",
                      "--kde-subsample", "0", "--tgls", "GL.tgls.gz",
                      "--gl-type", "GL"],
}


@pytest.mark.parametrize("name", list(OPTION_RUNS))
def test_option_runs_match_garlic_tpu(auto_dir, name):
    wd, base = auto_dir, _base(auto_dir) + OPTION_RUNS[name]
    ref = f"{name}_jx"
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", ref]) == 0
    for eng in ("fast", "exact"):
        out = f"{name}_p{eng[0]}"
        assert _run(port_main, wd, base + ["--tpu-engine", eng,
                                           "--out", out],
                    device="cpu") == 0
        _same_outputs(wd, out, ref, bed=name != "explore")
        _same_kde(wd, out, ref, fast=eng == "fast")
    log = read_text(f"{wd}/{ref}.log")
    if name == "explore":
        assert not os.path.exists(f"{wd}/{ref}.roh.bed")
        assert _kde_files(wd, ref) == [".40SNPs.kde", ".60SNPs.kde"]
    elif name == "overlap_frac":
        assert "Selected overlap fraction:" in log
    elif "subsample" in name:
        assert "Individuals used for KDE:" in log


def test_freq_only_matches_garlic_tpu(auto_dir):
    wd, base = auto_dir, _base(auto_dir) + ["--winsize", "60",
                                            "--freq-only"]
    assert _run(jax_main, wd, base + ["--out", "fo_j"]) == 0
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "fo_p"], device="cpu") == 0
    assert read_text(f"{wd}/fo_p.freq.gz") == read_text(f"{wd}/fo_j.freq.gz")
    _same_outputs(wd, "fo_p", "fo_j", bed=False)
    assert not os.path.exists(f"{wd}/fo_p.roh.bed")


def test_gmm_failure_exits_1_like_garlic_tpu(tmp_path):
    """Too few ROH for three classes: exit 1 and the same .error lines."""
    wd = str(tmp_path)
    panel = make_panel(nind=12, nloci_per_chr=(900, 700), seed=5)
    write_tped(panel, f"{wd}/t.tped.gz", f"{wd}/t.tfam")
    base = ["--tped", "t.tped.gz", "--tfam", "t.tfam", "--winsize", "30",
            "--kde-subsample", "0"] + AUTO
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "gj"]) == 1
    for eng in ("fast", "exact"):
        assert _run(port_main, wd, base + ["--tpu-engine", eng, "--out",
                                           f"gp{eng[0]}"], device="cpu") == 1
        err = read_text(f"{wd}/gp{eng[0]}.error")
        assert "ERROR: GMM size classification failed:" in err
        assert err == read_text(f"{wd}/gj.error")
        _same_outputs(wd, f"gp{eng[0]}", "gj", bed=False)


# ---------------------------------------------------------------------------
# On the card (skipped without CUDA)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return make_mesh(1, 1, ["cuda"])


@pytest.mark.gpu
def test_gauss_transform_on_card_matches_host(cuda_device):
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(-3, 1, 600_000), rng.normal(2, 1, 9)])
    h, targets, _ = gt_kde._kde_grid(x)
    np.testing.assert_allclose(
        port_engine.gauss_transform_sharded(x, targets, h, cuda_device)
        * (1.0 / x.size),
        gt_kde.gauss_transform(x, targets, h, device=False),
        rtol=5e-4, atol=1e-7)


@pytest.mark.gpu
def test_fit_gmm_device_on_card_matches_host(cuda_device):
    x = _mixture()
    w0, mu0, var0 = _init(x)
    dev = port_engine.fit_gmm_sharded(x, 3, w0, mu0, var0, cuda_device)
    host = gt_gmm.fit_gmm(x, 3, w0, mu0, var0)
    assert dev.iterations == host.iterations
    for a, b in ((dev.weights, host.weights), (dev.means, host.means),
                 (dev.variances, host.variances)):
        assert [g(v) for v in a] == [g(v) for v in b]


@pytest.mark.gpu
def test_auto_run_on_card_matches_exact(auto_dir, cuda_device):
    wd, base = auto_dir, _base(auto_dir) + ["--winsize", "60",
                                            "--kde-subsample", "0"]
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "gpu_auto"]) == 0
    assert cuda_lod.LAUNCHES["covered"] == before["covered"] + 2
    assert cuda_lod.LAUNCHES["lod_windows"] == before["lod_windows"]
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", "gpu_autox"]) == 0
    _same_outputs(wd, "gpu_auto", "gpu_autox")
    _same_kde(wd, "gpu_auto", "gpu_autox", fast=True)
