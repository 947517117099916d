"""The port's multi-device runs (garlic_tpu_torch/parallel/) against its
one-device runs (the 1x1 mesh) and against garlic_tpu's --tpu-mesh, case
by case as tests/test_parallel.py holds garlic_tpu's mesh to its single
chip.

On the CPU the port's meshes lie over ["cpu"] * 8 (the kernels' plain
versions per shard); garlic_tpu's over conftest's 8 virtual CPU devices.

Tolerances:
- the port's sharded windows, coverage planes, LD band and wLOD windows
  equal its 1x1 mesh's bit for bit (every window a fresh chain
  of f32 adds; int32 pair counts);
- its windows against garlic_tpu's sharded XLA windows: atol 1e-4 +
  rtol 1e-5 (f32 sums in another order);
- Gauss transforms: the port's sharded one within 1e-5 * max of its
  1x1 mesh's (block partials added in another order), and within
  rtol 2e-4 + atol 1e-7 of garlic_tpu's (the bound of
  tests/test_parallel.py); the GMM within rtol 1e-8 of the host EM;
- whole runs: .roh.bed, .freq.gz, .log after line 1, the .kde x column
  and --raw-lod text byte-identical to the port's one-device run;
  .kde y within 1e-5 * max y; against garlic_tpu's mesh run the same
  (the winsize searches against its exact engine, see SEARCHES), with
  --raw-lod values within atol 1e-4 + rtol 1e-5.

The gpu-marked tests run the same meshes over ["cuda:0"] * k on the card
and hold them to the 1x1 mesh's launches; garlic_tpu is imported only
inside the CPU-side tests.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, write_map_scaffold,  # noqa: E402
                  write_tgls, write_tped)

from garlic_tpu_torch.core.types import ChromData  # noqa: E402
from garlic_tpu_torch.ops import cuda_lod, gmm, kde  # noqa: E402
from garlic_tpu_torch.ops import device_win as dw  # noqa: E402
from garlic_tpu_torch.parallel import engine  # noqa: E402
from garlic_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from garlic_tpu_torch.pipeline import run_main as port_main  # noqa: E402

CPU8 = ["cpu"] * 8
ONE = make_mesh(1, 1, ["cpu"])  # one device: the 1x1 mesh
MESHES = [(8, 1), (1, 8), (2, 4), (4, 2)]
ERR, GAP = 0.001, 200000
Y_TOL = 1e-5


class _Centro:
    def __init__(self, s=10**18, e=10**18 + 1):
        self._s, self._e = s, e

    def start(self, c):
        return self._s

    def end(self, c):
        return self._e


def _arrays(I, L, seed, gap_at=None):
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.02] = -9
    steps = rng.integers(500, 3000, size=L)
    if gap_at is not None:
        steps[gap_at] = GAP + 1
    codes = rng.integers(0, 6, size=(I, L)).astype(np.uint8)
    lut = 10.0 ** -np.linspace(2, 5, 6)
    return dict(chrom="chr1", positions=np.cumsum(steps).astype(np.int64),
                gpos=np.cumsum(rng.random(L) * 0.01),
                locus_names=[f"r{i}" for i in range(L)],
                alleles=np.array(["A"] * L), genotypes=geno,
                freq=np.clip(rng.beta(0.8, 0.8, L), 0.02, 0.98),
                first_copy=rng.random((I, L)) < 0.5), codes, lut


def _chrom(I=12, L=200, seed=0, gap_at=97, gl=None):
    """A port chromosome; gl: None, "codes" (the TGLS dictionary form)
    or "float" (its f64 matrix form)."""
    a, codes, lut = _arrays(I, L, seed, gap_at)
    if gl == "codes":
        a.update(gl_codes=codes, gl_lut=lut)
    elif gl == "float":
        a.update(gl=lut[codes])
    return ChromData(**a)


def _gt_chrom(c):
    from garlic_tpu.core.types import ChromData as GtChromData
    return GtChromData(chrom=c.chrom, positions=c.positions, gpos=c.gpos,
                       locus_names=c.locus_names, alleles=c.alleles,
                       genotypes=c.genotypes, freq=c.freq,
                       first_copy=c.first_copy, gl=c.gl)


# ---------------------------------------------------------------------------
# Phase I: K1/K3 per shard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dp,n_sp", MESHES)
def test_lod_windows_sharded_matches_one_device_and_garlic_tpu(n_dp, n_sp):
    from garlic_tpu.parallel import lod_windows_sharded, make_mesh as jmesh
    c = _chrom()
    cen = _Centro()
    single = engine.lod_windows_sharded(c, cen, 8, ERR, GAP, ONE).to_numpy()
    sw = engine.lod_windows_sharded(c, cen, 8, ERR, GAP,
                                    make_mesh(n_dp, n_sp, CPU8))
    got = sw.to_numpy()
    np.testing.assert_array_equal(got, single)
    want = lod_windows_sharded(_gt_chrom(c), cen, 8, ERR, GAP,
                               jmesh(n_dp=n_dp, n_sp=n_sp)).to_numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    # the thinned pool of the API's Phase II, shard by shard
    for step in (1, 3, 8):
        np.testing.assert_array_equal(
            dw.thinned_block(sw, step),
            dw.thinned_block(engine.lod_windows_sharded(c, cen, 8, ERR, GAP,
                                                        ONE), step))


@pytest.mark.parametrize("form", ["codes", "float"])
def test_lod_windows_sharded_tgls_is_k3_per_shard(form):
    """use_gl: the error plane sharded like the genotypes, K3 per shard
    (both forms), equal to the 1x1 mesh's K3 windows and within the
    tolerance of garlic_tpu's sharded windows."""
    from garlic_tpu.parallel import lod_windows_sharded, make_mesh as jmesh
    c = _chrom(L=230, seed=4, gl=form)
    cen = _Centro()
    before = dict(cuda_lod.LAUNCHES)
    got = engine.lod_windows_sharded(c, cen, 10, ERR, GAP,
                                     make_mesh(2, 4, CPU8),
                                     use_gl=True).to_numpy()
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    np.testing.assert_array_equal(
        got, engine.lod_windows_sharded(c, cen, 10, ERR, GAP, ONE,
                                        use_gl=True).to_numpy())
    want = lod_windows_sharded(_gt_chrom(c), cen, 10, ERR, GAP,
                               jmesh(n_dp=2, n_sp=4),
                               use_gl=True).to_numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_check_halo_fits_error_text():
    from garlic_tpu.parallel.engine import check_halo_fits as gt_check
    for args in ((64, 9, 8), (64, 8, 8), (7, 6, 1)):
        msgs = []
        for fn in (engine.check_halo_fits, gt_check):
            try:
                fn(*args)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]
    assert msgs[0] is None
    with pytest.raises(ValueError, match="winsize-1 = 30 exceeds the "
                       "per-shard locus width 25"):
        engine.lod_windows_sharded(_chrom(), _Centro(), 31, ERR, GAP,
                                   make_mesh(1, 8, CPU8))


# ---------------------------------------------------------------------------
# Phase III: the fused route (K2/K4 per shard) and the split coverage
# ---------------------------------------------------------------------------

def _fetch(src, cutoff, W, thr, delta):
    packed, sus, (si, sw, side) = dw.covered_packed(src, cutoff, W, thr,
                                                    delta)
    return packed, sus, si, sw, side


def _same_fetch(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _edge_kinds(bits, edges):
    """Whether any row has a coverage transition exactly at a shard edge
    ("on"), a covered run across one ("straddle"), and an uncovered
    locus pair across one ("off")."""
    kinds = set()
    for e in edges:
        left, right = bits[:, e - 1], bits[:, e]
        kinds |= {"on"} if (left != right).any() else set()
        kinds |= {"straddle"} if (left & right).any() else set()
        kinds |= {"off"} if (~left & ~right).any() else set()
    return kinds


@pytest.mark.parametrize("n_dp,n_sp,L,gl", [
    (1, 4, 200, None), (2, 4, 203, None), (4, 2, 157, None),
    (1, 8, 200, None), (2, 4, 203, "codes")])
def test_fused_route_pieces_match_one_device(n_dp, n_sp, L, gl):
    """K2 (K4 on the dictionary form) per shard on its halo-extended
    block, stitched in locus order, gives the 1x1 mesh's packed rows,
    suspect rows and suspect windows, with shard edges on, off and
    inside covered runs; so does the split coverage of the sharded
    DeviceWin."""
    W, thr, delta = 8, 3.0, 0.05
    c = _chrom(I=24, L=L, seed=7, gl=gl)
    cen = _Centro()
    mesh = make_mesh(n_dp, n_sp, CPU8)
    use_gl = gl is not None
    win = engine.lod_windows_sharded(c, cen, W, ERR, GAP, ONE, use_gl)
    live = win.to_numpy()[:, :win.nwin]
    cutoff = float(np.median(live[live > -9999]))
    one = _fetch(dw.FusedCov(c, cen, W, ERR, GAP, ONE, use_gl), cutoff,
                 W, thr, delta)
    fused = _fetch(dw.FusedCov(c, cen, W, ERR, GAP, mesh, use_gl), cutoff,
                   W, thr, delta)
    _same_fetch(fused, one)
    split = _fetch(engine.lod_windows_sharded(c, cen, W, ERR, GAP, mesh,
                                              use_gl), cutoff, W, thr, delta)
    _same_fetch(split, one)
    assert one[1].any()  # the tie band flags suspects
    bits = np.unpackbits(one[0], axis=1, bitorder="little")[:, :L] > 0
    per = -(-L // n_sp)
    edges = [e for e in range(per, L, per)]
    assert _edge_kinds(bits, edges) == {"on", "off", "straddle"}


def test_gate_sizes_each_device_by_its_shards():
    """The streaming gate's mesh holdings: each device holds the shards
    laid on it (a device listed twice counts both); on the split route
    the shards' f32 windows add up to the chromosome's, on the fused one
    the u8 planes of each shard's halo-extended block."""
    from garlic_tpu_torch import pipeline
    c, W = _chrom(I=10, L=400, seed=5), 20
    cpu, meta = torch.device("cpu"), torch.device("meta")
    mesh = make_mesh(2, 2, ["cpu", "meta", "cpu", "meta"])
    split = engine.shard_holdings(c, W, False, mesh)
    assert set(split) == {cpu, meta}
    assert sum(split.values()) == engine.shard_holdings(c, W, False,
                                                        ONE)[cpu]
    fused = engine.shard_holdings(c, W, True, mesh)
    for dev, s in ((cpu, 0), (meta, 1)):
        want = 0.0
        for sh in engine.shard_blocks(c.nind, c.nloci, mesh, W):
            if sh.s == s:
                a, b = sh.block(W, W - 1, c.nloci)
                want += sh.rows * ((b - a) + 2 * (b - a - W + 1))
        assert fused[dev] == want
    assert sum(fused.values()) > engine.shard_holdings(c, W, True, ONE)[cpu]
    held = pipeline._device_holdings([c, c], W, False, True, mesh)
    assert held == {d: 2 * v for d, v in fused.items()}


def test_streamed_fused_mesh_matches_one_device():
    """A streamed FusedCov on a mesh (no pre-enqueue) and its make(), the
    split DeviceWin of its shards, give the 1x1 mesh's coverage."""
    c = _chrom(I=10, L=180, seed=9)
    cen, W = _Centro(), 6
    mesh = make_mesh(4, 2, CPU8)
    one = _fetch(dw.FusedCov(c, cen, W, ERR, GAP, ONE), 0.4, W, 2.0, 0.0)
    fc = dw.FusedCov(c, cen, W, ERR, GAP, mesh, stream=True)
    _same_fetch(_fetch(fc, 0.4, W, 2.0, 0.0), one)
    assert len(fc.make().blocks) == 8
    _same_fetch(_fetch(fc.make(), 0.4, W, 2.0, 0.0), one)


# ---------------------------------------------------------------------------
# Phase II and Phase IV reductions
# ---------------------------------------------------------------------------

def test_gauss_transform_sharded_matches():
    from garlic_tpu.parallel import gauss_transform_sharded as gt_gauss
    from garlic_tpu.parallel import make_mesh as jmesh
    rng = np.random.default_rng(7)
    src = rng.standard_normal(5000) * 1.7 + 0.4
    tgt = np.linspace(-4.0, 5.0, 512)
    h = 0.21
    got = engine.gauss_transform_sharded(src, tgt, h,
                                         make_mesh(4, 2, CPU8)) / 5000
    one = engine.gauss_transform_sharded(src, tgt, h, ONE) / 5000
    assert np.abs(got - one).max() <= Y_TOL * one.max()
    want = gt_gauss(src, tgt, h, jmesh(n_dp=4, n_sp=2)) / 5000
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-7)


def test_compute_kde_mesh_matches():
    from garlic_tpu.ops import kde as gt_kde
    from garlic_tpu.parallel import make_mesh as jmesh
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.standard_normal(4000) - 2.0,
                        rng.standard_normal(2000) * 0.5 + 2.5])
    got = kde.compute_kde(x, mesh=make_mesh(2, 4, CPU8))
    one = kde.compute_kde(x, mesh=ONE)
    want = gt_kde.compute_kde(x, mesh=jmesh(n_dp=2, n_sp=4))
    for ref in (one, want):
        np.testing.assert_array_equal(got.x, ref.x)
        assert np.abs(got.y - ref.y).max() <= Y_TOL * ref.y.max()


def _lengths(seed, sizes):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.normal(4.5e5, 8e4, sizes[0]), rng.normal(1.2e6, 2e5, sizes[1]),
        rng.normal(3.0e6, 5e5, sizes[2])]).clip(1e4, None)


def test_fit_gmm_sharded_matches_host_and_garlic_tpu(monkeypatch):
    """The Phase-IV reduction reproduces the host f64 EM and garlic_tpu's
    sharded EM; the host EM is made to raise, so the mesh fit cannot
    fall back to it."""
    from garlic_tpu.parallel import fit_gmm_sharded as gt_fit
    from garlic_tpu.parallel import make_mesh as jmesh
    x = _lengths(13, (3000, 1500, 500))
    k = 3
    var, mean = float(np.var(x, ddof=1)), float(np.mean(x))
    w0 = np.full(k, 1.0 / k)
    mu0 = np.array([mean * (n + 1) / (k + 1) for n in range(k)])
    var0 = np.array([var * (n + 1) / k for n in range(k)])
    host = gmm.fit_gmm(x, k, w0, mu0, var0)
    want = gt_fit(x, k, w0, mu0, var0, jmesh(n_dp=4, n_sp=2))

    def _no_fallback(*a, **kw):
        raise AssertionError("the mesh EM ran the host EM")

    monkeypatch.setattr(gmm, "fit_gmm", _no_fallback)
    got = engine.fit_gmm_sharded(x, k, w0, mu0, var0, make_mesh(4, 2, CPU8))
    for ref in (host, want):
        for f in ("weights", "means", "variances"):
            np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                       rtol=1e-8)
        assert got.converged == ref.converged
        assert abs(got.iterations - ref.iterations) <= 1
        np.testing.assert_allclose(got.loglikelihood, ref.loglikelihood,
                                   rtol=1e-10)
    with pytest.raises(FloatingPointError, match="collapsed"):
        engine.fit_gmm_sharded(np.full(64, 5e5), k, w0, np.full(k, 5e5),
                               np.zeros(k), make_mesh(2, 4, CPU8))


def test_select_size_classes_mesh_matches():
    from garlic_tpu.ops import gmm as gt_gmm
    from garlic_tpu.parallel import make_mesh as jmesh
    x = _lengths(17, (2000, 800, 300))
    got, _ = gmm.select_size_classes(x, 3, mesh=make_mesh(8, 1, CPU8))
    host, _ = gmm.select_size_classes(x, 3)
    want, _ = gt_gmm.select_size_classes(x, 3, mesh=jmesh(n_dp=8, n_sp=1))
    np.testing.assert_allclose(got, host, rtol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-7)


# ---------------------------------------------------------------------------
# The weighted path
# ---------------------------------------------------------------------------

def _full_band(bands, mesh):
    return torch.cat([bands[(0, s)] for s in range(mesh.shape["sp"])])


@pytest.mark.parametrize("n_dp,n_sp", [(2, 4), (4, 2), (1, 8)])
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("sub", [None, "sub"])
def test_ld_band_sharded_equals_one_device(n_dp, n_sp, phased, sub):
    c = _chrom(I=14, L=260, seed=51)
    sub_idx = None if sub is None else np.array([0, 2, 3, 7, 8, 11, 13])
    W = 10
    mesh = make_mesh(n_dp, n_sp, CPU8)
    bands = engine.ld_band_sharded(c, W, phased, sub_idx, mesh)
    want = engine.ld_band_sharded(c, W, phased, sub_idx, ONE)[(0, 0)]
    got = _full_band(bands, mesh)
    assert got.shape == want.shape
    assert torch.equal(got, want)
    for (d, s), b in bands.items():
        assert torch.equal(b, bands[(0, s)])


@pytest.mark.parametrize("use_gl", [False, True], ids=["scalar", "tgls"])
def test_wlod_windows_sharded_equals_one_device(use_gl):
    c = _chrom(I=14, L=260, seed=3, gl="float" if use_gl else None)
    cen, W, mu, M = _Centro(), 10, 1e-9, 7
    mesh = make_mesh(2, 4, CPU8)
    bands = engine.ld_band_sharded(c, W, False, None, mesh)
    got = engine.wlod_windows_sharded(c, cen, bands, W, ERR, GAP, use_gl,
                                      mu, M, mesh)
    want = engine.wlod_windows_sharded(
        c, cen, engine.ld_band_sharded(c, W, False, None, ONE), W, ERR, GAP,
        use_gl, mu, M, ONE)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    assert torch.equal(got.tie_scale, want.tie_scale)
    _same_fetch(_fetch(got, 0.3, W, 3.0, 0.01),
                _fetch(want, 0.3, W, 3.0, 0.01))


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

PINNED = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
          "--lod-cutoff", "1.2", "--size-bounds", "300000", "800000",
          "--kde-subsample", "0"]


@pytest.fixture(scope="module")
def mesh_dir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("port_mesh")
    _write_pinned_panel(str(wd))
    a = make_panel(nind=40, nloci_per_chr=(8000, 6000), seed=1)
    write_tped(a, str(wd / "a.tped.gz"), str(wd / "a.tfam"))
    return str(wd)


def _write_pinned_panel(wd):
    """22 x (3000, 2000) with planted ROH at 1.5 times make_panel's rate
    (15 calls pinned, 84 weighted), its GQ and GL TGLS files and a map."""
    p = make_panel(nind=22, nloci_per_chr=(3000, 2000), seed=13,
                   roh_rate=1.5)
    write_tped(p, f"{wd}/p.tped.gz", f"{wd}/p.tfam")
    write_tgls(p, f"{wd}/GQ.tgls.gz", gl_type="GQ")
    write_tgls(p, f"{wd}/GL.tgls.gz", gl_type="GL")
    write_map_scaffold(p, f"{wd}/p.map.gz")


def _inputs(wd, panel):
    return ["--tped", f"{wd}/{panel}.tped.gz", "--tfam",
            f"{wd}/{panel}.tfam"]


RUNS = {
    "pinned": ("p", PINNED),
    "raw_lod": ("p", PINNED + ["--raw-lod"]),
    "gq": ("p", PINNED + ["--tgls", "GQ.tgls.gz", "--gl-type", "GQ"]),
    "gl": ("p", PINNED + ["--tgls", "GL.tgls.gz", "--gl-type", "GL"]),
    # 0.1: the weighted windows' scale (tests/test_torch_wlod.py)
    "weighted": ("p", ["--build", "hg18", "--map", "p.map.gz", "--weighted",
                       "--winsize", "30", "--error", "0.001", "--lod-cutoff",
                       "0.1", "--kde-subsample", "0", "--size-bounds",
                       "300000", "800000"]),
    "phased_ldsub": ("p", ["--build", "hg18", "--map", "p.map.gz",
                           "--weighted", "--phased", "--winsize", "30",
                           "--error", "0.001", "--lod-cutoff", "0.1",
                           "--kde-subsample", "0", "--ld-subsample", "10",
                           "--tpu-seed", "5", "--size-bounds", "300000",
                           "800000"]),
    "auto": ("a", ["--build", "hg18", "--winsize", "60", "--error", "0.001",
                   "--kde-subsample", "0"]),
    "auto_winsize": ("a", ["--build", "hg18", "--winsize", "20",
                           "--auto-winsize", "--auto-winsize-step", "20",
                           "--error", "0.001", "--kde-subsample", "0"]),
    "winsize_multi": ("a", ["--build", "hg18", "--winsize-multi", "30", "50",
                            "70", "--auto-winsize", "--error", "0.001",
                            "--kde-subsample", "0"]),
}
# the winsize searches' garlic_tpu reference is its exact engine, which
# ignores --tpu-mesh: its fast engine's f32 transform moves the %g
# smoothness digits of the search's .log rows on this panel (as in
# tests/test_torch_auto.py), and the port's mesh keeps its own
# 1x1 mesh's transform digits
SEARCHES = ("auto_winsize", "winsize_multi")


def _argv(wd, name):
    panel, flags = RUNS[name]
    return _inputs(wd, panel) + [f if not f.endswith((".tgls.gz", ".map.gz"))
                                 else f"{wd}/{f}" for f in flags]


def _run(main, wd, argv, **kw):
    old = os.getcwd()
    os.chdir(wd)
    try:
        return main(argv, prog="garlic", **kw)
    finally:
        os.chdir(old)


def _kde(wd, out):
    path = [f for f in os.listdir(wd) if f.startswith(out + ".")
            and f.endswith(".kde")]
    assert len(path) == 1, path
    x, y = np.loadtxt(os.path.join(wd, path[0]), unpack=True)
    text = read_text(os.path.join(wd, path[0]))
    return [line.split()[0] for line in text.splitlines()], y


def _raw(wd, out):
    return {c: read_text(f"{wd}/{out}.POP1.{c}.raw.lod.windows.gz")
            for c in ("chr1", "chr2")}


def _same_run(wd, out, ref, raw_exact=True):
    assert read_text(f"{wd}/{out}.roh.bed") == read_text(f"{wd}/{ref}.roh.bed")
    assert read_text(f"{wd}/{out}.freq.gz") == \
        read_text(f"{wd}/{ref}.freq.gz")
    assert diff_logs(read_text(f"{wd}/{ref}.log"),
                     read_text(f"{wd}/{out}.log"), ref, out) == []
    if os.path.exists(f"{wd}/{ref}.POP1.chr1.raw.lod.windows.gz"):
        a, b = _raw(wd, out), _raw(wd, ref)
        for c in a:
            if raw_exact:
                assert a[c] == b[c]
            else:
                va = np.array(a[c].replace("NA", "nan").split(), dtype=float)
                vb = np.array(b[c].replace("NA", "nan").split(), dtype=float)
                np.testing.assert_array_equal(np.isnan(va), np.isnan(vb))
                live = ~np.isnan(vb)
                np.testing.assert_allclose(va[live], vb[live], atol=1e-4,
                                           rtol=1e-5)
    if any(f.startswith(ref + ".") and f.endswith(".kde")
           for f in os.listdir(wd)):
        xa, ya = _kde(wd, out)
        xb, yb = _kde(wd, ref)
        assert xa == xb
        assert np.abs(ya - yb).max() <= Y_TOL * yb.max()


@pytest.mark.parametrize("name,spec", [
    ("pinned", "4x2"), ("pinned", "8x1"), ("pinned", "2x4"),
    ("auto", "4x2"), ("gq", "2x4"), ("gl", "2x4"), ("weighted", "4x2"),
    ("weighted", "2x4"), ("phased_ldsub", "4x2"), ("raw_lod", "4x2"),
    ("pinned", "auto"), ("auto_winsize", "2x4"), ("winsize_multi", "4x2")])
def test_mesh_run_matches_one_device_and_garlic_tpu(mesh_dir, name, spec):
    wd, argv = mesh_dir, _argv(mesh_dir, name)
    tag = f"{name}_{spec}"
    if not os.path.exists(f"{wd}/{name}_dev1.roh.bed"):
        assert _run(port_main, wd, argv + ["--tpu-engine", "fast", "--out",
                                           f"{name}_dev1"],
                    device="cpu") == 0
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, argv + ["--tpu-engine", "fast", "--tpu-mesh",
                                       spec, "--out", f"p{tag}"],
                device=CPU8) == 0
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    from garlic_tpu.pipeline import run_main as jax_main
    jeng = "exact" if name in SEARCHES else "fast"
    assert _run(jax_main, wd, argv + ["--tpu-engine", jeng, "--tpu-mesh",
                                      spec, "--out", f"j{tag}"]) == 0
    assert read_text(f"{wd}/{name}_dev1.roh.bed").count("\nchr") >= 5
    _same_run(wd, f"p{tag}", f"{name}_dev1")
    _same_run(wd, f"p{tag}", f"j{tag}", raw_exact=False)


@pytest.mark.parametrize("name", ["pinned", "raw_lod", "gq"])
def test_streaming_mesh_run_matches_resident(mesh_dir, monkeypatch, capsys,
                                             name):
    """GARLIC_TPU_HBM_BUDGET=1000: every device's shards exceed half the
    budget, so Phase I streams (fused FusedCov entries dispatched in
    assembly, the split DeviceWin made by a LazyWin thunk) and gives the
    resident one-device and garlic_tpu mesh runs' outputs."""
    wd, argv = mesh_dir, _argv(mesh_dir, name)
    assert _run(port_main, wd, argv + ["--tpu-engine", "fast", "--out",
                                       f"s{name}_dev1"], device="cpu") == 0
    from garlic_tpu.pipeline import run_main as jax_main
    assert _run(jax_main, wd, argv + ["--tpu-engine", "fast", "--tpu-mesh",
                                      "4x2", "--out", f"s{name}_j"]) == 0
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "1000")
    capsys.readouterr()
    assert _run(port_main, wd, argv + ["--tpu-engine", "fast", "--tpu-mesh",
                                       "4x2", "--out", f"s{name}_p"],
                device=CPU8) == 0
    assert "streaming per chromosome" in capsys.readouterr().err
    _same_run(wd, f"s{name}_p", f"s{name}_dev1")
    _same_run(wd, f"s{name}_p", f"s{name}_j", raw_exact=False)


def test_call_roh_mesh_matches(mesh_dir):
    """call_roh(mesh=...): K1 per shard, the automatic cutoff from the
    sharded windows' thinned pool; pinned calls equal the one-device
    and garlic_tpu mesh calls, automatic ones pick the same grid point."""
    from garlic_tpu import api as gt_api
    from garlic_tpu.parallel import make_mesh as jmesh
    from garlic_tpu_torch import api
    args = (f"{mesh_dir}/a.tped.gz", f"{mesh_dir}/a.tfam")
    ds = api.load_panel(*args, build="hg18")
    gds = gt_api.load_panel(*args, build="hg18")
    mesh = make_mesh(2, 4, CPU8)
    kw = dict(winsize=60, cutoff=1.3, bounds=[300000.0, 800000.0],
              engine="fast")
    got = api.call_roh(ds, mesh=mesh, **kw)
    one = api.call_roh(ds, device="cpu", **kw)
    assert len(got.to_rows()) >= 10
    assert got.to_rows() == one.to_rows()
    auto = api.call_roh(ds, winsize=60, engine="fast", mesh=mesh)
    auto_one = api.call_roh(ds, winsize=60, engine="fast", device="cpu")
    want = gt_api.call_roh(gds, winsize=60, engine="fast",
                           mesh=jmesh(n_dp=2, n_sp=4))
    # the same f32 windows as one device: the same pool and grid; against
    # garlic_tpu's XLA windows, as tests/test_torch_api.py holds them
    np.testing.assert_array_equal(auto.kde.x, auto_one.kde.x)
    for ref in (auto_one, want):
        assert np.abs(auto.kde.y - ref.kde.y).max() <= \
            Y_TOL * ref.kde.y.max()
        assert np.flatnonzero(auto.kde.x == auto.cutoff).tolist() == \
            np.flatnonzero(ref.kde.x == ref.cutoff).tolist()
    assert auto.to_rows() == auto_one.to_rows()


# ---------------------------------------------------------------------------
# On the card: the same meshes over one device, listed k times
# ---------------------------------------------------------------------------

CARD_MESHES = [(2, 1), (1, 2), (2, 2)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return ["cuda:0"] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("n_dp,n_sp", CARD_MESHES)
def test_kernels_per_shard_on_card(n_dp, n_sp):
    """K1, K3 and the fused K2/K4 per shard on the card equal the 1x1
    mesh's launches: windows bit for bit, coverage exactly."""
    devs = _card()
    mesh, one_card = make_mesh(n_dp, n_sp, devs), make_mesh(1, 1, devs)
    cen, W = _Centro(), 60
    for gl in (None, "codes"):
        c = _chrom(I=40, L=5000, seed=2, gl=gl)
        use_gl = gl is not None
        one = engine.lod_windows_sharded(c, cen, W, ERR, GAP, one_card,
                                         use_gl)
        before = dict(cuda_lod.LAUNCHES)
        sw = engine.lod_windows_sharded(c, cen, W, ERR, GAP, mesh, use_gl)
        key = "window_sums" if use_gl else "lod_windows"
        assert cuda_lod.LAUNCHES[key] == before[key] + n_dp * n_sp
        np.testing.assert_array_equal(sw.to_numpy(), one.to_numpy())
        cut = float(np.median(one.blocks[(0, 0)].cpu().numpy()))
        want = _fetch(dw.FusedCov(c, cen, W, ERR, GAP, one_card, use_gl),
                      cut, W, 15.0, 0.01)
        _same_fetch(_fetch(dw.FusedCov(c, cen, W, ERR, GAP, mesh, use_gl),
                           cut, W, 15.0, 0.01), want)
        _same_fetch(_fetch(sw, cut, W, 15.0, 0.01), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["pinned", "weighted"])
def test_mesh_run_on_card_matches_one_device(tmp_path, name):
    devs = _card()
    wd = str(tmp_path)
    _write_pinned_panel(wd)
    argv = _argv(wd, name) + ["--tpu-engine", "fast"]
    assert _run(port_main, wd, argv + ["--out", "dev1"],
                device="cuda:0") == 0
    for n_dp, n_sp in CARD_MESHES:
        out = f"m{n_dp}x{n_sp}"
        assert _run(port_main, wd, argv + ["--tpu-mesh", f"{n_dp}x{n_sp}",
                                           "--out", out],
                    device=devs[:n_dp * n_sp]) == 0
        _same_run(wd, out, "dev1")
