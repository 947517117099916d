"""Parity of the port's TGLS path (--tgls: per-genotype error in place of
--error) with garlic_tpu: the term plane (cuda_lod.gl_terms_f32 and
chrom_gl_inputs against pallas_lod._gl_terms), the plain versions of
kernels K3 and K4 against the Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them, and whole runs of both packages.

Tolerances: the term planes differ from XLA's only in log10's last ulp
(rtol 1e-6).  On the same f32 plane the plain K3 sums equal the Pallas
kernel's bit for bit for W <= 64 (both chain W f32 adds left to right
from 0); for W > 64 the Pallas kernel takes a block prefix-sum
difference instead, held to atol 1e-3 as in test_pallas_large_winsize.
K4's planes are exact.  Whole runs: .roh.bed byte-identical, .log
identical after its first line, .freq.gz equal; --raw-lod values within
atol 1e-4 + rtol 1e-5 (f32 sums printed with %g)."""

from __future__ import annotations

import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from garlic_tpu.core.types import MISSING, ChromData
from garlic_tpu.io.tgls import convert_gl
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.parallel import engine as port_engine
from garlic_tpu_torch.ops.lod import window_missing_mask
from garlic_tpu_torch.pipeline import run_main as port_main

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, write_tgls,  # noqa: E402
                  write_tped)

# the JAX package's modules are imported inside the tests that run them,
# so the gpu tests collect where JAX is absent (pytest --noconftest -m gpu)
_COL = 128  # pallas_lod._COL_TILE
_BL = 128  # Pallas window-start block: small grids keep interpret mode fast
GQ_LUT = convert_gl(np.arange(20, 60), "GQ")  # write_tgls' GQ values
PINNED = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
          "--kde-subsample", "0", "--lod-cutoff", "1.3", "--size-bounds",
          "300000", "800000"]


def _cdiv(a, b):
    return -(-a // b)


class _Centro:
    def __init__(self, start, end):
        self._s, self._e = start, end

    def start(self, chrom):
        return self._s

    def end(self, chrom):
        return self._e


def _chrom(I, L, W, seed, form):
    """A TGLS chromosome (dictionary or float error plane), its
    centromere, and the f32 error plane the kernels see."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.03] = -9
    freq = np.clip(rng.beta(0.8, 0.8, L), 0.02, 0.98)
    freq[::53] = 0.0  # monomorphic sites score 0
    pos = np.cumsum(rng.integers(100, 4000, L)).astype(np.int64)
    c = ChromData(chrom="chr1", positions=pos, gpos=np.zeros(L),
                  locus_names=[f"rs{i}" for i in range(L)],
                  alleles=np.array(["A"] * L), genotypes=geno, freq=freq)
    if form == "dict":
        c.gl_codes = rng.integers(0, GQ_LUT.size, (I, L)).astype(np.uint8)
        c.gl_lut = GQ_LUT
        err = GQ_LUT.astype(np.float32)[c.gl_codes]
    else:
        c.gl = np.clip(rng.random((I, L)), 1e-6, 0.99)
        err = c.gl.astype(np.float32)
    # a centromere masks some windows, where that leaves others live
    c0 = L // 3 if L >= 4 * W else L - 1
    centro = _Centro(int(pos[c0]) + 1, int(pos[min(c0 + 5, L - 1)]) + 1)
    return c, centro, err


def _inputs(I, L, W, seed, form="dict"):
    c, centro, _ = _chrom(I, L, W, seed, form)
    terms, miss = cuda_lod.chrom_gl_inputs(c, centro, W, 100000, "cpu")
    assert not miss.bool().all()
    return terms, miss


@pytest.mark.parametrize("form", ["dict", "float"])
def test_gl_inputs_match_jax_gl_terms(form):
    """chrom_gl_inputs (upload, lut gather or f32 cast, gl_terms_f32)
    against pallas_lod._gl_terms on the same genotypes, f32 freq and f32
    error plane."""
    import jax.numpy as jnp
    from garlic_tpu.ops import pallas_lod
    c, centro, err = _chrom(11, 900, 30, seed=7, form=form)
    terms, miss = cuda_lod.chrom_gl_inputs(c, centro, 30, 100000, "cpu")
    want = np.asarray(pallas_lod._gl_terms(
        jnp.asarray(c.genotypes.astype(np.int32)),
        jnp.asarray(c.freq.astype(np.float32)), jnp.asarray(err)))
    got = terms.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(
        miss.numpy(), window_missing_mask(c.positions, 30, 100000,
                                          centro.start("chr1"),
                                          centro.end("chr1")))


def _jax_k3(a, W):
    """Raw window sums [I, nwin] from the Pallas K3 in interpret mode.
    At W=1 its halo copy has width 0, which Pallas refuses (the CLI
    takes W >= 2, as in tests/test_torch_kernels.py), so W=1 runs the
    kernel's body, _window_sum_block, on the plane itself."""
    import jax.numpy as jnp
    from garlic_tpu.ops import pallas_lod
    I, L = a.shape
    nwin = L - W + 1
    if W == 1:
        return np.asarray(pallas_lod._window_sum_block(jnp.asarray(a), I,
                                                       nwin, W))
    HW = _cdiv(W - 1, _COL) * _COL
    NW2 = _cdiv(nwin, _BL) * _BL
    ap = np.zeros((_cdiv(I, 32) * 32, NW2 + HW), np.float32)
    ap[:I, :L] = a
    out = pallas_lod._window_sums_pallas_padded(jnp.asarray(ap), W, 32, _BL,
                                                interpret=True)
    return np.asarray(out)[:I, :nwin]


def _jax_k4(a, miss, W, cutoff, thr, delta):
    """(covered [I, L], susw, above [I, nwin]) from the Pallas K4."""
    import jax.numpy as jnp
    from garlic_tpu.ops import pallas_lod
    I, L = a.shape
    nwin = L - W + 1
    HW = _cdiv(W - 1, _COL) * _COL
    NW2 = _cdiv(L, _BL) * _BL  # coverage needs nwin + W - 1
    ap = np.zeros((_cdiv(I, 32) * 32, 2 * HW + NW2), np.float32)
    ap[:I, HW:HW + L] = a  # zero left halo
    mp = np.ones((8, HW + NW2), np.int8)
    mp[:, HW:HW + nwin] = miss
    scal = np.zeros((8, 128), np.float32)
    scal[0], scal[1], scal[2] = cutoff, math.ceil(thr), delta
    cov, susw, above = pallas_lod._covered_terms_pallas_padded(
        jnp.asarray(ap), jnp.asarray(mp), jnp.asarray(scal), W, 32, _BL,
        interpret=True)
    return (np.asarray(cov)[:I, :L], np.asarray(susw)[:I, :nwin],
            np.asarray(above)[:I, :nwin])


@pytest.mark.parametrize("W", [1, 7, 19, 64])
def test_k3_plain_bitwise_equals_pallas(W):
    terms, miss = _inputs(9, 700, W, seed=W)
    want = _jax_k3(terms.numpy(), W)
    want = np.where(miss.numpy()[None, :] != 0, np.float32(MISSING), want)
    got = cuda_lod.window_sums_plain(terms, miss, W).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("W", [65, 120])
def test_k3_plain_matches_pallas_large_winsize(W):
    terms, miss = _inputs(7, 1200, W, seed=W, form="float")
    want = _jax_k3(terms.numpy(), W)
    got = cuda_lod.window_sums_plain(terms, miss, W).numpy()
    live = miss.numpy() == 0
    np.testing.assert_array_equal(got[:, ~live], np.float32(MISSING))
    np.testing.assert_allclose(got[:, live], want[:, live], atol=1e-3)


@pytest.mark.parametrize("W", [2, 7, 19, 64])
def test_k4_plain_planes_equal_pallas(W):
    terms, miss = _inputs(9, 700, W, seed=100 + W)
    live = miss.numpy() == 0
    cutoff = float(np.median(_jax_k3(terms.numpy(), W)[:, live]))
    thr, delta = float(max(1, W // 4)), 0.05
    want = _jax_k4(terms.numpy(), miss.numpy(), W, cutoff, thr, delta)
    got = cuda_lod.covered_terms_plain(terms, miss, W, cutoff, thr, delta)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy().astype(bool), w)
    assert want[0].any() and not want[0].all() and want[1].any()


def test_terms_wrappers_take_plain_versions_and_check_inputs():
    terms, miss = _inputs(6, 300, 20, seed=3)
    before = dict(cuda_lod.LAUNCHES)
    a = cuda_lod.window_sums(terms, miss, 20)
    c = cuda_lod.covered_terms(terms, miss, 20, 0.5, 5.0, 0.01)
    assert cuda_lod.LAUNCHES == before  # no kernel ran
    assert torch.equal(a, cuda_lod.window_sums_plain(terms, miss, 20))
    for x, y in zip(c, cuda_lod.covered_terms_plain(terms, miss, 20, 0.5,
                                                    5.0, 0.01)):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        cuda_lod.window_sums(terms.double(), miss, 20)
    with pytest.raises(TypeError):
        cuda_lod.covered_terms(terms, miss[:-1], 20, 0.5, 5.0, 0.01)
    with pytest.raises(ValueError):
        cuda_lod.window_sums(terms, miss[:0], 301)  # no window fits
    with pytest.raises(ValueError):
        cuda_lod.window_sums(terms.t(), miss, 20)  # not contiguous


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tgls_dir(tmp_path_factory):
    """tests/test_device_win.py:234's panel on two chromosomes, with a GQ
    TGLS file (40 distinct tokens: the native reader's dictionary form)
    and a GL one (random floats: its f64 matrix form)."""
    wd = tmp_path_factory.mktemp("port_tgls")
    panel = make_panel(nind=30, nloci_per_chr=(4000, 3000), seed=23)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    write_tgls(panel, str(wd / "GL.tgls.gz"), gl_type="GL")
    return str(wd)


def _run(main, wd, args, **kw):
    old = os.getcwd()
    os.chdir(wd)
    try:
        return main(args, prog="garlic", **kw)
    finally:
        os.chdir(old)


def jax_main(argv, prog):
    from garlic_tpu.pipeline import run_main
    return run_main(argv, prog=prog)


def _base(wd, gl_type, tped="p.tped.gz", tgls=None):
    return ["--tped", f"{wd}/{tped}", "--tfam", f"{wd}/p.tfam", "--tgls",
            f"{wd}/{tgls or gl_type + '.tgls.gz'}", "--gl-type",
            gl_type] + PINNED


def _same_outputs(wd, out, ref):
    assert read_text(f"{wd}/{out}.roh.bed") == read_text(f"{wd}/{ref}.roh.bed")
    assert read_text(f"{wd}/{out}.freq.gz") == read_text(f"{wd}/{ref}.freq.gz")
    assert diff_logs(read_text(f"{wd}/{ref}.log"),
                     read_text(f"{wd}/{out}.log"), ref, out) == []


@pytest.fixture
def routes(monkeypatch):
    """Spies on the port's routes: covered_sharded's results (None: split
    path), lod_windows_sharded's use_gl flags, and the K3/K4 wrapper
    calls."""
    seen = {"fused": [], "split_gl": [], "window_sums": 0,
            "covered_terms": 0}

    def spy_fused(*a, **k):
        r = orig_fused(*a, **k)
        seen["fused"].append(r is not None)
        return r

    def spy_split(*a, **k):
        seen["split_gl"].append(bool(a[6] if len(a) > 6
                                     else k.get("use_gl", False)))
        return orig_split(*a, **k)

    def counting(name, fn):
        def f(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return f

    orig_fused = port_engine.covered_sharded
    orig_split = port_engine.lod_windows_sharded
    monkeypatch.setattr(port_engine, "covered_sharded", spy_fused)
    monkeypatch.setattr(port_engine, "lod_windows_sharded", spy_split)
    for name in ("window_sums", "covered_terms"):
        monkeypatch.setattr(cuda_lod, name,
                            counting(name, getattr(cuda_lod, name)))
    return seen


@pytest.mark.parametrize("gl_type", ["GQ", "GL"])
def test_pinned_tgls_run_matches_garlic_tpu(tgls_dir, monkeypatch, routes,
                                            gl_type):
    """GQ (dictionary form): K4 fused, as covered_pallas_gl_codes_raw.
    GL (float form): covered_sharded declines and K3 feeds the split
    coverage program, as lod_windows_pallas_gl_raw."""
    wd, base = tgls_dir, _base(tgls_dir, gl_type)
    tag = gl_type.lower()
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", f"{tag}_jx"]) == 0
    monkeypatch.setenv("GARLIC_TPU_FUSED_INTERPRET", "1")
    assert _run(jax_main, wd, base + ["--tpu-engine", "fast",
                                      "--out", f"{tag}_jf"]) == 0
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", f"{tag}_pf"],
                device="cpu") == 0
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    if gl_type == "GQ":
        assert routes["fused"] == [True, True] and not routes["split_gl"]
        assert routes["covered_terms"] == 2 and routes["window_sums"] == 0
    else:
        assert routes["fused"] == [False, False]
        assert routes["split_gl"] == [True, True]
        assert routes["window_sums"] == 2 and routes["covered_terms"] == 0
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", f"{tag}_px"]) == 0
    bed = read_text(f"{wd}/{tag}_jx.roh.bed")
    assert bed.count("\nchr") >= 5  # the panel has ROH to call
    for out in (f"{tag}_pf", f"{tag}_px"):
        _same_outputs(wd, out, f"{tag}_jx")
        _same_outputs(wd, out, f"{tag}_jf")


def _raw(wd, out):
    vals = []
    for c in ("chr1", "chr2"):
        text = read_text(f"{wd}/{out}.POP1.{c}.raw.lod.windows.gz")
        vals.append(np.array(text.replace("NA", "nan").split(), dtype=float))
    return np.concatenate(vals)


@pytest.mark.parametrize("gl_type", ["GQ", "GL"])
def test_tgls_raw_lod_matches_garlic_tpu(tgls_dir, routes, gl_type):
    """--raw-lod with TGLS: K3 over either error-plane form
    (lod_windows_pallas_gl_codes_raw / _gl_raw), then the split coverage
    program."""
    wd = tgls_dir
    base = _base(wd, gl_type) + ["--raw-lod"]
    tag = "r" + gl_type.lower()
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", f"{tag}_jx"]) == 0
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", f"{tag}_pf"],
                device="cpu") == 0
    assert routes["split_gl"] == [True, True] and not routes["fused"]
    assert routes["window_sums"] == 2
    assert read_text(f"{wd}/{tag}_pf.roh.bed") == \
        read_text(f"{wd}/{tag}_jx.roh.bed")
    got, want = _raw(wd, f"{tag}_pf"), _raw(wd, f"{tag}_jx")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    live = ~np.isnan(want)
    np.testing.assert_allclose(got[live], want[live], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("gl_type", ["GQ", "GL"])
def test_tgls_panel_cache_cold_and_warm_match(tgls_dir, gl_type):
    """--tpu-panel-cache also writes the TGLS sidecar (.gtlc: dictionary
    codes for GQ, the f64 matrix for GL); the warm run reads it and
    calls the same BED."""
    wd = tgls_dir
    tped, tg = f"pc_{gl_type}.tped.gz", f"pc_{gl_type}.tgls.gz"
    shutil.copy(f"{wd}/p.tped.gz", f"{wd}/{tped}")
    shutil.copy(f"{wd}/{gl_type}.tgls.gz", f"{wd}/{tg}")
    base = _base(wd, gl_type, tped=tped, tgls=tg)
    tag = "c" + gl_type.lower()
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", f"{tag}_jx"]) == 0
    base = base + ["--tpu-panel-cache", "--tpu-engine", "fast"]
    assert _run(port_main, wd, base + ["--out", f"{tag}_cold"],
                device="cpu") == 0
    assert os.path.exists(f"{wd}/{tg}.gtlc")
    assert _run(port_main, wd, base + ["--out", f"{tag}_warm"],
                device="cpu") == 0
    for out in (f"{tag}_cold", f"{tag}_warm"):
        _same_outputs(wd, out, f"{tag}_jx")


# ---------------------------------------------------------------------------
# On the card (skipped without CUDA)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("I,L,W", [(37, 1001, 60), (5, 64, 64), (3, 10, 1),
                                   (9, 3001, 120), (200, 20000, 60)])
def test_terms_kernels_match_plain_on_card(cuda_device, I, L, W):
    c, centro, _ = _chrom(I, L, W, seed=I + L, form="dict")
    terms, miss = cuda_lod.chrom_gl_inputs(c, centro, W, 100000, cuda_device)
    before = dict(cuda_lod.LAUNCHES)
    a = cuda_lod.window_sums(terms, miss, W)
    b = cuda_lod.window_sums_plain(terms, miss, W)
    cutoff = float(b[b != MISSING].median())
    c3 = cuda_lod.covered_terms(terms, miss, W, cutoff, float(max(1, W // 4)),
                                0.05)
    d3 = cuda_lod.covered_terms_plain(terms, miss, W, cutoff,
                                      float(max(1, W // 4)), 0.05)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["window_sums"] == before["window_sums"] + 1
    assert cuda_lod.LAUNCHES["covered_terms"] == before["covered_terms"] + 1
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for x, y in zip(c3, d3):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_pinned_gq_run_on_card_matches_exact(tgls_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wd, base = tgls_dir, _base(tgls_dir, "GQ")
    before = cuda_lod.LAUNCHES["covered_terms"]
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "gpu_gq"]) == 0
    assert cuda_lod.LAUNCHES["covered_terms"] == before + 2
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", "gpu_gqx"]) == 0
    _same_outputs(wd, "gpu_gq", "gpu_gqx")
