"""Parity of the port's device-window layer (garlic_tpu_torch/ops/
device_win.py) with garlic_tpu's on the same inputs: the coverage
transfer over an f32 window matrix (split path) and the fused K2
dispatch over a chromosome (garlic_tpu's Pallas K2 in interpret mode).
Coverage bits, suspect rows and the suspect-window triples are exact."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from garlic_tpu.core.types import MISSING, ChromData
from garlic_tpu.ops import device_win as jax_dw
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.ops import device_win as dw
from garlic_tpu_torch.parallel import engine
from garlic_tpu_torch.parallel.mesh import make_mesh

sys.path.insert(0, os.path.dirname(__file__))
from util import make_panel  # noqa: E402


def _win(I, L, W, seed):
    """f32 window scores [I, nwin] with MISSING slots."""
    rng = np.random.default_rng(seed)
    nwin = L - W + 1
    win = (rng.standard_normal((I, nwin)) * 2).astype(np.float32)
    win[:, rng.random(nwin) < 0.1] = MISSING
    return win


# the 1x1 mesh over the CPU: the plain versions of the kernels
ONE = make_mesh(1, 1, ["cpu"])


def _dwin(win, I, L, W):
    """The port's DeviceWin of an [I, nwin] window matrix on the 1x1
    mesh."""
    return dw.DeviceWin(nind=I, nloci=L, nwin=win.shape[1],
                        shards=engine.shard_blocks(I, L, ONE, W),
                        blocks={(0, 0): torch.from_numpy(win)})


def _triples(susw):
    si, sw, side = susw
    return sorted(zip(np.asarray(si).tolist(), np.asarray(sw).tolist(),
                      np.asarray(side).astype(bool).tolist()))


@pytest.mark.parametrize("seed,cutoff,delta", [(0, -0.5, 0.0),
                                                (1, 0.8, 1e-3),
                                                (2, 3.0, 5e-3)])
def test_covered_packed_matches_garlic_tpu(seed, cutoff, delta):
    import jax.numpy as jnp
    I, L, W = 9, 500, 12
    win = _win(I, L, W, seed)
    nwin = win.shape[1]
    # a few windows inside the tie band, on both sides of the cutoff
    win[1, 40] = cutoff + delta / 2
    win[4, 200] = cutoff - delta / 2
    a = jax_dw.DeviceWin(win=jnp.asarray(win), nind=I, nloci=L, nwin=nwin)
    b = _dwin(win, I, L, W)
    pa, sa, wa = jax_dw.covered_packed(a, cutoff, W, 3.0, tie_delta=delta)
    pb, sb, wb = dw.covered_packed(b, cutoff, W, 3.0, tie_delta=delta)
    assert pb.shape == pa.shape == (I, (L + 7) // 8)
    np.testing.assert_array_equal(pb, pa)
    np.testing.assert_array_equal(sb, sa[:I])
    assert _triples(wb) == _triples(wa)
    assert bool(sb.any()) == (delta > 0)


def test_device_win_to_numpy_matches_garlic_tpu():
    import jax.numpy as jnp
    I, L, W = 7, 300, 20
    win = _win(I, L, W, 5)
    nwin = win.shape[1]
    a = jax_dw.DeviceWin(win=jnp.asarray(win), nind=I, nloci=L, nwin=nwin)
    b = _dwin(win, I, L, W)
    np.testing.assert_array_equal(b.to_numpy(), a.to_numpy())
    np.testing.assert_array_equal(b[3], a.to_numpy()[3])
    assert b.shape == (I, L)


class _Centro:
    def __init__(self, start, end):
        self._s, self._e = start, end

    def start(self, chrom):
        return self._s

    def end(self, chrom):
        return self._e


def _chrom(nind, L, seed):
    p = make_panel(nind=nind, nloci_per_chr=(L,), seed=seed,
                   big_gap_every=400)
    g = p.genotypes[0]
    obs = g >= 0
    freq = np.where(obs, g, 0).sum(0) / np.maximum(2 * obs.sum(0), 1)
    pos = p.positions[0]
    chrom = ChromData(chrom="chr1", positions=pos, gpos=np.zeros(L),
                      locus_names=[f"rs{i}" for i in range(L)],
                      alleles=np.array(["A"] * L), genotypes=g, freq=freq)
    mid = min(L // 2 + 30, L - 1)
    return chrom, _Centro(int(pos[L // 2]), int(pos[mid]))


def test_fused_dispatch_matches_garlic_tpu(monkeypatch):
    """FusedCov through K2 (plain version here) against garlic_tpu's
    FusedCov through the Pallas K2 in interpret mode, same chromosome."""
    monkeypatch.setenv("GARLIC_TPU_FUSED_INTERPRET", "1")
    chrom, centro = _chrom(12, 2500, seed=3)
    W, cutoff, thr, delta = 40, 1.3, 10.0, 0.3
    a = jax_dw.covered_fetch(jax_dw.covered_dispatch(
        jax_dw.FusedCov(chrom, centro, W, 0.001, 200000), cutoff, W, thr,
        delta))
    before = dict(cuda_lod.LAUNCHES)
    b = dw.covered_fetch(dw.covered_dispatch(
        dw.FusedCov(chrom, centro, W, 0.001, 200000, ONE), cutoff, W, thr,
        delta))
    assert cuda_lod.LAUNCHES == before  # CPU tensors: the plain K2
    I = chrom.nind  # garlic_tpu pads rows to a multiple of 32
    np.testing.assert_array_equal(b[0], a[0][:I])
    assert not a[0][I:].any()
    np.testing.assert_array_equal(b[1], a[1][:I])
    assert _triples(b[2]) == _triples(a[2])
    assert b[0].any() and b[1].any()


def test_split_and_fused_paths_agree():
    """K1 + the torch coverage program equal K2 on the same chromosome
    (one window-sum routine for every W, W > 64 included)."""
    chrom, centro = _chrom(10, 1500, seed=4)
    for W in (40, 90):
        win = engine.lod_windows_sharded(chrom, centro, W, 0.001, 200000,
                                         ONE)
        split = dw.covered_packed(win, 0.5, W, W / 4, 0.02)
        fused = dw.covered_packed(
            dw.FusedCov(chrom, centro, W, 0.001, 200000, ONE), 0.5, W,
            W / 4, 0.02)
        np.testing.assert_array_equal(split[0], fused[0])
        np.testing.assert_array_equal(split[1], fused[1])
        assert _triples(split[2]) == _triples(fused[2])


@pytest.mark.parametrize("L", [30, 0])
def test_chromosome_shorter_than_window_covers_nothing(L):
    """Fewer SNPs than the window (a chromosome the monomorphic filter
    emptied included): no windows, nothing covered, no kernel launch."""
    chrom, centro = _chrom(4, 30, seed=5)
    if L == 0:
        chrom = ChromData(chrom="chr1", positions=chrom.positions[:0],
                          gpos=np.zeros(0), locus_names=[],
                          alleles=chrom.alleles[:0],
                          genotypes=chrom.genotypes[:, :0],
                          freq=chrom.freq[:0])
    W = 40
    win = engine.lod_windows_sharded(chrom, centro, W, 0.001, 200000, ONE)
    assert win.nwin == 0 and (win.to_numpy() == MISSING).all()
    for src in (win, dw.FusedCov(chrom, centro, W, 0.001, 200000, ONE)):
        packed, sus, (si, _, _) = dw.covered_packed(src, 0.5, W, 10.0, 0.1)
        assert packed.shape == (4, (L + 7) // 8) and not packed.any()
        assert not sus.any() and si.size == 0


@pytest.mark.gpu
def test_fused_dispatch_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chrom, centro = _chrom(40, 20000, seed=6)
    W = 60
    got = dw.covered_packed(
        dw.FusedCov(chrom, centro, W, 0.001, 200000,
                    make_mesh(1, 1, ["cuda"])), 1.5, W, 15.0,
        0.01)
    want = dw.covered_packed(
        dw.FusedCov(chrom, centro, W, 0.001, 200000, ONE), 1.5, W, 15.0,
        0.01)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert _triples(got[2]) == _triples(want[2])
