"""Parity of the port's Phase-I kernels (garlic_tpu_torch/ops/cuda_lod.py)
with the JAX package's Pallas kernels, run here as the Pallas tests run
them (interpret mode on the CPU).  The plain PyTorch versions carry the
kernels' arithmetic on the CPU; the CUDA kernels themselves are compared
with those plain versions on the card (tests marked gpu, skipped here).

Tolerances: with the same f32 table the plain K1 sums equal the Pallas
kernel's bit for bit for W <= 64 (both chain W f32 adds left to right
from 0); for W > 64 the Pallas kernel takes a block prefix-sum
difference instead, held to the atol=1e-3 of test_pallas_large_winsize.
(The Pallas kernels need W >= 2, as the CLI does; W=1 is checked on the
card against the plain versions.)
K2's planes are exact.  The f32 table differs from XLA's only in log10's
last ulp."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from garlic_tpu.core.types import MISSING
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.ops.lod import window_missing_mask

# the JAX package's modules are imported inside the tests that run them,
# so the gpu tests collect where JAX is absent (pytest --noconftest -m gpu)
_COL = 128  # pallas_lod._COL_TILE
_BL = 128  # Pallas window-start block: small grids keep interpret mode fast


def _cdiv(a, b):
    return -(-a // b)


def _case(I, L, W, seed):
    """Genotypes (int8, -9 missing), freq, window mask, the f32 table."""
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.03] = -9
    freq = np.clip(rng.beta(0.8, 0.8, L), 0.02, 0.98)
    freq[::53] = 0.0  # monomorphic sites score 0
    pos = np.cumsum(rng.integers(100, 4000, L)).astype(np.int64)
    # a centromere masks some windows, where that leaves others live
    c0 = L // 3 if L >= 4 * W else L - 1
    miss = window_missing_mask(pos, W, 100000, pos[c0] + 1,
                               pos[min(c0 + 5, L - 1)] + 1)
    assert not miss.all()
    table = cuda_lod.lod_table_f32(
        torch.from_numpy(freq.astype(np.float32)), 0.001).numpy()
    return geno, freq, miss, table


def _torch_inputs(geno, miss, table):
    packed = cuda_lod._pack_numpy(geno, _cdiv(geno.shape[1], 4) * 4)
    return (torch.from_numpy(packed), torch.from_numpy(table),
            torch.from_numpy(miss.astype(np.uint8)))


def _jax_k1(geno, table, W):
    """Raw window sums [I, nwin] from the Pallas K1 in interpret mode."""
    import jax.numpy as jnp
    from garlic_tpu.ops import pallas_lod
    I, L = geno.shape
    nwin = L - W + 1
    HW = _cdiv(W - 1, _COL) * _COL
    I2 = _cdiv(I, 32) * 32
    NW2 = _cdiv(nwin, _BL) * _BL
    gp = np.full((I2, NW2 + HW), -9, np.int8)
    gp[:I, :L] = geno
    tp = np.zeros((8, NW2 + HW), np.float32)
    tp[:3, :L] = table
    out = pallas_lod._lod_windows_pallas_padded(
        jnp.asarray(gp), jnp.asarray(tp), W, 32, _BL, interpret=True)
    return np.asarray(out)[:I, :nwin]


def _jax_k2(geno, table, miss, W, cutoff, thr, delta):
    """(covered [I, L], susw, above [I, nwin]) from the Pallas K2."""
    import jax.numpy as jnp
    from garlic_tpu.ops import pallas_lod
    I, L = geno.shape
    nwin = L - W + 1
    HW = _cdiv(W - 1, _COL) * _COL
    I2 = _cdiv(I, 32) * 32
    NW2 = _cdiv(L, _BL) * _BL  # coverage needs nwin + W - 1
    gp = np.full((I2, 2 * HW + NW2), -9, np.int8)
    gp[:I, HW:HW + L] = geno
    tp = np.zeros((8, 2 * HW + NW2), np.float32)
    tp[:3, HW:HW + L] = table
    mp = np.ones((8, HW + NW2), np.int8)
    mp[:, HW:HW + nwin] = miss
    scal = np.zeros((8, 128), np.float32)
    scal[0], scal[1], scal[2] = cutoff, math.ceil(thr), delta
    cov, susw, above = pallas_lod._covered_pallas_padded(
        jnp.asarray(gp), jnp.asarray(tp), jnp.asarray(mp), jnp.asarray(scal),
        W, 32, _BL, interpret=True)
    return (np.asarray(cov)[:I, :L], np.asarray(susw)[:I, :nwin],
            np.asarray(above)[:I, :nwin])


@pytest.mark.parametrize("I,L", [(5, 64), (9, 1001), (3, 7)])
def test_decode_2bit_roundtrips_pack_genotypes(I, L):
    from garlic_tpu.ops.pallas_lod import pack_genotypes
    rng = np.random.default_rng(L)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.2] = -9
    padded = np.concatenate([geno, np.full((I, (-L) % 4), -9, np.int8)],
                            axis=1)
    packed = torch.from_numpy(pack_genotypes(padded))
    np.testing.assert_array_equal(
        packed.numpy(), cuda_lod._pack_numpy(geno, padded.shape[1]))
    got = cuda_lod.decode_2bit(packed, L)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), geno)


def test_lod_table_f32_matches_jax_table():
    """The JAX package builds its f32 table inside _packed_entry.  A W=2
    window over [class c, missing] sums to (0 + t) + 0 = t exactly, so
    rows holding class c at even (odd) loci and missing codes elsewhere
    return that table row at even (odd) window starts."""
    import jax.numpy as jnp
    from garlic_tpu.ops import pallas_lod
    L = 1024 + _COL  # window starts [0, 1024) + the Pallas halo
    rng = np.random.default_rng(1)
    freq = np.clip(rng.beta(0.8, 0.8, L), 0.02, 0.98).astype(np.float32)
    freq[::97] = 0.0
    freq[5::97] = 1.0
    codes = np.full((32, L), 3, np.uint8)
    for c in range(3):
        codes[2 * c, 0::2] = c
        codes[2 * c + 1, 1::2] = c
    packed = (codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4)
              | (codes[:, 3::4] << 6)).astype(np.uint8)
    win = np.asarray(pallas_lod._packed_entry(
        jnp.asarray(packed), jnp.asarray(freq), 0.001, 2, 32, _BL,
        interpret=True))
    n = win.shape[1]
    rows = np.where(np.arange(n) % 2 == 0, win[0:6:2], win[1:6:2])
    got = cuda_lod.lod_table_f32(torch.from_numpy(freq), 0.001).numpy()
    assert got.dtype == np.float32 and got.shape == (3, L)
    np.testing.assert_array_equal(got[:, :n] == 0, rows == 0)
    # log10 differs in its last ulp between XLA and torch; near a zero
    # term that ulp is absolute (one f32 ulp at 1.0), hence the atol
    np.testing.assert_allclose(got[:, :n], rows, rtol=1e-6, atol=2.0 ** -23)


@pytest.mark.parametrize("W", [2, 7, 40, 64])
def test_k1_plain_bitwise_equals_pallas(W):
    geno, _, miss, table = _case(9, 700, W, seed=W)
    want = _jax_k1(geno, table, W)
    want = np.where(miss[None, :], np.float32(MISSING), want)
    got = cuda_lod.lod_windows_plain(*_torch_inputs(geno, miss, table),
                                     W).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("W", [65, 120])
def test_k1_plain_matches_pallas_large_winsize(W):
    geno, _, miss, table = _case(7, 1200, W, seed=W)
    want = _jax_k1(geno, table, W)
    got = cuda_lod.lod_windows_plain(*_torch_inputs(geno, miss, table),
                                     W).numpy()
    live = ~miss
    np.testing.assert_array_equal(got[:, ~live], np.float32(MISSING))
    np.testing.assert_allclose(got[:, live], want[:, live], atol=1e-3)


@pytest.mark.parametrize("W", [2, 7, 40, 64])
def test_k2_plain_planes_equal_pallas(W):
    geno, _, miss, table = _case(9, 700, W, seed=100 + W)
    live = _jax_k1(geno, table, W)[:, ~miss]
    cutoff = float(np.median(live))      # both sides of the cutoff occur
    thr, delta = float(max(1, W // 4)), 0.05
    want = _jax_k2(geno, table, miss, W, cutoff, thr, delta)
    got = cuda_lod.covered_plain(*_torch_inputs(geno, miss, table), W,
                                 cutoff, thr, delta)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy().astype(bool), w)
    assert want[0].any() and not want[0].all() and want[1].any()


def test_wrappers_take_plain_versions_for_cpu_tensors():
    geno, _, miss, table = _case(6, 300, 20, seed=3)
    inp = _torch_inputs(geno, miss, table)
    before = dict(cuda_lod.LAUNCHES)
    a = cuda_lod.lod_windows(*inp, 20)
    c = cuda_lod.covered(*inp, 20, 0.5, 5.0, 0.01)
    assert cuda_lod.LAUNCHES == before  # no kernel ran
    assert torch.equal(a, cuda_lod.lod_windows_plain(*inp, 20))
    for x, y in zip(c, cuda_lod.covered_plain(*inp, 20, 0.5, 5.0, 0.01)):
        assert torch.equal(x, y)


def test_wrappers_reject_bad_inputs():
    geno, _, miss, table = _case(4, 100, 10, seed=4)
    pk, tb, ms = _torch_inputs(geno, miss, table)
    with pytest.raises(TypeError):
        cuda_lod.lod_windows(pk.to(torch.int8), tb, ms, 10)
    with pytest.raises(TypeError):
        cuda_lod.covered(pk, tb.double(), ms, 10, 0.0, 1.0, 0.0)
    with pytest.raises(TypeError):
        cuda_lod.lod_windows(pk, tb, ms[:-1], 10)
    with pytest.raises(ValueError):
        cuda_lod.lod_windows(pk[:, :-1].contiguous(), tb, ms, 10)
    with pytest.raises(ValueError):
        cuda_lod.lod_windows(pk, tb, ms, 101)  # no window fits
    with pytest.raises(ValueError):
        cuda_lod.lod_windows(pk.to("meta"), tb.to("meta"), ms.to("meta"),
                             10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# shapes that register blocking (29 window starts per thread in K1/K3, 15
# in K2/K4) and the tiles (3712 starts per K1/K3 tile, 3840 per K2/K4
# block pass) make risky: W=1, nwin=1, W and nwin off multiples of 29 and
# 15, rows not 16-byte aligned (nwin % 4 != 0), W=120 and W=500, I=1, L
# under one tile, W below and at the chains' ramps (13, 14), a second
# tile by one start (nwin=3713 and 3841), K2's two passes (W=2500), more
# items than resident blocks (200 and 1000 rows), and blocks whose items
# change column tile (3 rows of 2,000,000), and a table too large for
# shared memory next to K1's and K2's tiles (W=12000: the unstaged decode)
@pytest.mark.gpu
@pytest.mark.parametrize("I,L,W", [(37, 1001, 60), (5, 64, 64), (3, 10, 1),
                                   (9, 3001, 120), (200, 20000, 60),
                                   (1, 5000, 500), (7, 9001, 500),
                                   (5, 3772, 60),
                                   (6, 3901, 61), (4, 777, 13),
                                   (11, 4001, 14), (3, 12001, 2500),
                                   (1000, 4000, 60), (3, 2000000, 37),
                                   (3, 40000, 12000)])
def test_kernels_match_plain_on_card(cuda_device, I, L, W):
    """K1/K2 against their plain versions bit for bit, and the twins: K3
    over K1's own term plane is K1, K4 over it is K2."""
    geno, _, miss, table = _case(I, L, W, seed=I + L)
    inp = [t.to(cuda_device) for t in _torch_inputs(geno, miss, table)]
    before = dict(cuda_lod.LAUNCHES)
    a = cuda_lod.lod_windows(*inp, W)
    b = cuda_lod.lod_windows_plain(*inp, W)
    cutoff = float(b[b != MISSING].median())
    args = (cutoff, float(max(1, W // 4)), 0.05)
    c = cuda_lod.covered(*inp, W, *args)
    d = cuda_lod.covered_plain(*inp, W, *args)
    own = cuda_lod.table_terms(inp[0], inp[1])
    e = cuda_lod.window_sums(own, inp[2], W)
    f = cuda_lod.covered_terms(own, inp[2], W, *args)
    torch.cuda.synchronize()
    for k in ("lod_windows", "covered", "window_sums", "covered_terms"):
        assert cuda_lod.LAUNCHES[k] == before[k] + 1
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(e.view(torch.int32), a.view(torch.int32))
    for x, y, z in zip(c, d, f):
        assert torch.equal(x, y) and torch.equal(z, x)
