"""The weighted path's kernels K5 (pair counts) and K6 (wLOD window sums).

On the CPU the wrappers in garlic_tpu_torch/ops/device_wlod.py take their
plain PyTorch versions; those are held here to the wrappers bit for bit
and to garlic_tpu's XLA programs on JAX-CPU (_hr2_counts_chunk,
_r2_counts_chunk, _wlod_chunk, _wlod_windows_dev) on seeded numpy
inputs.  Tolerances: the counts are exact integers (garlic_tpu's are f32
sums of 0/1 in [L2, W], with r^2's total doubled); the windows within
rtol 1e-5, atol 1e-6 of garlic_tpu's f32 (XLA may contract a product
and its add into one FMA; the port rounds both); the tie scale equal to
the largest |f32 score * f32 inv| over every row and window start.  The
gpu-marked tests hold each kernel on the card to its plain version bit
for bit.

garlic_tpu is imported inside the CPU-side tests only: the gpu tests run
where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from garlic_tpu_torch.core.types import MISSING
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.ops import device_wlod as dw

ERR, MU, M = 0.001, 1e-9, 7


def _codes(I, L, seed, missing=0.05):
    """(int8 genotypes [I, L], -9 missing; u8 2-bit codes; first-copy bits
    bool [I, L])."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, (I, L)).astype(np.int8)
    g[rng.random((I, L)) < missing] = -9
    return g, cuda_lod.pack_codes(g), rng.random((I, L)) < 0.5


def _planes(W, L, device="cpu", fill=0):
    T = torch.full((W, L), fill, dtype=torch.int32, device=device)
    return T, T.clone()


def _window_inputs(I, L, W, seed, col0=0):
    """(codes [I, ceil(L/4)], table f32 [4, L] (class 3: zeros, as
    score_table's), inv_t f32 [W, nwin] in (0, 1], miss u8 [nwin]) with
    nwin = L - col0 - W + 1."""
    rng = np.random.default_rng(seed)
    _, pk, _ = _codes(I, L, seed)
    nwin = L - col0 - W + 1
    table = rng.normal(0.0, 0.7, (4, L)).astype(np.float32)
    table[3] = 0.0
    inv_t = rng.uniform(0.05, 1.0, (W, nwin)).astype(np.float32)
    miss = (rng.random(nwin) < 0.1).astype(np.uint8)
    return (torch.from_numpy(pk), torch.from_numpy(table),
            torch.from_numpy(inv_t), torch.from_numpy(miss))


def _plane(pk, table):
    """The f32 score plane of the codes' gather (the plain gather)."""
    return dw._wlod_score_from_table(
        cuda_lod.decode_2bit(pk, table.shape[1]), table).contiguous()


def _tie_exact(score, inv_t, col0):
    """The largest |score[i, col0 + l + j] * inv_t[j, l]| in f32."""
    W, nwin = inv_t.shape
    s = score.numpy()
    iv = inv_t.numpy()
    return max(float(np.abs(s[:, col0 + j:col0 + j + nwin] * iv[j]).max())
               for j in range(W))


# ---------------------------------------------------------------------------
# K5 on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_pair_counts_cpu_takes_plain_version(phased):
    """CPU tensors: the plain counts added into the planes, bit for bit,
    and no launch."""
    g, pk, fc = _codes(45, 613, seed=1 + phased)
    W = 23
    T, X = _planes(W, 613, fill=7)
    before = dict(cuda_lod.LAUNCHES)
    fcb = torch.from_numpy(dw.pack_first_copy(fc)) if phased else None
    dw.pair_counts(torch.from_numpy(pk), fcb, T, X, W)
    assert cuda_lod.LAUNCHES == before
    gt = torch.from_numpy(g)
    t, x = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    assert torch.equal(T, t + 7) and torch.equal(X, x + 7)


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("W", [1, 17, 40])
def test_pair_counts_match_garlic_tpu(phased, W):
    """The int32 counts equal garlic_tpu's f32 counts ([L2, W], L2 the
    padded width; r^2's total is twice the both-valid count) exactly, on
    an odd L."""
    import jax.numpy as jnp
    from garlic_tpu.ops import device_wlod as gt_dwlod
    I, L, L2 = 37, 301, 384
    g, pk, fc = _codes(I, L, seed=W + phased)
    T, X = _planes(W, L)
    fcb = dw.pack_first_copy(fc)
    dw.pair_counts(torch.from_numpy(pk),
                   torch.from_numpy(fcb) if phased else None, T, X, W)
    if phased:
        fcp = np.zeros((I, L2), dtype=bool)
        fcp[:, :L] = fc
        t, x = gt_dwlod._r2_counts_chunk(
            jnp.asarray(pk), jnp.asarray(np.packbits(fcp, axis=1,
                                                     bitorder="little")),
            I, L, L2, W)
    else:
        t, x = gt_dwlod._hr2_counts_chunk(jnp.asarray(pk), I, L, L2, W)
    t = np.asarray(t)[:L].T
    x = np.asarray(x)[:L].T
    assert np.array_equal(t, (2 if phased else 1) * T.numpy())
    assert np.array_equal(x, X.numpy())
    assert T.numpy()[1:].any() and X.numpy()[1:].any() or W == 1


def test_first_copy_packer():
    """pack_first_copy / unpack_first_copy round-trip any width, and the
    r^2 counts over the packed bits equal the plain counts over the bool
    plane."""
    for L in (1, 7, 8, 9, 613):
        fc = np.random.default_rng(L).random((5, L)) < 0.5
        bits = dw.pack_first_copy(fc)
        assert bits.shape == (5, (L + 7) // 8) and bits.dtype == np.uint8
        assert np.array_equal(
            dw.unpack_first_copy(torch.from_numpy(bits), L).numpy(), fc)
    g, pk, fc = _codes(30, 613, seed=5)
    T, X = _planes(19, 613)
    dw.pair_counts(torch.from_numpy(pk),
                   torch.from_numpy(dw.pack_first_copy(fc)), T, X, 19)
    t, x = dw._r2_counts(torch.from_numpy(g), torch.from_numpy(fc), 19)
    assert torch.equal(T, t) and torch.equal(X, x)


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_chunked_accumulation(phased):
    """Adding row chunks into the same planes gives the one-chunk counts;
    so does the route's _pair_counts_chunked with chunks of 8 rows."""
    g, pk, fc = _codes(41, 500, seed=9)
    W = 31
    pkt = torch.from_numpy(pk)
    fcb = torch.from_numpy(dw.pack_first_copy(fc))
    one = _planes(W, 500)
    dw.pair_counts(pkt, fcb if phased else None, *one, W)
    parts = _planes(W, 500)
    for s in (0, 8, 19, 33):
        e = {0: 8, 8: 19, 19: 33, 33: 41}[s]
        dw.pair_counts(pkt[s:e], fcb[s:e] if phased else None, *parts, W)
    assert torch.equal(one[0], parts[0]) and torch.equal(one[1], parts[1])
    for C in (8, 41):
        T, X = dw._pair_counts_chunked(pkt, fc if phased else None, 500, W,
                                       C)
        assert torch.equal(T, one[0]) and torch.equal(X, one[1])


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_pair_counts_store_mode(phased):
    """fresh=True ignores what the planes hold and writes every entry: the
    plain counts, 0 in row 0 and past L - d; the route's chunked counts
    (the first chunk stored into torch.empty planes, the later ones
    added) equal zeros plus the adds of every chunk, for several C; no
    rows with fresh=True gives zeros."""
    I, L, W = 53, 517, 29
    g, pk, fc = _codes(I, L, seed=21 + phased)
    pkt = torch.from_numpy(pk)
    fcb = torch.from_numpy(dw.pack_first_copy(fc)) if phased else None
    gt = torch.from_numpy(g)
    t, x = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    T, X = _planes(W, L, fill=-77)
    dw.pair_counts(pkt, fcb, T, X, W, fresh=True)
    assert torch.equal(T, t) and torch.equal(X, x)
    for C in (8, 16, 24, 53, 64):
        zeros = _planes(W, L)
        for s in range(0, I, C):
            dw.pair_counts(pkt[s:s + C], None if fcb is None else fcb[s:s + C],
                           *zeros, W)
        got = dw._pair_counts_chunked(pkt, fc if phased else None, L, W, C)
        assert torch.equal(got[0], zeros[0]) and torch.equal(got[1], zeros[1])
        assert torch.equal(got[0], t) and torch.equal(got[1], x)
    T, X = _planes(W, L, fill=5)
    dw.pair_counts(pkt[:0], None if fcb is None else fcb[:0], T, X, W,
                   fresh=True)
    assert not T.any() and not X.any()
    empty = dw._pair_counts_chunked(pkt[:0], fc[:0] if phased else None, L,
                                    W, 8)
    assert not empty[0].any() and not empty[1].any()


def _channel_counts(g, fc, W, tile=16):
    """K5's formulation in plain torch: T and X as integer products of 0/1
    flag planes over the rows, tile by tile of loci m against the band of
    partners n = m + 1 .. m + W - 1 (as the kernel's mma.sync tiles do),
    the counts picked from the products' diagonals.  HR^2: T = valid'
    valid, X = hom' hom; r^2 (fc given): X = h1' h1 + h2' h2 over the two
    haplotypes (h1 = a2 | a1 & f, h2 = a2 | a1 & ~f).  int32 [W, L]."""
    g = torch.from_numpy(g)
    L = g.shape[1]
    valid = (g != -9).to(torch.int32)
    if fc is None:
        hom = (valid.bool() & (g != 1)).to(torch.int32)
        chans = [(valid, valid), (hom, hom)]
    else:
        f = torch.from_numpy(fc)
        a1, a2 = g == 1, g == 2
        h1 = (a2 | (a1 & f)).to(torch.int32)
        h2 = (a2 | (a1 & ~f)).to(torch.int32)
        chans = [(valid, valid), (h1, h1), (h2, h2)]
    out = [torch.zeros((W, L), dtype=torch.int32) for _ in range(2)]
    for m0 in range(0, L, tile):
        m1 = min(L, m0 + tile)
        n1 = min(L, m1 + W - 1)
        prods = [a[:, m0:m1].T @ b[:, m0:n1] for a, b in chans]
        planes = (prods[0], sum(prods[1:]))
        for plane, P in zip(out, planes):
            for d in range(1, W):
                for m in range(m0, m1):
                    if m + d < L:
                        plane[d, m] = P[m - m0, m + d - m0]
    return out


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("W", [1, 17, 40])
def test_channel_counts_match_garlic_tpu(phased, W):
    """The tensor-core form of the counts (int products of 0/1 flag planes
    over the band; r^2 over the two haplotype channels) equals
    garlic_tpu's _hr2_counts_chunk / _r2_counts_chunk exactly, on 37 rows
    (not a multiple of 32) and an odd L, and equals the plain counts."""
    import jax.numpy as jnp
    from garlic_tpu.ops import device_wlod as gt_dwlod
    I, L, L2 = 37, 149, 256
    g, pk, fc = _codes(I, L, seed=100 + W + phased)
    T, X = _channel_counts(g, fc if phased else None, W)
    if phased:
        fcp = np.zeros((I, L2), dtype=bool)
        fcp[:, :L] = fc
        t, x = gt_dwlod._r2_counts_chunk(
            jnp.asarray(pk), jnp.asarray(np.packbits(fcp, axis=1,
                                                     bitorder="little")),
            I, L, L2, W)
    else:
        t, x = gt_dwlod._hr2_counts_chunk(jnp.asarray(pk), I, L, L2, W)
    assert np.array_equal(np.asarray(t)[:L].T, (2 if phased else 1)
                          * T.numpy())
    assert np.array_equal(np.asarray(x)[:L].T, X.numpy())
    gt = torch.from_numpy(g)
    want = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    assert torch.equal(T, want[0]) and torch.equal(X, want[1])
    assert T.numpy()[1:].any() and X.numpy()[1:].any() or W == 1


# ---------------------------------------------------------------------------
# K6 on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loader", ["codes", "plane"])
def test_wlod_windows_cpu_takes_plain_version(loader):
    """CPU tensors: the plain windows and tie scale bit for bit, written
    into `out` when one is given, and no launch."""
    W, col0 = 21, 3
    pk, table, inv_t, miss = _window_inputs(23, 400, W, seed=2, col0=col0)
    score = _plane(pk, table)
    before = dict(cuda_lod.LAUNCHES)
    calls = dw.CALLS["wlod_windows_plain"]
    out = torch.full((23, inv_t.shape[1]), 5.0)
    if loader == "codes":
        win, tie = dw.wlod_windows(pk, table, inv_t, miss, W, col0, out=out)
        want, wt = dw.wlod_windows_plain(pk, table, inv_t, miss, W, col0)
    else:
        win, tie = dw.wlod_windows_terms(score, inv_t, miss, W, col0,
                                         out=out)
        want, wt = dw.wlod_windows_terms_plain(score, inv_t, miss, W, col0)
    assert cuda_lod.LAUNCHES == before
    assert dw.CALLS["wlod_windows_plain"] == calls + 2
    assert win is out
    assert torch.equal(win.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tie, wt) and tie.dim() == 0
    assert float(tie) == _tie_exact(score, inv_t, col0)
    assert (win == MISSING).any() and (win != MISSING).any()


@pytest.mark.parametrize("loader", ["codes", "plane"])
@pytest.mark.parametrize("W", [1, 12, 40])
def test_wlod_windows_match_garlic_tpu(loader, W):
    """Against garlic_tpu's _wlod_chunk (codes and table) and
    _wlod_windows_dev (the plane), over its padded width: MISSING at the
    same places, live windows within rtol 1e-5, atol 1e-6, and the same
    tie scale (the band rows past nwin are zeros, so the padded windows'
    terms are 0)."""
    import jax.numpy as jnp
    from garlic_tpu.ops import device_wlod as gt_dwlod
    I, L, L2 = 29, 333, 384
    pk, table, inv_t, miss = _window_inputs(I, L, W, seed=40 + W)
    nwin, nw2 = L - W + 1, L2 - W + 1
    tp = np.zeros((4, L2), dtype=np.float32)
    tp[:, :L] = table.numpy()
    inv = np.zeros((nw2, W), dtype=np.float32)
    inv[:nwin] = inv_t.numpy().T
    mrow = np.ones((1, nw2), dtype=np.int8)
    mrow[0, :nwin] = miss.numpy()
    score = _plane(pk, table)
    if loader == "codes":
        win, tie = dw.wlod_windows(pk, table, inv_t, miss, W)
        want, wt = gt_dwlod._wlod_chunk(
            jnp.asarray(pk.numpy()), jnp.asarray(tp), jnp.asarray(inv),
            jnp.asarray(mrow), I, L, L2, W)
    else:
        win, tie = dw.wlod_windows_terms(score, inv_t, miss, W)
        sp = np.zeros((I, L2), dtype=np.float32)
        sp[:, :L] = score.numpy()
        want, wt = gt_dwlod._wlod_windows_dev(
            jnp.asarray(sp), jnp.asarray(inv), jnp.asarray(mrow), W)
    g, w = win.numpy(), np.asarray(want)[:, :nwin]
    np.testing.assert_array_equal(g == MISSING, w == MISSING)
    live = w != MISSING
    assert live.any() and (~live).any()
    np.testing.assert_allclose(g[live], w[live], rtol=1e-5, atol=1e-6)
    assert float(tie) == _tie_exact(score, inv_t, 0) == float(wt)


def test_wlod_windows_from_the_route_band_view():
    """The route's layout: ld_band_sharded's band is a [nwin, W] view of
    the assembled offset-major rows, whose reciprocal's transpose is
    contiguous; the wrapper over it gives _wlod_windows_dev's windows and
    tie scale over the [nwin, W] band, bit for bit."""
    from garlic_tpu_torch.core.types import ChromData
    from garlic_tpu_torch.parallel import engine
    from garlic_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(3)
    I, L, W = 26, 420, 15
    g, pk, _ = _codes(I, L, seed=3)
    c = ChromData(
        chrom="chr1", positions=np.cumsum(rng.integers(200, 4000, L)),
        gpos=np.cumsum(rng.random(L) * 0.01),
        locus_names=[f"r{i}" for i in range(L)], alleles=np.array(["A"] * L),
        genotypes=g, freq=np.clip(rng.beta(1, 1, L), 0.05, 0.95))
    band = engine.ld_band_sharded(c, W, False, None,
                                  make_mesh(1, 1, ["cpu"]))[(0, 0)]
    assert band.shape == (L - W + 1, W) and not band.is_contiguous()
    inv_t = 1.0 / band.T
    assert inv_t.is_contiguous()
    table = torch.from_numpy(dw.score_table(c, ERR, MU, M))
    miss = torch.from_numpy((rng.random(L - W + 1) < 0.1).astype(np.uint8))
    win, tie = dw.wlod_windows(torch.from_numpy(pk), table, inv_t, miss, W)
    score = _plane(torch.from_numpy(pk), table)
    want, wt = dw._wlod_windows_dev(score, 1.0 / band, miss, W)
    assert torch.equal(win.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tie, wt)


def _tie_per_block(score, inv_t, col0, rows, tile=128, chunk=64):
    """K6's tie scale as the kernel forms it: per block of `rows` rows and
    tile of `tile` window starts, the largest finite |score| of each
    column over the block's rows (0 when none), times |1/LD| for each
    (start, offset) of the tile, chunk by chunk of offsets, non-finite
    products dropped; the max over blocks and tiles."""
    W, nwin = inv_t.shape
    s = score[:, col0:col0 + nwin + W - 1].abs()
    s = torch.where(torch.isfinite(s), s, torch.zeros((), dtype=s.dtype))
    best = torch.zeros((), dtype=torch.float32)
    for r0 in range(0, score.shape[0], rows):
        cm = s[r0:r0 + rows].amax(0)
        for l0 in range(0, nwin, tile):
            for j0 in range(0, W, chunk):
                for j in range(j0, min(W, j0 + chunk)):
                    q = cm[l0 + j:min(nwin, l0 + tile) + j] \
                        * inv_t[j, l0:l0 + tile].abs()
                    q = q[torch.isfinite(q)]
                    if q.numel():
                        best = torch.maximum(best, q.max())
    return best


@pytest.mark.parametrize("W", [1, 9, 70])
def test_tie_scale_per_block_equals_plain(W):
    """The tie scale from one column maximum over each block's rows
    (K6's formula, combined over blocks by max) equals the plain
    version's over all rows, with +inf, -inf and NaN scores, columns
    where every row is missing (score 0), and inf / NaN entries of 1/LD,
    for blocks of 8, 40 and all rows."""
    rng = np.random.default_rng(W)
    I, col0 = 45, 2
    L = 300 + col0 + W - 1
    score = rng.normal(0.0, 3.0, (I, L)).astype(np.float32)
    score[rng.random((I, L)) < 0.02] = np.inf
    score[rng.random((I, L)) < 0.02] = -np.inf
    score[rng.random((I, L)) < 0.02] = np.nan
    score[:, 50:53] = 0.0  # every row missing
    score[:, 7] = np.inf   # no finite score at all
    nwin = L - col0 - W + 1
    inv_t = rng.uniform(0.05, 1.0, (W, nwin)).astype(np.float32)
    inv_t[rng.random((W, nwin)) < 0.01] = np.inf
    inv_t[rng.random((W, nwin)) < 0.01] = np.nan
    score, inv_t = torch.from_numpy(score), torch.from_numpy(inv_t)
    miss = torch.zeros(nwin, dtype=torch.uint8)
    _, want = dw.wlod_windows_terms_plain(score, inv_t, miss, W, col0)
    for rows in (8, 40, I):
        got = _tie_per_block(score, inv_t, col0, rows)
        assert float(got) == float(want) > 0.0


def test_no_rows():
    """n = 0: the planes stay as they are; the windows are [0, nwin] and
    the tie scale 0, with no launch."""
    W, L = 9, 100
    T, X = _planes(W, L, fill=4)
    before = dict(cuda_lod.LAUNCHES)
    dw.pair_counts(torch.zeros((0, 25), dtype=torch.uint8), None, T, X, W)
    dw.pair_counts(torch.zeros((0, 25), dtype=torch.uint8),
                   torch.zeros((0, 13), dtype=torch.uint8), T, X, W)
    assert (T == 4).all() and (X == 4).all()
    _, table, inv_t, miss = _window_inputs(1, L, W, seed=1)
    win, tie = dw.wlod_windows(torch.zeros((0, 25), dtype=torch.uint8),
                               table, inv_t, miss, W)
    assert win.shape == (0, L - W + 1) and float(tie) == 0.0
    win, tie = dw.wlod_windows_terms(torch.zeros((0, L)), inv_t, miss, W)
    assert win.shape == (0, L - W + 1) and float(tie) == 0.0
    assert cuda_lod.LAUNCHES == before


# ---------------------------------------------------------------------------
# Bad inputs
# ---------------------------------------------------------------------------

def _pair_args():
    _, pk, fc = _codes(6, 50, seed=4)
    T, X = _planes(7, 50)
    return dict(packed=torch.from_numpy(pk),
                fcbits=torch.from_numpy(dw.pack_first_copy(fc)), T=T, X=X,
                winsize=7)


def _win_args():
    pk, table, inv_t, miss = _window_inputs(6, 50, 7, seed=4)
    return dict(packed=pk, table=table, inv_t=inv_t, miss=miss, winsize=7)


def _terms_args():
    a = _win_args()
    return dict(score=_plane(a["packed"], a["table"]), inv_t=a["inv_t"],
                miss=a["miss"], winsize=7)


# (wrapper, argument builder, change, error)
BAD = {
    "pairs_dtype": (dw.pair_counts, _pair_args,
                    lambda a: a.update(packed=a["packed"].to(torch.int8)),
                    TypeError),
    "pairs_plane_dtype": (dw.pair_counts, _pair_args,
                          lambda a: a.update(T=a["T"].long()), TypeError),
    "pairs_shape": (dw.pair_counts, _pair_args,
                    lambda a: a.update(packed=a["packed"][:, :-1]
                                       .contiguous()), ValueError),
    "pairs_fc_shape": (dw.pair_counts, _pair_args,
                       lambda a: a.update(fcbits=a["fcbits"][:-1]),
                       TypeError),
    "pairs_noncontiguous": (dw.pair_counts, _pair_args,
                            lambda a: a.update(T=a["T"].t().contiguous().t()),
                            ValueError),
    "pairs_strided": (dw.pair_counts, _pair_args,
                      lambda a: a.update(packed=torch.cat(
                          [a["packed"], a["packed"]], 1)[:, ::2]),
                      ValueError),
    "pairs_devices": (dw.pair_counts, _pair_args,
                      lambda a: a.update(X=a["X"].to("meta")), ValueError),
    "pairs_w0": (dw.pair_counts, _pair_args,
                 lambda a: a.update(winsize=0), ValueError),
    "win_dtype": (dw.wlod_windows, _win_args,
                  lambda a: a.update(table=a["table"].double()), TypeError),
    "win_inv_shape": (dw.wlod_windows, _win_args,
                      lambda a: a.update(inv_t=a["inv_t"][:-1]), TypeError),
    "win_miss_shape": (dw.wlod_windows, _win_args,
                       lambda a: a.update(miss=a["miss"][:-1]), TypeError),
    "win_noncontiguous": (dw.wlod_windows, _win_args,
                          lambda a: a.update(inv_t=torch.cat(
                              [a["inv_t"]] * 2, 1)[:, ::2]), ValueError),
    "win_devices": (dw.wlod_windows, _win_args,
                    lambda a: a.update(miss=a["miss"].to("meta")),
                    ValueError),
    "win_w0": (dw.wlod_windows, _win_args,
               lambda a: a.update(winsize=0), ValueError),
    "win_too_wide": (dw.wlod_windows, _win_args,
                     lambda a: a.update(col0=1), ValueError),
    "terms_dtype": (dw.wlod_windows_terms, _terms_args,
                    lambda a: a.update(score=a["score"].double()),
                    TypeError),
    "terms_noncontiguous": (dw.wlod_windows_terms, _terms_args,
                            lambda a: a.update(score=torch.cat(
                                [a["score"]] * 2, 1)[:, ::2]), ValueError),
    "terms_devices": (dw.wlod_windows_terms, _terms_args,
                      lambda a: a.update(inv_t=a["inv_t"].to("meta")),
                      ValueError),
    "terms_w0": (dw.wlod_windows_terms, _terms_args,
                 lambda a: a.update(winsize=0), ValueError),
}


@pytest.mark.parametrize("name", list(BAD))
def test_wrappers_reject_bad_inputs(name):
    fn, build, change, err = BAD[name]
    args = build()
    fn(**args)  # the unchanged arguments are accepted
    args = build()
    change(args)
    with pytest.raises(err):
        fn(**args)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


WS = [1, 2, 59, 60, 61, 120, 300]
IS = [1, 31, 33, 200]
L_ODD = 4001


@pytest.mark.gpu
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("I", IS)
def test_pair_counts_on_card_equal_plain(cuda_device, phased, W, I):
    """K5 against its plain version, exact, accumulating into planes
    that already hold counts, on an odd L; one launch."""
    g, pk, fc = _codes(I, L_ODD, seed=I * 1000 + W)
    fcb = torch.from_numpy(dw.pack_first_copy(fc)).to(cuda_device) \
        if phased else None
    T, X = _planes(W, L_ODD, cuda_device, fill=3)
    before = cuda_lod.LAUNCHES["pair_counts"]
    dw.pair_counts(torch.from_numpy(pk).to(cuda_device), fcb, T, X, W)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["pair_counts"] == before + 1
    gt = torch.from_numpy(g)
    t, x = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    assert torch.equal(T.cpu(), t + 3) and torch.equal(X.cpu(), x + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("loader", ["codes", "plane"])
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("I", IS)
def test_wlod_windows_on_card_equal_plain(cuda_device, loader, W, I):
    """K6 against its plain version on the card: windows and tie scale
    bit for bit, from a column offset, on an odd L; one launch."""
    col0 = 3
    pk, table, inv_t, miss = (t.to(cuda_device) for t in _window_inputs(
        I, L_ODD, W, seed=I + W, col0=col0))
    before = cuda_lod.LAUNCHES["wlod_windows"]
    if loader == "codes":
        win, tie = dw.wlod_windows(pk, table, inv_t, miss, W, col0)
        want, wt = dw.wlod_windows_plain(pk, table, inv_t, miss, W, col0)
    else:
        score = _plane(pk, table)
        win, tie = dw.wlod_windows_terms(score, inv_t, miss, W, col0)
        want, wt = dw.wlod_windows_terms_plain(score, inv_t, miss, W, col0)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["wlod_windows"] == before + 1
    assert torch.equal(win.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tie, wt)


@pytest.mark.gpu
def test_no_rows_on_card(cuda_device):
    """No rows: nothing launched, the planes untouched."""
    T, X = _planes(9, 100, cuda_device, fill=2)
    before = dict(cuda_lod.LAUNCHES)
    dw.pair_counts(torch.zeros((0, 25), dtype=torch.uint8,
                               device=cuda_device), None, T, X, 9)
    _, table, inv_t, miss = (t.to(cuda_device)
                             for t in _window_inputs(1, 100, 9, seed=1))
    win, tie = dw.wlod_windows(torch.zeros((0, 25), dtype=torch.uint8,
                                           device=cuda_device),
                               table, inv_t, miss, 9)
    assert cuda_lod.LAUNCHES == before
    assert (T == 2).all() and win.shape == (0, 92) and float(tie) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("I", IS)
def test_pair_counts_on_card_store_mode(cuda_device, phased, W, I):
    """K5 with fresh=True: planes holding anything come out as the plain
    counts exactly (0 in row 0 and past L - d); one launch."""
    g, pk, fc = _codes(I, L_ODD, seed=I * 7 + W)
    fcb = torch.from_numpy(dw.pack_first_copy(fc)).to(cuda_device) \
        if phased else None
    T, X = _planes(W, L_ODD, cuda_device, fill=-77)
    before = cuda_lod.LAUNCHES["pair_counts"]
    dw.pair_counts(torch.from_numpy(pk).to(cuda_device), fcb, T, X, W,
                   fresh=True)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["pair_counts"] == before + 1
    gt = torch.from_numpy(g)
    t, x = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    assert torch.equal(T.cpu(), t) and torch.equal(X.cpu(), x)


@pytest.mark.gpu
@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
@pytest.mark.parametrize("C", [8, 64, 200, 300])
def test_pair_counts_on_card_row_chunks(cuda_device, phased, C):
    """The route's chunked counts on the card (the first chunk stored, the
    later ones added; 300 rows: two of K5's 256-row tiles in one launch
    at C=300) equal the plain counts of all rows."""
    I, L, W = 300, 2999, 61
    g, pk, fc = _codes(I, L, seed=C + phased)
    before = cuda_lod.LAUNCHES["pair_counts"]
    T, X = dw._pair_counts_chunked(torch.from_numpy(pk).to(cuda_device),
                                   fc if phased else None, L, W, C)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["pair_counts"] == before + -(-I // C)
    gt = torch.from_numpy(g)
    t, x = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    assert torch.equal(T.cpu(), t) and torch.equal(X.cpu(), x)


def _on_card_windows(loader, pk, table, inv_t, miss, W, col0, out=None):
    """(kernel's (win, tie), plain version's (win, tie)) on the card."""
    if loader == "codes":
        return (dw.wlod_windows(pk, table, inv_t, miss, W, col0, out=out),
                dw.wlod_windows_plain(pk, table, inv_t, miss, W, col0))
    score = _plane(pk, table)
    return (dw.wlod_windows_terms(score, inv_t, miss, W, col0, out=out),
            dw.wlod_windows_terms_plain(score, inv_t, miss, W, col0))


@pytest.mark.gpu
@pytest.mark.parametrize("loader", ["codes", "plane"])
@pytest.mark.parametrize("W", [1, 60, 65, 300])
@pytest.mark.parametrize("L,col0", [(4001, 0), (4002, 1), (4003, 2),
                                    (4004, 130), (4133, 129)])
def test_wlod_windows_on_card_shapes(cuda_device, loader, W, L, col0):
    """K6 bit for bit against its plain version with odd and even L and
    nwin and column offsets inside and past the first tile of 128 (the
    codes' rows and the plane's rows start off 16-byte boundaries)."""
    pk, table, inv_t, miss = (t.to(cuda_device) for t in _window_inputs(
        37, L, W, seed=L + W + col0, col0=col0))
    (win, tie), (want, wt) = _on_card_windows(loader, pk, table, inv_t, miss,
                                              W, col0)
    torch.cuda.synchronize()
    assert torch.equal(win.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tie, wt)


@pytest.mark.gpu
@pytest.mark.parametrize("loader", ["codes", "plane"])
@pytest.mark.parametrize("C", [8, 33, 200])
def test_wlod_windows_on_card_row_chunks(cuda_device, loader, C):
    """The route's row chunks (each launch writing its rows of one output,
    a row slice whose first row is not 16-byte aligned) give the
    one-launch windows bit for bit, and the max of the chunks' tie
    scales is the one launch's."""
    I, L, W = 200, 3001, 60
    pk, table, inv_t, miss = (t.to(cuda_device) for t in _window_inputs(
        I, L, W, seed=C))
    win = torch.empty((I, L - W + 1), dtype=torch.float32,
                      device=cuda_device)
    ties = []
    for r in range(0, I, C):
        if loader == "codes":
            _, t = dw.wlod_windows(pk[r:r + C], table, inv_t, miss, W,
                                   out=win[r:r + C])
        else:
            _, t = dw.wlod_windows_terms(_plane(pk[r:r + C], table), inv_t,
                                         miss, W, out=win[r:r + C])
        ties.append(t)
    (_, _), (want, wt) = _on_card_windows(loader, pk, table, inv_t, miss, W,
                                          0)
    torch.cuda.synchronize()
    assert torch.equal(win.view(torch.int32), want.view(torch.int32))
    assert torch.equal(torch.stack(ties).amax(), wt)


@pytest.mark.gpu
@pytest.mark.parametrize("loader", ["codes", "plane"])
@pytest.mark.parametrize("W", [1, 60, 120])
def test_wlod_windows_on_card_nonfinite(cuda_device, loader, W):
    """Non-finite scores (table entries of +inf, -inf and NaN for the codes,
    plane entries for the plane) and columns where every row is missing:
    the windows equal the plain version's (NaN at the same places, every
    other value bit for bit) and the tie scale is the plain one, the
    largest finite term."""
    I, L, col0 = 41, 2003, 1
    pk, table, inv_t, miss = _window_inputs(I, L, W, seed=W, col0=col0)
    g = cuda_lod.decode_2bit(pk, L)
    g[:, 100:104] = -9  # columns where every row is missing
    pk = torch.from_numpy(cuda_lod.pack_codes(g.numpy()))
    table = table.clone()
    table[0, 10], table[1, 500], table[2, 900] = np.inf, -np.inf, np.nan
    pk, table, inv_t, miss = (t.to(cuda_device)
                              for t in (pk, table, inv_t, miss))
    if loader == "codes":
        win, tie = dw.wlod_windows(pk, table, inv_t, miss, W, col0)
        want, wt = dw.wlod_windows_plain(pk, table, inv_t, miss, W, col0)
    else:
        score = _plane(pk, table)
        score[3, 1200], score[7, 1700] = np.inf, np.nan
        win, tie = dw.wlod_windows_terms(score, inv_t, miss, W, col0)
        want, wt = dw.wlod_windows_terms_plain(score, inv_t, miss, W, col0)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(win), nan)
    assert torch.equal(win[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    assert torch.equal(tie, wt) and torch.isfinite(tie)


@pytest.mark.parametrize("phased", [False, True], ids=["hr2", "r2"])
def test_library_yardsticks_compute_the_kernels_function(phased):
    """chip_smoke.py's one-call yardsticks (timed beside K5 and K6, never
    called by the port) compute the kernels' functions: the f16 einsum's
    planes equal the plain counts past row 0, and the f32 einsum's
    windows equal the plain windows where no window is masked, within
    rtol 1e-5 (another summation order)."""
    import chip_smoke
    I, L, W = 23, 311, 13
    g, pk, fc = _codes(I, L, seed=31 + phased)
    gt = torch.from_numpy(g)
    got = chip_smoke.library_pairs(gt, torch.from_numpy(fc) if phased
                                   else None, W)().float()
    want = (dw._r2_counts(gt, torch.from_numpy(fc), W) if phased
            else dw._hr2_counts(gt, W))
    for k in range(2):
        assert torch.equal(got[k, 1:].round().int(), want[k][1:])
    pkt, table, inv_t, miss = _window_inputs(I, L, W, seed=5)
    score = _plane(pkt, table)
    win = chip_smoke.library_windows(score, inv_t)()
    plain, _ = dw.wlod_windows_terms_plain(score, inv_t,
                                           torch.zeros_like(miss), W)
    np.testing.assert_allclose(win.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
