"""Phase I host code: LOD terms, gap/centromere masks and the exact engine.

JAX-free copies of garlic_tpu/ops/lod.py, whose module imports JAX (the
fast path is decorated with jax.jit at import time).  The tie patrol and
the exact engine run these; the fast engine's window sums live in
ops/cuda_lod.py.  Each function names its source line.
"""

from __future__ import annotations

import numpy as np

from ..core.types import MISSING


# copy of garlic_tpu/ops/lod.py:42
def lod_terms(geno: np.ndarray, freq: np.ndarray,
              error, dtype=np.float64) -> np.ndarray:
    """Elementwise lod(genotype, freq, error) over [I, L].

    `error` is a scalar or an [I, L] array (TGLS per-genotype error).
    Branch-free evaluation with the reference's exact operation order per
    branch so float64 results are bit-identical to the C++ scalar code."""
    geno = np.asarray(geno)
    freq = np.asarray(freq, dtype=np.float64)
    e = np.asarray(error, dtype=np.float64)
    one_minus = 1.0 - freq
    with np.errstate(divide="ignore", invalid="ignore"):
        non0 = one_minus * one_minus
        aut0 = (1.0 - e) * one_minus + e * non0
        non1 = 2.0 * freq * one_minus
        aut1 = e * non1
        non2 = freq * freq
        aut2 = (1.0 - e) * freq + e * non2
        r0 = np.log10(aut0 / non0)
        r1 = np.log10(aut1 / non1)
        r2 = np.log10(aut2 / non2)
    out = np.zeros(np.broadcast_shapes(geno.shape, r0.shape), dtype=np.float64)
    np.copyto(out, r0, where=(geno == 0))
    np.copyto(out, r1, where=(geno == 1))
    np.copyto(out, r2, where=(geno == 2))
    # monomorphic sites score 0 for every genotype (freq==0 or freq==1)
    mono = (freq == 0.0) | (freq == 1.0)
    out = np.where(mono, 0.0, out)
    return out.astype(dtype, copy=False)


_lod_table_cache = {}  # id(freq) -> (freq strong ref, error, table)


# copy of garlic_tpu/ops/lod.py:76
def lod_table(freq: np.ndarray, error: float) -> np.ndarray:
    """[4, L] float64 table of lod values for genotype classes 0,1,2,missing.

    Only valid for scalar error (no TGLS).  Results cache per freq ARRAY
    identity: the chunked exact paths (tie repair) rebuild subset
    chromosomes that share the parent's freq object, so the table is
    computed once per (chromosome, error).  The cached entry holds a
    strong reference to the freq array, so its id cannot be reused while
    the entry lives."""
    key = id(freq)
    hit = _lod_table_cache.get(key)
    if hit is not None and hit[0] is freq and hit[1] == error:
        return hit[2]
    L = freq.shape[0]
    p = np.asarray(freq, dtype=np.float64)
    e = np.float64(error)
    one_minus = 1.0 - p
    with np.errstate(divide="ignore", invalid="ignore"):
        non0 = one_minus * one_minus
        aut0 = (1.0 - e) * one_minus + e * non0
        non1 = 2.0 * p * one_minus
        aut1 = e * non1
        non2 = p * p
        aut2 = (1.0 - e) * p + e * non2
        r0 = np.log10(aut0 / non0)
        r1 = np.log10(aut1 / non1)
        r2 = np.log10(aut2 / non2)
    mono = (p == 0.0) | (p == 1.0)
    table = np.zeros((4, L), dtype=np.float64)
    table[0] = np.where(mono, 0.0, r0)
    table[1] = np.where(mono, 0.0, r1)
    table[2] = np.where(mono, 0.0, r2)
    if len(_lod_table_cache) >= 4:  # tiny LRU: panels have few chroms live
        _lod_table_cache.pop(next(iter(_lod_table_cache)))
    _lod_table_cache[key] = (freq, error, table)
    return table


# copy of garlic_tpu/ops/lod.py:122
def in_gap(q_start, q_end, t_start, t_end):
    """inGap (src/garlic-roh.cpp:11-16): query interval touches target."""
    return (((t_start <= q_start) & (t_end >= q_start)) |
            ((t_start <= q_end) & (t_end >= q_end)) |
            ((t_start >= q_start) & (t_end <= q_end)))


# copy of garlic_tpu/ops/lod.py:129
def pair_breaks(positions: np.ndarray, max_gap: int, cstart: int,
                cend: int) -> np.ndarray:
    """bool [L]: breaks[i] = adjacent pair (i-1, i) violates the gap or
    centromere test. breaks[0] is False (no previous locus)."""
    pos = np.asarray(positions, dtype=np.int64)
    b = np.zeros(pos.shape[0], dtype=bool)
    if pos.shape[0] > 1:
        p0 = pos[:-1]
        p1 = pos[1:]
        b[1:] = (p1 - p0 > max_gap) | in_gap(p0, p1, cstart, cend)
    return b


# copy of garlic_tpu/ops/lod.py:142
def window_missing_mask(positions: np.ndarray, winsize: int, max_gap: int,
                        cstart: int, cend: int) -> np.ndarray:
    """bool [nwin]: True where window l (starting locus l) is MISSING.

    nwin = max(L - winsize + 1, 0).  Window l is missing iff its first locus
    is inside the centromere (the i==locus self-pair check,
    src/garlic-roh.cpp:58-61) or any pair break falls in (l, l+W-1]."""
    pos = np.asarray(positions, dtype=np.int64)
    L = pos.shape[0]
    nwin = L - winsize + 1
    if nwin <= 0:
        return np.zeros(0, dtype=bool)
    b = pair_breaks(pos, max_gap, cstart, cend)
    csum = np.concatenate([[0], np.cumsum(b.astype(np.int64))])
    # breaks in (l, l+W-1]  <=>  csum[l+W] - csum[l+1] > 0
    any_break = (csum[winsize:winsize + nwin] - csum[1:nwin + 1]) > 0
    first_in_centro = (pos[:nwin] >= cstart) & (pos[:nwin] <= cend)
    return any_break | first_in_centro


# adapted from garlic_tpu/ops/lod.py:166: the native library is required
def lod_windows_exact(terms: np.ndarray, missing: np.ndarray,
                      winsize: int) -> np.ndarray:
    """win [I, L] float64 (MISSING-padded) from per-locus terms [I, L].

    Reproduces the rolling-sum order of calcLOD (src/garlic-roh.cpp:46-126):
    the first window of each non-missing run is a fresh left-to-right sum;
    subsequent windows are (prev - head) + tail."""
    from ..native import lod_windows_exact_native
    return lod_windows_exact_native(terms, missing, winsize)


# adapted from the exact branch of garlic_tpu/ops/lod.py:310
# (calc_lod_windows): the native library is required; the fast engine is
# parallel/engine.lod_windows_sharded
def calc_lod_windows(chrom, centro, winsize: int, error: float,
                     max_gap: int, use_gl: bool = False,
                     bar=None) -> np.ndarray:
    """Exact f64 Phase-I window matrix [I, L] for one chromosome.

    Mirrors calcLOD/calcLODWindows (src/garlic-roh.cpp:18-132,279-309).
    use_gl: per-genotype TGLS errors (chrom.gl) replace `error`.
    bar: optional core.pbar.Bar advanced as individuals complete (the
    reference ticks once per individual, src/garlic-roh.cpp:48)."""
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    missing = window_missing_mask(chrom.positions, winsize, max_gap,
                                  cstart, cend)
    if not use_gl:
        # table-driven native kernel: same per-(genotype, locus) f64
        # values, no [I, L] terms materialization
        from ..native import lod_windows_exact_tbl_native
        table = lod_table(chrom.freq, error)
        I = chrom.genotypes.shape[0]
        if bar is None or I <= 1:
            return lod_windows_exact_tbl_native(chrom.genotypes, table,
                                                missing, winsize)
        # tick as individuals complete: chunk the kernel over individual
        # blocks (rows are independent; OpenMP still fans out within each
        # block)
        step = max(1, -(-I // 8))
        outs = []
        for s in range(0, I, step):
            outs.append(lod_windows_exact_tbl_native(
                chrom.genotypes[s:s + step], table, missing, winsize))
            bar.advance(min(step, I - s))
        return np.concatenate(outs, axis=0)
    terms = lod_terms(chrom.genotypes, chrom.freq, chrom.gl)
    win = lod_windows_exact(terms, missing, winsize)
    if bar is not None:
        bar.advance(chrom.genotypes.shape[0])
    return win
