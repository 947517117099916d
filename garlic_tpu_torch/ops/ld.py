"""Banded LD matrix engine for the weighted (wLOD) path.

The reference computes LD[locus][j] = sum over the window [locus, locus+W-1]
of pairwise LD between site locus+j and every window member (self term = 1),
recomputing each pairwise value in every window that contains the pair —
O(L*W^2*I) (src/garlic-data.cpp:330-646, pthread fan-out over locus ranges).

Here the pairwise values are computed ONCE into a banded matrix
P[m, delta] = ld(m, m+delta), delta in [1, W-1] — O(L*W*I), vectorized over
individuals — and the window sums are assembled from the band.  Two
assembly orders:

* exact: replicates the reference's k-loop summation order per entry
  (W^2 vectorized adds over L) so float64 LD matches bit-for-bit;
* fast: cumsum decomposition LD[l][j] = 1 + D[l+j, j] + S[l+j, W-1-j]
  (O(L*W) adds), the order of the device band (ops/device_wlod.py).

Pairwise definitions:
* unphased HR^2 (src/garlic-data.cpp:558-583): homozygote-homozygote
  covariance squared over HA(1-HA)HB(1-HB), with HA/HB the full-panel
  homozygosity frequencies and the joint count over the LD subsample;
* phased r^2 (src/garlic-data.cpp:585-617): haplotype x11 frequency from
  genotype pairs + firstCopy bits.

Copy of garlic_tpu/ops/ld.py: the port imports nothing of garlic_tpu.
Each function names its source line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def geno_hom_counts(genotypes: np.ndarray):
    """(hom, total) int64 [L] count planes behind geno_hom_freq — exact
    integers, so per-host partials sum across a cluster and one division
    reproduces the full-panel frequency bit-for-bit.

    Copy of garlic_tpu/ops/ld.py:34."""
    valid = genotypes != -9
    hom = valid & (genotypes != 1)
    return hom.sum(axis=0).astype(np.int64), valid.sum(axis=0).astype(np.int64)


def geno_hom_freq_from_counts(hom: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Copy of garlic_tpu/ops/ld.py:43."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return hom.astype(np.float64) / total.astype(np.float64)


def geno_hom_freq(genotypes: np.ndarray) -> np.ndarray:
    """Per-locus frequency of homozygous genotypes over non-missing calls
    (calculateGenoFreq, src/garlic-data.cpp:656-676).  total==0 yields nan,
    as in the reference (0/0).

    Copy of garlic_tpu/ops/ld.py:48."""
    hom, total = geno_hom_counts(genotypes)
    return geno_hom_freq_from_counts(hom, total)


def pair_counts_hr2(genotypes: np.ndarray, winsize: int,
                    sub_idx: Optional[np.ndarray] = None):
    """(num, den) int64 [L, winsize] joint count planes: num[m, d] =
    #(both hom at m, m+d), den[m, d] = #(both valid), d in [1, W-1] —
    exact integers, so partials over row blocks sum and the divisions
    below reproduce the full-panel pair LD bit-for-bit.

    Copy of garlic_tpu/ops/ld.py:56."""
    g = genotypes if sub_idx is None else genotypes[sub_idx]
    I, L = g.shape
    valid = (g != -9)
    homv = valid & (g != 1)
    num = np.zeros((L, winsize), dtype=np.int64)
    den = np.zeros((L, winsize), dtype=np.int64)
    for d in range(1, winsize):
        if d >= L:
            break
        num[:L - d, d] = (homv[:, :-d] & homv[:, d:]).sum(axis=0)
        den[:L - d, d] = (valid[:, :-d] & valid[:, d:]).sum(axis=0)
    return num, den


def pair_ld_hr2_from_counts(num: np.ndarray, den: np.ndarray,
                            hom_freq: np.ndarray,
                            winsize: int) -> np.ndarray:
    """P from the joint count planes — the exact arithmetic sequence of
    the fused pair_ld_hr2 (hr2, src/garlic-data.cpp:558-583).

    Copy of garlic_tpu/ops/ld.py:77."""
    L = num.shape[0]
    P = np.zeros((L, winsize), dtype=np.float64)
    HA = hom_freq
    ok_h = (HA > 0) & (HA < 1)
    denom_h = HA * (1.0 - HA)
    for d in range(1, winsize):
        if d >= L:
            break
        total = den[:L - d, d].astype(np.float64)
        hab = num[:L - d, d].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            hab = hab / total
            h = hab - HA[:-d] * HA[d:]
            hr2 = (h * h) / (denom_h[:-d] * denom_h[d:])
        hr2 = np.where(hr2 > 1, 1.0, hr2)
        hr2 = np.where(ok_h[:-d] & ok_h[d:], hr2, 0.0)
        P[:L - d, d] = hr2
    return P


def pair_ld_hr2(genotypes: np.ndarray, hom_freq: np.ndarray, winsize: int,
                sub_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """P [L, W] float64 with P[m, d] = hr2(m, m+d) for d in [1, W-1]
    (P[:, 0] unused; out-of-range entries 0).

    Copy of garlic_tpu/ops/ld.py:102."""
    num, den = pair_counts_hr2(genotypes, winsize, sub_idx)
    return pair_ld_hr2_from_counts(num, den, hom_freq, winsize)


def pair_counts_r2(genotypes: np.ndarray, first_copy: np.ndarray,
                   winsize: int,
                   sub_idx: Optional[np.ndarray] = None):
    """(x11, bv) int64 [L, winsize] count planes for the phased r2 pair
    LD: x11[m, d] = the haplotype-count accumulation
    (src/garlic-data.cpp:594-607), bv[m, d] = #(both valid) — exact
    integers, summable across row blocks.

    Copy of garlic_tpu/ops/ld.py:110."""
    g = genotypes if sub_idx is None else genotypes[sub_idx]
    fc = first_copy if sub_idx is None else first_copy[sub_idx]
    I, L = g.shape
    valid = (g != -9)
    x11p = np.zeros((L, winsize), dtype=np.int64)
    bvp = np.zeros((L, winsize), dtype=np.int64)
    g2 = (g == 2)
    g1 = (g == 1)
    for d in range(1, winsize):
        if d >= L:
            break
        bv = valid[:, :-d] & valid[:, d:]
        a2, b2 = g2[:, :-d], g2[:, d:]
        a1, b1 = g1[:, :-d], g1[:, d:]
        same_fc = fc[:, :-d] == fc[:, d:]
        x11 = (2 * (a2 & b2) + (a1 & b2) + (a2 & b1)
               + (a1 & b1 & same_fc)).astype(np.int64)
        x11p[:L - d, d] = np.where(bv, x11, 0).sum(axis=0)
        bvp[:L - d, d] = bv.sum(axis=0)
    return x11p, bvp


def pair_ld_r2_from_counts(x11p: np.ndarray, bvp: np.ndarray,
                           freq: np.ndarray, winsize: int) -> np.ndarray:
    """P from the phased count planes — the exact arithmetic sequence of
    the fused pair_ld_r2 (r2, src/garlic-data.cpp:585-617).

    Copy of garlic_tpu/ops/ld.py:139."""
    L = x11p.shape[0]
    P = np.zeros((L, winsize), dtype=np.float64)
    p = freq
    ok = (p > 0) & (p < 1)
    denom = p * (1.0 - p)
    for d in range(1, winsize):
        if d >= L:
            break
        x11 = x11p[:L - d, d].astype(np.float64)
        total = 2.0 * bvp[:L - d, d].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            x11 = x11 / total
            D = x11 - p[:-d] * p[d:]
            r2 = (D * D) / (denom[:-d] * denom[d:])
        r2 = np.where(r2 > 1, 1.0, r2)
        r2 = np.where(ok[:-d] & ok[d:], r2, 0.0)
        P[:L - d, d] = r2
    return P


def pair_ld_r2(genotypes: np.ndarray, first_copy: np.ndarray,
               freq: np.ndarray, winsize: int,
               sub_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """P [L, W] float64 with P[m, d] = r2(m, m+d) (phased path).

    Copy of garlic_tpu/ops/ld.py:163."""
    x11p, bvp = pair_counts_r2(genotypes, first_copy, winsize, sub_idx)
    return pair_ld_r2_from_counts(x11p, bvp, freq, winsize)


def _pair_lookup(P: np.ndarray, m: np.ndarray, k: np.ndarray) -> np.ndarray:
    """ld(site m, site k) from the symmetric band: P[min(m,k), |m-k|].

    Copy of garlic_tpu/ops/ld.py:171."""
    lo = np.minimum(m, k)
    d = np.abs(m - k)
    return np.where(d == 0, 1.0, P[lo, d])


def assemble_ld_exact(P: np.ndarray, winsize: int) -> np.ndarray:
    """LD [nwin_slots, W] with the reference's per-entry k-loop order:
    LD[l][j] = sum_{k=l}^{l+W-1} ld(k, l+j)  (ldHR2/ldR2,
    src/garlic-data.cpp:521-535).  Rows beyond the last full window are left
    0 (never touched by the reference either).

    Copy of garlic_tpu/ops/ld.py:178."""
    L = P.shape[0]
    nwin = L - winsize + 1
    LD = np.zeros((L, winsize), dtype=np.float64)
    if nwin <= 0:
        return LD
    l = np.arange(nwin)
    for j in range(winsize):
        site = l + j
        acc = np.zeros(nwin, dtype=np.float64)
        for c in range(winsize):
            acc = acc + _pair_lookup(P, l + c, site)
        LD[:nwin, j] = acc
    return LD


def assemble_ld_exact_rows(P: np.ndarray, winsize: int,
                           rows: np.ndarray) -> np.ndarray:
    """assemble_ld_exact restricted to the given window-start rows —
    identical per-entry k-loop summation order (ldHR2/ldR2,
    src/garlic-data.cpp:521-535), O(len(rows)*W^2) instead of O(L*W^2).
    Used by the weighted exact Phase-II sampler, which only needs the
    band at thinned window positions (every winsize-th row).

    Copy of garlic_tpu/ops/ld.py:198."""
    l = np.asarray(rows, dtype=np.int64)
    LD = np.zeros((l.size, winsize), dtype=np.float64)
    for j in range(winsize):
        site = l + j
        acc = np.zeros(l.size, dtype=np.float64)
        for c in range(winsize):
            acc = acc + _pair_lookup(P, l + c, site)
        LD[:, j] = acc
    return LD


def pair_ld(chrom, winsize: int, phased: bool,
            sub_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """The pairwise band P alone (calc_ld's first stage) — callers that
    need exact LD at selected rows assemble from it with
    assemble_ld_exact_rows / assemble_ld_exact.

    Copy of garlic_tpu/ops/ld.py:216."""
    if phased:
        return pair_ld_r2(chrom.genotypes, chrom.first_copy, chrom.freq,
                          winsize, sub_idx)
    hf = geno_hom_freq(chrom.genotypes)
    return pair_ld_hr2(chrom.genotypes, hf, winsize, sub_idx)


def assemble_ld_fast(P: np.ndarray, winsize: int) -> np.ndarray:
    """Cumsum decomposition (same values, different f64 rounding):
    LD[l][j] = 1 + sum_{d=1}^{j} P[l+j-d, d] + sum_{d=1}^{W-1-j} P[l+j, d].

    Copy of garlic_tpu/ops/ld.py:228."""
    L = P.shape[0]
    W = winsize
    nwin = L - W + 1
    LD = np.zeros((L, W), dtype=np.float64)
    if nwin <= 0:
        return LD
    # S[m, j] = sum_{d=1}^{j} P[m, d]
    S = np.cumsum(P, axis=1)
    # D[m, j] = sum_{d=1}^{j} P[m-d, d]
    D = np.zeros((L, W), dtype=np.float64)
    for j in range(1, W):
        D[j:, j] = D[j:, j - 1] + P[:-j, j]
    l = np.arange(nwin)
    for j in range(W):
        m = l + j
        LD[:nwin, j] = 1.0 + D[m, j] + S[m, W - 1 - j]
    return LD


def calc_ld(chrom, winsize: int, phased: bool,
            sub_idx: Optional[np.ndarray] = None,
            engine: str = "exact") -> np.ndarray:
    """Full LD matrix for one chromosome (calcLDData per-chr step,
    src/garlic-data.cpp:330-375).

    Copy of garlic_tpu/ops/ld.py:250."""
    P = pair_ld(chrom, winsize, phased, sub_idx)
    if engine == "fast":
        return assemble_ld_fast(P, winsize)
    return assemble_ld_exact(P, winsize)
