"""Phase I, weighted variant (wLOD), on the host in f64.

Reproduces calcwLOD/parallelwLOD (src/garlic-roh.cpp:134-277): the per-locus
score is lod * nomut * norec where

    nomut(M, mu, d_bp) = exp(-2*M*mu*d_bp)     (src/garlic-roh.cpp:134-136)
    norec(M, d_cM)     = exp(-2*M*d_cM)        (src/garlic-roh.cpp:138-140)

with d the interval to the previous locus (the locus's own position at the
chromosome start), and window l sums score[i] / LD[l][i-l] over the window —
no rolling update.  The window sum is W sequential vectorized adds over all
windows at once — the same f64 addition order per window as the
reference's inner i-loop, so the exact engine is bit-identical.  MISSING
masking is identical to plain LOD.  The fast engine's counterpart is
ops/device_wlod.py.

Copy of garlic_tpu/ops/wlod.py: the port imports nothing of garlic_tpu.
Each function names its source line.
"""

from __future__ import annotations

import numpy as np

from ..core.types import MISSING
from .lod import lod_terms, window_missing_mask


def wlod_scores(chrom, error, use_gl: bool, mu: float, M: int) -> np.ndarray:
    """Per-locus weighted scores [I, L] float64.

    Copy of garlic_tpu/ops/wlod.py:25."""
    err = chrom.gl if use_gl else error
    base = lod_terms(chrom.genotypes, chrom.freq, err)
    pos = chrom.positions.astype(np.float64)
    gpos = chrom.gpos.astype(np.float64)
    dpos = np.empty_like(pos)
    dpos[0] = pos[0]
    dpos[1:] = pos[1:] - pos[:-1]
    dg = np.empty_like(gpos)
    dg[0] = gpos[0]
    dg[1:] = gpos[1:] - gpos[:-1]
    nomut = np.exp(-2.0 * M * mu * dpos)
    norec = np.exp(-2.0 * M * 1.0 * dg)
    # reference order: (lod * nomut) * norec (src/garlic-roh.cpp:249)
    return (base * nomut[None, :]) * norec[None, :]


def wlod_windows(chrom, centro, ld: np.ndarray, winsize: int, error,
                 max_gap: int, use_gl: bool, mu: float, M: int,
                 bar=None) -> np.ndarray:
    """win [I, L] float64 with MISSING padding/masking.

    bar: optional progress bar, total=nind (the reference advances
    1/numThreads per individual per worker, src/garlic-roh.cpp:155,242);
    here the vectorized j-loop advances nind/winsize per iteration so the
    displayed percentage tracks actual compute progress.

    Copy of garlic_tpu/ops/wlod.py:43."""
    I, L = chrom.genotypes.shape
    win = np.full((I, L), float(MISSING), dtype=np.float64)
    nwin = L - winsize + 1
    if nwin <= 0:
        return win
    cstart = centro.start(chrom.chrom)
    cend = centro.end(chrom.chrom)
    missing = window_missing_mask(chrom.positions, winsize, max_gap,
                                  cstart, cend)
    score = wlod_scores(chrom, error, use_gl, mu, M)
    inv_ld = 1.0 / ld[:nwin, :winsize]            # [nwin, W]
    acc = np.zeros((I, nwin), dtype=np.float64)
    tick = I / float(winsize)
    for j in range(winsize):
        # same accumulation order as the reference's i-loop
        # (src/garlic-roh.cpp:259-272): score[i] * (1.0 / LD[l][i-l])
        acc = acc + score[:, j:j + nwin] * inv_ld[:, j][None, :]
        if bar is not None:
            bar.advance(tick)
    win[:, :nwin] = np.where(missing[None, :], float(MISSING), acc)
    return win
