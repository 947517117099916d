"""Seeded panels of a configuration, and their TPED and TFAM files.

A vectorized rewrite of tests/util.py:29 (make_panel), whose loop over
individuals is too slow for a WGS panel, and a copy of tests/util.py:71
(write_tped) with its row loop vectorized.  Same model: allele
frequencies from a Beta, Hardy-Weinberg genotypes, planted autozygous
segments (both alleles of one draw) so that the LOD windows have two
modes, and missing genotypes.  Positions are uniform over each
chromosome outside its centromere.  Everything comes from the seed.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import List

import numpy as np

from .centromeres import centromere

ROWS = 16  # individuals drawn at once: bounds the [rows, L] temporaries


@dataclass
class Panel:
    chroms: List[str]
    positions: List[np.ndarray]   # int64 [L] a chromosome
    genotypes: List[np.ndarray]   # int8 [I, L]: copies of allele A, -9 missing
    ind_ids: List[str]
    pop: str


def _positions(rng, n: int, length: int, cstart: int, cend: int):
    """n distinct sorted positions in [1, length] outside [cstart, cend]."""
    span = length - (cend - cstart + 1)
    u = np.sort(rng.random(n))
    pos = 1 + (u * (span - n)).astype(np.int64) + np.arange(n)
    return np.where(pos >= cstart, pos + (cend - cstart + 1), pos)


def _autozygous(rng, nind: int, L: int, per_snp: float, classes):
    """bool [nind, L]: the planted autozygous segments."""
    share = np.array([c[0] for c in classes], dtype=np.float64)
    n = rng.poisson(per_snp * L, size=nind)
    tot = int(n.sum())
    ind = np.repeat(np.arange(nind), n)
    cls = rng.choice(len(classes), size=tot, p=share / share.sum())
    lo = np.array([c[1] for c in classes])[cls]
    hi = np.array([c[2] for c in classes])[cls]
    seg = (lo + rng.random(tot) * (hi - lo)).astype(np.int64)
    start = rng.integers(0, L, size=tot)
    diff = np.zeros((nind, L + 1), dtype=np.int16)
    np.add.at(diff, (ind, start), 1)
    np.add.at(diff, (ind, np.minimum(start + seg, L)), -1)
    out = np.empty((nind, L), dtype=bool)
    for i in range(nind):
        out[i] = np.cumsum(diff[i, :L]) > 0
    return out


def make_panel(cfg: dict, seed: int) -> Panel:
    """The configuration's panel, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    nind = int(cfg["individuals"])
    a, b = cfg["allele_freq_beta"]
    lo, hi = cfg["allele_freq_clip"]
    positions, genos = [], []
    for chrom, length, L in zip(cfg["chromosomes"], cfg["chrom_lengths"],
                                cfg["snps"]):
        cs, ce = centromere(cfg["build"], chrom)
        positions.append(_positions(rng, L, length, cs, ce))
        f = np.clip(rng.beta(a, b, size=L), lo, hi)
        # one uniform a genotype: 2 below f^2, 1 below 1 - (1-f)^2, else
        # 0; inside a segment 2 below f, else 0
        c2 = (f * f).astype(np.float32)
        c1 = (1.0 - (1.0 - f) ** 2).astype(np.float32)
        f = f.astype(np.float32)
        auto = _autozygous(rng, nind, L, cfg["roh_per_snp"],
                           cfg["roh_classes"])
        g = np.empty((nind, L), dtype=np.int8)
        for s in range(0, nind, ROWS):
            k = min(ROWS, nind - s)
            u = rng.random((k, L), dtype=np.float32)
            hwe = (u < c2).astype(np.int8) + (u < c1).astype(np.int8)
            g[s:s + k] = np.where(auto[s:s + k], 2 * (u < f), hwe)
        nmiss = rng.binomial(nind * L, cfg["missing_rate"])
        g.reshape(-1)[rng.integers(0, nind * L, size=nmiss)] = -9
        genos.append(g)
    return Panel(chroms=list(cfg["chromosomes"]), positions=positions,
                 genotypes=genos, ind_ids=[f"IND{i:04d}" for i in range(nind)],
                 pop=cfg["population"])


# genotype -> 4 bytes " a b": allele 'A' counted, 'C' the other, '0' missing
_LUT = np.array([b" C C", b" A C", b" A A", b" 0 0"], dtype="S4")


def write_tped(panel: Panel, tped_path: str, tfam_path: str) -> None:
    """The panel's TPED (gzip level 1 when the name ends in .gz) and TFAM.
    Adapted from tests/util.py:71: rows rendered a chromosome at a time."""
    if tped_path.endswith(".gz"):
        f = gzip.open(tped_path, "wb", compresslevel=1)
    else:
        f = open(tped_path, "wb")
    with f:
        for ci, chrom in enumerate(panel.chroms):
            pos = panel.positions[ci]
            g = panel.genotypes[ci]
            L = pos.shape[0]
            codes = np.where(g < 0, 3, g).astype(np.uint8)
            cells = np.ascontiguousarray(_LUT[codes.T])          # [L, I] S4
            rows = cells.view(f"S{4 * g.shape[0]}")[:, 0]        # [L]
            for s in range(0, L, 1 << 16):
                e = min(s + (1 << 16), L)
                f.write(b"".join(
                    b"%s rs%d_%d 0 %d%s\n" % (chrom.encode(), ci, l,
                                              pos[l], rows[l])
                    for l in range(s, e)))
    with open(tfam_path, "w") as t:
        for ind in panel.ind_ids:
            t.write(f"{panel.pop} {ind} 0 0 0 -9\n")


def panel_files(panel: Panel, workdir: str, tag: str, gz: bool):
    """Writes the panel under workdir; returns (tped, tfam) paths."""
    tped = os.path.join(workdir, f"{tag}.tped" + (".gz" if gz else ""))
    tfam = os.path.join(workdir, f"{tag}.tfam")
    write_tped(panel, tped, tfam)
    return tped, tfam


def kept_loci(panel: Panel) -> List[int]:
    """Loci a chromosome left after the monomorphic filter: those whose
    non-missing genotypes are not all one homozygote."""
    out = []
    for g in panel.genotypes:
        ok = g >= 0
        alt = np.where(ok, g, 0).sum(axis=0, dtype=np.int64)
        n = 2 * ok.sum(axis=0, dtype=np.int64)
        out.append(int(((alt > 0) & (alt < n)).sum()))
    return out
