"""Seeded VCF and feature files for the companion tools' workflow (VCF ->
vcf2tped -> ROH calls -> count_features_in_roh), from a tests/util.Panel.

Imports numpy only, so chip_smoke.py (which refuses JAX and garlic_tpu)
writes its workflow inputs with the same code as tests/test_torch_tools.py.
"""

from __future__ import annotations

import gzip

import numpy as np

BASES = np.array(list("ACGT"))
EFFECTS = ("LOSS_OF_FUNCTION", "MISSENSE", "SYNONYMOUS", "UTR")


def _opener(path):
    if path.endswith(".gz"):
        return gzip.open(path, "wb", compresslevel=1)
    return open(path, "wb")


def write_vcf(panel, path: str, seed: int, multiallelic: int = 0):
    """A VCF v4.1 of the panel's genotypes as phased GT: code 0 -> 0|0,
    2 -> 1|1, 1 -> 0|1 or 1|0 (a seeded draw), missing -> .|.; REF and
    ALT two distinct bases drawn per site; sample names the panel's
    ind_ids.  multiallelic: that many (site, sample) cells, drawn among
    the called ones, become 2|0 (a code vcf2tped emits one allele for).
    Returns [(ref, alt, (loci, samples))] per chromosome: the one-letter
    REF and ALT of each site, and the multi-allelic cells."""
    rng = np.random.default_rng(seed)
    nind = len(panel.ind_ids)
    lut = np.array([b"\t0|0", b"\t0|1", b"\t1|1", b"\t.|.", b"\t1|0",
                    b"\t2|0"], dtype="S4")
    alleles = []
    with _opener(path) as f:
        f.write(b"##fileformat=VCFv4.1\n##source=tests/vcfutil.py\n"
                b"##FORMAT=<ID=GT,Number=1,Type=String,Description="
                b"\"Genotype\">\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER"
                b"\tINFO\tFORMAT\t" + "\t".join(panel.ind_ids).encode()
                + b"\n")
        for ci, chrom in enumerate(panel.chrom_names):
            pos = panel.positions[ci]
            g = panel.genotypes[ci].T  # [L, nind]
            L = len(pos)
            ref = rng.integers(0, 4, L)
            alt = (ref + rng.integers(1, 4, L)) % 4
            code = np.ascontiguousarray(np.where(g < 0, 3, g), np.int64)
            code[(g == 1) & (rng.random(g.shape) < 0.5)] = 4
            pick = rng.choice(np.flatnonzero(g.reshape(-1) >= 0),
                              multiallelic, replace=False)
            code.reshape(-1)[pick] = 5
            alleles.append((BASES[ref], BASES[alt],
                            np.unravel_index(pick, g.shape)))
            rows = lut[code].view("S1").reshape(L, -1).view(
                f"S{4 * nind}")[:, 0]
            for start in range(0, L, 65536):
                stop = min(start + 65536, L)
                f.write(b"".join(
                    f"{chrom}\t{int(pos[l])}\trs{ci}_{l}\t{BASES[ref[l]]}\t"
                    f"{BASES[alt[l]]}\t.\tPASS\t.\tGT".encode() + rows[l]
                    + b"\n" for l in range(start, stop)))
    return alleles


def write_features(panel, alleles, path: str, nsites: int, seed: int):
    """A feature file (`chr<name>:pos other functional effect` rows) of
    nsites seeded sites per chromosome: the functional allele (the
    column count_features_in_roh keys on) is the site's REF at about
    half of them and its ALT at the others; one of EFFECTS each.
    alleles: write_vcf's.  Returns {chrom name: (positions, functional
    allele is ALT, effect, locus index)} of the sites, sorted by
    position."""
    rng = np.random.default_rng(seed)
    sites = {}
    with open(path, "w") as f:
        for ci, name in enumerate(panel.chrom_names):
            pos = panel.positions[ci]
            ref, alt = alleles[ci][:2]
            at = np.sort(rng.choice(pos.size, nsites, replace=False))
            is_alt = rng.random(nsites) < 0.5
            eff = np.array(EFFECTS)[rng.integers(0, len(EFFECTS), nsites)]
            for l, a, e in zip(at, is_alt, eff):
                fa, other = (alt[l], ref[l]) if a else (ref[l], alt[l])
                f.write(f"chr{name}:{int(pos[l])} {other} {fa} {e}\n")
            sites[name] = (pos[at], is_alt, eff, at)
    return sites
