"""TPED loading and the --freq-only streaming path for the port.

Copies of garlic_tpu/io/tped.py: the native C++ parser's assembly, the
pure-Python reader, peek_nind and the --freq-only stream as they are;
load_tped, which asks the native parser for 2-bit codes (unphased) or
int8 genotypes with the first-copy bits (--phased), writing a cold run's
sidecar through io/panelcache.py here, or for one process's column
range of individuals (col_range) on a multi-process run, and timing its
steps (runtime.span) and the sidecar's hits under --tpu-profile.
Each function names its source line.
"""

from __future__ import annotations

import gzip
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

from ..core.types import ChromData, Dataset, GarlicDataError
from ..runtime import count, span
from . import panelcache


def _open_maybe_gz(path: str):
    """Copy of garlic_tpu/io/tped.py:25."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def check_chr_name(chrom: str) -> str:
    """Prefix "chr" when the name does not start with 'c'
    (src/garlic-data.cpp:1886-1891).

    Copy of garlic_tpu/io/tped.py:31."""
    if not chrom or chrom[0] != "c":
        return "chr" + chrom
    return chrom


def _parse_line(line: str, tped_missing: str, col_range=None):
    """Parse one TPED line into (chr, name, gpos, ppos, geno[I], first_copy[I],
    nalleles, total, allele[, num_part, den_part]).

    The reference extracts alleles with `ss >> char` — one non-whitespace
    character at a time (src/garlic-data.cpp:111) — so we parse the
    concatenation of all characters in the trailing fields.
    col_range=(c0, c1) stores only genotype columns [c0, c1) (per-host
    sharded input) and additionally returns the partial '1'-allele /
    observed-allele counts over that range; the allele coding still scans
    from column 0 (the '1' allele is full-row defined).

    Copy of garlic_tpu/io/tped.py:39."""
    fields = line.split()
    ncols = len(fields) - 4
    numind = ncols // 2
    chrom, name = fields[0], fields[1]
    gpos = float(fields[2])
    ppos = int(float(fields[3]))  # read as double, stored as int (truncation)

    c0, c1 = (0, numind) if col_range is None else (
        max(int(col_range[0]), 0), min(int(col_range[1]), numind))
    c1 = max(c1, c0)
    chars = "".join(fields[4:])
    one_allele = tped_missing
    geno = np.empty(c1 - c0, dtype=np.int8)
    fc = np.empty(c1 - c0, dtype=bool)
    nalleles = 0
    total = 0
    num_part = 0
    den_part = 0
    k = 0
    for i in range(numind):
        a1 = chars[k]
        a2 = chars[k + 1]
        k += 2
        if one_allele == tped_missing and a1 != tped_missing:
            one_allele = a1
        if one_allele == tped_missing and a2 != tped_missing:
            one_allele = a2
        in_r = c0 <= i < c1
        d = 0
        if a1 == tped_missing:
            d += -9
        elif a1 == one_allele:
            d += 1
            nalleles += 1
            total += 1
            if in_r:
                num_part += 1
                den_part += 1
        else:
            total += 1
            if in_r:
                den_part += 1
        if a2 == tped_missing:
            d += -9
        elif a2 == one_allele:
            d += 1
            nalleles += 1
            total += 1
            if in_r:
                num_part += 1
                den_part += 1
        else:
            total += 1
            if in_r:
                den_part += 1
        if d < 0:
            d = -9
        if in_r:
            geno[i - c0] = d
            fc[i - c0] = (a1 == one_allele)
    if col_range is None:
        return chrom, name, gpos, ppos, geno, fc, nalleles, total, one_allele
    return (chrom, name, gpos, ppos, geno, fc, nalleles, total, one_allele,
            num_part, den_part)


def peek_nind(tpedfile: str) -> int:
    """Individual count from the first non-blank TPED line (cheap even on
    gz: only the head of the stream inflates) — used to compute per-host
    column ranges before the sharded parse.

    Copy of garlic_tpu/io/tped.py:116."""
    with _open_maybe_gz(tpedfile) as fin:
        for line in fin:
            fields = line.split()
            if fields:
                return max((len(fields) - 4) // 2, 0)
    return 0


def _finish_chrom(log, chrom, names, gposs, pposs, alleles, genos, fcs, freqs,
                  phased, auto_freq, counts=None, layout=None) -> ChromData:
    """Copy of garlic_tpu/io/tped.py:208."""
    if log is not None:
        log.log("Chromosome", check_chr_name(chrom), nl=False)
        log.log(":", len(names), nl=False)
        log.log(" sites.")
    geno = np.stack(genos, axis=0).T.copy() if genos else np.empty((0, 0), np.int8)
    fnum = fden = None
    if counts is not None:
        fnum = np.asarray([c[0] for c in counts], dtype=np.float64)
        fden = np.asarray([c[1] for c in counts], dtype=np.float64)
    return ChromData(
        chrom=check_chr_name(chrom),
        positions=np.asarray(pposs, dtype=np.int64),
        gpos=np.asarray(gposs, dtype=np.float64),
        locus_names=list(names),
        alleles=np.asarray(alleles, dtype="<U1"),
        genotypes=geno,
        freq=np.asarray(freqs, dtype=np.float64) if auto_freq else None,
        first_copy=(np.stack(fcs, axis=0).T.copy() if phased and fcs else None),
        freq_num=fnum, freq_den=fden,
        nind_total=None if layout is None else layout[0],
        row0=0 if layout is None else layout[1],
    )


def _load_tped_python(tpedfile: str, tped_missing: str, phased: bool,
                      auto_freq: bool, log,
                      col_range=None) -> Tuple[Dataset, int]:
    """Copy of garlic_tpu/io/tped.py:234."""
    ds = Dataset()
    num_loci = 0
    prev_chr = None
    names: List[str] = []
    gposs: List[float] = []
    pposs: List[int] = []
    alleles: List[str] = []
    genos: List[np.ndarray] = []
    fcs: List[np.ndarray] = []
    freqs: List[float] = []
    counts: Optional[List[tuple]] = [] if col_range is not None else None
    layout = None

    with _open_maybe_gz(tpedfile) as fin:
        for line in fin:
            if not line.strip():
                continue
            num_loci += 1
            rec = _parse_line(line, tped_missing, col_range=col_range)
            chrom, name, gpos, ppos, geno, fc, nalleles, total, allele = \
                rec[:9]
            if col_range is not None and layout is None:
                nind_file = (len(line.split()) - 4) // 2
                layout = (nind_file, max(min(int(col_range[0]), nind_file),
                                         0))
            if prev_chr is None:
                prev_chr = chrom
            if chrom != prev_chr:
                ds.chroms.append(_finish_chrom(log, prev_chr, names, gposs,
                                               pposs, alleles, genos, fcs,
                                               freqs, phased, auto_freq,
                                               counts, layout))
                names, gposs, pposs, alleles = [], [], [], []
                genos, fcs, freqs = [], [], []
                counts = [] if col_range is not None else None
                prev_chr = chrom
            names.append(name)
            gposs.append(gpos)
            pposs.append(ppos)
            alleles.append(allele)
            genos.append(geno)
            if phased:
                fcs.append(fc)
            if auto_freq:
                freqs.append(0.0 if total == 0 else nalleles / total)
            if counts is not None:
                counts.append((rec[9], rec[10]))
    if prev_chr is None:
        if log is not None:
            log.err("ERROR:", tpedfile, nl=False)
            log.err(" contains no data.")
        raise GarlicDataError(f"{tpedfile} contains no data")
    ds.chroms.append(_finish_chrom(log, prev_chr, names, gposs, pposs,
                                   alleles, genos, fcs, freqs, phased,
                                   auto_freq, counts, layout))
    return ds, num_loci


def _assemble_from_native(native, phased: bool, auto_freq: bool, log):
    """Assemble a Dataset from the native parser's per-chromosome blocks.

    Copy of garlic_tpu/io/tped.py:295."""
    ds = Dataset()
    num_loci = 0
    for blk in native:
        num_loci += len(blk["names"])
        if log is not None:
            log.log("Chromosome", check_chr_name(blk["chrom"]), nl=False)
            log.log(":", len(blk["names"]), nl=False)
            log.log(" sites.")
        nt = blk.get("nind_total")
        ng = blk["genotypes"].shape[0] if blk["genotypes"] is not None \
            else (blk["geno2b"].shape[0] if blk.get("geno2b") is not None
                  else None)
        if nt is not None and ng is not None and int(nt) == int(ng) \
                and not blk.get("row0"):
            nt = None  # full panel: keep single-process semantics
        ds.chroms.append(ChromData(
            chrom=check_chr_name(blk["chrom"]),
            positions=blk["positions"],
            gpos=blk["gpos"],
            locus_names=blk["names"],
            alleles=blk["alleles"],
            genotypes=blk["genotypes"],
            freq=blk["freq"] if auto_freq else None,
            first_copy=blk["first_copy"] if phased else None,
            geno2b=blk.get("geno2b"),
            geno2b_digest=blk.get("geno2b_digest"),
            freq_num=blk.get("freq_num"),
            freq_den=blk.get("freq_den"),
            nind_total=None if nt is None else int(nt),
            row0=int(blk.get("row0") or 0),
        ))
    return ds, num_loci


# adapted from garlic_tpu/io/tped.py:128: unphased genotypes parsed to
# 2-bit codes (packed_geno=True), phased ones to int8 with the first-copy
# bits; the native library is required
def load_tped(tpedfile: str, tped_missing: str = "0", nresample: int = 0,
              auto_freq: bool = True, log=None,
              rng: Optional[np.random.Generator] = None,
              panel_cache: bool = False,
              phased: bool = False, col_range=None) -> Tuple[Dataset, int]:
    """Load a TPED file into a Dataset. Returns (dataset, total_loci).

    Mirrors loadTPEDData (src/garlic-data.cpp:10-177). Frequency
    resampling draws `nresample` Bernoulli(freq) trials
    (src/garlic-data.cpp:142-148) from the given generator.  phased
    keeps the first-copy bits (--phased); a sidecar without them is a
    miss.

    col_range=(c0, c1): per-host sharded input — store only genotype
    columns [c0, c1) (chrom.nind_total/row0 record the global layout and
    chrom.freq_num/freq_den carry partial count planes for the freq
    sum).  Resampling is deferred to the caller in this mode (it applies
    to the summed global freq)."""
    if not os.path.exists(tpedfile):
        if log is not None:
            log.err("ERROR: Failed to open", tpedfile)
        raise FileNotFoundError(tpedfile)
    native = None
    from_cache = False
    if panel_cache:
        with span("sidecar"):
            native = panelcache.load_cache(tpedfile, want_fc=phased,
                                           tped_missing=tped_missing,
                                           col_range=col_range)
        from_cache = native is not None
        count("sidecar.hit" if from_cache else "sidecar.miss")
        if from_cache:
            print(f"Loaded panel cache {panelcache.cache_path(tpedfile)}",
                  file=sys.stderr)
    if native is None:
        from ..native import parse_tped_native
        try:
            with span("parse"):
                native = parse_tped_native(tpedfile, tped_missing,
                                           want_fc=phased,
                                           col_range=col_range)
        except OSError:  # the parser rejects the file: the Python reader
            native = None  # gives the reference's error

    if native is not None:
        with span("assemble"):
            ds, num_loci = _assemble_from_native(native, phased, auto_freq,
                                                 log)
        if panel_cache:
            ds.panel_cache_file = panelcache.cache_path(tpedfile)
        if panel_cache and not from_cache and col_range is None:
            # range-mode parses hold only a column slice: never write the
            # (full-panel) sidecar from one
            with span("sidecar-write"):
                digs = panelcache.save_cache(
                    tpedfile, native,
                    ds.nind if ds.ind_ids else
                    (ds.chroms[0].nind if ds.chroms else 0),
                    tped_missing=tped_missing)
            if digs:
                # attach the payload digests to the COLD run's chroms too
                # (warm loads read them from the sidecar header)
                for c, d in zip(ds.chroms, digs):
                    c.geno2b_digest = d
    else:
        with span("parse"):
            ds, num_loci = _load_tped_python(tpedfile, tped_missing, phased,
                                             auto_freq, log,
                                             col_range=col_range)

    if auto_freq and nresample > 0 and col_range is None:
        if rng is None:
            rng = np.random.default_rng()
        for c in ds.chroms:
            # Binomial(nresample, freq)/nresample; a freq of 0 (including the
            # total==0 case) resamples to 0 (src/garlic-data.cpp:142-148).
            counts = rng.binomial(nresample, np.clip(c.freq, 0.0, 1.0))
            c.freq = counts.astype(np.float64) / float(nresample)
    return ds, num_loci


def freq_only(tpedfile: str, outfile: str, nresample: int,
              tped_missing: str = "0", log=None,
              rng: Optional[np.random.Generator] = None) -> None:
    """Single-pass streaming frequency computation writing <out>.freq.gz and
    returning — O(1) RAM (reference freqOnly, src/garlic-data.cpp:238-315).

    Copy of garlic_tpu/io/tped.py:331."""
    from ..core.fmt import g
    freqoutfile = outfile + ".freq.gz"
    if rng is None and nresample > 0:
        rng = np.random.default_rng()
    with gzip.open(freqoutfile, "wt") as fout, _open_maybe_gz(tpedfile) as fin:
        fout.write("CHR\tSNP\tPOS\tALLELE\tFREQ\n")
        for line in fin:
            if not line.strip():
                continue
            fields = line.split()
            chrom, name = fields[0], fields[1]
            ppos = int(float(fields[3]))
            one_allele = tped_missing
            total = 0
            nalleles = 0
            # freqOnly scans whole tokens and uses token[0]
            # (src/garlic-data.cpp:289-296)
            for tok in fields[4:]:
                if tok[0] != tped_missing:
                    total += 1
                    if one_allele == tped_missing:
                        one_allele = tok[0]
                    if tok[0] == one_allele:
                        nalleles += 1
            freq = 0.0 if total == 0 else nalleles / total
            if nresample > 0 and total != 0:
                count = int(np.sum(rng.random(nresample) <= freq))
                freq = count / nresample
            fout.write(f"{check_chr_name(chrom)}\t{name}\t{ppos}\t{one_allele}\t{g(freq)}\n")
