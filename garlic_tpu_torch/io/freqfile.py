"""Allele-frequency file I/O: `CHR SNP POS ALLELE FREQ` (gzip).

Reproduces writeFreqData/readFreqData (src/garlic-data.cpp:1311-1440).  On
read, when the file's allele disagrees with the internal '1' allele coding
the frequency flips to 1-freq (src/garlic-data.cpp:1419-1424).

Copy of garlic_tpu/io/freqfile.py (write_freq, _freq_content_key and
read_freq adapted: the native library, which the port requires, writes
the file and hashes its content, and write_freq counts the cached blob's
hits): the port imports nothing of garlic_tpu. Each function and class
names its source line.
"""

from __future__ import annotations

import gzip
from typing import List

import numpy as np

from ..core.types import ChromData, GarlicDataError


class FreqFileError(GarlicDataError):
    """Copy of garlic_tpu/io/freqfile.py:19."""
    pass


def write_freq(freq_outfile: str, chroms: List[ChromData], log=None,
               blob: str = None) -> None:
    """Writes <basename>.gz (caller passes "<out>.freq").

    blob: optional path of a cached, already-gzipped freq file whose
    content is a pure function of the per-locus arrays written
    (computed-from-data freqs, no resampling).  A content digest of those
    arrays, stored beside the blob, decides reuse — not mtimes, which
    race under concurrent runs, failed sidecar rewrites, or TPED swaps.
    On a digest match the blob is copied instead of re-formatting +
    re-deflating ~25 MB of text (~1 s for a 1M-locus genome); otherwise
    the normal write runs and refreshes blob + digest for the next run.
    Under --tpu-profile the blob's hits and misses are counted
    (runtime.count).

    Adapted from garlic_tpu/io/freqfile.py:23: the counters; the native
    library is required."""
    from ..runtime import count
    path = freq_outfile + ".gz"
    key = _freq_content_key(chroms) if blob is not None else None
    if key is not None and _copy_freq_blob(blob, path, key):
        count("freq_blob.hit")
        print(f"Wrote allele frequency data to {path}")
        return
    if key is not None:
        count("freq_blob.miss")
    from ..native import write_freq_chrom_native
    for ci, c in enumerate(chroms):
        write_freq_chrom_native(path, ci > 0, c.chrom, c.locus_names,
                                c.positions, c.alleles, c.freq)
    if key is not None:
        _save_freq_blob(blob, path, key)
    print(f"Wrote allele frequency data to {path}")


def _freq_content_key(chroms) -> bytes:
    """Digest of everything the freq file's text depends on: chromosome
    names, locus names, positions, alleles, and the freq values.  ~10 ms
    per 1M-locus genome via the native hash.

    Adapted from garlic_tpu/io/freqfile.py:75: the native library is
    required."""
    import hashlib

    from ..native import hash128_native
    h = hashlib.blake2b(digest_size=16)
    for c in chroms:
        h.update(c.chrom.encode())
        names = c.locus_names
        h.update(names.raw if hasattr(names, "raw")
                 else "\n".join(names).encode())
        for arr in (np.ascontiguousarray(c.positions),
                    np.ascontiguousarray(np.asarray(c.alleles).view(np.uint32)
                                         if np.asarray(c.alleles).dtype.kind == "U"
                                         else np.asarray(c.alleles)),
                    np.ascontiguousarray(c.freq)):
            h.update(hash128_native(arr))
    return h.digest()


def _copy_freq_blob(blob: str, path: str, key: bytes) -> bool:
    """Copy the cached freq file to path when its stored digest matches
    the current content key; False -> write normally.  Digest matching
    makes every race (concurrent runs, partial writes) safe: a mixed
    blob/digest pair from two writers either mismatches (rewrite) or
    matches because the content is identical anyway.

    Copy of garlic_tpu/io/freqfile.py:100."""
    import os
    import shutil
    try:
        with open(blob + ".key", "rb") as f:
            if f.read(64) != key:
                return False
        if os.path.exists(blob):
            shutil.copyfile(blob, path)
            return True
    except OSError:
        pass
    return False


def _save_freq_blob(blob: str, path: str, key: bytes) -> None:
    """Best-effort refresh of the cached freq file (atomic renames, blob
    before digest, so a matching digest always describes a complete
    blob).

    Copy of garlic_tpu/io/freqfile.py:120."""
    import os
    import shutil
    try:
        tmp = blob + f".tmp{os.getpid()}"
        shutil.copyfile(path, tmp)
        os.replace(tmp, blob)
        with open(tmp + "k", "wb") as f:
            f.write(key)
        os.replace(tmp + "k", blob + ".key")
    except OSError:
        pass


def read_freq(freqfile: str, chroms: List[ChromData], log=None) -> None:
    """Reads frequencies into each ChromData in place, validating row counts,
    column counts and locus-name agreement.

    Adapted from garlic_tpu/io/freqfile.py:137: the native library is
    required."""
    expected_rows = 1 + sum(c.nloci for c in chroms)
    opener = gzip.open if freqfile.endswith(".gz") else open
    import sys
    print(f"Reading {freqfile}", file=sys.stderr)
    # native fast path: one OpenMP pass (~0.1 s/1M loci vs ~1.8 s for the
    # line loop below).  Any anomaly -> None -> the Python loop re-parses
    # and produces the reference's exact error text.
    from ..native import read_freq_native
    names_raw = b"\n".join(
        c.locus_names.raw if hasattr(c.locus_names, "raw")
        else "\n".join(c.locus_names).encode() for c in chroms)
    alleles = np.concatenate(
        [np.asarray(c.alleles) for c in chroms]) if chroms else \
        np.empty(0, dtype="S1")
    freqs = read_freq_native(freqfile, names_raw, alleles, expected_rows - 1)
    if freqs is not None:
        o = 0
        for c in chroms:
            c.freq = freqs[o:o + c.nloci].copy()
            o += c.nloci
        return
    with opener(freqfile, "rt") as fin:
        fin.readline()  # header
        line_num = 1
        prev_cols = -1
        for c in chroms:
            freqs = np.empty(c.nloci, dtype=np.float64)
            for locus in range(c.nloci):
                line_num += 1
                line = fin.readline()
                if not line:
                    if log is not None:
                        log.err("ERROR: at line", line_num, nl=False)
                        log.err(" in", freqfile, nl=False)
                        log.err(". Perhaps too few lines?")
                    raise FreqFileError("short freq file")
                fields = line.split()
                if len(fields) < 5:
                    if log is not None:
                        log.err("ERROR: Found", len(fields), nl=False)
                        log.err(" in", freqfile, nl=False)
                        log.err(" on line", line_num, nl=False)
                        log.err(" but expected at least", 5)
                    raise FreqFileError("bad freq columns")
                if prev_cols != -1 and len(fields) != prev_cols:
                    if log is not None:
                        log.err("ERROR: Differing number of columns across rows found in",
                                freqfile)
                    raise FreqFileError("ragged freq file")
                prev_cols = len(fields)
                locus_id, allele, fr = fields[1], fields[3], float(fields[4])
                if c.locus_names[locus] != locus_id:
                    if log is not None:
                        log.err("ERROR: Loci appear mismatched in:", freqfile)
                        log.err("ERROR: at line:", line_num)
                        log.err("ERROR: freq file locus name:", locus_id)
                        log.err("ERROR: tped file locus name:", c.locus_names[locus])
                    raise FreqFileError("locus mismatch")
                if c.alleles[locus] != allele:
                    fr = 1.0 - fr
                freqs[locus] = fr
            c.freq = freqs
