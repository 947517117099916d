"""Site filters.

Reproduces filterMonomorphicSites / filterMonomorphicAndOOBSites
(src/garlic-data.cpp:871-1195): monomorphic sites (freq outside (0,1)) are
dropped everywhere; the weighted/cm variant additionally drops sites outside
the genetic-map scaffold's physical range or strictly inside the centromere.
All per-chromosome arrays are filtered consistently.

Copy of garlic_tpu/io/filters.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.types import ChromData


class _FilteredNames:
    """Lazy filtered locus-name view: downstream phases never read names
    post-filter (freq I/O runs pre-filter), so avoid materializing 10^5
    strings on every run.

    Copy of garlic_tpu/io/filters.py:19."""

    __slots__ = ("_parent", "_idx")

    def __init__(self, parent, idx):
        self._parent = parent
        self._idx = idx

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        return self._parent[int(self._idx[i])]

    def __iter__(self):
        return (self._parent[int(i)] for i in self._idx)


def _compact(arr, keep: np.ndarray):
    """Column compaction: in-place C++ memmove of kept spans when
    possible (a fresh compacted copy costs seconds of page faults at WGS
    scale under virtualization), a numpy copy for non-contiguous arrays.
    The result may be a [:, :nkeep] view over the original buffer.

    Read-only arrays (zero-copy views into a sidecar mmap, e.g. the TGLS
    .gtlc code matrix) must NOT take the in-place path: ctypes bypasses
    numpy's writeable flag and the store into the read-only mapping
    segfaults — they get the numpy copy too.

    Adapted from garlic_tpu/io/filters.py:40: the native library is
    required."""
    if arr is None:
        return None
    if arr.flags.writeable:
        from ..native import filter_columns_native
        out = filter_columns_native(arr, keep)
        if out is not None:
            return out
    return np.ascontiguousarray(np.compress(keep, arr, axis=1))


def _apply(c: ChromData, keep: np.ndarray) -> ChromData:
    """Adapted from garlic_tpu/io/filters.py:63: the native library is
    required."""
    if keep.all():
        return c  # nothing filtered: avoid copying the [I, L] matrices
    idx = np.flatnonzero(keep)
    geno = None
    geno2b_thunk = None
    digest = None
    if c.geno_is_packed_only:
        # packed-mode column compaction: the int8 matrix never exists
        # (4x less memory traffic; the native pass emits missing-filled
        # tail codes so kernels can pad by 0xFF fill).  The compaction is
        # DEFERRED (thunk): with a sidecar digest the filtered payload's
        # content key is derivable without touching the bytes, and on a
        # device-cache hit nothing ever reads them.
        from ..core.digest import derived_digest
        from ..native import filter_pack_2bit_native
        parent2b, parent_L = c.geno2b, c.nloci
        k = keep.copy()

        def geno2b_thunk(_p=parent2b, _L=parent_L, _k=k):
            return filter_pack_2bit_native(_p, _L, _k)[0]

        digest = derived_digest(c.geno2b_digest, keep)
    else:
        geno = _compact(c.genotypes, keep)
    out = ChromData(
        chrom=c.chrom,
        positions=c.positions[idx],
        gpos=c.gpos[idx],
        locus_names=_FilteredNames(c.locus_names, idx),
        alleles=c.alleles[idx],
        genotypes=geno,
        freq=c.freq[idx],
        first_copy=_compact(c.first_copy, keep),
        # dictionary-form TGLS: compact the u8 codes, never materialize
        # the f64 matrix (the fast TPU path ships codes directly)
        gl=_compact(c._gl, keep) if c.gl_codes is None else None,
        gl_codes=_compact(c.gl_codes, keep),
        gl_lut=c.gl_lut,
        geno2b_thunk=geno2b_thunk,
        nind=c.nind,
        geno2b_digest=digest,
        nind_total=c.nind_total,
        row0=c.row0,
    )
    if geno2b_thunk is not None:
        # sparse consumers can decode straight from the unfiltered parent
        # payload without firing the compaction (ChromData.geno2b_parent)
        out.geno2b_parent = (c.geno2b, idx)
    return out


def filter_monomorphic(chroms: List[ChromData]) -> tuple[List[ChromData], int]:
    """Keep sites with freq strictly in (0, 1). Returns (chroms, new_loci).

    Copy of garlic_tpu/io/filters.py:116."""
    out = []
    n = 0
    for c in chroms:
        keep = (c.freq > 0) & (c.freq < 1)
        c2 = _apply(c, keep)
        n += c2.nloci
        out.append(c2)
    return out, n


def filter_monomorphic_and_oob(chroms: List[ChromData], scaffolds,
                               ) -> tuple[List[ChromData], int]:
    """Also drop sites outside the scaffold range or strictly inside the
    centromere (src/garlic-data.cpp:1066-1098).

    Copy of garlic_tpu/io/filters.py:128."""
    out = []
    n = 0
    for c, s in zip(chroms, scaffolds):
        keep = ((c.freq > 0) & (c.freq < 1)
                & ~(c.positions < s.positions[0])
                & ~(c.positions > s.positions[-1])
                & ~((c.positions > s.centro_start) & (c.positions < s.centro_end)))
        c2 = _apply(c, keep)
        n += c2.nloci
        out.append(c2)
    return out, n
