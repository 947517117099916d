"""Genetic-map scaffold loading and linear interpolation.

Reproduces loadMapScaffold/getMapInfo/interpolate (src/garlic-data.cpp:
702-869).  Scaffold files are 4 columns: <chr> <locusID> <geneticPos>
<physicalPos>.  Data sites outside the scaffold's physical range must be
filtered before interpolation; exact-position hits return the scaffold value,
others interpolate linearly between the bracketing scaffold sites.

Copy of garlic_tpu/io/genmap.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass
from typing import List

import numpy as np

from ..core.types import GarlicDataError
from .tped import check_chr_name


def _open_maybe_gz(path: str):
    """Copy of garlic_tpu/io/genmap.py:23."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


class GenMapError(GarlicDataError):
    """Copy of garlic_tpu/io/genmap.py:30."""
    pass


@dataclass
class MapScaffold:
    """Copy of garlic_tpu/io/genmap.py:35."""
    chrom: str
    positions: np.ndarray  # int64 [N]
    gpos: np.ndarray       # float64 [N]
    centro_start: int = 0
    centro_end: int = 0


def load_map_scaffold(mapfile: str, centro, log=None) -> List[MapScaffold]:
    """Copy of garlic_tpu/io/genmap.py:43."""
    import sys
    print(f"Opening {mapfile}...", file=sys.stderr)
    scaffolds: List[MapScaffold] = []
    cur_chr = None
    poss: List[int] = []
    gposs: List[float] = []
    nloci = 0
    with _open_maybe_gz(mapfile) as fin:
        for line in fin:
            fields = line.split()
            if not fields:
                continue
            nloci += 1
            if len(fields) != 4:
                raise GenMapError(
                    f"line {nloci} of {mapfile} has {len(fields)} columns, expected 4")
            chrom = fields[0]
            if cur_chr is None:
                cur_chr = chrom
            if chrom != cur_chr:
                scaffolds.append(_mk(cur_chr, poss, gposs, centro))
                poss, gposs = [], []
                cur_chr = chrom
            gposs.append(float(fields[2]))
            poss.append(int(float(fields[3])))
    if cur_chr is None:
        raise GenMapError(f"{mapfile} is empty")
    scaffolds.append(_mk(cur_chr, poss, gposs, centro))
    print(f"Loading genetic map scaffold for {nloci} loci.", file=sys.stderr)
    return scaffolds


def _mk(chrom, poss, gposs, centro) -> MapScaffold:
    """Copy of garlic_tpu/io/genmap.py:76."""
    name = check_chr_name(chrom)
    return MapScaffold(
        chrom=name,
        positions=np.asarray(poss, dtype=np.int64),
        gpos=np.asarray(gposs, dtype=np.float64),
        centro_start=centro.start(name),
        centro_end=centro.end(name),
    )


def interpolate_genetic_map(positions: np.ndarray, scaffold: MapScaffold,
                            ) -> tuple[np.ndarray, int]:
    """Interpolated genetic positions for data sites (already OOB-filtered).

    Exact scaffold positions take the scaffold's genetic position verbatim;
    others use the reference's slope/intercept formula
    (src/garlic-data.cpp:754-757):  y = m*q + (y0 - m*x0).
    Returns (gpos, number interpolated).

    Copy of garlic_tpu/io/genmap.py:87."""
    sp = scaffold.positions
    sg = scaffold.gpos
    if np.any(positions < sp[0]) or np.any(positions > sp[-1]):
        raise GenMapError(
            "Sites outside of map scaffold should have been filtered out.")
    # Bracketing interval: index of the last scaffold position <= query.
    idx = np.searchsorted(sp, positions, side="right") - 1
    idx = np.clip(idx, 0, len(sp) - 2)
    exact = np.isin(positions, sp)
    x0 = sp[idx].astype(np.float64)
    x1 = sp[idx + 1].astype(np.float64)
    y0 = sg[idx]
    y1 = sg[idx + 1]
    m = (y1 - y0) / (x1 - x0)
    interp = m * positions.astype(np.float64) + (y0 - m * x0)
    # Exact hits: use the scaffold's stored value.
    exact_idx = np.searchsorted(sp, positions)
    exact_idx = np.clip(exact_idx, 0, len(sp) - 1)
    out = np.where(exact, sg[exact_idx], interp)
    return out, int(np.sum(~exact))
