"""TFAM reading: individual IDs and single-population enforcement.

Reproduces scanIndData3/readIndData3 (src/garlic-data.cpp:1893-2014):
column 1 is the population, column 2 the individual ID; all rows must share
one population and IDs must be unique.

Copy of garlic_tpu/io/tfam.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

from __future__ import annotations

import gzip
from typing import List, Tuple

from ..core.types import GarlicDataError


def _open_maybe_gz(path: str):
    """Copy of garlic_tpu/io/tfam.py:16."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")



class TfamError(GarlicDataError):
    """Copy of garlic_tpu/io/tfam.py:23."""
    pass


def read_tfam(filename: str, log=None) -> Tuple[List[str], str]:
    """Returns (individual IDs, population name).

    Copy of garlic_tpu/io/tfam.py:27."""
    import os
    if not os.path.exists(filename):
        if log is not None:
            log.err("ERROR: Failed to open", filename)
        raise TfamError(filename)
    ids: List[str] = []
    seen = set()
    pop = None
    with _open_maybe_gz(filename) as fin:
        for n, line in enumerate(fin, 1):
            fields = line.split()
            if not fields:
                continue
            if len(fields) < 2:
                if log is not None:
                    log.err("ERROR: Line", n, nl=False)
                    log.err(" of", filename, nl=False)
                    log.err(" has", len(fields), nl=False)
                    log.err(", but expected at least", 2)
                raise TfamError("bad tfam line")
            p, ind = fields[0], fields[1]
            if ind in seen:
                if log is not None:
                    log.err("ERROR: Found duplicate individual ID ( ", ind, nl=False)
                    log.err(" ) in", filename)
                raise TfamError("duplicate individual")
            seen.add(ind)
            if pop is None:
                pop = p
            elif p != pop:
                if log is not None:
                    log.err("ERROR: Found multiple population IDs ( ", p, nl=False)
                    log.err(",", pop, nl=False)
                    log.err(" ) in", filename)
                raise TfamError("multiple populations")
            ids.append(ind)
    if pop is None:
        raise TfamError(f"{filename} is empty")
    return ids, pop
