"""Raw LOD-window dump (--raw-lod).

Reproduces writeWinData (src/garlic-data.cpp:1704-1747): one gzipped file per
chromosome named <out>.<pop>.<chr>.raw.lod.windows.gz, one row per
individual, space-separated %g scores with MISSING as "NA".

Copy of garlic_tpu/io/rawlod.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

from __future__ import annotations

import gzip
import sys
from typing import List

import numpy as np

from ..core.fmt import g
from ..core.types import MISSING


def write_win_data(win_by_chr: List[np.ndarray], chrom_names: List[str],
                   pop_name: str, outfile: str) -> None:
    """Copy of garlic_tpu/io/rawlod.py:20."""
    for ci, win in enumerate(win_by_chr):
        if hasattr(win, "make"):  # LazyWin: materialize per chrom, drop
            win = win.make()
        path = f"{outfile}.{pop_name}.{chrom_names[ci]}.raw.lod.windows.gz"
        with gzip.open(path, "wt") as fout:
            for ind in range(win.shape[0]):
                row = win[ind]
                fout.write(" ".join(
                    "NA" if v == MISSING else g(v) for v in row))
                fout.write("\n")
        print(f"Wrote {path}", file=sys.stderr)
