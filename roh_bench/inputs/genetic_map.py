"""A genetic-map scaffold for a panel, the side input of --map.

The 4-column file (chromosome, id, position in cM, position in bp) that
the program's genetic-map loader reads, in the layout of
tests/util.write_map_scaffold: one block a chromosome, in the
configuration's order, so that the map has as many chromosomes as the
panel; each block a grid of `points` positions from 1 to the
chromosome's length, so that every generated locus lies inside it and
none is dropped as out of bounds; cM = rate_cm_per_mb * bp / 1e6.

The configuration's entry: {"flag": "--map", "writer": "genetic_map",
"rate_cm_per_mb": <float>, "points": <int>}.
"""

from __future__ import annotations

import numpy as np


def write(panel, cfg: dict, spec: dict, path: str) -> None:
    rate = float(spec["rate_cm_per_mb"])
    points = int(spec["points"])
    with open(path, "w") as f:
        for ci, (chrom, length) in enumerate(zip(panel.chroms,
                                                 cfg["chrom_lengths"])):
            bp = np.unique(np.linspace(1, length, points).astype(np.int64))
            cm = rate * bp / 1e6
            f.writelines(f"{chrom} map{ci}_{x} {c!r} {x}\n"
                         for x, c in zip(bp.tolist(), cm.tolist()))
