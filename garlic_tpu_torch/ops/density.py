"""SNP density and density-driven auto-selection heuristics.

Ports calcDensity/selectOverlapFrac (src/garlic-data.cpp:3-8,318-328) and
selectWinsizeWeighted (src/garlic-roh.cpp:3-9).

Copy of garlic_tpu/ops/density.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

import math


def calc_density(num_loci: int, chroms, centro) -> float:
    """loci / (covered bp - centromere spans) (src/garlic-data.cpp:318-328).

    Copy of garlic_tpu/ops/density.py:13."""
    length = 0.0
    for c in chroms:
        length += (float(c.positions[-1]) - float(c.positions[0]) + 1.0
                   - (centro.end(c.chrom) - centro.start(c.chrom)))
    return float(num_loci) / length


def select_overlap_frac(density: float, winsize: int) -> float:
    """(6.375*ln(d)+63.888)/100, clamped (src/garlic-data.cpp:3-8).

    Copy of garlic_tpu/ops/density.py:22."""
    frac = (6.375 * math.log(density) + 63.888) / 100.0
    if frac > 1:
        frac = 1.0
    if frac <= 0:
        frac = 1.0 / float(winsize)
    return frac


def select_winsize_weighted(density: float) -> int:
    """int(8.3235*ln(d)+138.0521+0.5), min 10 (src/garlic-roh.cpp:3-9).

    Copy of garlic_tpu/ops/density.py:32."""
    size = int(8.3235 * math.log(density) + 138.0521 + 0.5)
    return size if size >= 10 else 10
