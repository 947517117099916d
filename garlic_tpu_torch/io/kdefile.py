"""KDE result writer: `x y` per line, %g formatting.

Reproduces writeKDEResult / makeKDEFilename (src/garlic-kde.cpp:274-302).

Copy of garlic_tpu/io/kdefile.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

from ..core.fmt import g
from ..ops.kde import KDEResult


def make_kde_filename(basename: str, winsize: int) -> str:
    """Copy of garlic_tpu/io/kdefile.py:12."""
    return f"{basename}.{winsize}SNPs.kde"


def write_kde(kde: KDEResult, outfile: str, log=None) -> None:
    """Copy of garlic_tpu/io/kdefile.py:16."""
    try:
        fout = open(outfile, "w")
    except OSError:
        # reference: LOG.err("ERROR: Failed to open", outfile); throw
        # (src/garlic-kde.cpp:274-282)
        if log is not None:
            log.err("ERROR: Failed to open", outfile)
        raise
    with fout:
        for i in range(kde.size):
            fout.write(f"{g(kde.x[i])} {g(kde.y[i])}\n")
    if log is not None:
        log.log("Wrote KDE results to", outfile)
