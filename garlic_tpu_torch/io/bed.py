"""UCSC BED9 ROH writer.

Copy of garlic_tpu/io/bed.py (that module imports IndividualROH from
garlic_tpu.ops.assembly and therefore JAX).  Reproduces writeROHData
(src/garlic-roh.cpp:574-650) byte-for-byte: one track header per
individual, rows `chr start stop sizeClass length . 0 0 RGB`, size-class
letters assigned from the sorted bounds, and the 9 fixed RGB colors.
"""

from __future__ import annotations

from typing import List

from ..core.fmt import g
from ..ops.assembly import IndividualROH

# copy of garlic_tpu/io/bed.py:16
COLORS = [
    "228,26,28", "77,175,74", "55,126,184", "152,78,163", "255,127,0",
    "255,255,51", "166,86,40", "247,129,191", "153,153,153",
]


# copy of garlic_tpu/io/bed.py:22
def make_roh_filename(outfile: str) -> str:
    return outfile + ".roh.bed"


# copy of garlic_tpu/io/bed.py:26
def _classify(size: float, bounds: List[float]):
    """First bound exceeding size picks the class (src/garlic-roh.cpp:613-627)."""
    sc = ord("A")
    for i, b in enumerate(bounds):
        if size < b:
            return chr(sc), COLORS[i if i <= 8 else 8]
        sc += 1
    i = len(bounds)
    return chr(sc), COLORS[i if i <= 8 else 8]


# copy of garlic_tpu/io/bed.py:37
def write_roh(outfile: str, roh_by_ind: List[IndividualROH], chrom_names,
              bounds: List[float], pop_name: str, version: str, cm: bool,
              log=None) -> None:
    with open(outfile, "w") as out:
        for rec in roh_by_ind:
            out.write(
                f'track name="Ind: {rec.ind_id} Pop:{pop_name} ROH" '
                f'description="Ind: {rec.ind_id} Pop:{pop_name} ROH from '
                f'GARLIC v{version}" visibility=2 itemRgb="On"\n')
            for call in rec.calls:
                size_class, color = _classify(call.size, bounds)
                chrom = chrom_names[call.chrom_idx]
                if chrom[0] not in ("c", "C"):
                    chrom = "chr" + chrom
                if cm:
                    size_str = g(call.size)
                else:
                    size_str = str(int(call.size))
                out.write(f"{chrom}\t{int(call.start)}\t{int(call.stop)}\t"
                          f"{size_class}\t{size_str}\t.\t0\t0\t{color}\n")
    if log is not None:
        log.log("ROH calls:", outfile)
