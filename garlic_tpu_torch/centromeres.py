"""Centromere boundary tables and lookup.

Reproduces the reference's hardcoded hg18/hg19/hg38 centromere [start, end]
tables and custom-file reader (reference: src/garlic-centromeres.cpp:3-101,
185-619).  Chromosomes are keyed under both "chrN" and "N"; lookups for
unknown chromosomes return 0 and warn once per chromosome.

Copy of garlic_tpu/centromeres.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

import gzip
from typing import Dict, Tuple

# (start, end) per chromosome; transcribed from the UCSC gap tables embedded in
# the reference at src/garlic-centromeres.cpp:185-619.
_HG18: Dict[str, Tuple[int, int]] = {
    "chr1": (121236957, 123476957), "chr2": (91689898, 94689898),
    "chr3": (90587544, 93487544), "chr4": (49354874, 52354874),
    "chr5": (46441398, 49441398), "chr6": (58938125, 61938125),
    "chr7": (58058273, 61058273), "chr8": (43958052, 46958052),
    "chr9": (47107499, 50107499), "chr10": (39244941, 41624941),
    "chr11": (51450781, 54450781), "chr12": (34747961, 36142961),
    "chr13": (16000000, 17868000), "chr14": (15070000, 18070000),
    "chr15": (15260000, 18260000), "chr16": (35143302, 36943302),
    "chr17": (22187133, 22287133), "chr18": (15400898, 16764896),
    "chr19": (26923622, 29923622), "chr20": (26267569, 28033230),
    "chr21": (10260000, 13260000), "chr22": (11330000, 14330000),
    "chrX": (58598737, 61598737),
}

_HG19: Dict[str, Tuple[int, int]] = {
    "chr1": (121535434, 124535434), "chr2": (92326171, 95326171),
    "chr3": (90504854, 93504854), "chr4": (49660117, 52660117),
    "chr5": (46405641, 49405641), "chr6": (58830166, 61830166),
    "chr7": (58054331, 61054331), "chr8": (43838887, 46838887),
    "chr9": (47367679, 50367679), "chr10": (39254935, 42254935),
    "chr11": (51644205, 54644205), "chr12": (34856694, 37856694),
    "chr13": (16000000, 19000000), "chr14": (16000000, 19000000),
    "chr15": (17000000, 20000000), "chr16": (35335801, 38335801),
    "chr17": (22263006, 25263006), "chr18": (15460898, 18460898),
    "chr19": (24681782, 27681782), "chr20": (26369569, 29369569),
    "chr21": (11288129, 14288129), "chr22": (13000000, 16000000),
    "chrX": (58632012, 61632012),
}

_HG38: Dict[str, Tuple[int, int]] = {
    "chr1": (122026459, 124932724), "chr2": (92188145, 94090557),
    "chr3": (90772458, 93655574), "chr4": (49712061, 51743951),
    "chr5": (46485900, 50059807), "chr6": (58553888, 59829934),
    "chr7": (58169653, 61528020), "chr8": (44033744, 45877265),
    "chr9": (43389635, 45518558), "chr10": (39686682, 41593521),
    "chr11": (51078348, 54425074), "chr12": (34769407, 37185252),
    "chr13": (16000000, 18051248), "chr14": (16000000, 18173523),
    "chr15": (17083673, 19725254), "chr16": (36311158, 38265669),
    "chr17": (22813679, 26616164), "chr18": (15460899, 20861206),
    "chr19": (24498980, 27190874), "chr20": (26436232, 30038348),
    "chr21": (10864560, 12915808), "chr22": (12954788, 15054318),
    "chrX": (58605579, 62412542),
}

_BUILDS = {"hg18": _HG18, "hg19": _HG19, "hg38": _HG38}


def _check_chr_name(chr_name: str) -> str:
    """Prefix "chr" when the name does not start with lowercase 'c'
    (reference: src/garlic-centromeres.cpp:103-108).

    Copy of garlic_tpu/centromeres.py:64."""
    if not chr_name or chr_name[0] != "c":
        return "chr" + chr_name
    return chr_name


def _with_bare_keys(table: Dict[str, Tuple[int, int]]) -> Dict[str, Tuple[int, int]]:
    """Copy of garlic_tpu/centromeres.py:72."""
    out = dict(table)
    for k, v in table.items():
        out[k.removeprefix("chr")] = v
    return out


class Centromere:
    """Centromere gap lookup (reference: src/garlic-centromeres.cpp:3-59).

    start/end return 0 for unknown chromosomes, emitting a one-time warning
    through the supplied logger (matching errlog behavior).

    Copy of garlic_tpu/centromeres.py:79.
    """

    def __init__(self, build: str = "none", custom_file: str = "none",
                 default_file_name: str = "none", log=None):
        self._log = log
        self._warned: set[str] = set()
        if build in _BUILDS:
            self.gaps = _with_bare_keys(_BUILDS[build])
        elif custom_file != default_file_name:
            self.gaps = self._read_custom(custom_file)
        else:
            self.gaps = {}

    def _read_custom(self, filename: str) -> Dict[str, Tuple[int, int]]:
        """3-column <chr> <start> <end> file, gz or plain
        (reference: src/garlic-centromeres.cpp:64-101)."""
        opener = gzip.open if filename.endswith(".gz") else open
        gaps: Dict[str, Tuple[int, int]] = {}
        try:
            fh = opener(filename, "rt")
        except OSError:
            if self._log is not None:
                self._log.err("ERROR: Could not open", filename)
            raise
        n = 0
        with fh:
            for line in fh:
                fields = line.split()
                if not fields:
                    continue
                n += 1
                if len(fields) != 3 and self._log is not None:
                    self._log.err(
                        "ERROR: Custom centromere file requires three columns.  Found",
                        len(fields))
                chrname = _check_chr_name(fields[0])
                gaps[chrname] = (int(fields[1]), int(fields[2]))
        import sys
        print(f"Loaded custom centromere limits for {n} chromosomes.", file=sys.stderr)
        return gaps

    def _warn(self, chr_name: str, which: str):
        if chr_name not in self._warned:
            self._warned.add(chr_name)
            if self._log is not None:
                self._log.err(f"WARNING: No centromere {which} information for chr:",
                              chr_name)
                self._log.err("WARNING: If you provided custom centromeres check "
                              "that chromosome names match between data files.")

    def start(self, chr_name: str) -> int:
        if chr_name not in self.gaps:
            self._warn(chr_name, "start")
            return 0
        return self.gaps[chr_name][0]

    def end(self, chr_name: str) -> int:
        if chr_name not in self.gaps:
            self._warn(chr_name, "end")
            return 0
        return self.gaps[chr_name][1]
