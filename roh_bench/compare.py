"""The comparison that decides `correct`: each call's outputs against the
reference's outputs for its panel.

Three numbers, each exact, so each limit is 0 (PERF.md gives the
readings they were set from):
  rows_off    the worst call's BED lines missing or extra against the
              reference's (a multiset difference; a call that failed or
              wrote no BED misses all of them): Phases I and III, and
              through the size classes Phase IV;
  cutoff_off  calls whose .log cutoff differs from the reference's, as
              printed (%g): Phase II, automatic cutoffs only;
  bounds_off  calls whose .log size bounds differ from the reference's,
              as printed: Phase IV, automatic bounds only.
"""

from __future__ import annotations

import glob
import os
import re
from collections import Counter
from typing import List, Optional

from .reference import Call, g

LIMITS = {"rows_off": 0, "cutoff_off": 0, "bounds_off": 0}

_CUTOFF = re.compile(r"^Selected LOD score cutoff: (\S+)$", re.M)
_BOUNDS = re.compile(r"^Selected ROH size boundaries = \((.*)\)$", re.M)


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


def rows_off(bed: Optional[str], ref: Call) -> int:
    if bed is None:
        return len(ref.bed)
    a, b = Counter(bed.splitlines()), Counter(ref.bed)
    return sum((a - b).values()) + sum((b - a).values())


def cutoff_off(log: Optional[str], ref: Call) -> int:
    m = _CUTOFF.search(log or "")
    return int(m is None or g(float(m.group(1))) != g(ref.cutoff))


def bounds_off(log: Optional[str], ref: Call) -> int:
    m = _BOUNDS.search(log or "")
    if m is None:
        return 1
    got = [g(float(v)) for v in m.group(1).split()]
    return int(got != [g(v) for v in ref.bounds])


def check(outs: List[str], panels: List[int], refs: List[Call]) -> dict:
    """{name: (value, limit)} over the calls whose output prefixes are
    `outs`, call k on panel panels[k], against refs[panel]."""
    res = {"rows_off": 0}
    auto_cut = any(r.cutoff is not None for r in refs)
    auto_bounds = any(r.bounds is not None for r in refs)
    if auto_cut:
        res["cutoff_off"] = 0
    if auto_bounds:
        res["bounds_off"] = 0
    for out, p in zip(outs, panels):
        ref = refs[p]
        res["rows_off"] = max(res["rows_off"],
                              rows_off(_read(out + ".roh.bed"), ref))
        log = _read(out + ".log")
        if auto_cut:
            res["cutoff_off"] += cutoff_off(log, ref)
        if auto_bounds:
            res["bounds_off"] += bounds_off(log, ref)
    return {k: (v, LIMITS[k]) for k, v in res.items()}


def write_outputs(out: str, call: Call) -> None:
    """Writes a reference-made call's BED, and the .log lines that check
    reads, under the prefix `out`, as the program writes them (the
    control goes through check as a window's call does)."""
    with open(out + ".roh.bed", "w") as f:
        f.write("".join(line + "\n" for line in call.bed))
    with open(out + ".log", "w") as f:
        if call.cutoff is not None:
            f.write(f"Selected LOD score cutoff: {g(call.cutoff)}\n")
        if call.bounds is not None:
            f.write("Selected ROH size boundaries = ("
                    + "".join(f" {g(v)}" for v in call.bounds) + " )\n")


def remove_outputs(out: str, keep=()) -> None:
    """Deletes the files a call wrote under the prefix `out`, but those
    ending in one of `keep`."""
    for path in glob.glob(glob.escape(out) + ".*"):
        if not path.endswith(tuple(keep)):
            os.remove(path)
