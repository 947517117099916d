"""What the metric readers share: the window of calls they read."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class CallRecord:
    """One call of the window: its wall (host clock, closed by a device
    synchronize), exit code, panel, and on a traced run its phase split
    (--tpu-profile's lines, seconds), its counters (the last
    `[profile] counters {json}` line, parsed) and its trace
    (trace.trace_summary)."""
    wall: float
    rc: int
    panel: int
    phases: dict = field(default_factory=dict)
    trace: Optional[dict] = None
    counters: dict = field(default_factory=dict)


@dataclass
class Window:
    """A run's measured window and what the readers need beside it."""
    calls: List[CallRecord]
    seconds: float          # first call's start to last call's end
    setup_s: float          # process start to the first timed call
    peak_bytes: int         # device-memory peak over the window
    nind: int
    winsize: int
    snps: List[int]         # generated loci a chromosome (the cell's shape)
    kept: List[List[int]]   # loci a chromosome after the monomorphic
                            # filter, a panel each
    peaks: Optional[dict] = None   # the card's row of peaks.json
    flags: List[str] = field(default_factory=list)  # a call's flags after
                            # its files, without the side inputs' paths


def phase_ms(w: Window, *names: str) -> Optional[float]:
    """Mean over the window's traced calls of the named phases' summed
    seconds, in ms; None when no call has a phase split."""
    split = [c.phases for c in w.calls if c.phases]
    if not split:
        return None
    return 1e3 * sum(sum(p.get(n, 0.0) for n in names)
                     for p in split) / len(split)
