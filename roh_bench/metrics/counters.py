"""What the counter readers share: --tpu-profile's `[profile] counters`
line, which the harness keeps for each traced call (CallRecord.counters).
A counter is named by its path in that JSON object: `h2d_bytes`,
`patrol.suspects`, `launches.pair_counts`."""

from __future__ import annotations

from typing import Optional

from .common import Window


def counter(counters: dict, name: str) -> Optional[float]:
    """The number at the dotted path `name`; None where there is none."""
    v = counters
    for key in name.split("."):
        if not isinstance(v, dict) or key not in v:
            return None
        v = v[key]
    return v if isinstance(v, (int, float)) else None


def counter_mean(w: Window, name: str) -> Optional[float]:
    """Mean over the window's traced calls of the named counter (0 in a
    call that lacks it); None when no call has it: a program without the
    counter reports nothing."""
    got = [counter(c.counters, name) for c in w.calls if c.counters]
    if all(v is None for v in got):
        return None
    return sum(v or 0 for v in got) / len(got)
