"""What the span readers share: --tpu-profile's span breakdown, which
the harness's phase pattern parses beside the phases (a span path holds
a "/": `<phase>/<step>`, `<phase>/<step>/wait`)."""

from __future__ import annotations

from typing import Optional

from .common import Window, phase_ms


def span_ms(w: Window, *paths: str) -> Optional[float]:
    """Mean ms a traced call of the named span paths, summed (a path's
    seconds include its children's), through phase_ms; None when no
    call has any of them: a program without the spans reports nothing."""
    if not any(p in c.phases for c in w.calls for p in paths):
        return None
    return phase_ms(w, *paths)


def wait_paths(w: Window) -> list:
    """Every span path of the window's calls whose last step is `wait`:
    host time blocked on the card (a synchronize, a blocking copy)."""
    return sorted({p for c in w.calls for p in c.phases
                   if "/" in p and p.rsplit("/", 1)[1] == "wait"})
