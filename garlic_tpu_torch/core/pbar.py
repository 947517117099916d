"""Terminal percent ticker on stderr.

Mirrors the reference progress bar (src/garlic-pbar.cpp:4-34): backspace-
overwritten `NN%` updates at tick granularity, finalized as `100%\\n`.
The pthread mutex becomes a threading.Lock so native worker threads (the
C++ OpenMP stages report per-chromosome, the reference reported per
individual) can advance it safely.

Copy of garlic_tpu/core/pbar.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

from __future__ import annotations

import sys
import threading


class Bar:
    """Copy of garlic_tpu/core/pbar.py:16."""
    def __init__(self, total: float, total_ticks: int = 100,
                 stream=None):
        self.total = float(total)
        self.current = 0.0
        self.total_ticks = total_ticks
        self.current_tick = 0
        self._lock = threading.Lock()
        self._stream = stream if stream is not None else sys.stderr

    def advance(self, inc: float = 1.0) -> None:
        with self._lock:
            self.current += inc
            if self.total <= 0:
                return
            if (self.current / self.total >=
                    self.current_tick / self.total_ticks):
                self.current_tick += 1
                pct = int(self.current / self.total * 100)
                pad = " " if pct < 10 else ""
                self._stream.write("\b\b\b" + pad + f"{pct}%")
                self._stream.flush()

    def finalize(self) -> None:
        self._stream.write("\b\b\b100%\n")
        self._stream.flush()
