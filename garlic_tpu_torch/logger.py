"""Dual-stream run logger.

Mirrors the reference `errlog` class (src/garlic-errlog.{h,cpp}): a `.log`
file (mirrored to stdout) records run provenance, and a `.error` file
(mirrored to stderr) records errors/warnings.  Values are separated from
their label by a single space and doubles print as %g with 6 significant
digits — the .log file is a byte-comparison artifact, so format fidelity
matters (src/garlic-errlog.cpp:339-371).

Copy of garlic_tpu/logger.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

from __future__ import annotations

import sys
from typing import IO, Iterable, Optional

from .core.fmt import g


def _fmt(val) -> str:
    """Copy of garlic_tpu/logger.py:19."""
    if isinstance(val, bool):
        return "TRUE" if val else "FALSE"
    if isinstance(val, float):
        return g(val)
    return str(val)


class RunLog:
    """Dual-stream logger. Construct unopened; call init(basename) to open.

    Copy of garlic_tpu/logger.py:27."""

    def __init__(self):
        self._logstream: Optional[IO[str]] = None
        self._errstream: Optional[IO[str]] = None
        self.quiet = False

    def init(self, basename: str):
        self._logstream = open(basename + ".log", "w")
        self._errstream = open(basename + ".error", "w")

    def close(self):
        for s in (self._logstream, self._errstream):
            if s is not None:
                s.close()
        self._logstream = self._errstream = None

    # -- internals ---------------------------------------------------------
    def _out(self, stream, console, text: str, nl: bool):
        if nl:
            text += "\n"
        if stream is not None:
            stream.write(text)
            stream.flush()
        if console is not None and not self.quiet:
            console.write(text)
            console.flush()

    # -- log channel (stdout + .log) ---------------------------------------
    def log(self, label="", val=None, nl: bool = True):
        """log("x:", v) → "x: <v>\\n"; log("s") → "s\\n"; nl=False omits newline
        (reference: errlog::log overloads, src/garlic-errlog.cpp:186-317)."""
        text = _fmt(label) if val is None else f"{label} {_fmt(val)}"
        self._out(self._logstream, sys.stdout, text, nl)

    def logn(self, label=""):
        self.log(label, nl=False)

    def logv(self, label: str, vals: Iterable, nl: bool = True):
        text = label + "".join(f" {_fmt(v)}" for v in vals)
        self._out(self._logstream, sys.stdout, text, nl)

    def loga(self, label: str, vals: Iterable, nl: bool = True):
        self.logv(label, vals, nl)

    # -- error channel (stderr + .error) ------------------------------------
    def err(self, label="", val=None, nl: bool = True):
        text = _fmt(label) if val is None else f"{label} {_fmt(val)}"
        self._out(self._errstream, sys.stderr, text, nl)

    def errv(self, label: str, vals: Iterable, nl: bool = True):
        text = label + "".join(f" {_fmt(v)}" for v in vals)
        self._out(self._errstream, sys.stderr, text, nl)
