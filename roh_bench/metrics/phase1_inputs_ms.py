"""Mean ms a call of the span phase1-lod/inputs: Phase I's kernel inputs
on the host (packed codes, the window mask) and their upload
(phase1-lod/inputs/upload, within it)."""

from .spans import span_ms


def read(w):
    return span_ms(w, "phase1-lod/inputs")
