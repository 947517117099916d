"""Mean ms a call of --tpu-profile's 'phase1-lod' phase: Phase I (the LOD inputs and K2's enqueue)."""

from .common import phase_ms


def read(w):
    return phase_ms(w, "phase1-lod")
