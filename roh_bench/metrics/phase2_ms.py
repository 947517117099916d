"""Mean ms a call of --tpu-profile's 'phase2-cutoff' phase: Phase II (pool, KDE, cutoff search)."""

from .common import phase_ms


def read(w):
    return phase_ms(w, "phase2-cutoff")
