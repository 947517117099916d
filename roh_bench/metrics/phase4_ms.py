"""Mean ms a call of --tpu-profile's 'phase4-gmm' phase: Phase IV (the EM and the size bounds)."""

from .common import phase_ms


def read(w):
    return phase_ms(w, "phase4-gmm")
