"""Mean ms a call of --tpu-profile's 'load' phase: the load phase (parse or sidecar read, frequencies' input)."""

from .common import phase_ms


def read(w):
    return phase_ms(w, "load")
