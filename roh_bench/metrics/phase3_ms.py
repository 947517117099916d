"""Mean ms a call of --tpu-profile's 'phase3-assembly' and 'write-bed'
phases: coverage, the tie patrol, the run scan and the BED."""

from .common import phase_ms


def read(w):
    return phase_ms(w, "phase3-assembly", "write-bed")
