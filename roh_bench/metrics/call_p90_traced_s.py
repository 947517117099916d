"""call_p90_s over the traced run's calls, for the cells whose untraced
call_p90_s spreads too widely from run to run to hold a bound: the same
nearest-rank 90th percentile of every call's wall in the window, each
call carrying --tpu-profile and the device trace."""

from .call_p90_s import p90


def read(w):
    return p90([c.wall for c in w.calls])
