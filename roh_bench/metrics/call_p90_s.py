"""The 90th percentile of every call's wall in the window, by nearest
rank: the ceil(0.9 n)-th smallest, a wall that a call took."""

import math


def p90(walls):
    s = sorted(walls)
    return s[max(math.ceil(0.9 * len(s)) - 1, 0)] if s else None


def read(w):
    return p90([c.wall for c in w.calls])
