"""Seconds from the process's start to the first timed call: the
panel, its files, the set-up calls (and on a run that compiles, the
kernels' build)."""


def read(w):
    return w.setup_s
