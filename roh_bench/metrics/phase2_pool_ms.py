"""Mean ms a call of the spans phase2-cutoff/pool and
phase2-cutoff/pool-replay: Phase II's exact f64 pool of thinned windows,
pooled on the host or replayed from the pool cache (its lookup
included)."""

from .spans import span_ms


def read(w):
    return span_ms(w, "phase2-cutoff/pool", "phase2-cutoff/pool-replay")
