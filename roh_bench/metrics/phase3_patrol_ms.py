"""Mean ms a call of the span phase3-assembly/patrol: the tie patrol,
which re-derives the suspect windows near the cutoff in f64 on the host
and recomputes the rows whose decision flips."""

from .spans import span_ms


def read(w):
    return span_ms(w, "phase3-assembly/patrol")
