"""Mean ms a call that the host waits on the card: every span whose
last step is `wait` (each phase mark's synchronize, the edge payload's
size reads and copy, K7's and K8's result reads)."""

from .spans import span_ms, wait_paths


def read(w):
    paths = wait_paths(w)
    return span_ms(w, *paths) if paths else None
