"""`python -m garlic_tpu_torch` / `garlic-tpu-torch` console entry point."""

from __future__ import annotations

import sys


def main() -> None:
    from .pipeline import run_main
    rc = run_main(sys.argv[1:], prog=sys.argv[0])
    sys.stdout.flush()
    sys.stderr.flush()
    sys.exit(rc & 0xFF)  # -1 -> 255, as the JAX package's entry point


if __name__ == "__main__":
    main()
