"""Runs one cell of the garlic_tpu_torch benchmark once, on one CUDA card.

    python3 roh_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m roh_bench.run ...`), from the repository's root.  Prints
one JSON line on stdout; the program's own output and the checks go to
stderr.  Exits non-zero, printing nothing on stdout, without a CUDA
device.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == _HERE:
    sys.path.pop(0)  # roh_bench's modules are imported as a package
sys.path.insert(0, os.path.dirname(_HERE))

from roh_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
