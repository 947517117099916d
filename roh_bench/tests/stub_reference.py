"""A configuration's own reference, for the CPU tests of the side inputs
(test_rohbench_inputs.py): it reads every flag, records each argv it is
given, and works the call out with the program's exact engine (the f64
host engine, byte-identical to GARLIC v1.1.6a) on the panel's files, so
that a weighted window can be judged on the CPU.  No benchmark cell
uses it: a cell's reference imports nothing of the program."""

from __future__ import annotations

import contextlib
import io
import os
import tempfile

import numpy as np

from roh_bench import panel as panels
from roh_bench.reference import Call

SEEN = []  # the argv of every call()


def parse(argv):
    return list(argv)


def call(pan, argv, dt=np.float64) -> Call:
    from garlic_tpu_torch.pipeline import run_main
    SEEN.append(list(argv))
    argv = list(argv)
    argv[argv.index("--tpu-engine") + 1] = "exact"
    with tempfile.TemporaryDirectory() as work:
        tped, tfam = panels.panel_files(pan, work, "p", False)
        out = os.path.join(work, "x")
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = run_main(["--tped", tped, "--tfam", tfam, "--out", out]
                          + argv, device="cpu")
        assert rc == 0, rc
        with open(out + ".roh.bed") as f:
            return Call(bed=f.read().splitlines())
