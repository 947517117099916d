"""The control (the reference in float32, one precision below GARLIC's
float64, in the program's place) comes out as not correct, at sizes a
test run holds, through the check that judges a window's calls; on the
chip it is read at each cell's own size (control.py; PERF.md gives the
readings)."""

import os

import numpy as np
import pytest

from roh_bench import compare, control, panel, reference
from roh_bench.tests.conftest import small_config

CASES = [("garlic-example", (20000, 15000, 10000)),
         ("kgp3-wgs", (150000, 100000))]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,snps", CASES)
def test_float32_control_fails_the_check(name, snps, seed):
    got = control.readings(small_config(name, snps), {"panels": 1}, seed)
    assert any(v > compare.LIMITS[k] for k, v in got.items()), got


@pytest.mark.parametrize("name,snps", CASES)
def test_float64_reference_written_so_passes_the_check(tmp_path, name,
                                                       snps):
    # the control's outputs go through the same files and check: the
    # float64 reference, written so, reads 0 on every number
    cfg = small_config(name, snps)
    flags = list(cfg["flags"]) + ["--tpu-seed", "1"]
    ref = reference.call(panel.make_panel(cfg, 1), flags, np.float64)
    out = os.path.join(tmp_path, "ref")
    compare.write_outputs(out, ref)
    got = compare.check([out], [0], [ref])
    assert set(got) == ({"rows_off", "cutoff_off", "bounds_off"}
                        if name == "garlic-example" else {"rows_off"})
    assert all(v == 0 for v, _ in got.values()), got
