"""A run of each cell, driven on the CPU at a tiny size past the look
for a card (the fast engine's plain versions), comes out correct, and
comes out not correct with the timed path broken underneath: a call
that leaves its outputs unwritten, half of the individuals left out, a
run altered where assembly produces it, and on automatic cells the
cutoff and the size bounds altered where they are chosen.  (One card:
there is no exchange between chips to leave out.)"""

import contextlib
import io
import json
import time

import pytest

from roh_bench import harness
from roh_bench.tests.conftest import small_config

CELLS = {"wgs-pinned-warm": ("kgp3-wgs", (20000, 15000)),
         "example-auto-warm": ("garlic-example", (20000, 15000, 10000)),
         "example-auto-cold": ("garlic-example", (20000, 15000, 10000))}


def bench():
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        return json.load(f)


def run(cell, seed=97, traced=False):
    name, snps = CELLS[cell]
    return harness.run_cell(cell, seed, 1.0, traced, "cpu",
                            time.perf_counter(),
                            cfg=small_config(name, snps), bench=bench())


def no_bed(orig):
    return lambda *a, **k: None


def half_the_individuals(orig):
    def write(outfile, roh_by_ind, *a, **k):
        for rec in roh_by_ind[len(roh_by_ind) // 2:]:
            rec.calls = []
        return orig(outfile, roh_by_ind, *a, **k)
    return write


def one_run_altered(orig):
    def assemble(*a, **k):
        by_ind, lengths = orig(*a, **k)
        c = next(r.calls[0] for r in by_ind if r.calls)
        c.stop += 1
        c.size += 1
        return by_ind, lengths
    return assemble


def cutoff_altered(orig):
    return lambda *a, **k: orig(*a, **k) + 1e-3


def bounds_altered(orig):
    def select(*a, **k):
        bounds, res = orig(*a, **k)
        return [b * 1.001 for b in bounds], res
    return select


FAULTS = [("garlic_tpu_torch.io.bed", "write_roh", no_bed, False),
          ("garlic_tpu_torch.io.bed", "write_roh", half_the_individuals,
           False),
          ("garlic_tpu_torch.ops.assembly", "assemble_roh", one_run_altered,
           False),
          ("garlic_tpu_torch.ops.cutoff", "get_min_btw_modes",
           cutoff_altered, True),
          ("garlic_tpu_torch.ops.gmm", "select_size_classes",
           bounds_altered, True)]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    want = {"windows_per_s", "setup_s"}  # no card: no peak
    if cell != "example-auto-warm":  # its p90 is read in the traced run
        want.add("call_p90_s")
    assert set(res["metrics"]) == want


# pinned cells choose no cutoff or bounds, so those faults are the
# automatic cells' only
CASES = [(cell, f) for cell in ("wgs-pinned-warm", "example-auto-warm")
         for f in FAULTS if not (f[3] and cell.startswith("wgs"))]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f[2].__name__}" for c, f in CASES])
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    import importlib
    modname, attr, make, _ = fault
    mod = importlib.import_module(modname)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = run(cell)
    assert not res["correct"], res["checks"]


def test_traced_run_reports_its_layers():
    res = run("example-auto-warm", traced=True)
    assert res["correct"]
    m = res["metrics"]
    assert {"call_p90_traced_s", "load_ms", "phase2_ms", "phase3_ms",
            "phase4_ms", "device_idle_pct"} <= set(m)
    assert "k2_roofline_pct" not in m  # no card: no K2 in the trace
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with contextlib.redirect_stderr(io.StringIO()):
        rc = harness.main(["--workload", "wgs-pinned-warm", "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          time.perf_counter())
    assert rc != 0 and capsys.readouterr().out == ""
