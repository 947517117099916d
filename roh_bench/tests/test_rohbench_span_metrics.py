"""The readers of --tpu-profile's span breakdown on hand-made windows:
each one's mean ms a traced call, and nothing where no call has its
spans (the program before them)."""

import pytest

from roh_bench import harness
from roh_bench.metrics import (device_wait_ms, phase1_inputs_ms,
                               phase2_pool_ms, phase3_patrol_ms)
from roh_bench.metrics.common import CallRecord, Window

READERS = [phase1_inputs_ms, phase2_pool_ms, phase3_patrol_ms,
           device_wait_ms]
PHASES_ONLY = {"load": 0.05, "phase1-lod": 0.2, "phase3-assembly": 0.1}
CALLS = [
    {**PHASES_ONLY, "phase1-lod/inputs": 0.010, "phase1-lod/inputs/upload":
     0.004, "phase1-lod/wait": 0.001, "phase2-cutoff/pool": 0.100,
     "phase3-assembly/patrol": 0.002, "phase3-assembly/edges/wait": 0.003,
     "phase2-cutoff/kde/wait": 0.0005},
    {**PHASES_ONLY, "phase1-lod/inputs": 0.020, "phase2-cutoff/pool-replay":
     0.030, "phase3-assembly/patrol": 0.004, "phase1-lod/wait": 0.002,
     "phase4-gmm/em/wait": 0.0015, "phase3-assembly/waiter": 9.0},
]


def window(phases):
    return Window(calls=[CallRecord(wall=1.0, rc=0, panel=0, phases=p)
                         for p in phases],
                  seconds=10.0, setup_s=1.0, peak_bytes=0, nind=45,
                  winsize=60, snps=[100], kept=[[90]])


@pytest.mark.parametrize("reader,want", [
    (phase1_inputs_ms, (10.0 + 20.0) / 2),
    (phase2_pool_ms, (100.0 + 30.0) / 2),
    (phase3_patrol_ms, (2.0 + 4.0) / 2),
    (device_wait_ms, (1.0 + 3.0 + 0.5 + 2.0 + 1.5) / 2),
], ids=lambda r: getattr(r, "__name__", "").rsplit(".", 1)[-1])
def test_reader_is_the_mean_ms_a_call(reader, want):
    assert reader.read(window(CALLS)) == pytest.approx(want)


@pytest.mark.parametrize("reader", READERS,
                         ids=lambda r: r.__name__.rsplit(".", 1)[-1])
@pytest.mark.parametrize("phases", [[PHASES_ONLY, PHASES_ONLY], [{}]],
                         ids=["phases-only", "untraced"])
def test_reader_reports_nothing_without_its_spans(reader, phases):
    assert reader.read(window(phases)) is None


def test_the_span_lines_parse_with_the_harness_pattern():
    err = ("[profile] phase breakdown:\n"
           "[profile]   phase1-lod            0.227s  (1 windows/s)\n"
           "[profile]   TOTAL                 0.227s\n"
           "[profile] span breakdown:\n"
           "[profile]   phase1-lod/inputs                  0.012345s  "
           "44 spans\n"
           "[profile]   phase1-lod/wait                    0.000500s  "
           "1 spans\n"
           "[profile] counters {\"h2d_bytes\": 1}\n")
    got = {n: float(v) for n, v in harness._PHASE.findall(err)
           if n != "TOTAL"}
    assert got == {"phase1-lod": 0.227, "phase1-lod/inputs": 0.012345,
                   "phase1-lod/wait": 0.0005}
    w = window([got])
    assert phase1_inputs_ms.read(w) == pytest.approx(12.345)
    assert device_wait_ms.read(w) == pytest.approx(0.5)
