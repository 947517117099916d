"""On the card: a run of each cell at a tiny size through K2, K7 and
K8, correct, with every metric it lists read.  Run on the chip with
`python3 -m pytest roh_bench/tests -m gpu`; skips without a card."""

import json
import time

import pytest

from roh_bench import harness
from roh_bench.tests.conftest import small_config
from roh_bench.tests.test_rohbench_faults import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_on_the_card(cell, traced):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        bench = json.load(f)
    name, snps = CELLS[cell]
    res = harness.run_cell(cell, 2 ** 31 + 11, 2.0, traced, "cuda:0",
                           time.perf_counter(),
                           cfg=small_config(name, snps), bench=bench)
    assert res["correct"], res["checks"]
    want = {m["name"] for m in harness.metric_specs(cell, traced, bench)}
    assert set(res["metrics"]) == want
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
