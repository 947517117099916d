"""The control of the check that decides `correct`: the reference put in
the program's place, computed in float32, one precision below GARLIC's
float64.  It has to come out as not correct on every seed.

    python3 roh_bench/control.py --workload <cell> --seeds <n> [<n> ...]

prints a JSON line a seed with the numbers that compare.check reads from
the control's outputs, on the cell's own panels: the float32 call's BED
and .log lines are written as a call of the window writes them, and
judged by the same check.  The benchmark's runs do not run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from roh_bench import compare, harness, panel  # noqa: E402


def readings(cfg: dict, traffic: dict, seed: int) -> dict:
    """compare.check's numbers over the panels a run of this seed makes,
    each panel called once by the control: rows_off the worst panel's,
    the others counted over panels."""
    reference = harness.reference_for(cfg)
    work = tempfile.mkdtemp(prefix="roh_bench.control.")
    try:
        outs, refs = [], []
        for k in range(int(traffic["panels"])):
            pan = panel.make_panel(cfg, seed + k)
            flags = (list(cfg["flags"])
                     + harness.panel_inputs(pan, cfg, work, k)
                     + ["--tpu-seed", str(seed % 2147483647)])
            refs.append(reference.call(pan, flags))
            outs.append(os.path.join(work, f"panel{k}"))
            compare.write_outputs(outs[-1],
                                  reference.call(pan, flags, np.float32))
        got = compare.check(outs, list(range(len(outs))), refs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {name: v for name, (v, _) in got.items()}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="roh_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    wl = harness.load("workloads", a.workload)
    cfg = harness.load("configs", wl["config"])
    traffic = harness.load("traffic", wl["traffic"])
    for seed in a.seeds:
        t = time.perf_counter()
        r = readings(cfg, traffic, abs(seed))
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "control": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
