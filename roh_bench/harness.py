"""One run of one benchmark cell: set-up, a measured window of whole
garlic_tpu_torch calls in a closed loop with one caller, the check of
every call against the NumPy reference, and the result line.

Everything a cell is sits in files found by name: the workload
(workloads/<cell>.json: its config and traffic), the configuration
(configs/<config>.json: shapes, flags, generator; optionally "inputs",
side files a panel such as a genetic map, each written by
inputs/<writer>.py and passed as `<flag> <path>`, and "reference", the
module under roh_bench that judges its calls, reference.py by default),
the traffic (traffic/<traffic>.json: panels, extra flags, set-up calls)
and each metric's reader (metrics/<metric>.py), listed for the cell in
BENCHMARK.json.  See PERF.md for what each metric measures and why.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

from . import compare, panel as panels
from .metrics.common import CallRecord, Window
from .trace import trace_summary

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "garlic_tpu")
_PHASE = re.compile(r"^\[profile\]\s+(\S+)\s+([0-9.]+)s", re.M)
_COUNTERS = re.compile(r"^\[profile\] counters (\{.*\})\s*$", re.M)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def reference_for(cfg: dict):
    """The module that judges a configuration's calls: roh_bench.<its
    "reference">, roh_bench.reference by default.  It has parse(argv),
    which raises ValueError on a flag it does not implement, and
    call(panel, argv, dt=np.float64) -> reference.Call."""
    return importlib.import_module(
        f"roh_bench.{cfg.get('reference', 'reference')}")


def panel_inputs(pan, cfg: dict, work: str, k: int) -> list:
    """Writes panel k's side inputs (the configuration's "inputs") into
    work, panel{k}.<writer>; returns their flags, [flag, path, ...]."""
    out = []
    for spec in cfg.get("inputs", []):
        writer = importlib.import_module(
            f"roh_bench.inputs.{spec['writer']}")
        path = os.path.join(work, f"panel{k}.{spec['writer']}")
        writer.write(pan, cfg, spec, path)
        out += [spec["flag"], path]
    return out


def call_flags(cfg: dict, traffic: dict, seed: int, inputs=()) -> list:
    """A call's flags after its files: the configuration's, the
    traffic's, a panel's side inputs, the engine and the seed.  The
    reference reads the same."""
    return (list(cfg["flags"]) + list(traffic["flags"]) + list(inputs)
            + ["--tpu-engine", "fast", "--tpu-seed", str(seed % 2147483647)])


def call_argv(files, out: str, flags: list) -> list:
    """A call's argv: its panel's TPED and TFAM, its output prefix, its
    flags (call_flags)."""
    tped, tfam = files
    return ["--tped", tped, "--tfam", tfam, "--out", out] + flags


def profile_counters(err: str) -> dict:
    """The last `[profile] counters {json}` line of a call's stderr,
    parsed; {} without one."""
    found = _COUNTERS.findall(err)
    return json.loads(found[-1]) if found else {}


def metric_specs(cell: str, traced: bool, bench: dict) -> list:
    """BENCHMARK.json's metrics that this cell reports: end-to-end on an
    untraced run, per-layer on a traced one."""
    return [m for m in bench["per_layer" if traced else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


class Caller:
    """Calls garlic_tpu_torch.pipeline.run_main in this process, the
    program's stdout and stderr kept, and times each call on the host
    clock up to a device synchronize."""

    def __init__(self, device: str, workdir: str):
        import torch
        from garlic_tpu_torch.pipeline import run_main
        self.torch = torch
        self.run_main = run_main
        self.device = device
        self.cuda = torch.device(device).type == "cuda"
        self.tdir = os.path.join(workdir, "trace")

    def __call__(self, argv, traced: bool = False):
        if traced:
            os.environ["GARLIC_TPU_TRACE_DIR"] = self.tdir
            argv = argv + ["--tpu-profile"]
        else:
            os.environ.pop("GARLIC_TPU_TRACE_DIR", None)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = self.run_main(argv, prog="garlic-tpu-torch",
                               device=self.device)
            if self.cuda:
                self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            log(f"[roh_bench] call exited {rc}:\n{err.getvalue()[-4000:]}")
        return rc, wall, err.getvalue()

    def traces(self) -> list:
        """The summaries of the trace files written since the last call,
        the files deleted."""
        out = []
        for path in sorted(glob.glob(os.path.join(self.tdir, "*.json"))):
            with open(path) as f:
                out.append(trace_summary(json.load(f)))
            os.remove(path)
        return out


def breakdown(calls) -> dict:
    """The traced window's top device operations and longest idle gaps
    (by phase and host operation), each summed over its calls, seconds."""
    ops, gaps = defaultdict(float), defaultdict(float)
    for c in calls:
        for name, (_, ms) in c.trace["ops"].items():
            ops[name] += ms / 1e3
        for ms, phases, host, _ in c.trace["gaps"]:
            gaps[f"{phases}: {host}"] += ms / 1e3
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def run_cell(cell: str, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, cfg: dict = None,
             bench: dict = None) -> dict:
    """One run of `cell`; returns the result line's object.  cfg and
    bench replace the cell's configuration and BENCHMARK.json (the CPU
    tests run tiny shapes)."""
    wl = load("workloads", cell)
    cfg = cfg or load("configs", wl["config"])
    traffic = load("traffic", wl["traffic"])
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    specs = metric_specs(cell, traced, bench)
    work = tempfile.mkdtemp(prefix="roh_bench.")
    try:
        return _run(cell, cfg, traffic, specs, seed, seconds, traced,
                    device, t_start, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        os.environ.pop("GARLIC_TPU_TRACE_DIR", None)


def _run(cell, cfg, traffic, specs, seed, seconds, traced, device,
         t_start, work) -> dict:
    seed = abs(int(seed))
    caller = Caller(device, work)
    npan = int(traffic["panels"])
    t = time.perf_counter()
    made = [panels.make_panel(cfg, seed + k) for k in range(npan)]
    t1 = time.perf_counter()
    files = [panels.panel_files(p, work, f"panel{k}", cfg["tped"] == "gz")
             for k, p in enumerate(made)]
    flags = [call_flags(cfg, traffic, seed,
                        panel_inputs(p, cfg, work, k))
             for k, p in enumerate(made)]
    log(f"[roh_bench] set-up: {npan} panel(s) {t1 - t:.3f} s, their files "
        f"{time.perf_counter() - t1:.3f} s")
    ref = reference_for(cfg)
    for f in flags:  # a cell its reference cannot judge fails here
        ref.parse(f)

    def argv(k: int, out: str):
        return call_argv(files[k % npan], out, flags[k % npan])

    setup = [(k, False) for k in range(int(traffic["setup_calls"]))]
    if traced:  # the profiler's first start, outside the window
        setup.append((len(setup), True))
    for k, tr in setup:
        out = os.path.join(work, f"setup{k}")
        rc, wall, _ = caller(argv(k, out), traced=tr)
        log(f"[roh_bench] set-up call {k}{' traced' if tr else ''}: "
            f"rc {rc}, {wall:.3f} s")
        if rc != 0:
            raise RuntimeError(f"set-up call {k} exited {rc}")
        caller.traces()
        compare.remove_outputs(out)
    torch = caller.torch
    if caller.cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    from garlic_tpu_torch.ops import _build
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls, outs = [], []
    while time.perf_counter() - t0 < seconds:
        k = len(calls)
        out = os.path.join(work, f"c{k}")
        rc, wall, err = caller(argv(k, out), traced=traced)
        rec = CallRecord(wall=wall, rc=rc, panel=k % npan)
        if traced:
            rec.phases = {n: float(v) for n, v in _PHASE.findall(err)
                          if n != "TOTAL"}
            rec.counters = profile_counters(err)
            tr = caller.traces()
            rec.trace = tr[-1] if tr else None
        calls.append(rec)
        outs.append(out)
        compare.remove_outputs(out, keep=(".roh.bed", ".log"))
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if caller.cuda else 0
    gc.collect()
    if caller.cuda:
        torch.cuda.empty_cache()
    walls = sorted(c.wall for c in calls)
    log(f"[roh_bench] walls: min {walls[0]:.4f} median "
        f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s")
    log(f"[roh_bench] {cell}: {len(calls)} calls in {window_s:.3f} s; "
        f"set-up {setup_s:.3f} s (nvcc build "
        f"{_build.build_seconds if _build.build_seconds else 0:.1f} s)")

    t_ref = time.perf_counter()
    used = sorted({c.panel for c in calls})
    refs = [ref.call(made[p], flags[p]) if p in used else None
            for p in range(npan)]
    checks = compare.check(outs, [c.panel for c in calls], refs)
    log(f"[roh_bench] reference and check: "
        f"{time.perf_counter() - t_ref:.3f} s")

    kept = [[int(k) for k in panels.kept_loci(p)] for p in made]
    peaks = None
    if caller.cuda:
        with open(os.path.join(HERE, "peaks.json")) as f:
            peaks = json.load(f).get(torch.cuda.get_device_name(0))
    w = Window(calls=calls, seconds=window_s, setup_s=setup_s,
               peak_bytes=peak, nind=int(cfg["individuals"]),
               winsize=int(cfg["winsize"]), snps=list(cfg["snps"]),
               kept=kept, peaks=peaks,
               flags=call_flags(cfg, traffic, seed))
    metrics = {}
    for spec in specs:
        mod = importlib.import_module(f"roh_bench.metrics.{spec['name']}")
        v = mod.read(w)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    failed = sum(1 for c in calls if c.rc != 0)
    correct = failed == 0 and bool(calls) and all(
        v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if caller.cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if caller.cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power": power_limit() if caller.cuda else "none"}
    res = {"correct": correct, "attempted": len(calls), "failed": failed,
           "metrics": metrics, "device": dev}
    tr = [c for c in calls if c.trace]
    if traced and tr:
        dev["busy_s"] = sum(c.trace["busy"] for c in tr) / 1e3
        dev["window_s"] = sum(c.trace["window"] for c in tr) / 1e3
        res["breakdown"] = breakdown(tr)
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return res


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="roh_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    chips = next(int(w["chips"]) for w in bench["workloads"]
                 if w["name"] == a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"[roh_bench] {a.workload} needs {chips} CUDA device(s): "
            "this benchmark measures the card")
        return 2
    # every cell takes one card; a cell on four would bring its mesh flag
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda:0",
                   t_start, bench=bench)
    bad = forbidden_modules()
    if bad:
        log(f"[roh_bench] the run loaded {', '.join(bad)}: refused")
        return 3
    log(f"[roh_bench] card: {res['device']['power']}")
    for k, c in res["checks"].items():
        log(f"[roh_bench] check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(res), flush=True)
    return 0
