#!/usr/bin/env python3
"""Two checkouts of the repository against each other on one CUDA card:
the port's kernel times and its warm walls, interleaved in one run.

    python3 chip_ab.py PARENT_DIR CHANGE_DIR [--pairs N] [--out DIR]

Each directory is a checkout of the repository (for example a commit
unpacked with `git archive` under build/, which .gitignore lists).  One
worker process per checkout imports that checkout's garlic_tpu_torch
(and its chip_smoke.py's synthetic chromosome), builds its kernels, and
takes orders from this process over a pipe, so the two sides are timed
the same way and in alternating order:

- kernels: K1-K4 on bench chromosome 1 (200 x 500,000, W=60, K3/K4 over
  the GQ term plane), built as chip_smoke.py phase 2 builds them, and
  K5 (HR^2, and r^2 over seeded first-copy bits) and K6 (over the codes
  and the per-class score table, and over the f32 score plane) on the
  same codes with a seeded 1/LD band; per kernel the median of 21 single
  launches timed with CUDA events (chip_smoke.py's method) and, beside
  it, the median of 21 spans of 10 back-to-back launches divided by 10;
  order parent, change, change, parent.  K5 runs as each side's route
  runs it: into fresh planes where the checkout's pair_counts takes
  `fresh`, else (the kernel before store mode) into planes zeroed first,
  the zeroing timed with it; K7 and K8 through the functions the
  automatic run calls, on seeded inputs of the bench shapes (a pool of
  3,328,600 f32 windows from a two-mode mixture against its 512-point
  grid: ops/kde.gauss_sums, upload included; 5,530 ROH lengths from a
  three-mode mixture, K = 3: parallel/engine.fit_gmm_sharded over the
  card's 1x1 mesh (K8's fit mode) and over a 2x2 mesh laid on it (one
  stats-mode launch per shard and iteration), and ops/gmm.em_stats per
  call on all the lengths), each side through its own checkout's route;
- walls: bench.py's panel (200 x (500k, 500k), seed 42), pinned
  (--lod-cutoff 1.5 --size-bounds 500000 1000000), auto (neither), gq
  (pinned with chip_smoke.py's GQ TGLS file) and weighted (pinned with
  --weighted over chip_smoke.py's bench map), --tpu-engine fast
  --tpu-panel-cache, no --tpu-profile; each side runs each once cold
  (its own names for the TPED and the TGLS file, so the sidecars and
  the pool are its own), then N warm runs of each, the order of the two
  sides alternating from one pair to the next; a run is one in-process
  `python -m garlic_tpu_torch`, timed on the host clock up to a CUDA
  synchronize;
- the device-memory peak of every warm run (torch.cuda.
  max_memory_allocated above what was allocated before it, reset just
  before the run);
- one more warm auto run of each side under cProfile: the top functions
  by own time are printed, the whole table is written to
  OUT/profile_<side>.txt.

The workers' own output goes to OUT/worker_<side>.log.  The last line of
standard output is one JSON object with every time measured.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_PANEL = dict(nind=200, nloci_per_chr=(500_000, 500_000), seed=42,
                   spacing_mean=4000)
W, ERROR, MAX_GAP, OVERLAP_FRAC = 60, 0.001, 200000, 0.25
COMMON = ["--build", "hg18", "--winsize", str(W), "--error", str(ERROR),
          "--kde-subsample", "0", "--tpu-panel-cache", "--tpu-engine",
          "fast"]
PINNED = COMMON + ["--lod-cutoff", "1.5", "--size-bounds", "500000",
                   "1000000"]
# configuration -> its flags; {tgls} and {map} are the side's files
CONFIGS = {"pinned": PINNED,
           "auto": COMMON,
           "gq": PINNED + ["--tgls", "{tgls}", "--gl-type", "GQ"],
           "weighted": PINNED + ["--map", "{map}", "--weighted"]}
KERNELS = ("lod_windows", "covered", "window_sums", "covered_terms",
           "pair_counts", "pair_counts_r2", "wlod_windows",
           "wlod_windows_terms", "gauss_sums", "gmm_em", "gmm_em_2x2",
           "em_stats")
POOL, ROH = 3_328_600, 5_530  # the bench auto run's pool and ROH count


def say(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# The worker: one per checkout, in that checkout's directory
# ---------------------------------------------------------------------------

def _events_ms(fn, reps, n=21):
    """Median over n samples of CUDA events around `reps` back-to-back
    fn() calls, divided by reps."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


class _KernelInputs:
    """The bench chromosome's K1-K4 inputs on the card, as chip_smoke.py
    phase 2 makes them, and K5's and K6's over the same codes."""

    def __init__(self):
        import chip_smoke
        import torch
        from garlic_tpu_torch import pipeline
        from garlic_tpu_torch.ops import cuda_lod
        from tests.util import make_panel
        panel = make_panel(**BENCH_PANEL)
        chrom = chip_smoke._Chrom("chr1", panel.positions[0],
                                  panel.genotypes[0], seed=11)
        centro = chip_smoke._Centro(*chip_smoke.HG18_CHR1_CENTROMERE)
        dev = torch.device("cuda")
        self.pk, self.tb, self.ms = cuda_lod.chrom_device_inputs(
            chrom, centro, W, ERROR, MAX_GAP, dev)
        self.terms, _ = cuda_lod.chrom_gl_inputs(chrom, centro, W, MAX_GAP,
                                                 dev)
        thr = float(math.ceil(OVERLAP_FRAC * W))
        self.a2 = (1.5, thr, pipeline._tie_band([chrom], W, ERROR, False))
        self.a4 = (1.5, thr, pipeline._tie_band([chrom], W, ERROR, True))
        # K5 / K6: the same codes, seeded first-copy bits, a seeded 1/LD
        # band and per-class score table (class 3 zeros), no mask
        import numpy as np
        from garlic_tpu_torch.ops import device_wlod as dw
        I, L = chrom.genotypes.shape
        nwin = L - W + 1
        rng = np.random.default_rng(13)
        self.wpk = cuda_lod._upload(cuda_lod.packed_host(chrom), dev)
        self.fcb = cuda_lod._upload(dw.pack_first_copy(
            rng.random((I, L)) < 0.5), dev)
        table = rng.normal(0.0, 0.7, (4, L)).astype(np.float32)
        table[3] = 0.0
        self.table = cuda_lod._upload(table, dev)
        self.inv_t = cuda_lod._upload(
            rng.uniform(0.05, 1.0, (W, nwin)).astype(np.float32), dev)
        self.miss = torch.zeros(nwin, dtype=torch.uint8, device=dev)
        self.score = dw._wlod_score_from_table(
            cuda_lod.decode_2bit(self.wpk, L), self.table).contiguous()
        self.T = torch.empty((W, L), dtype=torch.int32, device=dev)
        self.X = torch.empty_like(self.T)
        # K7 / K8: a seeded pool and its grid, seeded ROH lengths
        from garlic_tpu_torch.ops import kde
        from garlic_tpu_torch.parallel.mesh import make_mesh
        pool = np.concatenate([rng.normal(-1.5, 0.8, POOL // 2),
                               rng.normal(1.2, 0.6, POOL - POOL // 2)])
        self.h, self.targets, _ = kde._kde_grid(pool)
        self.pool = pool.astype(np.float32)
        a, b = ROH * 45 // 100, ROH * 33 // 100
        self.lengths = np.concatenate([
            rng.normal(2.2e5, 5e4, a), rng.normal(8.5e5, 1.8e5, b),
            rng.normal(2.6e6, 6e5, ROH - a - b)]).clip(1e4, None)
        self.init = chip_smoke._gmm_init(self.lengths)
        self.mesh = make_mesh(1, 1, [dev])
        self.mesh4 = make_mesh(2, 2, [dev] * 4)
        self.x = torch.from_numpy(self.lengths).to(dev)
        self.params = [torch.from_numpy(v).to(dev) for v in self.init]

    def calls(self):
        import inspect
        from garlic_tpu_torch.ops import cuda_lod, gmm, kde
        from garlic_tpu_torch.ops import device_wlod as dw
        from garlic_tpu_torch.parallel import engine
        pk, tb, ms, terms, a2, a4 = (self.pk, self.tb, self.ms, self.terms,
                                     self.a2, self.a4)
        wpk, fcb, T, X = self.wpk, self.fcb, self.T, self.X
        table, inv_t, miss, score = (self.table, self.inv_t, self.miss,
                                     self.score)
        if "fresh" in inspect.signature(dw.pair_counts).parameters:
            def pairs(bits):
                dw.pair_counts(wpk, bits, T, X, W, fresh=True)
        else:
            def pairs(bits):
                T.zero_()
                X.zero_()
                dw.pair_counts(wpk, bits, T, X, W)
        return {"lod_windows": lambda: cuda_lod.lod_windows(pk, tb, ms, W),
                "covered": lambda: cuda_lod.covered(pk, tb, ms, W, *a2),
                "window_sums": lambda: cuda_lod.window_sums(terms, ms, W),
                "covered_terms": lambda: cuda_lod.covered_terms(terms, ms, W,
                                                                *a4),
                "pair_counts": lambda: pairs(None),
                "pair_counts_r2": lambda: pairs(fcb),
                "wlod_windows": lambda: dw.wlod_windows(wpk, table, inv_t,
                                                        miss, W),
                "wlod_windows_terms": lambda: dw.wlod_windows_terms(
                    score, inv_t, miss, W),
                "gauss_sums": lambda: kde.gauss_sums(
                    self.pool, self.targets, self.h, self.mesh.first),
                "gmm_em": lambda: engine.fit_gmm_sharded(
                    self.lengths, 3, *self.init, self.mesh),
                "gmm_em_2x2": lambda: engine.fit_gmm_sharded(
                    self.lengths, 3, *self.init, self.mesh4),
                "em_stats": lambda: gmm.em_stats(self.x, *self.params)}


def _run_port(argv):
    """One in-process `python -m garlic_tpu_torch`: (exit code, seconds,
    device-memory peak in bytes above what was allocated before it)."""
    import runpy
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    saved = sys.argv
    sys.argv = ["garlic_tpu_torch"] + argv
    rc = 0
    t0 = time.perf_counter()
    try:
        runpy.run_module("garlic_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        rc = e.code or 0
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() - base


def _profiled(argv, path, tree):
    """_run_port under cProfile; the table by own time is written to
    path, and the top 15 returned with the checkout's prefix cut."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    rc, wall, _ = _run_port(argv)
    prof.disable()
    with open(path, "w") as f:
        pstats.Stats(prof, stream=f).sort_stats("tottime").print_stats(60)
    rows = sorted(pstats.Stats(prof).stats.items(),
                  key=lambda kv: -kv[1][2])[:15]
    top = [[f"{os.path.relpath(k[0], tree) if k[0].startswith(tree) else k[0]}"
            f":{k[1]}({k[2]})", v[1], v[2], v[3]] for k, v in rows]
    return rc, wall, top


def serve(tree):
    """The worker's loop: one JSON order per line on stdin, one JSON
    answer per line on the pipe that was stdout; everything else the
    process prints goes to stderr."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    answer = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    import garlic_tpu_torch
    import torch
    inputs = None
    for line in sys.stdin:
        order = json.loads(line)
        op = order["op"]
        if op == "hello":
            out = {"package": os.path.dirname(garlic_tpu_torch.__file__),
                   "torch": torch.__version__,
                   "device": torch.cuda.get_device_name(0)}
        elif op == "kernels":
            if inputs is None:
                inputs = _KernelInputs()
            out = {k: {"ms": _events_ms(fn, 1), "ms_10": _events_ms(fn, 10)}
                   for k, fn in inputs.calls().items()}
        elif op == "drop_inputs":
            inputs = None
            torch.cuda.empty_cache()
            out = {}
        elif op == "run":
            rc, wall, peak = _run_port(order["argv"])
            out = {"rc": rc, "wall": wall, "peak": peak}
        elif op == "profile":
            rc, wall, top = _profiled(order["argv"], order["path"], tree)
            out = {"rc": rc, "wall": wall, "top": top}
        else:
            raise ValueError(f"unknown order {op!r}")
        answer.write(json.dumps(out) + "\n")
        answer.flush()


# ---------------------------------------------------------------------------
# The controller: this process
# ---------------------------------------------------------------------------

class _Worker:
    def __init__(self, side, tree, out):
        self.side, self.tree = side, tree
        self.log = open(os.path.join(out, f"worker_{side}.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import sys; sys.path.insert(0, {HERE!r}); import chip_ab; "
             f"chip_ab.serve({tree!r})"],
            cwd=tree, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.log, text=True)

    def ask(self, **order):
        self.proc.stdin.write(json.dumps(order) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the {self.side} worker ended; see "
                               f"{self.log.name}")
        return json.loads(line)

    def close(self):
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


def _spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "runs": xs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--out", help="where the profiles and worker logs go",
                    default=os.path.join(HERE, "build", "chip_ab_out"))
    args = ap.parse_args()
    args.out = os.path.abspath(args.out)  # the workers run in their trees
    sys.path.insert(0, HERE)
    import chip_smoke
    from tests.util import make_panel, write_map_scaffold, write_tped
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    work = os.path.join(HERE, "build", "chip_ab")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.makedirs(args.out, exist_ok=True)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    workers = {}
    try:
        t0 = time.perf_counter()
        panel = make_panel(**BENCH_PANEL)
        tped, tfam = os.path.join(work, "bench.tped.gz"), \
            os.path.join(work, "bench.tfam")
        write_tped(panel, tped, tfam)
        gq = os.path.join(work, "bench.gq.tgls")
        chip_smoke.write_tgls(panel, gq, chip_smoke.GQ_TOKENS, seed=5)
        wmap = os.path.join(work, "bench.map.gz")
        write_map_scaffold(panel, wmap, rate_cm_per_mb=chip_smoke.MAP_RATE)
        del panel
        say(f"bench panel, GQ TGLS file and map written in "
            f"{time.perf_counter() - t0:.1f}s")
        for side, tree in trees.items():
            workers[side] = _Worker(side, tree, args.out)
            say(f"{side}: {workers[side].ask(op='hello')}")

        kernels = {side: [] for side in trees}
        for side in ("parent", "change", "change", "parent"):
            kernels[side].append(workers[side].ask(op="kernels"))
            say(f"kernels, {side}: " + ", ".join(
                f"{k} {v['ms']:.4f} ms (10 launches: {v['ms_10']:.4f})"
                for k, v in kernels[side][-1].items()))
        for w in workers.values():
            w.ask(op="drop_inputs")

        argv = {}
        for side in trees:
            copy = os.path.join(work, f"{side}.tped.gz")
            shutil.copy(tped, copy)
            tgls = os.path.join(work, f"{side}.gq.tgls")
            os.link(gq, tgls)  # a name of its own: its own .gtlc sidecar
            base = ["--tped", copy, "--tfam", tfam, "--out",
                    os.path.join(work, side)]
            argv[side] = {c: base + [f.format(tgls=tgls, map=wmap)
                                     for f in flags]
                          for c, flags in CONFIGS.items()}
            for c in CONFIGS:
                got = workers[side].ask(op="run", argv=argv[side][c])
                say(f"{side} {c} cold: {got}")
                if got["rc"] != 0:
                    raise RuntimeError(f"{side} {c} exited {got['rc']}")

        walls = {side: {c: [] for c in CONFIGS} for side in trees}
        peaks = {side: {c: [] for c in CONFIGS} for side in trees}
        for i in range(args.pairs):
            order = ("parent", "change") if i % 2 == 0 else ("change",
                                                             "parent")
            for c in CONFIGS:
                for side in order:
                    got = workers[side].ask(op="run", argv=argv[side][c])
                    if got["rc"] != 0:
                        raise RuntimeError(f"{side} {c} exited {got['rc']}")
                    walls[side][c].append(got["wall"])
                    peaks[side][c].append(got["peak"])
            say(f"pair {i} ({order[0]} first): " + ", ".join(
                f"{side} {c} {walls[side][c][-1]:.3f}s"
                for c in CONFIGS for side in order))

        profiles = {}
        for side in trees:
            path = os.path.join(args.out, f"profile_{side}.txt")
            profiles[side] = workers[side].ask(op="profile",
                                               argv=argv[side]["auto"],
                                               path=path)
            say(f"cProfile, warm auto, {side}: wall "
                f"{profiles[side]['wall']:.3f}s; top by own time:")
            for name, calls, own, cum in profiles[side]["top"]:
                say(f"  {own:8.4f}s own {cum:8.4f}s cum {calls:8d}  {name}")
    finally:
        for w in workers.values():
            w.close()
        shutil.rmtree(work, ignore_errors=True)

    summary = {
        "kernels": {side: {k: {m: [r[k][m] for r in kernels[side]]
                               for m in ("ms", "ms_10")} for k in KERNELS}
                    for side in trees},
        "walls": {side: {c: _spread(walls[side][c]) for c in CONFIGS}
                  for side in trees},
        "peak_bytes": {side: {c: _spread(peaks[side][c]) for c in CONFIGS}
                       for side in trees},
        "profiled_wall": {side: profiles[side]["wall"] for side in trees}}
    for c in CONFIGS:
        p, ch = walls["parent"][c], walls["change"][c]
        faster = sum(b < a for a, b in zip(p, ch))
        say(f"warm {c}: parent median {statistics.median(p):.4f}s "
            f"[{min(p):.4f}, {max(p):.4f}], change median "
            f"{statistics.median(ch):.4f}s [{min(ch):.4f}, {max(ch):.4f}]; "
            f"change faster in {faster} of {len(p)} pairs; device-memory "
            f"peak parent {max(peaks['parent'][c]) / 1e6:.1f} MB, change "
            f"{max(peaks['change'][c]) / 1e6:.1f} MB")
    say(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
