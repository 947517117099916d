#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (garlic_tpu_torch) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. environment: the card (nvidia-smi), torch/CUDA/nvcc versions, and the
   build of the port's CUDA kernels from csrc/ (nvcc, sm_90a);
2. kernels: K1 (lod_windows) and K2 (covered) against their plain PyTorch
   versions on the card, on the same inputs: K1's f32 sums bit for bit,
   K2's three u8 planes exactly; shapes are the bench chromosome
   (200 x 500,000, W=60), W=120 and ragged small cases; median times over
   21 launches with CUDA events;
3. tie band: max |win_f32 - win_f64| / (2^-23 * W * tmax) on the bench
   chromosome at W=60 and W=120, f64 from the exact engine; it must stay
   within the 256 the tie patrol's band assumes;
4. main path: bench.py's panel (200 x (500k, 500k), seed 42) and pinned
   flags through `python -m garlic_tpu_torch` (run in-process), fast
   engine cold then warm with --tpu-panel-cache, then the exact engine;
   the .roh.bed files must be byte-identical and .freq.gz equal; then
   --raw-lod on a 50 x (100k, 100k) panel, fast against exact.  The
   kernel launch counters are zeroed just before this phase and read
   after it: K2 must run for every chromosome of every fast pinned run,
   K1 in the --raw-lod run.

The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  The script imports no JAX (an import
hook refuses it) and writes only under build/chip_smoke/, removed at
the end.
"""

from __future__ import annotations

import gzip
import json
import math
import os
import runpy
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
# bench.py's panel and pinned flags; the smaller --raw-lod panel
BENCH_PANEL = dict(nind=200, nloci_per_chr=(500_000, 500_000), seed=42,
                   spacing_mean=4000)
RAWLOD_PANEL = dict(nind=50, nloci_per_chr=(100_000, 100_000), seed=7,
                    spacing_mean=4000)
FLAGS = ["--build", "hg18", "--winsize", "60", "--error", "0.001",
         "--lod-cutoff", "1.5", "--size-bounds", "500000", "1000000",
         "--kde-subsample", "0"]
ERROR, MAX_GAP, OVERLAP_FRAC = 0.001, 200000, 0.25  # the flags' values
HG18_CHR1_CENTROMERE = (121236957, 123476957)
TIE_BAND_FACTOR = 256.0
SOURCE = "garlic_tpu_torch/csrc/lod_windows.cu"


def say(*a):
    print(*a, flush=True)


class _NoJax:
    """Import hook: the port must run without JAX."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"chip_smoke: {name} must not be imported")
        return None


class _Chrom:
    """The fields of a loaded chromosome that the port's kernel inputs,
    exact engine and tie band read, over a synthetic panel's arrays."""

    def __init__(self, name, positions, genotypes):
        self.chrom = name
        self.positions = positions
        self.genotypes = genotypes
        self.geno_is_packed_only = False
        self.nind, self.nloci = genotypes.shape
        obs = genotypes >= 0
        self.freq = (np.where(obs, genotypes, 0).sum(0)
                     / np.maximum(2 * obs.sum(0), 1)).astype(np.float64)


class _Centro:
    def __init__(self, start, end):
        self._s, self._e = start, end

    def start(self, chrom):
        return self._s

    def end(self, chrom):
        return self._e


def _median_ms(fn, n=21):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def phase_environment():
    import torch
    from garlic_tpu_torch.ops import _build
    say("== phase 1: environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    say(smi)
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say(nvcc[-1])
    t0 = time.perf_counter()
    _build.library()
    say(f"kernel library {os.path.relpath(_build.library_path(), REPO)}: "
        f"nvcc {_build.build_seconds}s, ready in "
        f"{time.perf_counter() - t0:.3f}s")
    for line in _build.ptxas_report().splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas:", line.strip())


def _random_case(I, L, W, seed, dev):
    from garlic_tpu_torch.ops import cuda_lod
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, (I, L)).astype(np.int8)
    g[rng.random((I, L)) < 0.01] = -9
    pos = np.cumsum(rng.integers(100, 4000, L)).astype(np.int64)
    chrom = _Chrom("chr1", pos, g)
    chrom.freq[::97] = 0.0  # monomorphic sites score 0
    # a centromere masks some windows, where that leaves others live
    c0 = L // 3 if L >= 4 * W else L - 1
    centro = _Centro(int(pos[c0]) + 1, int(pos[min(c0 + 2, L - 1)]) + 1)
    return cuda_lod.chrom_device_inputs(chrom, centro, W, ERROR, 20000, dev)


def phase_kernels(chrom, centro):
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import cuda_lod
    say("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    cases = []
    for W in (60, 120):
        inp = cuda_lod.chrom_device_inputs(chrom, centro, W, ERROR, MAX_GAP,
                                           dev)
        cases.append((f"bench chr1 {chrom.nind}x{chrom.nloci} W={W}", inp, W,
                      1.5, float(math.ceil(OVERLAP_FRAC * W)),
                      pipeline._tie_band([chrom], W, ERROR)))
    for name, (I, L, W) in (("ragged 37x1001 W=60", (37, 1001, 60)),
                            ("nwin=1 5x64 W=64", (5, 64, 64)),
                            ("W=1 3x10", (3, 10, 1)),
                            ("ragged 9x3001 W=120", (9, 3001, 120))):
        inp = _random_case(I, L, W, seed=L, dev=dev)
        plain = cuda_lod.lod_windows_plain(*inp, W)
        live = plain[plain != -9999]
        cases.append((name, inp, W, float(live.median()),
                      float(max(1, W // 4)), 0.05))
    err = {"lod_windows": 0.0, "covered": 0.0}
    for name, (pk, tb, ms), W, cut, thr, delta in cases:
        a = cuda_lod.lod_windows(pk, tb, ms, W)
        b = cuda_lod.lod_windows_plain(pk, tb, ms, W)
        c = cuda_lod.covered(pk, tb, ms, W, cut, thr, delta)
        d = cuda_lod.covered_plain(pk, tb, ms, W, cut, thr, delta)
        torch.cuda.synchronize()
        k1 = torch.equal(a.view(torch.int32), b.view(torch.int32))
        k2 = all(torch.equal(x, y) for x, y in zip(c, d))
        e1 = float((a - b).abs().max())
        e2 = max(int((x.int() - y.int()).abs().max()) for x, y in zip(c, d))
        err["lod_windows"] = max(err["lod_windows"], e1)
        err["covered"] = max(err["covered"], float(e2))
        say(f"  {name}: K1 bitwise {k1} (max |diff| {e1}); K2 planes equal "
            f"{k2} (covered {int(c[0].sum())}, suspects {int(c[1].sum())}, "
            f"above {int(c[2].sum())})")
        if not (k1 and k2):
            raise AssertionError(f"kernel differs from its plain version: "
                                 f"{name}")
    (pk, tb, ms), W, cut, thr, delta = cases[0][1:6]
    times = {
        "lod_windows": (_median_ms(lambda: cuda_lod.lod_windows(pk, tb, ms,
                                                                W)),
                        _median_ms(lambda: cuda_lod.lod_windows_plain(
                            pk, tb, ms, W))),
        "covered": (_median_ms(lambda: cuda_lod.covered(pk, tb, ms, W, cut,
                                                        thr, delta)),
                    _median_ms(lambda: cuda_lod.covered_plain(
                        pk, tb, ms, W, cut, thr, delta))),
    }
    for k, (t, tp) in times.items():
        say(f"  {k} at the bench shape: kernel {t:.4f} ms, plain "
            f"{tp:.4f} ms (median of 21, CUDA events)")
    say(f"  launch counters after the comparisons: {cuda_lod.LAUNCHES}")
    return err, times


def phase_tie_band(chrom, centro):
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import cuda_lod
    from garlic_tpu_torch.ops import lod as lod_ops
    say("== phase 3: tie band")
    tmax = pipeline._corner_tmax(chrom, ERROR)
    ratios = {}
    for W in (60, 120):
        pk, tb, ms = cuda_lod.chrom_device_inputs(chrom, centro, W, ERROR,
                                                  MAX_GAP, "cuda")
        w32 = cuda_lod.lod_windows(pk, tb, ms, W).cpu().numpy()
        nwin = w32.shape[1]
        w64 = lod_ops.calc_lod_windows(chrom, centro, W, ERROR,
                                       MAX_GAP)[:, :nwin]
        live = ms.cpu().numpy() == 0
        dev = np.abs(w32[:, live].astype(np.float64) - w64[:, live]).max()
        ratios[W] = float(dev / (2.0 ** -23 * W * tmax))
        say(f"  W={W}: max |f32 - f64| = {dev:.6g} over {chrom.nind} rows x "
            f"{int(live.sum())} windows; ratio {ratios[W]:.3f} "
            f"(band {TIE_BAND_FACTOR:g}, tmax {tmax:.4f})")
        del pk, tb, ms
        torch.cuda.empty_cache()
    if max(ratios.values()) > TIE_BAND_FACTOR:
        raise AssertionError(f"tie band exceeded: {ratios}")
    return ratios


def _run_port(argv, label):
    """One `python -m garlic_tpu_torch` run, in this process."""
    import torch
    saved = sys.argv
    sys.argv = ["garlic_tpu_torch"] + argv
    t0 = time.perf_counter()
    rc = 0
    try:
        runpy.run_module("garlic_tpu_torch", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        rc = e.code
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"  {label}: exit {rc}, wall {wall:.3f}s")
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}")
    return wall


def _read(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _raw_values(out, chroms):
    vals = []
    for c in chroms:
        text = _read(f"{out}.POP1.{c}.raw.lod.windows.gz").decode()
        vals.append(np.array(text.replace("NA", "nan").split(),
                             dtype=np.float64))
    return np.concatenate(vals)


def phase_main_path(panel):
    from garlic_tpu_torch.ops import cuda_lod
    from tests.util import make_panel, write_tped
    say("== phase 4: main path (python -m garlic_tpu_torch)")
    tped = os.path.join(WORK, "bench.tped.gz")
    tfam = os.path.join(WORK, "bench.tfam")
    t0 = time.perf_counter()
    write_tped(panel, tped, tfam)
    say(f"  wrote the bench panel in {time.perf_counter() - t0:.1f}s")
    base = ["--tped", tped, "--tfam", tfam] + FLAGS + ["--tpu-panel-cache",
                                                       "--tpu-profile"]
    nchrom = len(panel.chrom_names)
    for k in cuda_lod.LAUNCHES:
        cuda_lod.LAUNCHES[k] = 0
    walls = {}
    for label, engine in (("fast_cold", "fast"), ("fast_warm", "fast"),
                          ("exact", "exact")):
        before = dict(cuda_lod.LAUNCHES)
        walls[label] = _run_port(base + ["--tpu-engine", engine, "--out",
                                         os.path.join(WORK, label)], label)
        k2 = cuda_lod.LAUNCHES["covered"] - before["covered"]
        if engine == "fast" and k2 < nchrom:
            raise AssertionError(f"{label}: K2 ran {k2} times for {nchrom} "
                                 "chromosomes")
    out = {k: os.path.join(WORK, k) for k in walls}
    bed_x = _read(out["exact"] + ".roh.bed")
    freq_x = _read(out["exact"] + ".freq.gz")
    for k in ("fast_cold", "fast_warm"):
        if _read(out[k] + ".roh.bed") != bed_x:
            raise AssertionError(f"{k}.roh.bed differs from the exact "
                                 "engine's")
        if _read(out[k] + ".freq.gz") != freq_x:
            raise AssertionError(f"{k}.freq.gz differs from the exact "
                                 "engine's")
    say(f"  .roh.bed byte-identical across fast cold, fast warm and exact "
        f"({bed_x.count(b'track')} individuals, "
        f"{len(bed_x.splitlines()) - bed_x.count(b'track')} ROH); "
        ".freq.gz equal")

    small = make_panel(**RAWLOD_PANEL)
    stped = os.path.join(WORK, "small.tped.gz")
    stfam = os.path.join(WORK, "small.tfam")
    write_tped(small, stped, stfam)
    sbase = ["--tped", stped, "--tfam", stfam, "--raw-lod"] + FLAGS
    before = cuda_lod.LAUNCHES["lod_windows"]
    for label, engine in (("rawlod_fast", "fast"), ("rawlod_exact",
                                                    "exact")):
        walls[label] = _run_port(sbase + ["--tpu-engine", engine, "--out",
                                          os.path.join(WORK, label)], label)
    k1 = cuda_lod.LAUNCHES["lod_windows"] - before
    if k1 < len(small.chrom_names):
        raise AssertionError(f"--raw-lod: K1 ran {k1} times")
    rf, rx = (os.path.join(WORK, k) for k in ("rawlod_fast",
                                               "rawlod_exact"))
    if _read(rf + ".roh.bed") != _read(rx + ".roh.bed"):
        raise AssertionError("--raw-lod: fast .roh.bed differs from exact")
    names = [f"chr{c}" for c in small.chrom_names]
    vf, vx = _raw_values(rf, names), _raw_values(rx, names)
    if not np.array_equal(np.isnan(vf), np.isnan(vx)):
        raise AssertionError("--raw-lod: NA positions differ")
    m = ~np.isnan(vx)
    # %g keeps six significant digits, hence the relative term
    if not np.allclose(vf[m], vx[m], rtol=1e-5, atol=1e-4):
        raise AssertionError("--raw-lod: window values differ")
    say(f"  --raw-lod: BED identical, {m.sum()} raw values within "
        f"atol 1e-4 + rtol 1e-5 (max |diff| "
        f"{np.abs(vf[m] - vx[m]).max():.3g})")
    launches = dict(cuda_lod.LAUNCHES)
    say(f"  launches in this phase: {launches}")
    return walls, launches


def main() -> int:
    sys.meta_path.insert(0, _NoJax())
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tests.util import make_panel
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        phase_environment()
        t0 = time.perf_counter()
        panel = make_panel(**BENCH_PANEL)
        say(f"bench panel {BENCH_PANEL['nind']} x "
            f"{BENCH_PANEL['nloci_per_chr']} made in "
            f"{time.perf_counter() - t0:.1f}s")
        chrom = _Chrom("chr1", panel.positions[0], panel.genotypes[0])
        centro = _Centro(*HG18_CHR1_CENTROMERE)
        err, times = phase_kernels(chrom, centro)
        phase_tie_band(chrom, centro)
        del chrom
        walls, launches = phase_main_path(panel)
        say("wall seconds: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in walls.items()))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    replaces = {"lod_windows": "garlic_tpu/ops/pallas_lod.py:93",
                "covered": "garlic_tpu/ops/pallas_lod.py:291"}
    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": replaces[k], "launches": launches[k],
                "max_abs_err": err[k], "ms": times[k][0],
                "plain_ms": times[k][1]} for k in ("lod_windows", "covered")]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
