#!/usr/bin/env python
"""Headline benchmark of the PyTorch/CUDA port (garlic_tpu_torch):
end-to-end Phase I-III-IV ROH calling throughput on one CUDA card.

The counterpart of bench.py, with its measure: the same panel (200
diploid individuals x (500,000, 500,000) SNPs, seed 42, cached in
.bench_cache/ under bench.py's names, so both scripts share it), the
same pinned flags, garlic_tpu_torch.pipeline.run_main in process with
--tpu-engine fast --tpu-panel-cache --tpu-profile, best of 7 runs, and
the same JSON line.  Each run's wall ends with torch.cuda.synchronize()
and includes the synchronizations of --tpu-profile's phase marks.

On stderr: the card's name and power limit, K1's windows/s on bench.py's
kernel-diagnostic inputs, each run's wall and --tpu-profile lines, the
device-memory peak of the best run, and the process's kernel launches.
Without a CUDA device it exits 1 and prints no JSON line.

Run from the repository root:

    python3 bench_torch.py

Prints ONE JSON line on stdout:
  {"metric": "lod_windows_per_sec", "value": N, "unit": "windows/s",
   "vs_baseline": N}
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.pipeline import run_main

# Copy of bench.py:31-33.
REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cache")
ORACLE = "/root/reference/bin/linux/garlic"

# Copy of bench.py:35-40.
NIND = 200
NLOCI = (500_000, 500_000)
WINSIZE = 60
FLAGS = ["--build", "hg18", "--winsize", str(WINSIZE), "--error", "0.001",
         "--lod-cutoff", "1.5", "--size-bounds", "500000", "1000000",
         "--kde-subsample", "0"]

RUNS = 7  # bench.py's best of 7


def log(*a):
    """Copy of bench.py:48."""
    print(*a, file=sys.stderr, flush=True)


def total_windows() -> int:
    """Copy of bench.py:52."""
    return NIND * sum(L - WINSIZE + 1 for L in NLOCI)


def ensure_panel():
    """The bench panel's TPED and TFAM under CACHE, synthesized once.

    Copy of bench.py:56."""
    os.makedirs(CACHE, exist_ok=True)
    tag = f"{NIND}x{sum(NLOCI) // 1000}k"
    tped = os.path.join(CACHE, f"bench_{tag}.tped.gz")
    tfam = os.path.join(CACHE, f"bench_{tag}.tfam")
    if os.path.exists(tped) and os.path.exists(tfam):
        return tped, tfam
    log(f"bench: synthesizing {NIND}x{sum(NLOCI)} panel (cached after first run)")
    sys.path.insert(0, REPO)
    from tests.util import make_panel, write_tped
    panel = make_panel(nind=NIND, nloci_per_chr=NLOCI, seed=42,
                       spacing_mean=4000)
    write_tped(panel, tped, tfam)
    return tped, tfam


def oracle_baseline(tped: str, tfam: str) -> float:
    """windows/s of single-core garlic on the bench panel (cached).

    Copy of bench.py:72."""
    cache = os.path.join(
        CACHE, f"oracle_baseline_{NIND}x{sum(NLOCI) // 1000}k.json")
    if os.path.exists(cache):
        with open(cache) as f:
            return json.load(f)["windows_per_sec"]
    if not os.access(ORACLE, os.X_OK):
        raise RuntimeError("oracle binary unavailable and no cached baseline")
    log("bench: measuring single-core oracle baseline (one-time)")
    args = [ORACLE, "--tped", os.path.basename(tped),
            "--tfam", os.path.basename(tfam), "--threads", "1",
            "--out", "oracle_bench"] + FLAGS
    t0 = time.perf_counter()
    r = subprocess.run(args, cwd=CACHE, capture_output=True, text=True,
                       timeout=3600)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"oracle failed: {r.stderr[-500:]}")
    wps = total_windows() / dt
    with open(cache, "w") as f:
        json.dump({"windows_per_sec": wps, "wall_s": dt,
                   "panel": {"nind": NIND, "nloci": list(NLOCI),
                             "winsize": WINSIZE},
                   "binary": ORACLE, "flags": FLAGS}, f, indent=1)
    log(f"bench: oracle {dt:.1f}s -> {wps:,.0f} windows/s")
    return wps


def run_ours(tped: str, tfam: str, device=None) -> float:
    """End-to-end wall-clock of the port's pipeline (fast engine) ->
    windows/s.  device: run_main's (None: the visible CUDA devices; the
    tests pass "cpu").  A nonzero exit, or a missing or empty BED,
    raises.

    Adapted from bench.py:101: garlic_tpu_torch's run_main, its own out
    name (a garlic_tpu run in the same cache keeps its BED), and a
    synchronize on the card before the clock stops."""
    args = (["--tped", os.path.basename(tped),
             "--tfam", os.path.basename(tfam),
             "--out", "torch_bench", "--tpu-engine", "fast",
             # binary panel sidecar: run 1 parses gz + writes it, the
             # later runs load it
             "--tpu-panel-cache", "--tpu-profile"] + FLAGS)
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    old = os.getcwd()
    os.chdir(CACHE)
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_main(args, prog="garlic-tpu-torch", device=device)
        if rc == 0 and on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        os.chdir(old)
    log(buf.getvalue().strip())
    if rc != 0:
        raise RuntimeError(f"pipeline exited {rc}")
    bedfile = os.path.join(CACHE, "torch_bench.roh.bed")
    if not os.path.exists(bedfile) or os.path.getsize(bedfile) == 0:
        raise RuntimeError("pipeline produced no BED output (silent failure)")
    os.remove(bedfile)
    wps = total_windows() / dt
    log(f"bench: run wall {dt:.3f}s -> {wps:,.0f} windows/s")
    return wps


def kernel_inputs(device):
    """K1's inputs for bench.py's kernel diagnostic (:137-141) on
    `device`: seeded genotypes 0..2 [NIND, NLOCI[0]] as 2-bit codes, rows
    0-2 of the standard-normal [4, L] table (lod_windows_fast_jax reads
    row 3 only for missing genotypes, and there are none), and a mask
    with no missing window."""
    I, L, W = NIND, NLOCI[0], WINSIZE
    rng = np.random.default_rng(0)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    table = rng.standard_normal((4, L)).astype(np.float32)
    return (torch.from_numpy(cuda_lod.pack_codes(geno)).to(device),
            torch.from_numpy(np.ascontiguousarray(table[:3])).to(device),
            torch.zeros(L - W + 1, dtype=torch.uint8, device=device))


def kernel_throughput(device="cuda") -> float:
    """Device-only Phase-I kernel windows/s (diagnostic, stderr only):
    K1 (cuda_lod.lod_windows) once untimed, then 5 launches and a
    synchronize on the host clock.

    Adapted from bench.py:132: K1 in place of lod_windows_fast_jax."""
    packed, table, miss = kernel_inputs(device)
    I, W = packed.shape[0], WINSIZE
    nwin = miss.shape[0]
    cuda_lod.lod_windows(packed, table, miss, W)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        cuda_lod.lod_windows(packed, table, miss, W)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return I * nwin / dt


def start_warmup_thread():
    """Prepay, overlapped with the panel's synthesis, what the first run
    would otherwise pay: the CUDA context, the kernel library (built
    with nvcc on first use, ops/_build.py) and the native host library
    (g++).  Returns (thread, errors): the caller joins the thread before
    the first timed run and raises the first of its errors.

    Adapted from bench.py:153: no XLA cache and no device link."""
    import threading
    from garlic_tpu_torch import native
    from garlic_tpu_torch.ops import _build

    t0 = time.perf_counter()
    errors = []

    def _w():
        try:
            torch.zeros(8, device="cuda").cpu()
            _build.library()
            native.library()
        except Exception as e:  # re-raised by the caller after join()
            errors.append(e)
            return
        log(f"bench: CUDA context and kernel library "
            f"{time.perf_counter() - t0:.1f}s (untimed, overlapped)")

    th = threading.Thread(target=_w, daemon=True)
    th.start()
    return th, errors


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main() -> int:
    """Best of RUNS end-to-end runs; returns the exit status.

    Adapted from bench.py:176: no run without a CUDA device, the card
    named, no failure of a step caught (the oracle's absence aside, as
    in bench.py), and each run's device-memory peak."""
    if not torch.cuda.is_available():
        log("bench: no CUDA device is available; bench_torch.py measures "
            "the port on the card only")
        return 1
    log(f"bench: card {card()}")
    warmup, errors = start_warmup_thread()
    tped, tfam = ensure_panel()
    try:
        base = oracle_baseline(tped, tfam)
    except RuntimeError as e:
        log(f"bench: WARNING no oracle baseline ({e}); vs_baseline=0")
        base = None
    warmup.join()
    if errors:
        raise errors[0]
    log(f"bench: device kernel {kernel_throughput():,.0f} windows/s "
        "(K1, lod_windows)")
    # best of 7: the first run parses the gzip TPED and writes the panel
    # sidecar; the rest load it and measure the steady state
    wps, peak = 0.0, 0
    for _ in range(RUNS):
        torch.cuda.reset_peak_memory_stats()
        w = run_ours(tped, tfam)
        if w > wps:
            wps, peak = w, torch.cuda.max_memory_allocated()
    log(f"bench: end-to-end {wps:,.0f} windows/s (best of {RUNS}); "
        f"device-memory peak of the best run {peak} bytes")
    log(f"bench: launches {json.dumps(cuda_lod.LAUNCHES)}")
    # bench.py's keys and rounding (bench.py:195-200)
    print(json.dumps({
        "metric": "lod_windows_per_sec",
        "value": round(wps, 1),
        "unit": "windows/s",
        "vs_baseline": round(wps / base, 2) if base else 0.0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
