#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (garlic_tpu_torch) on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, printing no result):

1. environment: the card (nvidia-smi), torch/CUDA/nvcc versions, the
   build of the port's CUDA kernels from csrc/ (nvcc, sm_90a), and K7's
   premise: expf of every f32 from -104 down to -inf is +0 on the card
   (ops/kde.expf_underflow, 1,018,167,297 values);
2. kernels: K1 (lod_windows), K2 (covered), K3 (window_sums) and K4
   (covered_terms) against their plain PyTorch versions on the card, on
   the same inputs: K1's and K3's f32 sums bit for bit, K2's and K4's
   three u8 planes exactly; K3/K4 read the TGLS term plane of a GQ-like
   error lut (40 values, 10^-2 .. 10^-5.9).  K3 over the plane of K1's
   own terms must equal K1 bit for bit, and K4 over it K2 (the shared
   kernel body).  Shapes are the bench chromosome (200 x 500,000) at
   W=1, 60 and 120, and ragged small cases; CUDA-event medians of 21
   samples at the bench shape: per launch over 10 back-to-back launches
   at each of those W (the time that grows with W is the chains' adds),
   and at W=60 of one launch (the `ms` of the kernels line), the bound,
   the plain version's time, cuDNN's conv1d over the same term plane and
   fill_ over tensors of the kernel's outputs (what writing them alone
   takes); then gt_compact_2bit (compact_step), the column compaction of
   the 2-bit codes whose monomorphic filter deferred it, at the WGS
   benchmark's chromosome-1 shape (108 x 820,835 loci, ~1.75% dropped:
   tests/test_torch_compact.WGS_CHR1): the whole chromosome and each
   block of a 2x2 mesh byte for byte against its plain version and the
   host pass (gt_filter_pack_2bit), and its CUDA-event medians (one
   launch, 10 back to back) beside its byte bound, the plain version's
   and, on the host clock, the host pass's and the route's (uploads,
   launch, synchronize); then gt_exact_pool (pool_step), Phase II's
   exact f64 pool, at the example benchmark's pool (20 of 45 rows on its
   22 chromosomes, W 60, step 60), deferred codes: bit for bit against
   its plain version (CPU tensors) and its route against the host pass
   (gt_lod_windows_exact_thin), and its CUDA-event median of one launch
   beside its bounds, its bytes at 3.35 TB/s and its serial chain (2 x
   the longest chain's window steps x one dependent f64 add's latency,
   from gt_dadd_chain's one-thread chains), and, on the host clock, the
   route's and the host pass's times;
3. tie band: max |win_f32 - win_f64| / (2^-23 * W * tmax) on the bench
   chromosome at W=60 and W=120, with the scalar --error (K1) and with
   the GQ error plane (K3, tmax with the TGLS corners), f64 from the
   exact engine over all 200 rows; each must stay within the 256 the tie
   patrol's band assumes;
4. main path, through `python -m garlic_tpu_torch` (run in-process, with
   --tpu-profile), each run with the kernel launch counters zeroed just
   before it and read just after it:
   - bench.py's panel (200 x (500k, 500k), seed 42) and pinned flags,
     fast engine cold then warm with --tpu-panel-cache, then the exact
     engine: .roh.bed byte-identical, .freq.gz equal, K2 run for every
     chromosome of each fast run;
   - --raw-lod on a 50 x (100k, 100k) panel, fast against exact: BED
     identical, raw values within atol 1e-4 + rtol 1e-5, K1 run;
   - the bench panel with a GQ TGLS file (integers 20-59: the native
     reader's dictionary form), cold then warm (the .gtlc sidecar
     written, then read), then exact: BED byte-identical, .freq.gz
     equal, K4 run for every chromosome of each fast run;
   - on the small panel, a GL TGLS file (1,000 distinct values: the f64
     matrix form), pinned, fast against exact: BED identical, K3 run;
     and the GQ file with --raw-lod: BED identical, raw values as above,
     K3 run;
5. auto path: the reference's default run, no --lod-cutoff and no
   --size-bounds (the cutoff from the KDE, the bounds from the GMM):
   - bench.py's panel (a fresh TPED name), fast engine cold (the exact
     Phase-II pool computed and stored next to the sidecar), warm (the
     pool read back: the sampler is not called) and the exact engine:
     .roh.bed byte-identical, .freq.gz equal, .log equal after line 1,
     the .kde x column byte-identical and y within 1e-5 * max y of the
     exact engine's; K2 run for every chromosome of each fast run (the
     fused route, dispatched once Phase II has chosen the cutoff), K1
     never, K7 (gauss_sums, the Gauss transform) and K8 (gmm_em, the
     GMM-EM in fit mode: the run calls more ROH than the device EM's
     4096 gate) at least once, csrc/kde_gmm.cu; each run's
     phase2-cutoff split into the pool read and store, the exact
     sampler, the grid, the transform, the .kde writer and the cutoff
     search, and its phase4-gmm into the EM and the boundaries (host
     clock, the functions wrapped: _Split);
   - the device EM against the host EM (the same iterations and %g
     lines) on the run's ROH lengths, or on a synthetic >= 4096 mixture
     when the run calls fewer;
   - medians on the card: the pool's upload, the device Gauss transform
     against the host f64 one, the device EM against fit_gmm (both
     over the card's 1x1 mesh: gauss_transform_sharded, fit_gmm_sharded);
   - K7 and K8 against their plain versions on the card at the bench
     shapes: K7 over the cold run's pool (3,328,600 f32 sources x 512
     targets) within 1e-6 x max y of gauss_sums_plain, closer than it to
     the f64 sums of the same f32 terms (f64_term_sums), at most
     HOST_MARGIN times its distance from the host f64 transform (mostly
     the terms' own f32 error), its terms bit-equal to the plain
     version's on 256 of the pool's sources (k7_terms_bit_equal), two
     launches bit-equal, its bucketed sources equal to a stable sort by
     the buckets of ops/kde.k7_buckets (torch.sort, here only) and its
     plan equal to ops/kde.k7_plan's; K8 on the run's ROH lengths (K =
     3) in fit mode with the plain loop's iterations, flag and %g lines
     (rtol 1e-10), in stats mode within rtol 1e-12 of _em_stats, two
     launches of each bit-equal, on both launch shapes (one cluster,
     and the grid-wide launch), also at K = 9; CUDA-event medians of 21:
     K7 one launch and 10 back to back (and its kernels' device times
     from torch.profiler), K8's whole fit, its time per iteration and
     stats mode per call, on both shapes at the run's lengths (K = 3 and
     9) and on seeded mixtures of 100,000 and 1,000,000 lengths, beside
     the bounds (gauss_bound_ms, the dense one, and
     gauss_needed_bound_ms, over the terms these inputs make non-zero,
     counted on the card; em_bound_ms) and the plain versions' times (no
     one PyTorch call computes either: library none);
   - on the 50 x (100k, 100k) panel, fast against exact: --auto-winsize
     from 40 by 20 (the same window size, BED identical, every .kde's x
     column identical; K2, not K1; K7 per candidate) and --winsize-multi
     40 60 80 (the same .kde files, x identical; K7 three times);
6. weighted path (--weighted with a genetic map, --phased, --cm; its
   kernels K5, pair_counts, and K6, wlod_windows, csrc/wlod.cu, beside
   the plain-torch band programs of ops/device_wlod.py):
   - bench.py's panel and pinned flags with --weighted --map (a map
     scaffold at MAP_RATE), fast cold then warm (--tpu-panel-cache)
     against the exact engine: .roh.bed byte-identical, .freq.gz equal,
     K5 and K6 run for every chromosome; the warm run prints the tie
     patrol's stage times;
   - on bench chromosome 1 at W=60 and W=120: K5's HR^2 and r^2 counts
     equal to its plain version's (seeded first-copy bits, packed), in
     store mode (fresh planes, as the route's first row chunk) and in
     accumulate mode (added to planes holding counts), K6's windows and
     tie scale bit for bit over the codes and table and over the f32
     score plane (and the plane's equal to the codes'); at W=60 each
     kernel's CUDA-event median (one launch, and 10 back to back; K5 in
     store mode) beside its bound, its plain version's and one PyTorch
     call's (torch.einsum over unfolded planes: library_pairs,
     library_windows; never called by the port), and each kernel's time
     at W=1 (the part that does not grow with W); the pair band's
     finalize, the band assembly and the whole weighted Phase I, the
     route's host inputs (host clock), and the device-memory peak of the
     whole (torch.cuda.max_memory_allocated);
   - on the 50 x (100k, 100k) panel, fast against exact, BED identical:
     --weighted --phased, --weighted --ld-subsample 20, --weighted
     --tgls (GQ), automatic --weighted (.log equal, .kde x identical),
     --weighted --auto-winsize (K5 and K6 on every chromosome), --cm
     pinned and automatic (K2 runs, K1 never);
   - the weighted tie band on bench chromosome 1 at W=60 and W=120:
     max |win_f32 - win_f64| / (2^-23 * W * tie_scale) within 256, the
     f64 windows summed on the card over the f64 band of exact pair
     counts (the plain torch version's integers, not K5's).
   The exact engine's weighted runs take minutes of f64 host work, so
   they run as `python -m garlic_tpu_torch` subprocesses that cannot see
   the card, side by side, started as soon as their inputs are written
   (before phase 2) and pinned to the half of the CPUs that this process
   does not use (os.sched_setaffinity; this process keeps the other half
   until phase 6 has read them); the bench panel's as one run per
   chromosome, whose outputs are joined (the pinned run treats its
   chromosomes apart);
7. streaming Phase I and the programmatic API, once phase 6's
   subprocesses have ended (this process back on every CPU):
   - bench.py's panel, warm, pinned, automatic and with the GQ TGLS
     file, each run resident, streamed (GARLIC_TPU_HBM_BUDGET below
     every run's device holdings), streamed, resident: .roh.bed, .log
     and (automatic) .kde byte-identical, K2 (K4) run for every
     chromosome and K1 (K3) never, each run's device-memory peak
     (torch.cuda.max_memory_allocated, reset just before it), the
     streamed peak below the resident one, and the walls side by side;
   - --raw-lod (K1) and GL float-form --raw-lod (K3) on a 20 x (25k,
     25k) panel, streamed against resident: raw values and BED
     byte-identical, the streamed run making each chromosome's windows
     twice (written, then counted);
   - the programmatic API (garlic_tpu_torch.api) on the bench panel,
     warm (load_panel(panel_cache=True)): call_roh(engine="fast") with
     the pinned cutoff and bounds gives phase 4's fast BED rows, and
     without them a finite cutoff and two ordered bounds, printed beside
     the CLI's; K1 run for every chromosome of each call;
8. meshes on the one card (--tpu-mesh, garlic_tpu_torch/parallel/): the
   meshes 2x1, 1x2 and 2x2 over ["cuda:0"] * k, every shard on the card:
   - on bench chromosome 1 (W=60), K1 and K3 per shard
     (lod_windows_sharded) bit for bit equal to the 1x1 mesh's
     windows (one device), and K2 and K4 per shard (a FusedCov over the
     mesh) equal to its u8 planes, the stitched coverage rows too; the
     device-memory peak of one shard's K2/K4 launch, of all the mesh's
     shards at once and of the 1x1 mesh's launch;
   - bench.py's pinned, automatic, GQ TGLS and --weighted runs, warm,
     and phase 4's GL TGLS run on the 50 x (100k, 100k) panel (K3 on
     the split route), through run_main(..., device=["cuda:0"] * k) and
     on one device: .roh.bed, .freq.gz, .log (and .kde) equal to phases
     4-7's single-device runs, the kernel (the weighted run: K5 and K6)
     run on every shard of every chromosome, each run's wall and
     device-memory peak;
   - call_roh(mesh=...) on the bench panel, warm, pinned: K1 on every
     shard, its rows equal to phase 4's fast BED rows;
   - with more than one card visible, `python -m garlic_tpu_torch
     --tpu-mesh auto` over them in a subprocess, its BED against phase
     4's; with one, a line that says runs over distinct cards did not
     happen;
9. two processes on the one card (garlic_tpu_torch/parallel/
   multihost.py): each run is two `python -m garlic_tpu_torch`
   subprocesses joined by the three GARLIC_TPU_* variables (a gloo
   process group on 127.0.0.1), each process driving cuda:0:
   - bench.py's pinned, automatic, GQ TGLS and --weighted runs, warm,
     over --tpu-mesh 2x1 (each process loads and launches its own 100
     rows: sharded input), and the GL TGLS run of phase 4 and phase 7's
     --raw-lod run over 1x2 (not dp-aligned: each process loads the
     whole panel and launches its own sp cell): process 0's outputs and
     process 1's (.proc1) .roh.bed, .freq.gz, .log (and .kde, and the
     raw text) equal to the single-process runs of phases 4-7; each
     child's launch counters (its --tpu-profile line) show its kernel
     (the weighted run: K5 and K6) run on every chromosome in both
     processes, and count in the kernels line; each process's profiled
     wall beside phase 8's 2x1 or 1x2 run, its device-memory peak, and
     the bytes, calls and seconds of its exchanges by tag;
   - each process's device budget (its --tpu-profile line): half the
     card's, both processes driving cuda:0;
   - entry(): K2 on the card against its plain version, and
     dryrun_multichip(4) over ["cuda:0"] * 4;
10. the workflow a user runs, through the entry points a user calls:
   - a 200 x 100,000 panel on one chromosome named 22, its positions
     inside hg18 chr22's 49,691,432 bp, written as workflow.chr22.vcf.gz
     (phased GT, with missing calls), and a feature file of 2,000 seeded
     sites with four effect types, the functional allele REF at some
     sites and ALT at others (tests/vcfutil.py);
   - garlic_tpu_torch.tools.vcf2tped on the VCF, then `python -m
     garlic_tpu_torch` on its TPED, the reference's default run (no
     --lod-cutoff, no --size-bounds), fast (K2 run, K1 never) and exact:
     .roh.bed byte-identical;
   - count_features_in_roh over the VCF with each BED: the two counts
     files equal, and equal to a plain numpy count of the homozygous
     carriers of each functional allele, classed by np.searchsorted
     over each individual's intervals; each step's seconds;
11. the port's benchmark scripts, as a user runs them, in subprocesses:
   - the bench panel's TPED and TFAM copied into .bench_cache/ under
     bench_torch.ensure_panel's names where they are absent (the same
     make_panel arguments and write_tped, so no second synthesis);
   - `python3 bench_torch.py`: exit 0, its last stdout line bench.py's
     JSON object (the four keys, lod_windows_per_sec, a value above
     0), K1 run in its kernel diagnostic and K2 on every chromosome of
     each of its 7 runs (its launches line); its windows/s printed
     beside phase 4's fast_warm wall turned into windows/s (printed,
     not gated: host-bound walls move by tens of percent);
   - `python3 bench_scaling_torch.py`: exit 0, four JSON lines with
     bench_scaling.py's keys and devices 1, 2, 4 and 8, K1 run (the
     script itself holds every mesh's windows to one device's, bit for
     bit);
   - both outputs printed whole; what the phase added to .bench_cache/
     is removed after it;
12. the device trace (--tpu-profile with GARLIC_TPU_TRACE_DIR set:
   runtime.PhaseProfiler's torch.profiler trace, one Chrome-trace JSON
   a run): bench.py's pinned run, the GQ TGLS run, the automatic run,
   the --weighted run and the pinned run streamed (phase 7's budget),
   each on the sidecars and pools phases 4-7 made, one after another in
   one subprocess (traced_child: a process pays the profiler's first
   start on the card, ~9 s, once), each three times: untraced (warming
   the process and the run's kernels), untraced, then traced.  Each
   prints the traced and the untraced wall and --tpu-profile TOTAL
   beside the same configuration's in-process run; from the trace
   (trace_summary): the device's busy and idle shares of the traced
   window (its first event to its last phase mark; busy is the union of
   the kernels, copies and memsets), device time by kind, the TOP_OPS
   longest device operations (hand kernels by their K-names), the
   TOP_GAPS longest idle gaps with their phases and host operations, and
   each hand kernel's device ms a launch beside its CUDA-event median.  Checks: one trace file that parses, holding
   device events and the run's phase marks in order; every hand kernel
   that the traced run's counters line counts among its kernels; all
   three runs' .roh.bed byte-identical to the in-process run's.
Every run prints its --tpu-profile phase split; each phase prints its
seconds, and the end the smoke's.

The line before the last is {"kernels": [...]} (K1-K8; launches summed
over the main path's runs), the last line {"ok": true, "device": {...}}.  The
script imports no JAX (an import hook refuses it), writes only under
build/chip_smoke/, removed at the end, and in phase 11 under
.bench_cache/ (what it adds there is removed), and ends every subprocess
it starts.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import re
import runpy
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
# bench.py's panel and pinned flags; the smaller --raw-lod / GL panel
BENCH_PANEL = dict(nind=200, nloci_per_chr=(500_000, 500_000), seed=42,
                   spacing_mean=4000)
RAWLOD_PANEL = dict(nind=50, nloci_per_chr=(100_000, 100_000), seed=7,
                    spacing_mean=4000)
FLAGS = ["--build", "hg18", "--winsize", "60", "--error", "0.001",
         "--lod-cutoff", "1.5", "--size-bounds", "500000", "1000000",
         "--kde-subsample", "0", "--tpu-profile"]
ERROR, MAX_GAP, OVERLAP_FRAC = 0.001, 200000, 0.25  # the flags' values
HG18_CHR1_CENTROMERE = (121236957, 123476957)
TIE_BAND_FACTOR = 256.0
# the weighted runs: the genetic map's scale (tests/util.write_map_scaffold's
# rate_cm_per_mb, as tests/test_torch_wlod.py's automatic panel: at the
# default 1.2 the recombination factor shrinks every score below the
# pinned cutoff), and the --mu and --M defaults
MAP_RATE = 0.012
MU, M_GEN = 1e-9, 7
INT8_RATE = 1.979e15  # dense int8 operations per second (data sheet)
# the automatic run: no --lod-cutoff, no --size-bounds
AUTO_FLAGS = ["--build", "hg18", "--winsize", "60", "--error", "0.001",
              "--kde-subsample", "0", "--tpu-panel-cache", "--tpu-profile"]
SEARCH_FLAGS = ["--build", "hg18", "--error", "0.001", "--kde-subsample",
                "0", "--tpu-profile"]
Y_TOL = 1e-5  # max |dy| / max y of the .kde, fast engine against exact
GMM_GATE = 4096  # the device EM's size gate (ops/gmm.py)
FP32_LANES = 128  # f32 adds per clock on one Hopper SM
CARD = "NVIDIA H100 80GB HBM3"  # the card the bounds are computed for
MEMORY_RATE = 3.35e12  # its memory rate in bytes/s (NVIDIA's data sheet)
# every kernel of the port: what it replaces (K1-K4 the Pallas TPU kernels,
# K5 and K6 the XLA programs of the weighted path: K5 also replaces
# _r2_counts_chunk, device_wlod.py:317; K7 and K8 the automatic run's
# Gauss transform and GMM-EM: K7 also replaces garlic_tpu/ops/kde.py:119
# gauss_transform(device=True)) and its source
KERNELS = {"lod_windows": "garlic_tpu/ops/pallas_lod.py:93",
           "covered": "garlic_tpu/ops/pallas_lod.py:291",
           "window_sums": "garlic_tpu/ops/pallas_lod.py:175",
           "covered_terms": "garlic_tpu/ops/pallas_lod.py:402",
           "pair_counts": "garlic_tpu/ops/device_wlod.py:247",
           "wlod_windows": "garlic_tpu/ops/device_wlod.py:604",
           "gauss_sums": "garlic_tpu/parallel/engine.py:250",
           "gmm_em": "garlic_tpu/parallel/engine.py:309"}
LOD_KERNELS = ("lod_windows", "covered", "window_sums", "covered_terms")
WLOD_KERNELS = ("pair_counts", "wlod_windows")
AUTO_KERNELS = ("gauss_sums", "gmm_em")
SOURCES = {
    **dict.fromkeys(LOD_KERNELS, "garlic_tpu_torch/csrc/lod_windows.cu"),
    **dict.fromkeys(WLOD_KERNELS, "garlic_tpu_torch/csrc/wlod.cu"),
    **dict.fromkeys(AUTO_KERNELS, "garlic_tpu_torch/csrc/kde_gmm.cu")}
# K7's exp runs on the special-function units, 16 results a clock per SM
# (MUFU.EX2), its other operations on the 128 f32 lanes; K8's on the 64
# f64 lanes of an SM
MUFU_LANES, FP64_LANES = 16, 64
# TGLS tokens, each led by its separator: GQ integers 20-59 (the spread of
# tests/util.write_tgls; 40 distinct tokens, so the native reader keeps
# the dictionary form) and 1,000 GL values in [-0.01, -0.00001] (more
# than 255 distinct tokens: the f64 matrix form)
GQ_TOKENS = [f" {v}".encode() for v in range(20, 60)]
GL_TOKENS = [f" {-k / 1e5:.5f}".encode() for k in range(1, 1001)]
# phase 7: a device budget every fast run of the bench panel exceeds
# (GARLIC_TPU_HBM_BUDGET, bytes), and the --raw-lod panel (1M values: the
# text writer takes a few seconds)
STREAM_BUDGET = "1000"
RAWLOD_STREAM_PANEL = dict(nind=20, nloci_per_chr=(25_000, 25_000), seed=9,
                           spacing_mean=4000)
# phase 8: the meshes laid on the one card, (dp, sp)
MESHES = ((2, 1), (1, 2), (2, 2))
# phase 9: a child process's time limit, seconds
CHILD_TIMEOUT = 300
# phase 10: the workflow's panel, one chromosome named 22 (count_features_in
# _roh needs chr<num> in the file name and counts from chr22 up) inside hg18
# chr22's length (make_panel's gaps are uniform in [100, 800): ~450 bp on
# average), and the feature file's sites and seed
WORKFLOW_PANEL = dict(nind=200, nloci_per_chr=(100_000,), chrom_names=["22"],
                      seed=53, spacing_mean=400)
HG18_CHR22_BP = 49_691_432
WORKFLOW_SITES, WORKFLOW_SEED = 2000, 59
# phase 11: a benchmark script's time limit, seconds; the keys of
# bench.py's JSON line and of bench_scaling.py's, in order
SCRIPT_TIMEOUT = 600
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
SCALING_KEYS = ["devices", "mesh", "windows_per_sec", "speedup",
                "efficiency"]
# phase 12: the traced runs, each (name, the phase 8 configuration it
# repeats, GARLIC_TPU_HBM_BUDGET or None); the device operations and the
# idle gaps each prints; each hand kernel's K-name, in KERNELS' order;
# the trace's device events (kernels, copies, memsets) and its phase marks
TRACED = (("pinned", "pinned", None), ("gq", "gq", None),
          ("auto", "auto", None), ("weighted", "weighted", None),
          ("streamed", "pinned", STREAM_BUDGET))
TOP_OPS, TOP_GAPS = 8, 5
K_NAMES = {k: f"K{i + 1}" for i, k in enumerate(KERNELS)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "garlic::mark:"
# the phase whose CUDA-event median is each kernel's ms
TIMED_IN = {**dict.fromkeys(LOD_KERNELS, 2), **dict.fromkeys(WLOD_KERNELS, 6),
            **dict.fromkeys(AUTO_KERNELS, 5)}
# a hand kernel's symbol, demangled or not, and its K-name: the first
# pattern that matches names it (K6's symbol holds K1's name)
K_SYMBOLS = ((r"wlod_windows_kernel", "K6"), (r"pair_counts_kernel", "K5"),
             (r"lod_windows_kernel.*PlaneTerms", "K3"),
             (r"lod_windows_kernel", "K1"),
             (r"covered_kernel.*PlaneTerms", "K4"), (r"covered_kernel", "K2"),
             (r"k7_[a-z]+_kernel", "K7"), (r"(?<![A-Za-z_])em_kernel", "K8"))


def say(*a):
    print(*a, flush=True)


def _names(kernel):
    """A kernel name, a tuple of them, or None, as a tuple."""
    return () if kernel is None else (
        (kernel,) if isinstance(kernel, str) else tuple(kernel))


class _NoJaxPackage:
    """Import hook: the port must run without JAX and without the JAX
    package (garlic_tpu); garlic_tpu_torch is a top-level name of its own,
    so only an exact first dotted component is refused."""

    REFUSED = ("garlic_tpu", "jax", "jaxlib")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.REFUSED:
            raise ImportError(f"chip_smoke: {name} must not be imported")
        return None


class _Chrom:
    """The fields of a loaded chromosome that the port's kernel inputs,
    exact engine and tie band read, over a synthetic panel's arrays,
    with a dictionary-form TGLS error plane (gl_codes into gl_lut)."""

    def __init__(self, name, positions, genotypes, seed):
        from garlic_tpu_torch.io.tgls import convert_gl
        self.chrom = name
        self.positions = positions
        self.genotypes = genotypes
        self.geno_is_packed_only = False
        self.nind, self.nloci = genotypes.shape
        self.nind_global, self.row0 = self.nind, 0  # the whole panel
        obs = genotypes >= 0
        self.freq = (np.where(obs, genotypes, 0).sum(0)
                     / np.maximum(2 * obs.sum(0), 1)).astype(np.float64)
        self.gl_lut = convert_gl(np.arange(20, 60), "GQ")
        self.gl_codes = np.random.default_rng(seed).integers(
            0, self.gl_lut.size, genotypes.shape, dtype=np.uint8)
        self._gl = None

    @property
    def gl(self):
        if self._gl is None:
            self._gl = self.gl_lut[self.gl_codes]
        return self._gl


class _Centro:
    def __init__(self, start, end):
        self._s, self._e = start, end

    def start(self, chrom):
        return self._s

    def end(self, chrom):
        return self._e


def _median_wall_ms(fn, n):
    """Median host-clock time of fn() (which returns host data, so it has
    synchronized), after one warm-up call."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _median_ms(fn, n=21, reps=1):
    """Median over n samples of CUDA events around `reps` back-to-back
    fn() calls, divided by reps: with reps=1 the span holds the host's
    launch work too, with more the device's time alone."""
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


def phase_environment():
    import torch
    from garlic_tpu_torch import native
    from garlic_tpu_torch.ops import _build, kde
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
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("  ptxas:", line.strip())
    t0 = time.perf_counter()
    bad = kde.expf_underflow(torch.device("cuda", 0))
    say(f"K7's premise: expf of every f32 from -104 down to -inf "
        f"({0xFF800000 - 0xC2D00000 + 1} values) is +0 on the card: "
        f"{bad == 0} ({time.perf_counter() - t0:.3f}s); K7 skips only "
        "pairs whose argument is at most -110.25 (1 - 4 2^-24)")
    if bad:
        raise AssertionError(f"expf of the f32 {bad:#010x} is not +0")
    t0 = time.perf_counter()
    native.library()  # raises native.BuildError with g++'s stderr
    say(f"native host library "
        f"{os.path.relpath(native.build.loaded_path, REPO)}: g++ build and "
        f"load {time.perf_counter() - t0:.3f}s")
    return smi


def _random_chrom(I, L, W, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, (I, L)).astype(np.int8)
    g[rng.random((I, L)) < 0.01] = -9
    pos = np.cumsum(rng.integers(100, 4000, L)).astype(np.int64)
    chrom = _Chrom("chr1", pos, g, seed)
    chrom.freq[::97] = 0.0  # monomorphic sites score 0
    # a centromere masks some windows, where that leaves others live
    c0 = L // 3 if L >= 4 * W else L - 1
    return chrom, _Centro(int(pos[c0]) + 1, int(pos[min(c0 + 2, L - 1)]) + 1)


def _bitwise(a, b):
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _equal(planes, others):
    import torch
    return all(torch.equal(x, y) for x, y in zip(planes, others))


def _live_median(win):
    return float(win[win != -9999].median())


# window-start counts that register blocking (29 starts per thread in
# K1/K3, 15 in K2/K4) and the tiles (3712 starts per K1/K3 tile, 3840
# per K2/K4 block pass) make risky: W=1, nwin=1, W and nwin off multiples
# of 29 and 15, rows not 16-byte aligned, W=120 and W=500, I=1, L under
# one tile, W below and at the chains' ramps (W < 14, W = 14), a second
# tile by one start (nwin = 3713 and 3841), K2's two passes (W=2500), more
# items than resident blocks (1000 rows), blocks whose items change column
# tile (3 rows of 2,000,000), and a table too large for shared memory next
# to K1's and K2's tiles (W=12000: the unstaged decode)
SMALL_CASES = (("ragged 37x1001 W=60", (37, 1001, 60)),
               ("nwin=1 5x64 W=64", (5, 64, 64)),
               ("W=1 3x10", (3, 10, 1)),
               ("ragged 9x3001 W=120", (9, 3001, 120)),
               ("I=1 1x5000 W=500", (1, 5000, 500)),
               ("W=500 7x9001", (7, 9001, 500)),
               ("W=60 nwin=3713 5x3772", (5, 3772, 60)),
               ("W=61 nwin=3841 6x3901", (6, 3901, 61)),
               ("W=13 under a tile 4x777", (4, 777, 13)),
               ("W=14 11x4001", (11, 4001, 14)),
               ("W=2500 two passes 3x12001", (3, 12001, 2500)),
               ("many items 1000x4000 W=60", (1000, 4000, 60)),
               ("tile changes 3x2000000 W=37", (3, 2000000, 37)),
               ("unstaged table 3x40000 W=12000", (3, 40000, 12000)))


def _card():
    """(SM count, max SM clock in Hz, memory rate in bytes/s) of card 0."""
    import torch
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    if name != CARD:
        raise AssertionError(f"the bounds are for the {CARD}, not {name}")
    return (torch.cuda.get_device_properties(0).multi_processor_count,
            float(mhz) * 1e6, MEMORY_RATE)


def add_ms(I, L, W, card):
    """The I * nwin * W f32 adds of one launch at 128 per clock on every
    SM, in ms."""
    sms, clock, _ = card
    return I * (L - W + 1) * W / (sms * FP32_LANES * clock) * 1e3


def bound_ms(kernel, I, L, W, card):
    """(least time in ms, "bytes" or "operations") for one launch: each
    input read once and each output written once at the memory rate,
    against the adds (add_ms)."""
    rate = card[2]
    nwin = L - W + 1
    codes_table = I * ((L + 3) // 4) + 3 * L * 4
    nbytes = nwin + {"lod_windows": codes_table + 4 * I * nwin,
                     "covered": codes_table + I * L + 2 * I * nwin,
                     "window_sums": 4 * I * L + 4 * I * nwin,
                     "covered_terms": 4 * I * L + I * L + 2 * I * nwin}[kernel]
    t_bytes = nbytes / rate * 1e3
    t_ops = add_ms(I, L, W, card)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(chrom, centro):
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import cuda_lod
    say("== phase 2: kernels against their plain versions on the card")
    dev = torch.device("cuda")
    cases = []  # name, chrom, centro, W, max gap, threshold, bench?
    for W in (1, 60, 120):
        cases.append((f"bench chr1 {chrom.nind}x{chrom.nloci} W={W}", chrom,
                      centro, W, MAX_GAP, float(math.ceil(OVERLAP_FRAC * W)),
                      True))
    for name, (I, L, W) in SMALL_CASES:
        c, cen = _random_chrom(I, L, W, seed=L)
        cases.append((name, c, cen, W, 20000, float(max(1, W // 4)), False))
    err = dict.fromkeys(LOD_KERNELS, 0.0)
    timed, sweep = None, {}
    for name, c, cen, W, gap, thr, bench in cases:
        pk, tb, ms = cuda_lod.chrom_device_inputs(c, cen, W, ERROR, gap, dev)
        terms, _ = cuda_lod.chrom_gl_inputs(c, cen, W, gap, dev)
        k1 = cuda_lod.lod_windows(pk, tb, ms, W)
        p1 = cuda_lod.lod_windows_plain(pk, tb, ms, W)
        k3 = cuda_lod.window_sums(terms, ms, W)
        p3 = cuda_lod.window_sums_plain(terms, ms, W)
        if bench:
            cut1 = cut3 = 1.5
            d1 = pipeline._tie_band([c], W, ERROR, False)
            d3 = pipeline._tie_band([c], W, ERROR, True)
        else:
            cut1, cut3, d1, d3 = _live_median(p1), _live_median(p3), 0.05, 0.05
        a2 = (cut1, thr, d1)
        a4 = (cut3, thr, d3)
        k2 = cuda_lod.covered(pk, tb, ms, W, *a2)
        p2 = cuda_lod.covered_plain(pk, tb, ms, W, *a2)
        k4 = cuda_lod.covered_terms(terms, ms, W, *a4)
        p4 = cuda_lod.covered_terms_plain(terms, ms, W, *a4)
        # one kernel body: K3/K4 over the plane of K1's terms are K1/K2
        own = cuda_lod.table_terms(pk, tb)
        s3 = cuda_lod.window_sums(own, ms, W)
        s4 = cuda_lod.covered_terms(own, ms, W, *a2)
        torch.cuda.synchronize()
        checks = {"K1 bitwise": _bitwise(k1, p1), "K2 equal": _equal(k2, p2),
                  "K3 bitwise": _bitwise(k3, p3), "K4 equal": _equal(k4, p4),
                  "K3=K1": _bitwise(s3, k1), "K4=K2": _equal(s4, k2)}
        e = {"lod_windows": float((k1 - p1).abs().max()),
             "window_sums": float((k3 - p3).abs().max()),
             "covered": max(float((x.int() - y.int()).abs().max())
                            for x, y in zip(k2, p2)),
             "covered_terms": max(float((x.int() - y.int()).abs().max())
                                  for x, y in zip(k4, p4))}
        for k in err:
            err[k] = max(err[k], e[k])
        say(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in checks.items())
            + f"; max |diff| {e}; K2 covered {int(k2[0].sum())} suspects "
            f"{int(k2[1].sum())}; K4 covered {int(k4[0].sum())} suspects "
            f"{int(k4[1].sum())} above {int(k4[2].sum())}")
        if not all(checks.values()):
            raise AssertionError(f"kernel differs from its plain version or "
                                 f"its twin: {name} {checks}")
        if bench:  # the kernels' times by W: what grows with W is the adds
            sweep[W] = [_median_ms(f, reps=10) for f in (
                lambda: cuda_lod.lod_windows(pk, tb, ms, W),
                lambda: cuda_lod.covered(pk, tb, ms, W, *a2),
                lambda: cuda_lod.window_sums(terms, ms, W),
                lambda: cuda_lod.covered_terms(terms, ms, W, *a4))]
        if bench and W == 60:
            timed = (pk, tb, ms, terms, W, a2, a4)
        del pk, tb, ms, terms, k1, p1, k2, p2, k3, p3, k4, p4, own, s3, s4
        torch.cuda.empty_cache()
    card = _card()
    say(f"  card: {card[0]} SMs, max SM clock {card[1] / 1e6:.0f} MHz, "
        f"memory {card[2] / 1e12:.2f} TB/s")
    I, L = chrom.nind, chrom.nloci
    for W, t in sweep.items():
        say(f"  bench shape, W={W}: K1 {t[0]:.4f} K2 {t[1]:.4f} K3 "
            f"{t[2]:.4f} K4 {t[3]:.4f} ms; their I * nwin * W adds "
            f"{add_ms(I, L, W, card):.4f} ms at the add rate (CUDA events "
            "around 10 launches, median of 21)")
    pk, tb, ms, terms, W, a2, a4 = timed
    # the library yardstick: one cuDNN convolution with a ones filter over
    # the same f32 term plane (K1's from cuda_lod.table_terms, so it skips
    # K1's gather and mask), f32 arithmetic (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    ones = torch.ones((1, 1, W), dtype=torch.float32, device=dev)
    own = cuda_lod.table_terms(pk, tb)
    conv = torch.nn.functional.conv1d
    runs = {
        "lod_windows": (lambda: cuda_lod.lod_windows(pk, tb, ms, W),
                        lambda: cuda_lod.lod_windows_plain(pk, tb, ms, W),
                        lambda: conv(own[:, None], ones)),
        "covered": (lambda: cuda_lod.covered(pk, tb, ms, W, *a2),
                    lambda: cuda_lod.covered_plain(pk, tb, ms, W, *a2),
                    None),
        "window_sums": (lambda: cuda_lod.window_sums(terms, ms, W),
                        lambda: cuda_lod.window_sums_plain(terms, ms, W),
                        lambda: conv(terms[:, None], ones)),
        "covered_terms": (
            lambda: cuda_lod.covered_terms(terms, ms, W, *a4),
            lambda: cuda_lod.covered_terms_plain(terms, ms, W, *a4),
            None),
    }
    # what the card takes to write each kernel's outputs and nothing else
    nwin = L - W + 1
    sums = [torch.empty((I, nwin), dtype=torch.float32, device=dev)]
    planes = [torch.empty(s, dtype=torch.uint8, device=dev)
              for s in ((I, L), (I, nwin), (I, nwin))]
    outputs = {"lod_windows": sums, "covered": planes, "window_sums": sums,
               "covered_terms": planes}
    times = {}
    for k, (kern, plain, lib) in runs.items():
        b, by = bound_ms(k, I, L, W, card)
        t = {"ms": _median_ms(kern), "plain_ms": _median_ms(plain),
             "bound_ms": b, "bound_by": by,
             "library_ms": None if lib is None else _median_ms(lib)}
        times[k] = t
        back = _median_ms(kern, reps=10)
        fill = _median_ms(lambda: [o.fill_(0) for o in outputs[k]])
        libs = ("none" if lib is None
                else f"{t['library_ms']:.4f} ms (cuDNN conv1d, f32)")
        say(f"  {k} at the bench shape, W={W}: kernel {t['ms']:.4f} ms, "
            f"bound {b:.4f} ms ({by}), share of bound {b / t['ms']:.1%}, "
            f"plain {t['plain_ms']:.4f} ms, library {libs}, fill_ of its "
            f"outputs {fill:.4f} ms "
            "(CUDA events around one launch, median of 21); back to back "
            f"{back:.4f} ms, share of bound {b / back:.1%} (CUDA events "
            "around 10 launches, median of 21); "
            f"{cuda_lod.resident_warps(k, W)} resident warps per SM "
            "(of 64)")
    say(f"  launch counters after the comparisons: {cuda_lod.LAUNCHES}")
    return err, times


def compact_step():
    """gt_compact_2bit on the card (the module docstring, phase 2):
    returns its kernels-line entry."""
    import torch
    from garlic_tpu_torch.io import filters
    from garlic_tpu_torch.native import filter_pack_2bit_native
    from garlic_tpu_torch.ops import cuda_lod
    from garlic_tpu_torch.parallel import engine
    from garlic_tpu_torch.parallel.mesh import make_mesh
    from tests.test_torch_compact import WGS_CHR1, packed_chrom, wgs_chr1_keep
    dev = torch.device("cuda")
    I, L = WGS_CHR1["nind"], WGS_CHR1["nloci"]
    keep = wgs_chr1_keep(seed=2)
    fc = filters._apply(packed_chrom(I, L, seed=1), keep)
    pb, idx = fc.geno2b_parent
    n, W = fc.nloci, 60
    got = cuda_lod.packed_device(fc, dev)
    parent = torch.from_numpy(pb.reshape(-1)).to(dev)
    rel = torch.from_numpy(idx.astype(np.int32)).to(dev)
    stride = pb.shape[1]
    plain = cuda_lod.compact_2bit_plain(parent, stride, I, rel)
    host = filter_pack_2bit_native(pb, L, keep)[0]
    blocks = []
    for sh in engine.shard_blocks(I, n, make_mesh(2, 2, [dev] * 4), W):
        a, b = sh.block(W, W - 1, n)
        k = np.zeros(L, dtype=bool)
        k[idx[a:b]] = True
        blocks.append(np.array_equal(cuda_lod.packed_device(
            engine._Block(fc, None, sh.h0, sh.h1, a, b), dev).cpu().numpy(),
            filter_pack_2bit_native(pb[sh.h0:sh.h1], L, k)[0]))
    torch.cuda.synchronize()
    checks = {"plain equal": torch.equal(got, plain),
              "host equal": np.array_equal(got.cpu().numpy(), host),
              "2x2 blocks equal": all(blocks)}
    say(f"  compact_2bit at the WGS chr1 shape {I} x {L}, {n} kept "
        f"({L - n} dropped): " + ", ".join(f"{k} {v}"
                                           for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"gt_compact_2bit differs: {checks}")
    card = _card()
    nbytes = parent.numel() + 4 * n + got.numel()
    b = nbytes / card[2] * 1e3
    kern = lambda: cuda_lod.compact_2bit(parent, stride, I, rel)  # noqa: E731
    t = {"ms": _median_ms(kern),
         "plain_ms": _median_ms(
             lambda: cuda_lod.compact_2bit_plain(parent, stride, I, rel)),
         "bound_ms": b, "bound_by": "bytes", "library_ms": None}
    back = _median_ms(kern, reps=10)
    # the card's own time: both kernels of a launch (the plan and the
    # compaction), from the profiler; at ~0.03 ms a launch the events
    # above hold the wrapper's host work too
    dev_ms = sum((_device_ms(kern, ("compact_plan_kernel",
                                    "compact_2bit_kernel")) or {}).values())
    t["device_ms"] = dev_ms or None

    def route():
        cuda_lod.packed_device(fc, dev)
        torch.cuda.synchronize()

    host_ms = _median_wall_ms(
        lambda: filter_pack_2bit_native(pb, L, keep), 5)
    say(f"  compact_2bit: kernel {t['ms']:.4f} ms, bound {b:.4f} ms (bytes: "
        f"{nbytes / 1e6:.2f} MB, the parent rows, the int32 index and the "
        f"codes once), share of bound {b / t['ms']:.1%} (CUDA events around "
        f"one launch, median of 21); back to back {back:.4f} ms, share "
        f"{b / back:.1%} (10 launches); device time {dev_ms:.4f} ms, "
        f"share {b / dev_ms if dev_ms else 0:.1%} (torch.profiler, the plan "
        f"and the compaction kernels, 10 launches); "
        f"plain {t['plain_ms']:.4f} ms; "
        f"library none; the host pass gt_filter_pack_2bit "
        f"{host_ms:.4f} ms and the device route (uploads, launch, "
        f"synchronize) {_median_wall_ms(route, 5):.4f} ms (host clock, "
        "median of 5)")
    return t


# the example benchmark's pool: 20 of its 45 rows (--kde-subsample 20) on
# each of its 22 chromosomes, W = 60, step W (roh_bench/configs/
# garlic-example.json)
EXAMPLE_CONFIG = os.path.join(REPO, "roh_bench", "configs",
                              "garlic-example.json")
POOL_ROWS, POOL_W = 20, 60
# gt_dadd_chain's rounds, two dependent adds each: the latency is the
# difference of the two times over the difference of their adds
DADD_ROUNDS = (1 << 20, 1 << 21)


def dadd_latency_ns():
    """One dependent f64 add's latency on the card, in ns: one thread's
    chains of dependent adds (ops/exact_pool.dadd_chain) at two lengths,
    CUDA-event medians of 21."""
    import torch
    from garlic_tpu_torch.ops import exact_pool
    x = torch.tensor([1e-3, 2e-3, 0.5], dtype=torch.float64, device="cuda")
    t = [_median_ms(lambda n=n: exact_pool.dadd_chain(x, n))
         for n in DADD_ROUNDS]
    return (t[1] - t[0]) * 1e6 / (2 * (DADD_ROUNDS[1] - DADD_ROUNDS[0]))


def pool_step():
    """gt_exact_pool on the card (the module docstring, phase 2): returns
    its kernels-line entry."""
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import cuda_lod, exact_pool, lod
    from tests.test_torch_pool import MAX_GAP as GAP, pool_chrom
    dev = torch.device("cuda")
    with open(EXAMPLE_CONFIG) as f:
        cfg = json.load(f)
    I, snps = cfg["individuals"], cfg["snps"]
    rows = np.sort(np.random.default_rng(20).choice(I, POOL_ROWS, False))

    def chroms():  # fresh: the host pass compacts a chromosome once
        made = [pool_chrom(I, L, 100 + i, "two", "deferred", f"chr{i + 1}")
                for i, L in enumerate(snps)]
        return [c for c, _ in made], made[0][1]

    cs, centro = chroms()
    items = []
    for c in cs:
        miss = lod.window_missing_mask(c.positions, POOL_W, GAP,
                                       centro.start(c.chrom),
                                       centro.end(c.chrom))
        items.append((cuda_lod.packed_device(c, dev),
                      torch.from_numpy(rows.astype(np.int32)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(
                          lod.lod_table(c.freq, ERROR)[:3])).to(dev),
                      torch.from_numpy(miss.astype(np.uint8)).to(dev)))
    got = exact_pool.exact_pool(items, POOL_W, POOL_W)
    torch.cuda.synchronize()
    cpu_items = [tuple(t.cpu() for t in it) for it in items]
    t0 = time.perf_counter()
    plain = exact_pool.exact_pool_plain(cpu_items, POOL_W, POOL_W)
    plain_ms = (time.perf_counter() - t0) * 1e3
    route = exact_pool.thinned_samples(cs, centro, POOL_W, ERROR, GAP,
                                       POOL_W, [rows] * len(cs), dev)
    hs, _ = chroms()
    host = [pipeline._exact_thinned_samples([c], centro, POOL_W, ERROR, GAP,
                                            False, POOL_W, rows) for c in hs]
    g, p = got.cpu().numpy(), plain.numpy()
    checks = {
        "plain equal": bool(np.array_equal(np.isnan(g), np.isnan(p)) and
                            np.array_equal(g[~np.isnan(g)].view(np.uint64),
                                           p[~np.isnan(p)].view(np.uint64))),
        "host pass equal": all(np.array_equal(a.view(np.uint64),
                                              b.view(np.uint64))
                               for a, b in zip(route, host)),
        "compaction deferred": all(cuda_lod.deferred(c) for c in cs)}
    nsamp = sum(a.size for a in route)
    say(f"  exact_pool at the example's pool, {POOL_ROWS} of {I} rows x "
        f"{len(snps)} chromosomes ({sum(snps)} loci), W {POOL_W}, step "
        f"{POOL_W}: {nsamp} samples; " + ", ".join(
            f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"gt_exact_pool differs: {checks}")
    card = _card()
    nwin = max(snps) - POOL_W + 1
    lat = dadd_latency_ns()
    chain = 2 * (nwin - 1) * lat / 1e6
    nbytes = sum(POOL_ROWS * ((L + 3) // 4) + 3 * 8 * L + (L - POOL_W + 1)
                 + 4 * POOL_ROWS + 8 * POOL_ROWS * -(-L // POOL_W)
                 for L in snps)
    b = nbytes / card[2] * 1e3
    kern = lambda: exact_pool.exact_pool(items, POOL_W, POOL_W)  # noqa: E731
    t = {"ms": _median_ms(kern), "plain_ms": plain_ms,
         "bound_ms": max(b, chain),
         "bound_by": "serial chain" if chain >= b else "bytes",
         "library_ms": None}
    dev_ms = sum((_device_ms(kern, ("exact_pool_kernel",)) or {}).values())
    t["device_ms"] = dev_ms or None

    def dev_route():
        exact_pool.thinned_samples(cs, centro, POOL_W, ERROR, GAP, POOL_W,
                                   [rows] * len(cs), dev)

    fresh = [chroms()[0] for _ in range(6)]

    def host_route():
        pipeline_cs = fresh.pop()
        for c in pipeline_cs:
            pipeline._exact_thinned_samples([c], centro, POOL_W, ERROR, GAP,
                                            False, POOL_W, rows)

    say(f"  exact_pool: kernel {t['ms']:.4f} ms (CUDA events around one "
        f"launch, median of 21), device time {dev_ms:.4f} ms "
        f"(torch.profiler, 10 launches); bounds: its bytes "
        f"{nbytes / 1e6:.2f} MB at 3.35 TB/s {b:.4f} ms, its serial chain "
        f"2 x {nwin - 1} window steps x {lat:.3f} ns a dependent f64 add "
        f"{chain:.4f} ms (gt_dadd_chain, {DADD_ROUNDS} rounds); share of "
        f"the chain {chain / t['ms']:.1%}; plain {plain_ms:.1f} ms (CPU "
        f"tensors, host clock, one call); library none; the route "
        f"(uploads, compactions, launch, copy back, filter) "
        f"{_median_wall_ms(dev_route, 5):.2f} ms against the host pass "
        f"(compaction, decode, table, mask, native thin pass) "
        f"{_median_wall_ms(host_route, 5):.2f} ms (host clock, median of 5)")
    return t


def phase_tie_band(chrom, centro):
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import cuda_lod
    from garlic_tpu_torch.ops import lod as lod_ops
    say("== phase 3: tie band")
    ratios = {}
    for use_gl in (False, True):
        tmax = pipeline._corner_tmax(chrom, ERROR, use_gl)
        for W in (60, 120):
            if use_gl:
                terms, ms = cuda_lod.chrom_gl_inputs(chrom, centro, W,
                                                     MAX_GAP, "cuda")
                w32 = cuda_lod.window_sums(terms, ms, W)
                del terms
            else:
                pk, tb, ms = cuda_lod.chrom_device_inputs(
                    chrom, centro, W, ERROR, MAX_GAP, "cuda")
                w32 = cuda_lod.lod_windows(pk, tb, ms, W)
                del pk, tb
            w32 = w32.cpu().numpy()
            nwin = w32.shape[1]
            w64 = lod_ops.calc_lod_windows(chrom, centro, W, ERROR, MAX_GAP,
                                           use_gl)[:, :nwin]
            live = ms.cpu().numpy() == 0
            dev = np.abs(w32[:, live].astype(np.float64) - w64[:, live]).max()
            key = f"{'tgls' if use_gl else 'plain'} W={W}"
            ratios[key] = float(dev / (2.0 ** -23 * W * tmax))
            say(f"  {key}: max |f32 - f64| = {dev:.6g} over {chrom.nind} "
                f"rows x {int(live.sum())} windows; ratio "
                f"{ratios[key]:.3f} (band {TIE_BAND_FACTOR:g}, tmax "
                f"{tmax:.4f})")
            del w32, w64, ms
            torch.cuda.empty_cache()
    if max(ratios.values()) > TIE_BAND_FACTOR:
        raise AssertionError(f"tie band exceeded: {ratios}")
    return ratios


class _Tee:
    """sys.stderr during a run: written through, and kept so the
    --tpu-profile lines can be read back."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def profile(self):
        """The phase breakdown's (phase, seconds), TOTAL last."""
        return re.findall(r"^\[profile\]\s+(\S+)\s+([0-9.]+)s",
                          phase_block("".join(self.parts)), flags=re.M)


def phase_block(text):
    """The --tpu-profile phase breakdown of a run's stderr: its last
    `[profile] phase breakdown:` block, without the span breakdown that
    follows it."""
    return text.split("[profile] phase breakdown:")[-1].split(
        "[profile] span breakdown:")[0]


def profile_counters(text):
    """The counters of each --tpu-profile report in a run's stderr (its
    `[profile] counters {...}` lines), in order."""
    return [json.loads(m) for m in re.findall(
        r"^\[profile\] counters (\{.*\})$", text, flags=re.M)]


def _run_port(argv, label, device=None):
    """One `python -m garlic_tpu_torch` run, in this process; prints its
    --tpu-profile phase split.  Returns (wall seconds, its stderr).
    device: a device list for run_main (the meshes of phase 8), called
    directly; None runs the module as the command line does."""
    import torch
    from garlic_tpu_torch.pipeline import run_main
    saved, saved_err = sys.argv, sys.stderr
    sys.argv = ["garlic_tpu_torch"] + argv
    tee = sys.stderr = _Tee(saved_err)
    t0 = time.perf_counter()
    rc = 0
    try:
        if device is None:
            runpy.run_module("garlic_tpu_torch", run_name="__main__",
                             alter_sys=True)
        else:
            rc = run_main(argv, prog="garlic_tpu_torch", device=device)
    except SystemExit as e:
        rc = e.code
    finally:
        sys.argv, sys.stderr = saved, saved_err
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    say(f"  {label}: exit {rc}, wall {wall:.3f}s")
    split = tee.profile()
    if split:
        say("    profile (s): " + ", ".join(f"{k} {v}" for k, v in split))
    if rc != 0:
        raise AssertionError(f"{label} exited {rc}")
    return wall, "".join(tee.parts)


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


def write_tgls(panel, path, tokens, seed):
    """A TGLS file aligned with tests/util.write_tped's rows (4 leading
    columns, then one value per individual), each value drawn uniformly
    from `tokens`; vectorized like write_tped, plain text."""
    rng = np.random.default_rng(seed)
    lut = np.array(tokens)
    width = lut.dtype.itemsize
    if any(len(t) != width for t in tokens):
        raise ValueError("tokens must share one width")
    nind = len(panel.ind_ids)
    with open(path, "wb") as f:
        for ci, chrom in enumerate(panel.chrom_names):
            pos = panel.positions[ci]
            L = len(pos)
            cells = lut[rng.integers(0, lut.size, (L, nind), dtype=np.uint16)]
            rows = cells.view("S1").reshape(L, -1).view(f"S{width * nind}")
            rows = rows[:, 0]
            for start in range(0, L, 65536):
                stop = min(start + 65536, L)
                f.write(b"".join(f"{chrom} rs{ci}_{l} 0 {int(pos[l])}"
                                 .encode() + rows[l] + b"\n"
                                 for l in range(start, stop)))


class _ExactRuns:
    """Exact-engine runs of `python -m garlic_tpu_torch` in subprocesses
    that cannot see the card.  They start together as soon as their
    inputs are written, each pinned to `cores` (os.sched_setaffinity),
    CPUs that the smoke's own process does not use, so their f64 host
    work runs beside the timed phases without sharing their cores (their
    own walls are taken side by side).  finish() waits for one, checks
    its exit code and prints its --tpu-profile split; stop() ends any
    left."""

    def __init__(self, cores=None):
        self.procs = {}
        self.cores = cores

    def start(self, argv, label):
        out = _MainPath.out(label)
        log = open(out + ".stderr", "wb")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.Popen(
            [sys.executable, "-m", "garlic_tpu_torch"] + argv
            + ["--tpu-engine", "exact", "--out", out], cwd=REPO, env=env,
            stdout=log, stderr=subprocess.STDOUT)
        if self.cores is not None:
            os.sched_setaffinity(proc.pid, self.cores)
        self.procs[label] = (proc, log)

    def finish(self, label, mp):
        proc, log = self.procs.pop(label)
        rc = proc.wait()
        log.close()
        text = _read(log.name).decode(errors="replace")
        split = re.findall(r"^\[profile\]\s+(\S+)\s+([0-9.]+)s", text,
                           flags=re.M)
        mp.walls[label] = float(dict(split).get("TOTAL", "nan"))
        say(f"  {label} (subprocess): exit {rc}, --tpu-profile total "
            f"{mp.walls[label]:.3f}s")
        if split:
            say("    profile (s): " + ", ".join(f"{k} {v}" for k, v in split))
        if rc != 0:
            raise AssertionError(f"{label} exited {rc}: {text[-3000:]}")

    def stop(self):
        for proc, log in self.procs.values():
            proc.kill()
            proc.wait()
            log.close()
        self.procs.clear()


def _split_cores():
    """(this process's CPUs, the exact runs' CPUs): the two halves of the
    CPUs this process may use when there are 4 or more, else all of them
    for both (no pinning: None for the exact runs)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return cores, None
    k = len(cores) // 2
    return cores[:k], cores[k:]


class _MainPath:
    """Drives the port's runs; each run's kernel launch counters are
    zeroed just before it and read just after it, and summed."""

    def __init__(self):
        self.walls = {}
        self.stderr = {}
        self.launches = dict.fromkeys([*KERNELS, "compact_2bit",
                                       "exact_pool"], 0)

    def run(self, argv, label, kernel=None, at_least=0, absent=None,
            device=None):
        """kernel: a kernel's name, a tuple of them, or one of the weighted
        path's plain-torch programs (device_wlod.CALLS), that must each
        run at least at_least times, or a dict of such names to their
        least counts; absent: a kernel that must not run; device: see
        _run_port."""
        def port():
            self.walls[label], self.stderr[label] = _run_port(
                argv + ["--out", self.out(label)], label, device)
        self.counted(port, label, kernel, at_least, absent)

    def counted(self, fn, label, kernel=None, at_least=0, absent=None):
        """fn() with every launch counter zeroed just before it and read
        just after it; returns what fn returns."""
        from garlic_tpu_torch.ops import cuda_lod, device_wlod
        for counts in (cuda_lod.LAUNCHES, device_wlod.CALLS):
            for k in counts:
                counts[k] = 0
        out = fn()
        got = {**cuda_lod.LAUNCHES, **device_wlod.CALLS}
        say(f"    launches: {got}")
        for k in self.launches:
            self.launches[k] += got[k]
        want = (kernel if isinstance(kernel, dict)
                else dict.fromkeys(_names(kernel), at_least))
        for k, least in want.items():
            if got[k] < least:
                raise AssertionError(f"{label}: {k} ran {got[k]} times, "
                                     f"expected >= {least}")
        if absent is not None and got[absent]:
            raise AssertionError(f"{label}: {absent} ran {got[absent]} "
                                 "times, expected none")
        return out

    @staticmethod
    def out(label):
        return os.path.join(WORK, label)

    def same(self, labels, ref):
        """.roh.bed byte-identical and .freq.gz equal to ref's."""
        bed = _read(self.out(ref) + ".roh.bed")
        for k in labels:
            if _read(self.out(k) + ".roh.bed") != bed:
                raise AssertionError(f"{k}.roh.bed differs from {ref}'s")
            if _read(self.out(k) + ".freq.gz") != \
                    _read(self.out(ref) + ".freq.gz"):
                raise AssertionError(f"{k}.freq.gz differs from {ref}'s")
        say(f"  .roh.bed byte-identical across {', '.join(labels)} and {ref}"
            f" ({bed.count(b'track')} individuals, "
            f"{len(bed.splitlines()) - bed.count(b'track')} ROH); "
            ".freq.gz equal")

    def join_chroms(self, label, parts):
        """Writes label's .roh.bed and .freq.gz from the runs `parts`, one
        per chromosome in order: each individual's track line, then its
        calls on each chromosome in turn; the frequency rows of each
        chromosome in turn under the first header."""
        blocks = []
        for k in parts:
            b = []
            for line in _read(self.out(k) + ".roh.bed").splitlines(True):
                if line.startswith(b"track"):
                    b.append([line])
                else:
                    b[-1].append(line)
            blocks.append(b)
        if len({tuple(x[0] for x in b) for b in blocks}) != 1:
            raise AssertionError(f"{parts}: the track lines differ")
        with open(self.out(label) + ".roh.bed", "wb") as f:
            for rows in zip(*blocks):
                f.write(b"".join([rows[0][0]] + [c for r in rows
                                                 for c in r[1:]]))
        texts = [_read(self.out(k) + ".freq.gz") for k in parts]
        with gzip.open(self.out(label) + ".freq.gz", "wb") as f:
            f.write(texts[0] + b"".join(t.split(b"\n", 1)[1]
                                        for t in texts[1:]))

    def log_lines(self, label):
        """.log after its first line, the output basename normalized."""
        text = _read(self.out(label) + ".log").decode()
        return [line.replace(label, "BASE")
                for line in text.splitlines()[1:]]

    def same_log(self, labels, ref):
        want = self.log_lines(ref)
        for k in labels:
            if self.log_lines(k) != want:
                raise AssertionError(f"{k}.log differs from {ref}'s")
        say(f"  .log equal after line 1 across {', '.join(labels)} and "
            f"{ref}")

    def kde_files(self, label):
        """The .kde suffixes of run `label` (not its .procN runs')."""
        base = self.out(label)
        return sorted(p[len(base):] for p in glob.glob(base + ".*SNPs.kde")
                      if ".proc" not in p[len(base):])

    def same_kde(self, labels, ref, y_tol=None):
        """Every .kde: x byte-identical; y within y_tol * max y."""
        sfx = self.kde_files(ref)
        if not sfx:
            raise AssertionError(f"{ref} wrote no .kde")
        for k in labels:
            if self.kde_files(k) != sfx:
                raise AssertionError(f"{k}: .kde files {self.kde_files(k)}"
                                     f" against {sfx}")
            for s in sfx:
                a = [r.split() for r in
                     _read(self.out(ref) + s).decode().splitlines()]
                b = [r.split() for r in
                     _read(self.out(k) + s).decode().splitlines()]
                if [r[0] for r in a] != [r[0] for r in b]:
                    raise AssertionError(f"{k}{s}: x column differs")
                ya = np.array([float(r[1]) for r in a])
                yb = np.array([float(r[1]) for r in b])
                rel = float(np.abs(ya - yb).max() / ya.max())
                say(f"  {k}{s}: x byte-identical to {ref}'s, max |dy| = "
                    f"{rel:.3g} * max y")
                if y_tol is not None and rel > y_tol:
                    raise AssertionError(f"{k}{s}: y differs by {rel:.3g}"
                                         f" * max y > {y_tol:g}")

    def logged(self, label, pattern):
        m = re.search(pattern, _read(self.out(label) + ".log").decode())
        if m is None:
            raise AssertionError(f"{label}.log has no {pattern!r}")
        return m.group(1)

    def raw_close(self, fast, exact, chroms):
        vf = _raw_values(self.out(fast), chroms)
        vx = _raw_values(self.out(exact), chroms)
        if not np.array_equal(np.isnan(vf), np.isnan(vx)):
            raise AssertionError(f"{fast}: NA positions differ")
        m = ~np.isnan(vx)
        # %g keeps six significant digits, hence the relative term
        if not np.allclose(vf[m], vx[m], rtol=1e-5, atol=1e-4):
            raise AssertionError(f"{fast}: window values differ")
        say(f"  {fast}: {m.sum()} raw values within atol 1e-4 + rtol 1e-5 "
            f"of {exact}'s (max |diff| {np.abs(vf[m] - vx[m]).max():.3g})")


def _split_rows(path, names):
    """{name: path} of one gzip text file per chromosome name, holding
    the rows of the TPED or map file `path` (chromosome first) that
    belong to it, as they are."""
    paths = {n: path.replace(".gz", f".{n}.gz") for n in names}
    outs = {n: gzip.open(q, "wb", compresslevel=1) for n, q in paths.items()}
    try:
        with gzip.open(path, "rb") as f:
            for line in f:
                outs[line.split(None, 1)[0].decode()].write(line)
    finally:
        for o in outs.values():
            o.close()
    return paths


def write_bench(panel):
    """bench.py's panel as TPED/TFAM, its genetic map, a copy of the TPED
    for the weighted runs (a name of their own: their cold run parses),
    and the weighted TPED and map split by chromosome (the exact engine's
    weighted runs, one per chromosome)."""
    from tests.util import write_map_scaffold, write_tped
    tped = os.path.join(WORK, "bench.tped.gz")
    tfam = os.path.join(WORK, "bench.tfam")
    t0 = time.perf_counter()
    write_tped(panel, tped, tfam)
    wtped = os.path.join(WORK, "weighted.tped.gz")
    shutil.copy(tped, wtped)
    wmap = os.path.join(WORK, "bench.map.gz")
    write_map_scaffold(panel, wmap, rate_cm_per_mb=MAP_RATE)
    tpeds = _split_rows(wtped, panel.chrom_names)
    maps = _split_rows(wmap, panel.chrom_names)
    split = [(tpeds[n], maps[n]) for n in panel.chrom_names]
    say(f"wrote the bench panel and map in {time.perf_counter() - t0:.1f}s")
    return tped, tfam, wtped, wmap, split


def write_small():
    """The 50 x (100k, 100k) panel as TPED/TFAM, its genetic map, and its
    GL (float form) and GQ (dictionary form) TGLS files."""
    from tests.util import make_panel, write_map_scaffold, write_tped
    t0 = time.perf_counter()
    small = make_panel(**RAWLOD_PANEL)
    stped = os.path.join(WORK, "small.tped.gz")
    stfam = os.path.join(WORK, "small.tfam")
    write_tped(small, stped, stfam)
    smap = os.path.join(WORK, "small.map.gz")
    write_map_scaffold(small, smap, rate_cm_per_mb=MAP_RATE)
    sgl = os.path.join(WORK, "small.gl.tgls")
    sgq = os.path.join(WORK, "small.gq.tgls")
    write_tgls(small, sgl, GL_TOKENS, seed=6)
    write_tgls(small, sgq, GQ_TOKENS, seed=7)
    say(f"wrote the small panel, map and TGLS files in "
        f"{time.perf_counter() - t0:.1f}s")
    return small, (stped, stfam), smap, sgl, sgq


def phase_main_path(panel, mp, tped, tfam, small, small_files, sgl, sgq):
    say("== phase 4: main path (python -m garlic_tpu_torch)")
    nchrom = len(panel.chrom_names)
    base = ["--tped", tped, "--tfam", tfam, "--tpu-panel-cache"] + FLAGS
    for label, engine in (("fast_cold", "fast"), ("fast_warm", "fast"),
                          ("exact", "exact")):
        mp.run(base + ["--tpu-engine", engine], label, "covered",
               nchrom if engine == "fast" else 0)
    mp.same(("fast_cold", "fast_warm"), "exact")

    stped, stfam = small_files
    sbase = ["--tped", stped, "--tfam", stfam] + FLAGS
    snames = [f"chr{c}" for c in small.chrom_names]
    for label, engine in (("rawlod_fast", "fast"), ("rawlod_exact",
                                                    "exact")):
        mp.run(sbase + ["--raw-lod", "--tpu-engine", engine], label,
               "lod_windows", nchrom if engine == "fast" else 0)
    mp.same(("rawlod_fast",), "rawlod_exact")
    mp.raw_close("rawlod_fast", "rawlod_exact", snames)

    # TGLS: a fresh TPED name, so the cold run writes both sidecars
    gtped = os.path.join(WORK, "bench_gl.tped.gz")
    shutil.copy(tped, gtped)
    gq = os.path.join(WORK, "bench.gq.tgls")
    t0 = time.perf_counter()
    write_tgls(panel, gq, GQ_TOKENS, seed=5)
    say(f"  wrote the bench GQ TGLS file ({os.path.getsize(gq) / 1e6:.0f} MB)"
        f" in {time.perf_counter() - t0:.1f}s")
    gbase = ["--tped", gtped, "--tfam", tfam, "--tgls", gq, "--gl-type",
             "GQ", "--tpu-panel-cache"] + FLAGS
    for label, engine in (("tgls_fast_cold", "fast"),
                          ("tgls_fast_warm", "fast"),
                          ("tgls_exact", "exact")):
        mp.run(gbase + ["--tpu-engine", engine], label, "covered_terms",
               nchrom if engine == "fast" else 0)
        if label == "tgls_fast_cold" and not os.path.exists(gq + ".gtlc"):
            raise AssertionError("the cold TGLS run wrote no .gtlc sidecar")
    mp.same(("tgls_fast_cold", "tgls_fast_warm"), "tgls_exact")

    for label, engine in (("gl_fast", "fast"), ("gl_exact", "exact")):
        mp.run(sbase + ["--tgls", sgl, "--gl-type", "GL", "--tpu-engine",
                        engine], label, "window_sums",
               nchrom if engine == "fast" else 0)
    mp.same(("gl_fast",), "gl_exact")
    for label, engine in (("tgls_rawlod_fast", "fast"),
                          ("tgls_rawlod_exact", "exact")):
        mp.run(sbase + ["--tgls", sgq, "--gl-type", "GQ", "--raw-lod",
                        "--tpu-engine", engine], label, "window_sums",
               nchrom if engine == "fast" else 0)
    mp.same(("tgls_rawlod_fast",), "tgls_rawlod_exact")
    mp.raw_close("tgls_rawlod_fast", "tgls_rawlod_exact", snames)


def _gmm_init(x, k=3):
    """selectSizeClasses' initial parameters (ops/gmm.py)."""
    var, mean = float(np.var(x, ddof=1)), float(np.mean(x))
    return (np.full(k, 1.0 / k),
            np.array([mean * (n + 1) / (k + 1) for n in range(k)]),
            np.array([var * (n + 1) / k for n in range(k)]))


def _check_em(x, what):
    """fit_gmm_sharded on the card's 1x1 mesh against the host EM: the
    same iterations and the same %g-printed parameters."""
    from garlic_tpu_torch.core.fmt import g
    from garlic_tpu_torch.ops import gmm
    from garlic_tpu_torch.parallel import engine
    from garlic_tpu_torch.parallel.mesh import make_mesh
    init = _gmm_init(x)
    dev = engine.fit_gmm_sharded(x, 3, *init, make_mesh(1, 1, ["cuda:0"]))
    host = gmm.fit_gmm(x, 3, *init)
    fmt = [[g(float(v)) for v in r.weights] + [g(float(v)) for v in r.means]
           + [g(float(v)) for v in r.variances] for r in (dev, host)]
    say(f"  device EM on {what} ({x.size} lengths): {dev.iterations} "
        f"iterations (host {host.iterations}); %g parameters "
        f"{'equal' if fmt[0] == fmt[1] else 'DIFFER'}")
    if dev.iterations != host.iterations or fmt[0] != fmt[1]:
        raise AssertionError(f"device EM differs from the host EM on {what}")


class _Split:
    """Host-clock seconds spent in named functions: each (owner,
    attribute) of `parts` ({label: [(owner, attribute), ...]}) is replaced
    by a wrapper that times its calls until close(); a wrapped function
    called inside another counts in the outer one's label only.  Every
    function wrapped returns host data, so its device work has ended
    when it returns."""

    def __init__(self, parts):
        self.sec = dict.fromkeys(parts, 0.0)
        self.saved = []
        self.depth = 0
        for label, targets in parts.items():
            for owner, name in targets:
                fn = getattr(owner, name)
                self.saved.append((owner, name, fn))
                setattr(owner, name, self._timed(label, fn))

    def _timed(self, label, fn):
        def timed(*a, **k):
            if self.depth:
                return fn(*a, **k)
            self.depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.depth -= 1
                self.sec[label] += time.perf_counter() - t0
        return timed

    def take(self):
        """The seconds so far, then zeroes them."""
        out = dict(self.sec)
        self.sec = dict.fromkeys(self.sec, 0.0)
        return out

    def close(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)


def _auto_split():
    """_Split over the automatic run's Phase II (pool read and store, the
    exact sampler, the grid, the transform, the .kde writer, the cutoff
    search) and Phase IV (the EM, the boundaries)."""
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.io import kdefile, poolcache
    from garlic_tpu_torch.ops import brent, cutoff, gmm, kde
    from garlic_tpu_torch.parallel import engine
    return _Split({
        "pool read": [(poolcache.PoolCache, "lookup")],
        "pool store": [(poolcache.PoolCache, "store")],
        "sampler": [(pipeline, "_exact_thinned_samples_sharded")],
        "grid": [(kde, "_kde_grid")],
        "transform": [(engine, "gauss_transform_sharded"),
                      (kde, "gauss_transform_host")],
        ".kde write": [(kdefile, "write_kde")],
        "cutoff search": [(cutoff, "get_min_btw_modes"),
                          (cutoff, "cutoff_tie_probe")],
        "EM": [(engine, "fit_gmm_sharded"), (gmm, "fit_gmm")],
        "boundaries": [(brent, "find_boundary")]})


def _exp_ms(terms, card):
    """ms of `terms` Gauss terms at the special-function rate (one exp
    each), against 4 f32 operations each (subtract, square, scale, add) at
    the f32 rate: the larger."""
    sms, clock, _ = card
    return max(terms / (sms * MUFU_LANES * clock),
               4 * terms / (sms * FP32_LANES * clock)) * 1e3


def gauss_bound_ms(n, M, card):
    """(least time in ms, "bytes" or "operations") of a dense transform
    of n sources at M targets: the sources and targets read once and the
    f64 sums written once, against all n * M terms (_exp_ms)."""
    return _bytes_or_ops(4 * n + 4 * M + 8 * M, _exp_ms(n * M, card), card)


def gauss_needed_bound_ms(n, M, nonzero, card):
    """gauss_bound_ms over the terms these inputs need: the `nonzero`
    terms that are not exactly +0 (counted on the card from the plain
    version's terms: f64_term_sums); the others add nothing to any sum."""
    return _bytes_or_ops(4 * n + 4 * M + 8 * M, _exp_ms(nonzero, card),
                         card)


def em_bound_ms(N, K, iterations, card):
    """(least time in ms, "bytes" or "operations") of K8's fit over N
    points, K components and this run's iterations: the points and the
    parameters read once and the result written once, against the plain
    E-step's f64 operations, 18 a point and component and 4 a point
    (each exp, log and division counted as one), at 64 f64 lanes an
    SM."""
    sms, clock, _ = card
    ops = N * iterations * (18 * K + 4)
    return _bytes_or_ops(8 * N + 24 * K + 8 * (3 * K + 4),
                         ops / (sms * FP64_LANES * clock) * 1e3, card)


def f64_term_sums(src, tgt, neg_inv_h2):
    """(the f64 sums of gauss_sums_plain's f32 terms, the count of those
    terms that are not +0): each term as the plain version makes it, the
    terms added in f64, the sums that K7's and the plain version's f32
    orders approximate.  Both make the same terms, so their distance from
    the host f64 transform is mostly the terms' own f32 error; their
    distance from these sums is their summation's alone."""
    import torch
    from garlic_tpu_torch.ops import kde
    out = torch.zeros(tgt.shape[0], dtype=torch.float64, device=src.device)
    nonzero = 0
    for s in range(0, src.shape[0], kde.BLOCK):
        d = src[s:s + kde.BLOCK, None] - tgt[None, :]
        d.square_().mul_(float(neg_inv_h2)).exp_()
        out += d.double().sum(dim=0)
        nonzero += int(torch.count_nonzero(d))
    return out, nonzero


def k7_terms_bit_equal(src, tgt, neg_inv_h2, count=256):
    """True when K7 makes gauss_sums_plain's f32 terms bit for bit, on
    `count` sources spread over src: each launch takes one run of 16
    sources, the source at one of the run's 16 places in turn and the
    other 15 so far off the grid that their terms are exactly 0 on both
    sides ((d * d) overflows to inf; K7's plan puts them in its
    over-range bucket), so each sum is its one term, exactly."""
    import torch
    from garlic_tpu_torch.ops import kde
    far = torch.full((16,), 1e20, dtype=torch.float32, device=src.device)
    for q, i in enumerate(np.linspace(0, src.shape[0] - 1, count,
                                      dtype=np.int64)):
        run = far.clone()
        run[q % 16] = src[int(i)]
        if not torch.equal(kde.gauss_sums_cuda(run, tgt, neg_inv_h2),
                           kde.gauss_sums_plain(run, tgt, neg_inv_h2)):
            return False
    return True


def k7_plan_checked(src, tgt, neg_inv_h2):
    """K7's bucketed sources against a stable sort by ops/kde.k7_buckets'
    buckets (torch.sort, stable: here only, never on the port's path) and
    its plan (each tile's range of the bucketed array, items, NaN count)
    against ops/kde.k7_plan's; raises on a difference.  Returns (the
    terms K7 computes: the tiles' ranges x 32 targets, all dense)."""
    import torch
    from garlic_tpu_torch.ops import kde
    _, srt, info = kde._gauss_launch(src, tgt, neg_inv_h2)
    src32, tgt32 = src.cpu().numpy(), tgt.cpu().numpy()
    plan = kde.k7_plan(tgt32, neg_inv_h2)
    b = kde.k7_buckets(src32, plan)
    order = torch.sort(torch.from_numpy(b), stable=True).indices
    if not torch.equal(srt.view(torch.int32),
                       src[order.to(src.device)].view(torch.int32)):
        raise AssertionError("K7's bucketed order is not a stable sort")
    info = info.cpu().numpy()
    start = np.searchsorted(np.sort(b), np.arange(plan.nc + 4))
    tiles = plan.ranges.shape[0]
    tinfo = info[kde.K7_INFO:kde.K7_INFO + 4 * tiles].reshape(tiles, 4)
    if (not (tinfo[:, 0] == start[plan.ranges[:, 0]]).all()
            or not (tinfo[:, 1] == start[plan.ranges[:, 1] + 1]).all()
            or info[1] != 0):
        raise AssertionError("K7's plan differs from ops/kde.k7_plan")
    return int((tinfo[:, 1] - tinfo[:, 0]).sum()) * kde.K7_TILE, \
        bool(info[2])


def _device_ms(fn, names, reps=10):
    """{kernel name: device ms per call} of the kernels whose names hold
    one of `names`, from torch.profiler over reps calls of fn; None when
    the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", 0) or 0
        if t > 0 and any(n in ev.key for n in names):
            out[ev.key] = t / reps / 1e3
    return out or None


# K7 may be this much farther than the plain version from the host f64
# transform: both add the same f32 terms (k7_terms_bit_equal), whose own
# error is that distance; only their summation orders differ.
HOST_MARGIN = 1.01
# K8's launch shapes, timed at these sizes (the run's lengths, then
# seeded mixtures) and, beside K = 3, at K = 9 (the grouped E-step)
EM_TIMED_N = (100_000, 1_000_000)
EM_TIMED_ITERS = 50  # iterations of a timed fit at those sizes


def _em_mixture(N, seed):
    """N seeded ROH lengths from three modes (tests/test_phase24.py)."""
    rng = np.random.default_rng(seed)
    a, b = N * 25 // 52, N * 18 // 52
    return np.concatenate([
        rng.normal(2.2e5, 5e4, a), rng.normal(8.5e5, 1.8e5, b),
        rng.normal(2.6e6, 6e5, N - a - b)]).clip(1e4, None)


def _em_times(x, k, path, iters=None):
    """K8 on the f64 points x (a CUDA tensor) with selectSizeClasses'
    start, by `path`: (whole fit ms (to convergence, or `iters`
    iterations with no convergence test), its iterations, us per
    iteration ((fit - fit of one iteration) / (iterations - 1)), stats
    mode ms per em_stats-style call)."""
    import torch
    from garlic_tpu_torch.ops import gmm
    N = int(x.shape[0])
    w, mu, var = (torch.from_numpy(v).to(x.device)
                  for v in _gmm_init(x.cpu().numpy(), k))
    out = torch.empty(3 * k + 4, dtype=torch.float64, device=x.device)
    prec = 1e-5 if iters is None else -1.0

    def fit(max_iter=iters or 1000):
        gmm._em_launch(x, w, mu, var, out, fit=True, n=N, max_iter=max_iter,
                       precision=prec, path=path)
    n = 21 if N <= 100_000 else 7
    full = _median_ms(fit, n=n)
    it = int(out[3 * k + 1].item())
    one = _median_ms(lambda: fit(1), n=n)

    def stats():
        o = torch.empty(3 * k + 1, dtype=torch.float64, device=x.device)
        gmm._em_launch(x, w, mu, var, o, fit=False, path=path)
    return full, it, (full - one) / max(it - 1, 1) * 1e3, _median_ms(stats)


def _auto_kernels(pool, lengths):
    """K7 and K8 against their plain versions on the card at the bench
    shapes (the warm auto run's pool and ROH lengths): the checks, the
    CUDA-event medians beside the bounds and the plain versions' times.
    Returns (max |diff| by kernel, times by kernel)."""
    import torch
    from garlic_tpu_torch.core.fmt import g
    from garlic_tpu_torch.ops import gmm, kde
    card = _card()
    dev = torch.device("cuda", 0)
    err, times = {}, {}
    # K7 over the pool's f32 sources and the grid's f32 targets
    h, targets, _ = kde._kde_grid(pool)
    n, M = pool.size, targets.size
    src = torch.from_numpy(pool.astype(np.float32)).to(dev)
    tgt = torch.from_numpy(targets.astype(np.float32)).to(dev)
    nih2 = -np.float32(1.0 / (h * h))
    a = kde.gauss_sums_cuda(src, tgt, nih2)
    b = kde.gauss_sums_cuda(src, tgt, nih2)
    p = kde.gauss_sums_plain(src, tgt, nih2)
    f, nonzero = f64_term_sums(src, tgt, nih2)
    torch.cuda.synchronize()
    a, b, p, f = (t.cpu().numpy() for t in (a, b, p, f))
    host = kde.gauss_transform_host(pool, targets, h)
    dk, dp = (float(np.abs(v / n - host).max() / host.max())
              for v in (a, p))
    fk, fp = (float(np.abs(v - f).max() / f.max()) for v in (a, p))
    terms = k7_terms_bit_equal(src, tgt, nih2)
    computed, dense = k7_plan_checked(src, tgt, nih2)
    err["gauss_sums"] = float(np.abs(a - p).max())
    say(f"  K7 gauss_sums on the pool ({n} sources x {M} targets, h "
        f"{h:.6g}): max |K7 - plain| = {err['gauss_sums'] / p.max():.3g} "
        f"* max y; from the f64 sums of the same f32 terms {fk:.3g} * max "
        f"y (plain {fp:.3g}); from the host f64 transform {dk:.3g} * max y "
        f"(plain {dp:.3g}: the f32 terms' own error, the same terms in "
        f"both; ratio {dk / dp:.6f}, at most {HOST_MARGIN}); terms "
        f"bit-equal to the plain version's on 256 sources {terms}; two "
        f"launches bit-equal {np.array_equal(a, b)}; bucketed order a "
        f"stable sort and plan equal to k7_plan's: True; terms not +0 "
        f"{nonzero} of {n * M} ({nonzero / (n * M):.2%}), computed by K7 "
        f"{computed} ({computed / (n * M):.2%}; every tile dense {dense})")
    if (err["gauss_sums"] > 1e-6 * p.max() or fk > fp
            or dk > HOST_MARGIN * dp or not terms
            or not np.array_equal(a, b)):
        raise AssertionError("K7 differs from its plain version")
    dense_bound, dense_by = gauss_bound_ms(n, M, card)
    bound, by = gauss_needed_bound_ms(n, M, nonzero, card)
    t = {"ms": _median_ms(lambda: kde.gauss_sums_cuda(src, tgt, nih2)),
         "plain_ms": _median_ms(lambda: kde.gauss_sums_plain(src, tgt,
                                                             nih2)),
         "bound_ms": bound, "bound_by": by, "library_ms": None,
         "dense_bound_ms": dense_bound}
    back = _median_ms(lambda: kde.gauss_sums_cuda(src, tgt, nih2), reps=10)
    times["gauss_sums"] = t
    say(f"  K7 at the bench shape: kernel {t['ms']:.4f} ms, back to back "
        f"{back:.4f} ms; bound over the terms these inputs need "
        f"{bound:.4f} ms ({by}: {nonzero:.4g} exps at {MUFU_LANES} a clock"
        f" per SM), share {bound / t['ms']:.1%} / {bound / back:.1%}; "
        f"dense bound {dense_bound:.4f} ms ({dense_by}: {n * M:.4g} exps), "
        f"share {dense_bound / t['ms']:.1%} / {dense_bound / back:.1%}; "
        f"plain {t['plain_ms']:.4f} ms, library none (no one PyTorch call "
        "computes it)")
    try:
        split = _device_ms(lambda: kde.gauss_sums_cuda(src, tgt, nih2),
                           ("k7_",))
    except Exception as e:  # the profiler is a reading, not a check
        split = None
        say(f"  K7's kernels: torch.profiler failed ({e!r})")
    say("  K7's kernels, device ms per launch (torch.profiler, 10 "
        "launches): " + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                         if split else "not measured (no device time)"))
    del src, tgt

    # K8 on the ROH lengths, K = 3 (the default --nclust)
    k, N = 3, lengths.size
    init = _gmm_init(lengths, k)
    x = torch.from_numpy(np.ascontiguousarray(lengths)).to(dev)
    w, mu, var = (torch.from_numpy(v).to(dev) for v in init)
    fits = [gmm.fit_em([x], k, *init, dev) for _ in range(2)]
    plain = gmm.fit_em_plain([x], k, *init, dev)
    s1, s2 = gmm.em_stats(x, w, mu, var), gmm.em_stats(x, w, mu, var)
    sp = gmm._em_stats(x, w, mu, var)
    torch.cuda.synchronize()
    pk = [np.concatenate([r.weights, r.means, r.variances])
          for r in fits + [plain]]
    same = (fits[0].iterations == plain.iterations
            and fits[0].converged == plain.converged
            and [g(float(v)) for v in pk[0]] == [g(float(v)) for v in pk[2]]
            and np.allclose(pk[0], pk[2], rtol=1e-10, atol=0))
    bit = (np.array_equal(pk[0], pk[1]) and torch.equal(s1, s2)
           and fits[0].loglikelihood == fits[1].loglikelihood)
    srel = float(((s1 - sp).abs() / sp.abs()).max())
    err["gmm_em"] = max(float(np.abs(pk[0] - pk[2]).max()),
                        float((s1 - sp).abs().max()))
    it = fits[0].iterations
    shape = gmm.em_path(dev, N, k)
    say(f"  K8 gmm_em on {N} ROH lengths, K={k} ({shape[0]}, {shape[1]} "
        f"blocks, points resident {shape[2]}): fit mode {it} iterations "
        f"(plain loop {plain.iterations}), converged {fits[0].converged}, "
        f"%g parameters {'equal' if same else 'DIFFER'}, max rel |diff| "
        f"{float(np.max(np.abs(pk[0] - pk[2]) / np.abs(pk[2]))):.3g}; "
        f"stats mode max rel |diff| {srel:.3g}; two launches bit-equal "
        f"{bit}")
    if not same or not bit or srel > 1e-12:
        raise AssertionError("K8 differs from its plain version")
    # the other shapes and the grouped E-step on the same lengths
    for kk in (3, 9):
        ini = _gmm_init(lengths, kk)
        want = gmm.fit_em_plain([x], kk, *ini, dev)
        ws = [torch.from_numpy(v).to(dev) for v in ini]
        for path in ("cluster", "grid"):
            o = torch.empty(3 * kk + 4, dtype=torch.float64, device=dev)
            gmm._em_launch(x, *ws, o, fit=True, n=N, max_iter=1000,
                           precision=1e-5, path=path)
            got = o.cpu().numpy()
            so = torch.empty(3 * kk + 1, dtype=torch.float64, device=dev)
            gmm._em_launch(x, *ws, so, fit=False, path=path)
            ref = gmm._em_stats(x, *ws)
            ok = (int(got[3 * kk + 1]) == want.iterations
                  and [g(float(v)) for v in got[:3 * kk]]
                  == [g(float(v)) for v in np.concatenate(
                      [want.weights, want.means, want.variances])]
                  and float(((so - ref).abs() / ref.abs()).max()) <= 1e-12)
            if not ok:
                raise AssertionError(f"K8 ({path}, K={kk}) differs from "
                                     "its plain version")
    say(f"  K8's shapes on the {N} lengths: cluster and grid, K = 3 and 9: "
        "the plain loop's iterations and %g lines, stats within rtol "
        "1e-12 of _em_stats")
    bound, by = em_bound_ms(N, k, it, card)
    full, _, per, stats = _em_times(x, k, "auto")
    t = {"ms": full,
         "plain_ms": _median_ms(lambda: gmm.fit_em_plain([x], k, *init,
                                                         dev), n=7),
         "bound_ms": bound, "bound_by": by, "library_ms": None}
    call = _median_ms(lambda: gmm.em_stats(x, w, mu, var))
    stats_plain = _median_ms(lambda: gmm._em_stats(x, w, mu, var))
    times["gmm_em"] = t
    say(f"  K8 at the bench shape: fit mode {t['ms']:.4f} ms for {it} "
        f"iterations, {per:.3f} us per iteration ((fit - fit with "
        f"max_iter 1) / {it - 1}), bound {bound:.4f} ms ({by}), share of "
        f"bound {bound / t['ms']:.2%}, plain loop {t['plain_ms']:.4f} ms; "
        f"stats mode {stats:.4f} ms a launch, {call:.4f} ms an em_stats "
        f"call (plain _em_stats {stats_plain:.4f} ms); library none")
    rows = [(N, kk, path) + _em_times(x, kk, path)
            for kk in (3, 9) for path in ("cluster", "grid")]
    for big in EM_TIMED_N:
        xb = torch.from_numpy(_em_mixture(big, big)).to(dev)
        rows += [(big, 3, path) + _em_times(xb, 3, path, EM_TIMED_ITERS)
                 for path in ("cluster", "grid")]
        del xb
    for N_, kk, path, full, it_, per, st in rows:
        shp = gmm.em_path(dev, N_, kk, path)
        say(f"  K8 {path} ({shp[1]} blocks, resident {shp[2]}), N={N_}, "
            f"K={kk}: fit {full:.4f} ms for {it_} iterations, {per:.3f} us "
            f"per iteration; stats mode {st:.4f} ms a launch"
            + ("  <- the automatic choice" if shp[0] == gmm.em_path(
                dev, N_, kk)[0] else ""))
    return err, times


def phase_auto_path(mp, bench_files, small_files, nchrom):
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import gmm, kde
    say("== phase 5: auto path (no --lod-cutoff, no --size-bounds)")
    tped, tfam = bench_files
    atped = os.path.join(WORK, "auto.tped.gz")
    shutil.copy(tped, atped)  # a fresh name: the cold run parses
    base = ["--tped", atped, "--tfam", tfam] + AUTO_FLAGS
    pools, fits = [], []
    sampler = pipeline._exact_thinned_samples_sharded
    select = gmm.select_size_classes

    def counting_sampler(*a, **k):
        pools.append(sampler(*a, **k))
        return pools[-1]

    def recording_select(lengths, nclust, log=None, mesh=None):
        fits.append((np.array(lengths, dtype=np.float64), mesh))
        return select(lengths, nclust, log, mesh=mesh)

    pipeline._exact_thinned_samples_sharded = counting_sampler
    gmm.select_size_classes = recording_select
    split = _auto_split()
    try:
        for label, engine, calls in (("auto_fast_cold", "fast", 1),
                                     ("auto_fast_warm", "fast", 0),
                                     ("auto_exact", "exact", 0)):
            n0 = len(pools)
            # the fast runs: K2 for every chromosome, one K7 (one shard)
            # and one K8 fit (5,530 ROH, above the device EM's gate); the
            # cold one pools on the card (one exact_pool launch)
            least = {"covered": nchrom, "gauss_sums": 1, "gmm_em": 1,
                     "exact_pool": calls} if engine == "fast" else None
            mp.run(base + ["--tpu-engine", engine], label, least,
                   absent="lod_windows")
            say(f"    exact sampler calls: {len(pools) - n0}")
            if len(pools) - n0 != calls:
                raise AssertionError(f"{label}: the exact sampler ran "
                                     f"{len(pools) - n0} times, expected "
                                     f"{calls}")
            pool = profile_counters(mp.stderr[label])[-1]["pool"]
            say(f"    pool counters: {pool}")
            if calls and not (pool["device"] > 0 and pool["host"] == 0):
                raise AssertionError(f"{label}: the pool ran on the host "
                                     f"({pool}), expected the card")
            sec = split.take()
            prof = dict(re.findall(r"^\[profile\]\s+(\S+)\s+([0-9.]+)s",
                                   mp.stderr[label], flags=re.M))
            say(f"    phase2-cutoff {prof.get('phase2-cutoff')}s: "
                + ", ".join(f"{k} {sec[k]:.4f}" for k in (
                    "pool read", "sampler", "pool store", "grid",
                    "transform", ".kde write", "cutoff search"))
                + f"; phase4-gmm {prof.get('phase4-gmm')}s: EM "
                f"{sec['EM']:.4f}, boundaries {sec['boundaries']:.4f} "
                "(host clock, seconds)")
    finally:
        split.close()
        pipeline._exact_thinned_samples_sharded = sampler
        gmm.select_size_classes = select
    fast = ("auto_fast_cold", "auto_fast_warm")
    mp.same(fast, "auto_exact")
    mp.same_log(fast, "auto_exact")
    mp.same_kde(fast, "auto_exact", Y_TOL)
    lengths = fits[0][0]
    cutoff = mp.logged("auto_exact", r"Selected LOD score cutoff: (.*)")
    bounds = mp.logged("auto_exact", r"boundaries = \((.*)\)")
    say(f"  selected LOD score cutoff {cutoff}, size bounds ({bounds}), "
        f"{lengths.size} ROH; GMM meshes per run "
        f"{[str(d) for _, d in fits]}")
    if lengths.size >= GMM_GATE:
        _check_em(lengths, "the run's ROH lengths")
    else:
        rng = np.random.default_rng(404)  # tests/test_phase24.py:243-247
        _check_em(np.concatenate([
            rng.normal(2.2e5, 5e4, 2500), rng.normal(8.5e5, 1.8e5, 1800),
            rng.normal(2.6e6, 6e5, 900)]).clip(1e4, None),
            f"a synthetic mixture (the run's {lengths.size} ROH are below "
            f"the {GMM_GATE} gate)")

    from garlic_tpu_torch.parallel import engine
    from garlic_tpu_torch.parallel.mesh import make_mesh
    one_card = make_mesh(1, 1, ["cuda:0"])
    pool = pools[0]
    h, targets, _ = kde._kde_grid(pool)
    f32 = pool.astype(np.float32)

    def transform():
        return engine.gauss_transform_sharded(pool, targets, h, one_card) \
            * (1.0 / pool.size)
    y_dev = transform()
    y_host = kde.gauss_transform_host(pool, targets, h)
    init = _gmm_init(lengths)
    times = {
        "pool H2D (f32)": _median_ms(
            lambda: torch.from_numpy(f32).to("cuda"), n=11),
        "device Gauss transform (gauss_transform_sharded, 1x1: K7)":
            _median_wall_ms(transform, n=7),
        "host f64 Gauss transform": _median_wall_ms(
            lambda: kde.gauss_transform_host(pool, targets, h),
            n=3),
        "device EM (fit_gmm_sharded, 1x1: K8 fit mode)": _median_wall_ms(
            lambda: engine.fit_gmm_sharded(lengths, 3, *init, one_card),
            n=7),
        "fit_gmm (host)": _median_wall_ms(
            lambda: gmm.fit_gmm(lengths, 3, *init), n=7),
    }
    say(f"  pool: {pool.size} samples, {pool.nbytes / 1e6:.1f} MB f64; "
        f"device transform against host: max |dy| = "
        f"{np.abs(y_dev - y_host).max() / y_host.max():.3g} * max y")
    for k, v in times.items():
        say(f"  {k}: {v:.3f} ms (median)")
    err, ktimes = _auto_kernels(pool, lengths)

    stped, stfam = small_files
    sbase = ["--tped", stped, "--tfam", stfam] + SEARCH_FLAGS
    search = ["--winsize", "40", "--auto-winsize", "--auto-winsize-step",
              "20"]
    for label, engine in (("search_fast", "fast"), ("search_exact",
                                                    "exact")):
        mp.run(sbase + search + ["--tpu-engine", engine], label,
               {"covered": nchrom, "gauss_sums": 1}
               if engine == "fast" else None, absent="lod_windows")
    ws = [mp.logged(k, r"Selected window size: (\d+)")
          for k in ("search_fast", "search_exact")]
    say(f"  selected window size: fast {ws[0]}, exact {ws[1]}")
    if ws[0] != ws[1]:
        raise AssertionError(f"the window size searches differ: {ws}")
    mp.same(("search_fast",), "search_exact")
    mp.same_kde(("search_fast",), "search_exact")
    for label, engine in (("explore_fast", "fast"), ("explore_exact",
                                                     "exact")):
        mp.run(sbase + ["--winsize-multi", "40", "60", "80", "--tpu-engine",
                        engine], label,
               {"gauss_sums": 3} if engine == "fast" else None)
    if len(mp.kde_files("explore_exact")) != 3:
        raise AssertionError("--winsize-multi 40 60 80 wrote "
                             f"{mp.kde_files('explore_exact')}")
    mp.same_kde(("explore_fast",), "explore_exact")
    return err, ktimes


def _bytes_or_ops(nbytes, ops_ms, card):
    """(least time in ms, "bytes" or "operations"): nbytes at the memory
    rate against ops_ms, the operations at their type's peak rate."""
    t = nbytes / card[2] * 1e3
    return (t, "bytes") if t >= ops_ms else (ops_ms, "operations")


def _weighted_chrom(tped, mapfile):
    """Bench chromosome 1 as a weighted run reads it: the port's loader
    (the warm sidecar), the monomorphic and out-of-bounds filter and the
    interpolated genetic positions."""
    from garlic_tpu_torch.centromeres import Centromere
    from garlic_tpu_torch.io import filters, genmap
    from garlic_tpu_torch.io import tped as tped_io
    centro = Centromere("hg18", "none", "none", None)
    ds, _ = tped_io.load_tped(tped, panel_cache=True)
    scaffolds = genmap.load_map_scaffold(mapfile, centro)
    chroms, _ = filters.filter_monomorphic_and_oob(ds.chroms, scaffolds)
    c = chroms[0]
    c.gpos, _ = genmap.interpolate_genetic_map(c.positions, scaffolds[0])
    return c, centro


def _wlod_f64(c, centro, W, counts, dev):
    """f64 weighted windows [I, nwin] on the card, MISSING where masked:
    the exact engine's pair counts (counts: ld.pair_counts_hr2 over the
    host genotypes, [L, >= W]), its f64 HR^2 (pair_ld_hr2_from_counts,
    full-panel marginals), the f64 band by the cumsum assembly
    (assemble_ld_fast: the exact engine's values up to f64 rounding) and
    the f64 scores of ops/wlod.py, summed in the reference's order (one
    rounded product, then one add, j from 0)."""
    import torch
    from garlic_tpu_torch.core.types import MISSING
    from garlic_tpu_torch.ops import ld, wlod
    from garlic_tpu_torch.ops.lod import window_missing_mask
    nwin = c.nloci - W + 1
    num, den = counts
    P = ld.pair_ld_hr2_from_counts(np.ascontiguousarray(num[:, :W]),
                                   np.ascontiguousarray(den[:, :W]),
                                   ld.geno_hom_freq(c.genotypes), W)
    inv = torch.from_numpy(1.0 / ld.assemble_ld_fast(P, W)[:nwin]).to(dev)
    del P
    score = torch.from_numpy(wlod.wlod_scores(c, ERROR, False, MU,
                                              M_GEN)).to(dev)
    acc = torch.zeros((c.nind, nwin), dtype=torch.float64, device=dev)
    for j in range(W):
        acc += score[:, j:j + nwin] * inv[:, j]
    missing = torch.from_numpy(window_missing_mask(
        c.positions, W, MAX_GAP, centro.start(c.chrom),
        centro.end(c.chrom))).to(dev)
    return acc.masked_fill_(missing[None, :], float(MISSING)), missing


def _weighted_1x1(c, centro, W, dev):
    """Weighted Phase I (pinned flags, HR^2) on the 1x1 mesh over dev, as
    the pipeline runs it: ld_band_sharded, then wlod_windows_sharded."""
    from garlic_tpu_torch.parallel import engine
    from garlic_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(1, 1, [dev])
    return engine.wlod_windows_sharded(
        c, centro, engine.ld_band_sharded(c, W, False, None, mesh), W, ERROR,
        MAX_GAP, False, MU, M_GEN, mesh)


def _weighted_tie_band(c, centro, dev):
    """max |win_f32 - win_f64| / (2^-23 * W * tie_scale) over every row
    and live window of bench chromosome 1, at W=60 and W=120; the f64
    side's pair counts are exact integers from the plain torch version
    (device_wlod._hr2_counts), not from K5, the kernel under test."""
    import torch
    from garlic_tpu_torch.ops import cuda_lod, device_wlod
    ratios = {}
    t0 = time.perf_counter()
    pk = cuda_lod._upload(cuda_lod.packed_host(c), dev)
    t, h = device_wlod._hr2_counts(cuda_lod.decode_2bit(pk, c.nloci), 120)
    counts = (h.T.cpu().numpy().astype(np.int64),
              t.T.cpu().numpy().astype(np.int64))
    del pk, t, h
    say(f"  exact pair counts of bench chromosome 1 to W=120 (plain torch "
        f"on the card) in {time.perf_counter() - t0:.1f}s")
    for W in (60, 120):
        dw = _weighted_1x1(c, centro, W, dev)
        w64, missing = _wlod_f64(c, centro, W, counts, dev)
        live = ~missing
        win = dw.blocks[(0, 0)]
        diff = float((win[:, live].double() - w64[:, live]).abs().max())
        scale = float(dw.tie_scale)
        ratios[f"W={W}"] = diff / (2.0 ** -23 * W * scale)
        say(f"  weighted W={W}: max |f32 - f64| = {diff:.6g} over {c.nind} "
            f"rows x {int(live.sum())} windows; tie_scale {scale:.6g}; "
            f"ratio {ratios[f'W={W}']:.3f} (band {TIE_BAND_FACTOR:g})")
        del dw, win, w64, missing, live
        torch.cuda.empty_cache()
    if max(ratios.values()) > TIE_BAND_FACTOR:
        raise AssertionError(f"weighted tie band exceeded: {ratios}")
    return ratios


def _pair_plain(pk, fcb, L, W):
    """K5's plain version on the card's tensors: the decode and the
    plain counts (what the wrapper runs for CPU tensors)."""
    from garlic_tpu_torch.ops import cuda_lod, device_wlod as dw
    g = cuda_lod.decode_2bit(pk, L)
    if fcb is None:
        return dw._hr2_counts(g, W)
    return dw._r2_counts(g, dw.unpack_first_copy(fcb, L), W)


def library_pairs(g, fc, W):
    """One PyTorch call computing K5's planes (T, X) as one f16 einsum
    (exact for counts below 2048) over the unfolded 0/1 flag planes of the
    int8 genotypes g [n, L] (-9 missing): HR^2 (fc None) the valid and
    homozygous planes, r^2 the valid and the two haplotype planes (h1 =
    a2 | a1 & f, h2 = a2 | a1 & ~f) weighted into (T, X); row 0 holds each
    locus's own count and the columns past L - d are 0.  Returns a
    function of no arguments (the timed call), never called by the
    port."""
    import torch
    valid = g != -9
    if fc is None:
        chans = [valid, valid & (g != 1)]
        mix = torch.eye(2)
    else:
        a1, a2 = g == 1, g == 2
        chans = [valid, a2 | (a1 & fc), a2 | (a1 & ~fc)]
        mix = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 1.0]])
    flags = torch.stack(chans).to(torch.float16)
    mix = mix.to(device=g.device, dtype=torch.float16)
    padded = torch.nn.functional.pad(flags, (0, W - 1))
    return lambda: torch.einsum("kc,cil,cilw->kwl", mix, flags,
                                padded.unfold(2, W, 1))


def library_windows(score, inv_t):
    """One PyTorch call computing K6's window sums (without the MISSING
    mask and the tie scale) as one f32 einsum over the unfolded score
    plane [I, L] and the offset-major 1/LD rows inv_t [W, nwin].  Returns
    a function of no arguments (the timed call), never called by the
    port."""
    import torch
    W = inv_t.shape[0]
    return lambda: torch.einsum("ilw,lw->il", score.unfold(1, W, 1),
                                inv_t.T)


def _weighted_kernels(c, centro, dev):
    """K5 and K6 on bench chromosome 1 against their plain versions at
    W=60 and W=120: K5's HR^2 and r^2 counts equal in store and
    accumulate mode (first-copy bits drawn from a seed: the panel is
    unphased), K6's windows and tie scale bit for bit over the codes and
    table and over the f32 score plane (and the plane's equal to the
    codes'), with the band the route builds from K5's counts; then at
    W=60 the CUDA-event medians of each kernel (one launch, and 10 back
    to back), its bound, its plain version and one PyTorch call, each
    kernel at W=1, then the programs around them and the route's host
    inputs.  Returns ({kernel: max |diff|}, {kernel: the kernels line's
    times: K5 HR^2 in store mode, K6 over the codes})."""
    import torch
    from garlic_tpu_torch.ops import cuda_lod, device_wlod as dw
    card = _card()
    I, L = c.nind, c.nloci
    pk = cuda_lod._upload(cuda_lod.packed_host(c), dev)
    fcb = cuda_lod._upload(dw.pack_first_copy(
        np.random.default_rng(3).random((I, L)) < 0.5), dev)
    hf = dw._hom_freq_from_counts(*dw._hom_counts_chunked(pk, L, I))
    err = dict.fromkeys(WLOD_KERNELS, 0.0)
    kept = None
    for W in (60, 120):
        nwin = L - W + 1
        planes = {}
        for kind, bits in (("hr2", None), ("r2", fcb)):
            t, x = _pair_plain(pk, bits, L, W)
            # store mode (the route's first row chunk) into planes holding
            # anything, then accumulate mode onto planes holding counts
            T = torch.full((W, L), -77, dtype=torch.int32, device=dev)
            X = torch.full_like(T, -77)
            dw.pair_counts(pk, bits, T, X, W, fresh=True)
            T2, X2 = t + 3, x + 3
            dw.pair_counts(pk, bits, T2, X2, W)
            torch.cuda.synchronize()
            same = {"store": torch.equal(T, t) and torch.equal(X, x),
                    "accumulate": torch.equal(T2, 2 * t + 3)
                    and torch.equal(X2, 2 * x + 3)}
            e = float(max((T - t).abs().max(), (X - x).abs().max(),
                          (T2 - 2 * t - 3).abs().max(),
                          (X2 - 2 * x - 3).abs().max()))
            err["pair_counts"] = max(err["pair_counts"], e)
            say(f"  K5 {kind} at {I}x{L}, W={W}: counts equal to the plain "
                f"version's, store mode {same['store']}, accumulate mode "
                f"{same['accumulate']} (max |diff| {e}; sums T "
                f"{int(T.sum())} X {int(X.sum())})")
            if not all(same.values()):
                raise AssertionError(f"K5 {kind} differs from its plain "
                                     f"version at W={W}: {same}")
            planes[kind] = (T, X)
            del t, x, T2, X2
        inv_t = 1.0 / dw._assemble_band(
            dw._pair_band(*planes["hr2"], hf, None, W), W)
        aux = cuda_lod._upload(dw._weighted_aux(c, centro, W, ERROR, MAX_GAP,
                                                MU, M_GEN), dev)
        table, miss = aux[:4], (aux[4, :nwin] != 0).to(torch.uint8)
        score = dw._wlod_score_from_table(cuda_lod.decode_2bit(pk, L), table)
        win, tie = dw.wlod_windows(pk, table, inv_t, miss, W)
        want, wt = dw.wlod_windows_plain(pk, table, inv_t, miss, W)
        pwin, ptie = dw.wlod_windows_terms(score, inv_t, miss, W)
        pwant, pwt = dw.wlod_windows_terms_plain(score, inv_t, miss, W)
        torch.cuda.synchronize()
        checks = {"codes bitwise": _bitwise(win, want),
                  "codes tie": torch.equal(tie, wt),
                  "plane bitwise": _bitwise(pwin, pwant),
                  "plane tie": torch.equal(ptie, pwt),
                  "plane=codes": _bitwise(pwin, win)
                  and torch.equal(ptie, tie)}
        e = float(max((win - want).abs().max(), (pwin - pwant).abs().max(),
                      (tie - wt).abs(), (ptie - pwt).abs()))
        err["wlod_windows"] = max(err["wlod_windows"], e)
        say(f"  K6 at {I}x{L}, W={W}: " + ", ".join(
            f"{k} {v}" for k, v in checks.items())
            + f"; max |diff| {e}; tie scale {float(tie):.9g}; "
            f"{int((win == -9999).sum())} MISSING windows")
        if not all(checks.values()):
            raise AssertionError(f"K6 differs from its plain version or "
                                 f"its twin at W={W}: {checks}")
        if W == 60:
            kept = (planes["hr2"], inv_t, table, miss, score)
        del planes, aux, win, want, pwin, pwant
        torch.cuda.empty_cache()
    (T, X), inv_t, table, miss, score = kept
    W, nwin = 60, L - 59
    Tt, Xt = torch.empty_like(T), torch.empty_like(X)  # the timed launches
    # the yardsticks, one PyTorch call each, never called by the port (see
    # library_pairs and library_windows)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = cuda_lod.decode_2bit(pk, L)
    fc = dw.unpack_first_copy(fcb, L)
    pairs = I * sum(L - d for d in range(1, W))
    int8_ms = 2 * 2 * pairs / INT8_RATE * 1e3  # AND and add per flag
    win_ms = 2 * add_ms(I, L, W, card)         # a product and an add
    codes, inv_b = I * ((L + 3) // 4), 4 * W * nwin
    runs = {  # name: (kernel, plain, library, (bound, by), library label)
        "pair_counts": (
            lambda: dw.pair_counts(pk, None, Tt, Xt, W, fresh=True),
            lambda: _pair_plain(pk, None, L, W),
            library_pairs(g, None, W),
            _bytes_or_ops(codes + 2 * 4 * W * L, int8_ms, card),
            "torch.einsum over the unfolded flags, f16"),
        "pair_counts r2": (
            lambda: dw.pair_counts(pk, fcb, Tt, Xt, W, fresh=True),
            lambda: _pair_plain(pk, fcb, L, W),
            library_pairs(g, fc, W),
            _bytes_or_ops(codes + I * ((L + 7) // 8) + 2 * 4 * W * L,
                          1.5 * int8_ms, card),
            "torch.einsum over the unfolded valid and haplotype channel "
            "planes, f16"),
        "wlod_windows": (
            lambda: dw.wlod_windows(pk, table, inv_t, miss, W),
            lambda: dw.wlod_windows_plain(pk, table, inv_t, miss, W),
            library_windows(score, inv_t),
            _bytes_or_ops(codes + 16 * L + inv_b + nwin + 4 * I * nwin,
                          win_ms, card),
            "torch.einsum over the unfolded score plane, f32"),
        "wlod_windows plane": (
            lambda: dw.wlod_windows_terms(score, inv_t, miss, W),
            lambda: dw.wlod_windows_terms_plain(score, inv_t, miss, W),
            library_windows(score, inv_t),
            _bytes_or_ops(4 * I * L + inv_b + nwin + 4 * I * nwin, win_ms,
                          card),
            "torch.einsum over the unfolded score plane, f32"),
    }
    del g, fc
    times = {}
    for name, (kern, plain, lib, (b, by), what) in runs.items():
        t = {"ms": _median_ms(kern), "plain_ms": _median_ms(plain, n=11),
             "bound_ms": b, "bound_by": by,
             "library_ms": None if lib is None else _median_ms(lib, n=5)}
        back = _median_ms(kern, reps=10)
        torch.cuda.empty_cache()
        if name in WLOD_KERNELS:
            times[name] = t
        libs = ("none" if t["library_ms"] is None
                else f"{t['library_ms']:.4f} ms ({what})")
        say(f"  {name} at the bench shape, W={W}: kernel {t['ms']:.4f} ms, "
            f"bound {b:.4f} ms ({by}), share of bound {b / t['ms']:.1%}, "
            f"plain {t['plain_ms']:.4f} ms, library {libs} (CUDA events "
            "around one call, median of 21; plain 11, library 5); back to "
            f"back {back:.4f} ms, share of bound {b / back:.1%} (CUDA "
            "events around 10 launches, median of 21)")
    del runs, Tt, Xt
    torch.cuda.empty_cache()
    # the part of each kernel that does not grow with W: W=1 (K5 then
    # only writes row 0 of fresh planes; K6 one product a window, 1/LD 1)
    T1 = torch.empty((1, L), dtype=torch.int32, device=dev)
    X1 = torch.empty_like(T1)
    inv1 = torch.ones((1, L), dtype=torch.float32, device=dev)
    miss1 = torch.zeros(L, dtype=torch.uint8, device=dev)
    ones = {"pair_counts": lambda: dw.pair_counts(pk, None, T1, X1, 1,
                                                  fresh=True),
            "pair_counts r2": lambda: dw.pair_counts(pk, fcb, T1, X1, 1,
                                                     fresh=True),
            "wlod_windows": lambda: dw.wlod_windows(pk, table, inv1, miss1,
                                                    1),
            "wlod_windows plane": lambda: dw.wlod_windows_terms(
                score, inv1, miss1, 1)}
    for name, fn in ones.items():
        say(f"  {name} at the bench shape, W=1: kernel "
            f"{_median_ms(fn):.4f} ms (CUDA events around one call, median "
            f"of 21); back to back {_median_ms(fn, reps=10):.4f} ms")
    del T1, X1, inv1, miss1, ones
    torch.cuda.empty_cache()
    # the programs around the kernels, and the whole weighted Phase I
    P = dw._pair_band(T, X, hf, None, W)
    progs = {
        "pair band finalize (_pair_band)": (
            lambda: dw._pair_band(T, X, hf, None, W),
            _bytes_or_ops(2 * 4 * W * L + 4 * L + 4 * W * L, 0.0, card)),
        "band assembly (_assemble_band)": (
            lambda: dw._assemble_band(P, W),
            _bytes_or_ops(4 * W * L + 4 * W * nwin, 0.0, card)),
        "weighted Phase I (ld_band_sharded, wlod_windows_sharded, 1x1)": (
            lambda: _weighted_1x1(c, centro, W, dev),
            _bytes_or_ops(codes + 20 * L + 4 * I * nwin, int8_ms + win_ms,
                          card)),
    }
    for name, (fn, (b, by)) in progs.items():
        t = _median_ms(fn, n=11)
        say(f"  {name} at {I}x{L}, W={W}: {t:.4f} ms, bound {b:.4f} ms "
            f"({by}), share of bound {b / t:.1%} (CUDA events around one "
            "call, median of 11)")
    # the route's host work: the 2-bit codes (packed by each of the two
    # routes) and the per-locus score table and mask
    host = _median_wall_ms(lambda: (
        cuda_lod.packed_host(c), cuda_lod.packed_host(c),
        dw._weighted_aux(c, centro, W, ERROR, MAX_GAP, MU, M_GEN)), 5)
    say(f"  the route's host inputs at {I}x{L}, W={W} (packed_host twice, "
        f"_weighted_aux): {host:.4f} ms (host clock, median of 5)")
    del pk, fcb, hf, T, X, P, inv_t, table, miss, score
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = _weighted_1x1(c, centro, W, dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    say(f"  weighted Phase I device-memory peak at {I}x{L}, W={W}: "
        f"{peak / 1e6:.1f} MB ({peak / (I * L):.2f} bytes per genotype; "
        "torch.cuda.max_memory_allocated)")
    del out
    return err, times


def weighted_args(tfam, wtped, wmap):
    """bench.py's pinned flags with --weighted over the bench map."""
    return ["--tped", wtped, "--tfam", tfam, "--map", wmap,
            "--weighted"] + FLAGS


def weighted_small_runs(small_files, smap, sgq):
    """Phase 6's runs on the small panel: (label, flags, kernels or
    program that must run on every chromosome, kernel that must not)."""
    stped, stfam = small_files
    pinned = ["--tped", stped, "--tfam", stfam, "--map", smap] + FLAGS
    auto = ["--tped", stped, "--tfam", stfam, "--map", smap, "--winsize",
            "60"] + SEARCH_FLAGS
    return (
        ("w_phased", pinned + ["--weighted", "--phased"], WLOD_KERNELS,
         None),
        ("w_ldsub", pinned + ["--weighted", "--ld-subsample", "20",
                              "--tpu-seed", "3"], WLOD_KERNELS, None),
        ("w_tgls", pinned + ["--weighted", "--tgls", sgq, "--gl-type", "GQ"],
         WLOD_KERNELS, None),
        ("w_auto", auto + ["--weighted"], WLOD_KERNELS, None),
        ("w_autowin", pinned + ["--weighted", "--auto-winsize"],
         WLOD_KERNELS, None),
        ("cm", pinned + ["--cm"], "covered", None),
        ("cm_auto", auto + ["--cm"], "covered", "lod_windows"),
    )


def start_exact_runs(exact, tfam, split, runs):
    """Starts the exact engine's weighted runs (phase 6's references):
    the bench panel's as one run per chromosome (split: (TPED, map) of
    each; the pinned run treats its chromosomes apart, so the joined
    outputs are the two-chromosome run's, in half the time) and each of
    the small panel's `runs`."""
    for i, (t, m) in enumerate(split):
        exact.start(weighted_args(tfam, t, m), f"weighted_exact_{i + 1}")
    for label, flags, _, _ in runs:
        exact.start(flags, f"{label}_exact")
    where = (f"on {len(exact.cores)} CPUs of their own" if exact.cores
             else "unpinned")
    say(f"  started {len(exact.procs)} exact weighted runs (subprocesses, "
        f"{where})")


def phase_weighted(mp, nchrom, tfam, wtped, wmap, split, runs, exact):
    """The weighted fast runs on bench.py's panel, K5's and K6's checks
    and times, the programs' times and peak memory, the small panel's
    fast runs and the weighted tie band; then each fast run held to the
    exact run that start_exact_runs started at the beginning."""
    import torch
    say("== phase 6: weighted path (--weighted, --phased, --cm)")
    wargs = weighted_args(tfam, wtped, wmap)
    base = wargs + ["--tpu-panel-cache"]
    mp.run(base + ["--tpu-engine", "fast"], "weighted_fast_cold",
           WLOD_KERNELS, nchrom)
    mp.run(base + ["--tpu-engine", "fast"], "weighted_fast_warm",
           WLOD_KERNELS, nchrom)
    say(f"    tie patrol: "
        f"{profile_counters(mp.stderr['weighted_fast_warm'])[-1]['patrol']}")

    dev = torch.device("cuda")
    c, centro = _weighted_chrom(wtped, wmap)
    err, times = _weighted_kernels(c, centro, dev)
    torch.cuda.empty_cache()
    for label, flags, prog, absent in runs:
        mp.run(flags + ["--tpu-engine", "fast"], f"{label}_fast", prog,
               nchrom, absent=absent)
    ratios = _weighted_tie_band(c, centro, dev)
    del c
    torch.cuda.empty_cache()
    for label, _, _, _ in runs:
        exact.finish(f"{label}_exact", mp)
        mp.same((f"{label}_fast",), f"{label}_exact")
        if label.endswith("auto"):
            mp.same_log((f"{label}_fast",), f"{label}_exact")
            mp.same_kde((f"{label}_fast",), f"{label}_exact", Y_TOL)
    parts = [f"weighted_exact_{i + 1}" for i in range(len(split))]
    for k in parts:
        exact.finish(k, mp)
    mp.join_chroms("weighted_exact", parts)
    mp.same(("weighted_fast_cold", "weighted_fast_warm"), "weighted_exact")
    return ratios, err, times


def _peak(fn):
    """(fn(), the device-memory peak of the call above what was allocated
    before it, in bytes: torch.cuda.max_memory_allocated, reset just
    before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _peak_run(mp, argv, label, kernel, at_least, absent=None, budget=None,
              device=None):
    """mp.run with its device-memory peak (_peak), in bytes.  budget:
    GARLIC_TPU_HBM_BUDGET for this run, which must then say that it
    streamed; without one it must not."""
    if budget is not None:
        os.environ["GARLIC_TPU_HBM_BUDGET"] = budget
    try:
        _, peak = _peak(lambda: mp.run(argv, label, kernel, at_least, absent,
                                       device))
    finally:
        os.environ.pop("GARLIC_TPU_HBM_BUDGET", None)
    streamed = "streaming per chromosome" in mp.stderr[label]
    say(f"    {'streamed' if streamed else 'resident'}; device-memory peak "
        f"{peak / 1e6:.1f} MB")
    if streamed != (budget is not None):
        raise AssertionError(f"{label}: streamed {streamed}, budget {budget}")
    return peak


def _bed_rows(path):
    """(individual, chromosome, start, stop, size class, size) of each call
    of a .roh.bed, in file order."""
    rows, ind = [], None
    for line in _read(path).decode().splitlines():
        if line.startswith("track"):
            ind = re.search(r"Ind: (\S+) Pop", line).group(1)
        else:
            f = line.split("\t")
            rows.append((ind, f[0], int(f[1]), int(f[2]), f[3], int(f[4])))
    return rows


def _api_rows(res):
    """ROHResult.to_rows in _bed_rows' form (the BED writer's chr prefix)."""
    return [(ind, c if c[0] in "cC" else "chr" + c, start, stop, cls,
             int(size)) for ind, c, start, stop, size, cls in res.to_rows()]


def phase_streaming(mp, nchrom, tped, tfam, gq):
    """Streaming Phase I and the programmatic API (see the module
    docstring, phase 7)."""
    import torch
    from garlic_tpu_torch import api
    from tests.util import make_panel, write_tped
    say("== phase 7: streaming Phase I and the programmatic API")
    os.environ.pop("GARLIC_TPU_HBM_BUDGET", None)
    configs = {  # name: (flags, kernel of its route, kernel never run)
        "pinned": (["--tped", tped, "--tfam", tfam, "--tpu-panel-cache"]
                   + FLAGS, "covered", "lod_windows"),
        "auto": (["--tped", os.path.join(WORK, "auto.tped.gz"), "--tfam",
                  tfam] + AUTO_FLAGS, "covered", "lod_windows"),
        "gq": (["--tped", os.path.join(WORK, "bench_gl.tped.gz"), "--tfam",
                tfam, "--tgls", gq, "--gl-type", "GQ", "--tpu-panel-cache"]
               + FLAGS, "covered_terms", "window_sums"),
    }
    peaks, walls = {}, {}
    for name, (argv, kernel, absent) in configs.items():
        labels = []
        # resident, streamed, streamed, resident: warm runs, so the walls
        # of both modes see the same host state on average
        for i, mode in enumerate(("resident", "streamed", "streamed",
                                  "resident")):
            label = f"{name}_{mode}_{i}"
            labels.append(label)
            peaks[label] = _peak_run(
                mp, argv, label, kernel, nchrom, absent,
                STREAM_BUDGET if mode == "streamed" else None)
            if name == "pinned" and i == 0:  # the tie patrol's counts
                say(f"    tie patrol: "
                    f"{profile_counters(mp.stderr[label])[-1]['patrol']}")
            walls[label] = mp.walls[label]
        mp.same(labels[1:], labels[0])
        mp.same_log(labels[1:], labels[0])
        if name == "auto":
            mp.same_kde(labels[1:], labels[0], y_tol=0.0)
        res = max(peaks[k] for k in labels if "resident" in k)
        st = max(peaks[k] for k in labels if "streamed" in k)
        say(f"  {name}: device-memory peak resident {res / 1e6:.1f} MB, "
            f"streamed {st / 1e6:.1f} MB; warm walls resident "
            f"{walls[labels[0]]:.3f} / {walls[labels[3]]:.3f} s, streamed "
            f"{walls[labels[1]]:.3f} / {walls[labels[2]]:.3f} s")
        if not st < res:
            raise AssertionError(f"{name}: the streamed peak {st} is not "
                                 f"below the resident peak {res}")

    # --raw-lod (K1) and GL float-form --raw-lod (K3), streamed against
    # resident, on a panel whose text the writer prints in a few seconds
    panel = make_panel(**RAWLOD_STREAM_PANEL)
    rtped = os.path.join(WORK, "rawst.tped.gz")
    rtfam = os.path.join(WORK, "rawst.tfam")
    write_tped(panel, rtped, rtfam)
    rgl = os.path.join(WORK, "rawst.gl.tgls")
    write_tgls(panel, rgl, GL_TOKENS, seed=8)
    names = [f"chr{c}" for c in panel.chrom_names]
    rbase = ["--tped", rtped, "--tfam", rtfam, "--raw-lod"] + FLAGS
    for tag, extra, kernel in (("rawlod", [], "lod_windows"),
                               ("gl_rawlod", ["--tgls", rgl, "--gl-type",
                                              "GL"], "window_sums")):
        for mode, budget, runs in (("resident", None, nchrom),
                                   ("streamed", STREAM_BUDGET, 2 * nchrom)):
            peaks[f"{tag}_{mode}"] = _peak_run(
                mp, rbase + extra + ["--tpu-engine", "fast"],
                f"{tag}_{mode}", kernel, runs, budget=budget)
        mp.same((f"{tag}_streamed",), f"{tag}_resident")
        for c in names:
            sfx = f".POP1.{c}.raw.lod.windows.gz"
            if _read(mp.out(f"{tag}_streamed") + sfx) != \
                    _read(mp.out(f"{tag}_resident") + sfx):
                raise AssertionError(f"{tag}: streamed raw values differ")
        say(f"  {tag}: raw values byte-identical streamed and resident "
            f"({panel.genotypes[0].shape[0]} x "
            f"{RAWLOD_STREAM_PANEL['nloci_per_chr']})")

    # the API on the bench panel, warm: pinned calls against phase 4's
    # fast BED, the automatic cutoff and bounds beside the CLI's
    t0 = time.perf_counter()
    ds = api.load_panel(tped, tfam, build="hg18", panel_cache=True)
    say(f"  api.load_panel (warm sidecar): {time.perf_counter() - t0:.3f}s")

    def timed(label, **kw):
        def call():
            t0 = time.perf_counter()
            res = api.call_roh(ds, winsize=60, error=ERROR, engine="fast",
                               **kw)
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            return res
        res = mp.counted(call, label, "lod_windows", nchrom,
                         absent="covered")
        say(f"  {label}: wall {walls[label]:.3f}s, cutoff {res.cutoff!r}, "
            f"bounds {[float(b) for b in res.bounds]}, "
            f"{len(res.lengths)} ROH")
        return res

    pinned = timed("api_pinned", cutoff=1.5, bounds=[500000, 1000000])
    want = _bed_rows(mp.out("fast_warm") + ".roh.bed")
    got = _api_rows(pinned)
    if got != want:
        diff = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"api_pinned: {len(got)} rows against the "
                             f"CLI's {len(want)}, {diff} differ")
    say(f"  api_pinned: {len(got)} rows equal to fast_warm's BED rows")
    auto = timed("api_auto")
    cli_cut = mp.logged("auto_exact", r"Selected LOD score cutoff: (.*)")
    cli_bounds = mp.logged("auto_exact", r"boundaries = \((.*)\)")
    say(f"  api_auto: cutoff {auto.cutoff!r} against the CLI's {cli_cut}; "
        f"bounds {[float(b) for b in auto.bounds]} against ({cli_bounds})")
    if not (math.isfinite(auto.cutoff) and len(auto.bounds) == 2
            and auto.bounds[0] < auto.bounds[1]):
        raise AssertionError(f"api_auto: cutoff {auto.cutoff}, bounds "
                             f"{auto.bounds}")
    return peaks, walls


def _mesh_kernels(chrom, centro):
    """Phase 8's kernel checks on bench chromosome 1, W=60: for each mesh,
    K1/K3 per shard against the 1x1 mesh's windows (max |diff| over
    every shard, which must be 0) and K2/K4 per shard against the 1x1
    mesh's planes, with the device-memory peaks of the fused launches.
    Returns {kernel: max |diff|}."""
    import torch
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.ops import cuda_lod
    from garlic_tpu_torch.ops import device_win as dw
    from garlic_tpu_torch.parallel import engine
    from garlic_tpu_torch.parallel.mesh import make_mesh
    W, cut = 60, 1.5
    thr = float(math.ceil(OVERLAP_FRAC * W))
    one_card = make_mesh(1, 1, ["cuda:0"])
    pk = cuda_lod.packed_host(chrom)
    miss = engine._missing(chrom, centro, W, MAX_GAP)
    err = {}
    for use_gl in (False, True):
        split, fused = (("window_sums", "covered_terms") if use_gl
                        else ("lod_windows", "covered"))
        delta = pipeline._tie_band([chrom], W, ERROR, use_gl)
        one = engine.lod_windows_sharded(chrom, centro, W, ERROR, MAX_GAP,
                                         one_card, use_gl).blocks[(0, 0)]
        fc = dw.FusedCov(chrom, centro, W, ERROR, MAX_GAP, one_card, use_gl)
        ref, one_peak = _peak(lambda: engine.covered_sharded(fc, cut, W, thr,
                                                             delta))
        cov, susw, above = (getattr(ref.pieces[0], k)
                            for k in ("cov", "susw", "above"))
        want_rows = dw.covered_fetch(ref)
        for n_dp, n_sp in MESHES:
            mesh = make_mesh(n_dp, n_sp, ["cuda:0"] * (n_dp * n_sp))
            sw = engine.lod_windows_sharded(chrom, centro, W, ERROR, MAX_GAP,
                                            mesh, use_gl)
            e, bits = 0.0, True
            for sh, blk in sw._live():
                want = one[sh.r0:sh.r1, sh.c0:sh.w1]
                bits &= _bitwise(blk, want)
                e = max(e, float((blk - want).abs().max()))
            del sw
            fcm = dw.FusedCov(chrom, centro, W, ERROR, MAX_GAP, mesh, use_gl)
            h, mesh_peak = _peak(lambda: engine.covered_sharded(
                fcm, cut, W, thr, delta))
            planes = True
            for p in h.pieces:
                r = slice(p.r0, p.r0 + p.cov.shape[0])
                c = slice(p.c0, p.c0 + p.cov.shape[1])
                nw = slice(p.c0, p.c0 + p.susw.shape[1])
                planes &= (torch.equal(p.cov, cov[r, c])
                           and torch.equal(p.susw, susw[r, nw])
                           and torch.equal(p.above, above[r, nw])
                           and (p.prev is None
                                or torch.equal(p.prev, cov[r, p.c0 - 1])))
            got_rows = dw.covered_fetch(h)
            rows = (np.array_equal(got_rows[0], want_rows[0])
                    and np.array_equal(got_rows[1], want_rows[1])
                    and all(np.array_equal(a, b) for a, b in
                            zip(got_rows[2], want_rows[2])))
            del h
            sh = engine.shard_blocks(chrom.nind, chrom.nloci, mesh, W)[0]
            _, shard_peak = _peak(lambda: engine.covered_shard(
                fcm, sh, pk, miss, cut, W, thr, delta))
            err[split] = max(err.get(split, 0.0), e)
            say(f"  mesh {n_dp}x{n_sp}, bench chr1 {chrom.nind}x"
                f"{chrom.nloci} W={W}: {split} per shard bitwise "
                f"{bits} (max |diff| {e}); {fused} planes per shard equal "
                f"{planes}, stitched rows equal {rows}; device-memory peak "
                f"of one shard's {fused} launch {shard_peak / 1e6:.1f} MB, "
                f"of the {n_dp * n_sp} shards' {mesh_peak / 1e6:.1f} MB, of "
                f"the 1x1 mesh's launch {one_peak / 1e6:.1f} MB")
            if not (bits and e == 0.0 and planes and rows):
                raise AssertionError(f"mesh {n_dp}x{n_sp}: {split}/{fused} "
                                     "per shard differ from the 1x1 mesh")
        del one, ref, cov, susw, above
        torch.cuda.empty_cache()
    return err


def phase_mesh(mp, nchrom, chrom, centro, configs, peaks):
    """Meshes on the one card (see the module docstring, phase 8).
    configs: name -> (argv, single-device label of phases 4-7, kernel or
    program of its route, .kde written); peaks: phase 7's resident
    peaks."""
    import torch
    say("== phase 8: meshes on the one card (--tpu-mesh, "
        "garlic_tpu_torch/parallel/)")
    t0 = time.perf_counter()
    err = _mesh_kernels(chrom, centro)
    walls, run_peaks = {}, {}
    for name, (argv, ref, kernel, kde) in configs.items():
        for n_dp, n_sp in ((1, 1),) + MESHES:
            k = n_dp * n_sp
            label = f"mesh_{name}_{n_dp}x{n_sp}"
            flags = argv + ["--tpu-engine", "fast"]
            if k > 1:
                flags += ["--tpu-mesh", f"{n_dp}x{n_sp}"]
            run_peaks[label] = _peak_run(mp, flags, label, kernel,
                                         nchrom * k,
                                         device=["cuda:0"] * k)
            walls[label] = mp.walls[label]
            mp.same((label,), ref)
            mp.same_log((label,), ref)
            if kde:
                mp.same_kde((label,), ref, Y_TOL)
        say(f"  {name}: warm walls " + ", ".join(
            f"{lb.rsplit('_', 1)[1]} {walls[lb]:.3f}s"
            for lb in walls if lb.startswith(f"mesh_{name}_"))
            + f" (phases 4-7's single-device run {mp.walls[ref]:.3f}s); "
            "device-memory peaks " + ", ".join(
                f"{lb.rsplit('_', 1)[1]} {run_peaks[lb] / 1e6:.1f} MB"
                for lb in run_peaks if lb.startswith(f"mesh_{name}_"))
            + (f" (phase 7's resident {peaks[name] / 1e6:.1f} MB)"
               if name in peaks else "")
            + "; every shard on the one card, so these walls are no "
            "scaling figures")
    # the API over the same meshes, warm: K1 per shard, the rows of
    # phase 4's fast BED
    from garlic_tpu_torch import api
    from garlic_tpu_torch.parallel.mesh import make_mesh
    argv = configs["pinned"][0]
    ds = api.load_panel(argv[argv.index("--tped") + 1],
                        argv[argv.index("--tfam") + 1], build="hg18",
                        panel_cache=True)
    want = _bed_rows(mp.out("fast_warm") + ".roh.bed")
    for n_dp, n_sp in MESHES:
        label = f"mesh_api_{n_dp}x{n_sp}"
        mesh = make_mesh(n_dp, n_sp, ["cuda:0"] * (n_dp * n_sp))

        def call():
            t1 = time.perf_counter()
            res = api.call_roh(ds, winsize=60, error=ERROR, engine="fast",
                               cutoff=1.5, bounds=[500000, 1000000],
                               mesh=mesh)
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t1
            return res
        got = _api_rows(mp.counted(call, label, "lod_windows",
                                   nchrom * n_dp * n_sp, absent="covered"))
        if got != want:
            raise AssertionError(f"{label}: {len(got)} rows against the "
                                 f"CLI's {len(want)}")
        say(f"  {label}: call_roh(mesh=...) wall {walls[label]:.3f}s, "
            f"{len(got)} rows equal to fast_warm's BED rows")
    n = torch.cuda.device_count()
    if n > 1:
        argv, ref, _, _ = configs["pinned"]
        out = mp.out("mesh_cards_auto")
        r = subprocess.run([sys.executable, "-m", "garlic_tpu_torch"] + argv
                           + ["--tpu-engine", "fast", "--tpu-mesh", "auto",
                              "--out", out], cwd=REPO, capture_output=True)
        if r.returncode != 0:
            raise AssertionError(f"--tpu-mesh auto over {n} cards exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        mp.same(("mesh_cards_auto",), ref)
        say(f"  --tpu-mesh auto over {n} cards (subprocess): BED equal")
    else:
        say("  one card visible: no run over distinct cards happened (the "
            "mesh's peer copies between cards, and any NCCL, untried)")
    say(f"  phase 8: {time.perf_counter() - t0:.1f}s")
    return err


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _two_processes(argv, label):
    """`python -m garlic_tpu_torch argv` as ranks 0 and 1 of a process
    group on this host, both on the card; their stderr goes to files
    under WORK.  Returns (wall seconds until both ended, [stderr text of
    each]); any exit but 0 raises, and a child still running after
    CHILD_TIMEOUT seconds is killed, with its peer."""
    port = _free_port()
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, GARLIC_TPU_COORD=f"127.0.0.1:{port}",
                       GARLIC_TPU_NUM_PROCS="2",
                       GARLIC_TPU_PROC_ID=str(rank))
            err = open(os.path.join(WORK, f"{label}.{rank}.stderr"), "w+")
            logs.append(err)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "garlic_tpu_torch"] + argv, cwd=REPO,
                env=env, stdout=subprocess.DEVNULL, stderr=err))
        rcs = [p.wait(timeout=CHILD_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for err in logs:
        err.seek(0)
        texts.append(err.read())
        err.close()
    if rcs != [0, 0]:
        raise AssertionError(f"{label}: exits {rcs}:\n"
                             + "\n".join(t[-2000:] for t in texts))
    return wall, texts


def _child_profile(text):
    """(launches, device-memory peak in bytes, {tag: (calls, bytes,
    seconds)}, profiled TOTAL seconds) from a child's --tpu-profile
    lines."""
    launches = profile_counters(text)[-1]["launches"]
    peak = int(re.search(r"^\[profile\] device-memory peak (\d+) bytes",
                         text, flags=re.M).group(1))
    ex = {m[0]: (int(m[1]), int(m[2]), float(m[3])) for m in re.findall(
        r"exchange (\S+): (\d+) calls, (\d+) bytes, ([0-9.]+)s", text)}
    return launches, peak, ex, _profile_total(text)


def _profile_total(text):
    """A run's profiled TOTAL seconds (its --tpu-profile line)."""
    return float(re.search(r"^\[profile\]\s+TOTAL\s+([0-9.]+)s", text,
                           flags=re.M).group(1))


def _check_share(text, label, rank):
    """A child's device budget (its --tpu-profile line) must be half the
    card's (0.9 of its memory): two processes drive it."""
    import torch
    m = re.search(r"^\[profile\] device budget (\d+) bytes on (\S+): "
                  r"1/(\d+) of the card's", text, flags=re.M)
    whole = 0.9 * float(torch.cuda.mem_get_info(0)[1])
    say(f"    device budget {int(m.group(1)) / 1e9:.3f} GB on {m.group(2)}: "
        f"1/{m.group(3)} of the card's {whole / 1e9:.3f} GB")
    if int(m.group(3)) != 2 or abs(int(m.group(1)) - whole / 2) > 1:
        raise AssertionError(f"{label}: process {rank}'s budget is not "
                             "half the card's")


def phase_multiprocess(mp, nchrom, configs):
    """Two processes on the one card (see the module docstring, phase
    9).  configs: name -> (flags, single-device run, kernel or program
    of its route, .kde written, mesh spec)."""
    import torch
    from garlic_tpu_torch import entry
    from garlic_tpu_torch.ops import cuda_lod
    say("== phase 9: two processes on the one card (GARLIC_TPU_COORD / "
        "NUM_PROCS / PROC_ID, a gloo process group)")
    t0 = time.perf_counter()
    for name, (argv, ref, kernel, kde, spec) in configs.items():
        label = f"mp_{name}_{spec}"
        wall, texts = _two_processes(
            argv + ["--tpu-engine", "fast", "--tpu-mesh", spec, "--out",
                    mp.out(label)], label)
        mp.walls[label] = wall
        sharded = spec == "2x1"
        for rank, text in enumerate(texts):
            holds = f"sharded input: process {rank} holds individuals"
            if (holds in text) != sharded:
                raise AssertionError(f"{label}: process {rank} sharded "
                                     f"{holds in text}, expected {sharded}")
            launches, peak, ex, total = _child_profile(text)
            say(f"  {label} process {rank}: launches {launches}")
            _check_share(text, label, rank)
            for k in mp.launches:
                mp.launches[k] += launches[k]
            for k in _names(kernel):
                if launches[k] < nchrom:
                    raise AssertionError(f"{label}: process {rank} ran {k} "
                                         f"{launches[k]} times, expected "
                                         f">= {nchrom}")
            one = mp.stderr.get(f"mesh_{name}_{spec}")
            beside = (f" (phase 8's one-process {spec} run "
                      f"{_profile_total(one):.3f}s)" if one else "")
            split = re.findall(r"^\[profile\]\s+(\S+)\s+([0-9.]+)s", text,
                               flags=re.M)
            say("    profile (s): " + ", ".join(f"{k} {v}" for k, v in split))
            say(f"    profiled wall {total:.3f}s{beside}; device-memory "
                f"peak {peak / 1e6:.1f} MB; exchanges: " + "; ".join(
                    f"{tag} {c} calls {b} bytes {sec:.4f}s"
                    for tag, (c, b, sec) in sorted(ex.items())))
        say(f"  {label}: both processes ended after {wall:.3f}s (startup "
            "included)")
        labels = (label, label + ".proc1")
        mp.same(labels, ref)
        mp.same_log(labels, ref)
        if kde:
            mp.same_kde(labels, ref, Y_TOL)
        for sfx in (sorted(glob.glob(mp.out(ref) + ".POP1.*.raw.lod."
                                     "windows.gz"))):
            sfx = sfx[len(mp.out(ref)):]
            for k in labels:
                if _read(mp.out(k) + sfx) != _read(mp.out(ref) + sfx):
                    raise AssertionError(f"{k}{sfx}: raw values differ")
            say(f"  {label}{sfx}: raw values byte-identical to {ref}'s on "
                "both processes")
    fn, args = entry.entry()
    n0 = cuda_lod.LAUNCHES["covered"]
    got = fn(*args)
    torch.cuda.synchronize()
    want = fn(*(a.cpu() for a in args))
    if cuda_lod.LAUNCHES["covered"] != n0 + 1 or not all(
            torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("entry(): K2 differs from its plain version")
    t1 = time.perf_counter()
    entry.dryrun_multichip(4, ["cuda:0"] * 4)
    torch.cuda.synchronize()
    say(f"  entry(): K2 on the card equal to its plain version; "
        f"dryrun_multichip(4) over ['cuda:0'] * 4 in "
        f"{time.perf_counter() - t1:.3f}s")
    say(f"  phase 9: {time.perf_counter() - t0:.1f}s")


def numpy_counts(ind_ids, geno, sites, bed, chrom):
    """count_features_in_roh's table, counted with numpy from the panel:
    for each individual, its homozygous carriers of each site's
    functional allele (code 0 where it is REF, 2 where it is ALT; a
    missing call never), classed by the interval of its .roh.bed rows
    on `chrom` that holds the site (np.searchsorted over the starts; a
    row [start, stop) holds start .. stop - 1), NONE outside them.
    geno: [individuals, loci] codes; sites: tests/vcfutil.write_features'
    (positions, functional allele is ALT, effect, locus index)."""
    pos, is_alt, eff, at = sites
    effects = sorted(set(eff.tolist()))
    classes = ("A", "B", "C", "NONE")
    rows = {}
    for ind, c, start, stop, cls, _ in _bed_rows(bed):
        if c == chrom:
            rows.setdefault(ind, []).append((start, stop - 1,
                                             classes.index(cls)))
    g = geno[:, at]
    carrier = np.where(is_alt, g == 2, g == 0)
    e = np.searchsorted(effects, eff)
    lines = [" ".join(f"{f}{c}" for f in effects for c in classes) + " "]
    for i, ind in enumerate(ind_ids):
        iv = np.array(rows.get(ind, [(-1, -2, 3)]), dtype=np.int64)
        k = np.searchsorted(iv[:, 0], pos, side="right") - 1
        inside = (k >= 0) & (pos <= iv[np.maximum(k, 0), 1])
        cls = np.where(inside, iv[np.maximum(k, 0), 2], 3)
        table = np.zeros((len(effects), len(classes)), dtype=np.int64)
        np.add.at(table, (e[carrier[i]], cls[carrier[i]]), 1)
        lines.append(" ".join([ind] + [str(v) for v in table.reshape(-1)]))
    return "\n".join(lines) + "\n"


def phase_workflow(mp):
    """The workflow a user runs (see the module docstring, phase 10)."""
    from garlic_tpu_torch.tools import count_features_in_roh, vcf2tped
    from tests.util import make_panel
    from tests.vcfutil import write_features, write_vcf
    say("== phase 10: the workflow (a VCF through vcf2tped, python -m "
        "garlic_tpu_torch, count_features_in_roh)")
    t0 = time.perf_counter()

    def step(name, fn):
        t = time.perf_counter()
        out = fn()
        say(f"  {name}: {time.perf_counter() - t:.3f}s")
        return out

    panel = step("make_panel", lambda: make_panel(**WORKFLOW_PANEL))
    if panel.positions[0][-1] > HG18_CHR22_BP:
        raise AssertionError("the workflow panel outgrows hg18 chr22")
    base = os.path.join(WORK, "workflow.chr22")
    vcf, feat = base + ".vcf.gz", os.path.join(WORK, "features.txt")
    alleles = step("write the VCF (phased GT)",
                   lambda: write_vcf(panel, vcf, seed=WORKFLOW_SEED))
    sites = step(f"write {WORKFLOW_SITES} feature sites", lambda:
                 write_features(panel, alleles, feat, WORKFLOW_SITES,
                                WORKFLOW_SEED)["22"])
    if step("vcf2tped", lambda: vcf2tped.main([vcf])) != 0:
        raise AssertionError("vcf2tped failed")
    argv = ["--tped", base + ".tped", "--tfam", base + ".tfam"] + AUTO_FLAGS
    mp.run(argv + ["--tpu-engine", "fast"], "workflow_fast", "covered", 1,
           absent="lod_windows")
    mp.run(argv + ["--tpu-engine", "exact"], "workflow_exact")
    mp.same(("workflow_fast",), "workflow_exact")
    counts = {}
    for label in ("workflow_fast", "workflow_exact"):
        out = mp.out(label) + ".counts"
        rc = step(f"count_features_in_roh over {label}.roh.bed", lambda: (
            count_features_in_roh.main([feat, mp.out(label) + ".roh.bed",
                                        vcf, "22", out])))
        if rc != 0:
            raise AssertionError(f"count_features_in_roh exited {rc}")
        counts[label] = _read(out).decode()
    if counts["workflow_fast"] != counts["workflow_exact"]:
        raise AssertionError("the fast BED's counts differ from the "
                             "exact BED's")
    want = step("the plain numpy count", lambda: numpy_counts(
        panel.ind_ids, panel.genotypes[0], sites,
        mp.out("workflow_exact") + ".roh.bed", "chr22"))
    if counts["workflow_fast"] != want:
        raise AssertionError("count_features_in_roh differs from the "
                             "numpy count")
    lines = counts["workflow_fast"].splitlines()
    total = np.array([[int(v) for v in r.split()[1:]] for r in lines[1:]])
    total = dict(zip(lines[0].split(), total.sum(0).tolist()))
    say(f"  counts equal across the fast and exact BEDs and the numpy "
        f"count ({len(lines) - 1} individuals); summed: {total}")
    say(f"  phase 10: {time.perf_counter() - t0:.1f}s")


def _script(args, label):
    """`python3 args` from the repository root in a subprocess (killed
    after SCRIPT_TIMEOUT seconds); prints its stderr and stdout whole.
    Any exit but 0 raises.  Returns (stdout, stderr)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable] + args, cwd=REPO, text=True,
                       capture_output=True, timeout=SCRIPT_TIMEOUT)
    say(f"  {label}: exit {r.returncode} in {time.perf_counter() - t0:.1f}s")
    for name, text in (("stderr", r.stderr), ("stdout", r.stdout)):
        say(f"  --- {label}, {name}:\n{text.rstrip()}")
    if r.returncode != 0:
        raise AssertionError(f"{label} exited {r.returncode}")
    return r.stdout, r.stderr


def _script_launches(mp, err, prefix, label, least):
    """Adds a script's launches line (`prefix launches {...}` on its
    stderr: its process's counts, from 0) to the main path's and checks
    each kernel of `least` ran at least that many times."""
    m = re.search(rf"^{re.escape(prefix)} launches (\{{.*\}})$", err,
                  flags=re.M)
    if m is None:
        raise AssertionError(f"{label} printed no launches line")
    got = json.loads(m.group(1))
    say(f"    launches: {got}")
    for k in mp.launches:
        mp.launches[k] += got[k]
    for k, n in least.items():
        if got[k] < n:
            raise AssertionError(f"{label}: {k} ran {got[k]} times, "
                                 f"expected >= {n}")


def phase_bench_scripts(mp, tped, tfam, nchrom):
    """The port's benchmark scripts (see the module docstring, phase
    11)."""
    import bench_torch
    say("== phase 11: the benchmark scripts (bench_torch.py, "
        "bench_scaling_torch.py)")
    t0 = time.perf_counter()
    if BENCH_PANEL != dict(nind=bench_torch.NIND,
                           nloci_per_chr=bench_torch.NLOCI, seed=42,
                           spacing_mean=4000):
        raise AssertionError("the smoke's bench panel is not bench_torch's")
    cache = bench_torch.CACHE
    had = set(os.listdir(cache)) if os.path.isdir(cache) else None
    os.makedirs(cache, exist_ok=True)
    tag = f"{bench_torch.NIND}x{sum(bench_torch.NLOCI) // 1000}k"
    try:
        for src, name in ((tped, f"bench_{tag}.tped.gz"),
                          (tfam, f"bench_{tag}.tfam")):
            dst = os.path.join(cache, name)
            if not os.path.exists(dst):
                shutil.copy(src, dst)
                say(f"  copied {os.path.basename(src)} to {dst}")
        out, err = _script(["bench_torch.py"], "bench_torch.py")
        line = json.loads(out.strip().splitlines()[-1])
        if list(line) != BENCH_KEYS or line["metric"] != \
                "lod_windows_per_sec" or not line["value"] > 0:
            raise AssertionError(f"bench_torch.py's last line: {line}")
        _script_launches(mp, err, "bench:", "bench_torch.py", {
            "lod_windows": 6, "covered": bench_torch.RUNS * nchrom})
        nwin, warm = bench_torch.total_windows(), mp.walls["fast_warm"]
        say(f"  bench_torch.py, best of {bench_torch.RUNS}: "
            f"{line['value']:,.1f} windows/s; phase 4's fast_warm, one "
            f"profiled run: {nwin / warm:,.1f} windows/s ({nwin:,} windows"
            f" in {warm:.3f}s); printed, not gated")
        out, err = _script(["bench_scaling_torch.py"],
                           "bench_scaling_torch.py")
        lines = [json.loads(t) for t in out.strip().splitlines()]
        if [d.get("devices") for d in lines] != [1, 2, 4, 8] or any(
                list(d) != SCALING_KEYS or not d["windows_per_sec"] > 0
                for d in lines):
            raise AssertionError(f"bench_scaling_torch.py's lines: {lines}")
        _script_launches(mp, err, "#", "bench_scaling_torch.py",
                         {"lod_windows": 1})
    finally:
        for name in os.listdir(cache):
            if had is None or name not in had:
                path = os.path.join(cache, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        if had is None:
            os.rmdir(cache)
    say(f"  phase 11: {time.perf_counter() - t0:.1f}s")


def kernel_name(symbol):
    """A device kernel's name in phase 12's lines: a hand kernel's
    K-name (K_SYMBOLS), else the function's own name without its scope,
    template and parameters, with the functor of a templated kernel
    (elementwise, reduce) in brackets."""
    for pattern, k in K_SYMBOLS:
        if re.search(pattern, symbol):
            return k
    s = symbol.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", s, maxsplit=1)[0]
    rest = s[len(base):]
    base = base.rsplit("::", 1)[-1]
    fn = re.search(r"\b([A-Za-z_]\w*?(?:Functor\w*|_functor|_kernel_cuda|"
                   r"_kernel_impl|_kernel))\b", rest)
    return f"{base}[{fn.group(1)}]" if fn else base


def _union(spans):
    """The spans (start, end) merged: sorted, disjoint [start, end]s."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _copy_kind(name):
    for tag, kind in (("HtoD", "H2D"), ("DtoH", "D2H"), ("DtoD", "D2D")):
        if tag in name:
            return kind
    return "memcpy"


def _gap_host(host, a, b):
    """(name, share of the gap) of the host operation in the gap [a, b]:
    the innermost (shortest) host event that covers at least half of it,
    else "python" and the share of the gap no host event covers."""
    best = None
    for e in host:
        cover = min(e["ts"] + e["dur"], b) - max(e["ts"], a)
        if cover >= 0.5 * (b - a) and (best is None or e["dur"] < best[1]):
            best = (e["name"], e["dur"], cover)
    if best is not None:
        return best[0], best[2] / (b - a)
    covered = sum(y - x for x, y in _union(
        (max(e["ts"], a), min(e["ts"] + e["dur"], b)) for e in host
        if e["ts"] < b and e["ts"] + e["dur"] > a))
    return "python", 1.0 - covered / (b - a)


def trace_summary(doc, top_ops=TOP_OPS, top_gaps=TOP_GAPS):
    """What phase 12 reads from a run's Chrome trace (`doc`, the parsed
    JSON that runtime.PhaseProfiler writes through torch.profiler); times
    in ms.  The traced window runs from the trace's first event to its
    last garlic::mark:* (the run's last phase mark).  The device is busy
    in the union of its kernels, copies and memsets inside the window;
    the rest of the window is its idle gaps.  The span between two marks
    is the phase the second one names, so each gap names the phases it
    falls in, and the host operation in it (_gap_host).  Returns a dict:
    window, busy (ms) and busy_share, idle_share; kinds, device ms by
    kind (kernels, H2D, D2H, D2D, memcpy, memset); ops, the top_ops
    device operations by total time as (name, count, ms), hand kernels by
    their K-names (kernel_name); hand, K-name -> (count, ms); gaps, the
    top_gaps longest as (ms, phases, host operation, its share); marks,
    the phase names in order; device_events, their count."""
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    marks = sorted((e["ts"], e["name"][len(MARK):]) for e in ev
                   if e["name"].startswith(MARK))
    if not marks:
        raise ValueError(f"the trace holds no {MARK}* event")
    t0, t1 = min(e["ts"] for e in ev), marks[-1][0]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                  for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    edges = [t0] + [x for span in busy for x in span] + [t1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:top_gaps]
    phases = [(s, e, name) for s, (e, name)
              in zip([t0] + [m[0] for m in marks[:-1]], marks)]
    host = [e for e in ev if e.get("cat") not in DEVICE_CATS + (
        "Trace", "gpu_user_annotation", "overhead")
        and not e["name"].startswith(MARK)]
    kinds = dict.fromkeys(("kernels", "H2D", "D2H", "D2D", "memcpy",
                           "memset"), 0.0)
    ops = {}
    for e in dev:
        if e["cat"] == "kernel":
            name, kind = kernel_name(e["name"]), "kernels"
        else:
            name = e["name"]
            kind = "memset" if e["cat"] == "gpu_memset" else \
                _copy_kind(name)
        kinds[kind] += e["dur"] / 1e3
        n_ms = ops.setdefault(name, [0, 0.0])
        n_ms[0] += 1
        n_ms[1] += e["dur"] / 1e3
    window = (t1 - t0) / 1e3
    busy_ms = sum(b - a for a, b in busy) / 1e3
    return {
        "window": window, "busy": busy_ms,
        "busy_share": busy_ms / window if window > 0 else 0.0,
        "idle_share": 1.0 - busy_ms / window if window > 0 else 1.0,
        "kinds": kinds,
        "ops": sorted(((k, n, ms) for k, (n, ms) in ops.items()),
                      key=lambda o: -o[2])[:top_ops],
        "hand": {k: tuple(ops[k]) for k in K_NAMES.values() if k in ops},
        "gaps": [(g / 1e3, "+".join(name for s, e, name in phases
                                    if s < b and e > a),
                  *_gap_host(host, a, b)) for g, a, b in gaps],
        "marks": [name for _, name in marks],
        "device_events": len(dev)}


def traced_child(args):
    """Phase 12's child process (`python3 -c`): args are a JSON file of
    runs and a device.  Each run (name, flags, budget, trace directory,
    output prefix) goes through run_main on the device three times in
    this one process: untraced (warming the process and the run's own
    kernels and files), untraced, then with GARLIC_TPU_TRACE_DIR set;
    under GARLIC_TPU_HBM_BUDGET=budget where one is given; each with
    the launch counters zeroed just before it and its own --out (prefix
    .0, .1, .2).  A line `[traced] <name>` on stderr starts each run's
    stderr; one JSON line a run on stdout gives its name, index, whether
    it was traced, its exit code and its wall (host clock, closed by a
    synchronize).  Returns 0, or 1 once a run exits otherwise."""
    import torch
    from garlic_tpu_torch.ops import cuda_lod, device_wlod
    from garlic_tpu_torch.pipeline import run_main
    with open(args[0]) as f:
        runs = json.load(f)
    device = args[1]
    for run in runs:
        print(f"[traced] {run['name']}", file=sys.stderr, flush=True)
        os.environ.pop("GARLIC_TPU_HBM_BUDGET", None)
        if run["budget"] is not None:
            os.environ["GARLIC_TPU_HBM_BUDGET"] = run["budget"]
        for i in range(3):
            os.environ.pop("GARLIC_TPU_TRACE_DIR", None)
            if i == 2:
                os.environ["GARLIC_TPU_TRACE_DIR"] = run["tdir"]
            for counts in (cuda_lod.LAUNCHES, device_wlod.CALLS):
                for k in counts:
                    counts[k] = 0
            t0 = time.perf_counter()
            rc = run_main(run["argv"] + ["--out", f"{run['out']}.{i}"],
                          prog="garlic_tpu_torch", device=device)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            print(json.dumps({"name": run["name"], "run": i,
                              "traced": i == 2, "rc": rc,
                              "wall": time.perf_counter() - t0}),
                  flush=True)
            if rc != 0:
                return 1
    return 0


def traced_runs(runs, device="cuda:0"):
    """traced_child over `runs` ({name: (flags, budget)}) in one
    subprocess, killed after CHILD_TIMEOUT seconds; each run's trace
    under WORK/trace_<name>/, its outputs WORK/traced_<name>.{0,1,2}.
    Returns {name: (its three JSON lines, its stderr, its trace's
    path)}; any exit but 0 raises, and so does a trace directory that
    does not hold exactly one file."""
    spec = [{"name": name, "argv": argv, "budget": budget,
             "tdir": os.path.join(WORK, f"trace_{name}"),
             "out": os.path.join(WORK, f"traced_{name}")}
            for name, (argv, budget) in runs.items()]
    path = os.path.join(WORK, "traced_runs.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.traced_child(sys.argv[1:]))", path, device],
        cwd=REPO, text=True, capture_output=True, timeout=CHILD_TIMEOUT)
    if r.returncode != 0:
        raise AssertionError(f"the traced runs: exit {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    lines = [json.loads(t) for t in r.stdout.splitlines()
             if t.startswith('{"name"')]
    errs = dict(re.findall(r"^\[traced\] (\S+)\n(.*?)(?=^\[traced\] |\Z)",
                           r.stderr, flags=re.M | re.S))
    out = {}
    for run in spec:
        files = (os.listdir(run["tdir"]) if os.path.isdir(run["tdir"])
                 else [])
        if len(files) != 1:
            raise AssertionError(f"traced {run['name']}: {run['tdir']} "
                                 f"holds {files}, not one trace")
        out[run["name"]] = ([t for t in lines if t["name"] == run["name"]],
                            errs[run["name"]],
                            os.path.join(run["tdir"], files[0]))
    return out


def phase_trace(mp, configs, times):
    """The device trace (see the module docstring, phase 12).  configs:
    phase 8's (flags, single-device run, ...) by name; times: the
    kernels line's times, whose ms is each kernel's CUDA-event median."""
    say("== phase 12: the device trace (--tpu-profile under "
        "GARLIC_TPU_TRACE_DIR, torch.profiler)")
    t0 = time.perf_counter()
    refs = {name: (configs[config][1] if budget is None
                   else f"{config}_streamed_1")
            for name, config, budget in TRACED}
    traced = traced_runs({name: (configs[config][0], budget)
                          for name, config, budget in TRACED})
    say(f"  the five runs, three times each in one subprocess: "
        f"{time.perf_counter() - t0:.1f}s")
    for name, config, budget in TRACED:
        ref = refs[name]
        runs, err, path = traced[name]
        bed = _read(mp.out(ref) + ".roh.bed")
        for i in range(3):
            if _read(os.path.join(WORK, f"traced_{name}.{i}.roh.bed")) \
                    != bed:
                raise AssertionError(f"traced {name}: run {i}'s .roh.bed "
                                     f"differs from {ref}'s")
        streamed = err.count("streaming per chromosome")
        if (budget is not None) != (streamed > 0):
            raise AssertionError(f"traced {name}: streamed {streamed} "
                                 f"times, budget {budget}")
        lines = [c["launches"] for c in profile_counters(err)]
        totals = [float(t) for t in re.findall(
            r"^\[profile\]\s+TOTAL\s+([0-9.]+)s", err, flags=re.M)]
        if len(runs) != 3 or len(lines) != 3 or len(totals) != 3:
            raise AssertionError(f"traced {name}: {len(runs)} runs, "
                                 f"{len(lines)} counters lines, "
                                 f"{len(totals)} TOTAL lines")
        for got in lines:
            for k in mp.launches:
                mp.launches[k] += got[k]
        with open(path) as f:
            doc = json.load(f)
        summ = trace_summary(doc)
        say(f"  {name} ({ref}'s flags): walls untraced {runs[1]['wall']:.3f}"
            f" s, traced {runs[2]['wall']:.3f} s (the profiler's start and "
            f"export included; {ref} in this process: "
            f"{mp.walls[ref]:.3f} s); --tpu-profile TOTAL untraced "
            f"{totals[1]:.3f} s, traced {totals[2]:.3f} s; .roh.bed of all "
            f"three runs byte-identical to {ref}'s")
        say(f"    trace {os.path.relpath(path, REPO)} "
            f"({os.path.getsize(path) / 1e6:.1f} MB, {len(doc['traceEvents'])}"
            f" events, {summ['device_events']} on the device): window "
            f"{summ['window']:.3f} ms, device busy {summ['busy']:.3f} ms = "
            f"{summ['busy_share']:.2%}, idle {summ['idle_share']:.2%}")
        say("    device ms by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in summ["kinds"].items()))
        say("    top device operations (count, total ms): " + "; ".join(
            f"{k} {n} {ms:.3f}" for k, n, ms in summ["ops"]))
        say("    longest idle gaps (ms, phase, host operation and its share"
            " of the gap): " + "; ".join(
                f"{g:.3f} {ph} {op} {share:.0%}"
                for g, ph, op, share in summ["gaps"]))
        if summ["device_events"] == 0:
            raise AssertionError(f"traced {name}: no device event in "
                                 f"{path}")
        phases = [p for p in re.findall(
            r"^\[profile\]\s+(\S+)\s+[0-9.]+s", phase_block(err),
            flags=re.M) if p != "TOTAL"]
        if summ["marks"] != phases:
            raise AssertionError(f"traced {name}: the trace's marks "
                                 f"{summ['marks']} are not the run's "
                                 f"phases {phases}")
        per = []
        for k, kname in K_NAMES.items():
            if not lines[2][k]:
                continue
            if kname not in summ["hand"]:
                raise AssertionError(f"traced {name}: {k} ran "
                                     f"{lines[2][k]} times, but no {kname}"
                                     " kernel is in the trace")
            n, ms = summ["hand"][kname]
            per.append(f"{kname} ({k}) {ms / lines[2][k]:.4f} ms a launch "
                       f"({lines[2][k]} launches, {n} kernels) beside "
                       f"{times[k]['ms']:.4f} ms (CUDA events, phase "
                       f"{TIMED_IN[k]})")
        say("    hand kernels in the trace: " + "; ".join(per))
        say("    trace_summary " + json.dumps(
            {"run": name, **{k: summ[k] for k in (
                "window", "busy", "busy_share", "idle_share", "kinds",
                "ops", "hand", "gaps")}}))
    say(f"  phase 12: {time.perf_counter() - t0:.1f}s")


def main() -> int:
    sys.meta_path.insert(0, _NoJaxPackage())
    all_cores = sorted(os.sched_getaffinity(0))
    own_cores, exact_cores = _split_cores()
    # before torch starts its threads: they inherit this thread's CPUs
    os.sched_setaffinity(0, own_cores)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from tests.util import make_panel
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t_start = last = time.perf_counter()

    def mark(what):
        nonlocal last
        now = time.perf_counter()
        say(f"-- {what}: {now - last:.1f}s (smoke at {now - t_start:.1f}s)")
        last = now

    exact = _ExactRuns(exact_cores)
    try:
        smi = phase_environment()
        say(f"CPUs: this process {len(own_cores)} of {len(all_cores)}, the "
            f"exact runs {len(exact_cores) if exact_cores else 'all'} "
            "(os.sched_setaffinity)")
        t0 = time.perf_counter()
        panel = make_panel(**BENCH_PANEL)
        say(f"bench panel {BENCH_PANEL['nind']} x "
            f"{BENCH_PANEL['nloci_per_chr']} made in "
            f"{time.perf_counter() - t0:.1f}s")
        tped, tfam, wtped, wmap, split = write_bench(panel)
        small, small_files, smap, sgl, sgq = write_small()
        wruns = weighted_small_runs(small_files, smap, sgq)
        start_exact_runs(exact, tfam, split, wruns)
        mark("phase 1 and the inputs")
        chrom = _Chrom("chr1", panel.positions[0], panel.genotypes[0],
                       seed=11)
        centro = _Centro(*HG18_CHR1_CENTROMERE)
        err, times = phase_kernels(chrom, centro)
        times["compact_2bit"] = compact_step()
        times["exact_pool"] = pool_step()
        mark("phase 2")
        phase_tie_band(chrom, centro)
        del chrom
        mark("phase 3")
        mp = _MainPath()
        phase_main_path(panel, mp, tped, tfam, small, small_files, sgl, sgq)
        mark("phase 4")
        nchrom = len(panel.chrom_names)
        aerr, atimes = phase_auto_path(mp, (tped, tfam), small_files, nchrom)
        err.update(aerr)
        times.update(atimes)
        mark("phase 5")
        _, werr, wtimes = phase_weighted(mp, nchrom, tfam, wtped, wmap,
                                         split, wruns, exact)
        err.update(werr)
        times.update(wtimes)
        os.sched_setaffinity(0, all_cores)  # the exact runs have ended
        mark("phase 6")
        gq = os.path.join(WORK, "bench.gq.tgls")
        peaks, _ = phase_streaming(mp, nchrom, tped, tfam, gq)
        mark("phase 7")
        configs = {  # phase 8: name -> (flags, single-device run, kernel,
            #            .kde written)
            "pinned": (["--tped", tped, "--tfam", tfam, "--tpu-panel-cache"]
                       + FLAGS, "fast_warm", "covered", False),
            "auto": (["--tped", os.path.join(WORK, "auto.tped.gz"), "--tfam",
                      tfam] + AUTO_FLAGS, "auto_fast_warm", "covered", True),
            "gq": (["--tped", os.path.join(WORK, "bench_gl.tped.gz"),
                    "--tfam", tfam, "--tgls", gq, "--gl-type", "GQ",
                    "--tpu-panel-cache"] + FLAGS, "tgls_fast_warm",
                   "covered_terms", False),
            "weighted": (weighted_args(tfam, wtped, wmap)
                         + ["--tpu-panel-cache"], "weighted_fast_warm",
                         WLOD_KERNELS, False),
            # float-form TGLS: K3 per shard on the split route
            "gl": (["--tped", small_files[0], "--tfam", small_files[1]]
                   + FLAGS + ["--tgls", sgl, "--gl-type", "GL"], "gl_fast",
                   "window_sums", False),
        }
        chrom = _Chrom("chr1", panel.positions[0], panel.genotypes[0],
                       seed=11)
        mesh_err = phase_mesh(mp, nchrom, chrom, centro, configs,
                              {k: peaks[f"{k}_resident_0"]
                               for k in ("pinned", "auto", "gq")})
        del chrom
        mark("phase 8")
        rawst = os.path.join(WORK, "rawst")
        phase_multiprocess(mp, nchrom, {
            **{k: (*configs[k], "2x1")
               for k in ("pinned", "auto", "gq", "weighted")},
            "gl": (*configs["gl"], "1x2"),
            "rawlod": (["--tped", rawst + ".tped.gz", "--tfam",
                        rawst + ".tfam", "--raw-lod"] + FLAGS,
                       "rawlod_resident", "lod_windows", False, "1x2")})
        mark("phase 9")
        phase_workflow(mp)
        mark("phase 10")
        phase_bench_scripts(mp, tped, tfam, nchrom)
        mark("phase 11")
        phase_trace(mp, configs, times)
        mark("phase 12")
        say(f"  launches over the main path's runs: {mp.launches}")
        say("wall seconds: " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in mp.walls.items()))
        launches = mp.launches
    finally:
        exact.stop()
        shutil.rmtree(WORK, ignore_errors=True)
    say(f"smoke seconds: {time.perf_counter() - t_start:.1f}")
    say(smi)  # the card's name and power limit, again beside the results
    # max |diff| against the plain version (phases 2 and 6) and, for K1/K3's
    # shards, against the single-device launch (phase 8)
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": KERNELS[k], "launches": launches[k],
                "max_abs_err": max(err[k], mesh_err.get(k, 0.0)),
                **times[k]} for k in KERNELS]
    kernels.append({"name": "compact_2bit", "route": "cuda",
                    "source": "garlic_tpu_torch/csrc/compact_2bit.cu",
                    "replaces": "no Pallas kernel: the host pass "
                    "garlic_tpu_torch/native/garlic_native.cpp:217",
                    "launches": launches["compact_2bit"], "max_abs_err": 0.0,
                    **times["compact_2bit"]})
    kernels.append({"name": "exact_pool", "route": "cuda",
                    "source": "garlic_tpu_torch/csrc/exact_pool.cu",
                    "replaces": "no Pallas kernel: the host pass "
                    "garlic_tpu_torch/native/garlic_native.cpp:1433",
                    "launches": launches["exact_pool"], "max_abs_err": 0.0,
                    **times["exact_pool"]})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
