#!/usr/bin/env python
"""Scaling harness of the PyTorch/CUDA port: sharded Phase-I throughput
across mesh sizes.

The counterpart of bench_scaling.py: the same seeded chromosome (64
individuals x 200,000 SNPs, W=60, no centromere), meshes of 1, 2, 4 and
8 devices laid out by factor_devices, 10 timed steps per mesh, and one
JSON line per mesh with bench_scaling.py's keys.  A step is one K1
launch per shard (garlic_tpu_torch.parallel.engine's layout: each shard
its rows and its loci plus the next W-1) and a synchronize, on inputs
built and uploaded once, as bench_scaling.py times only its jitted step
on inputs already placed.  On stderr, beside each mesh's step time: the
time of one whole engine.lod_windows_sharded call, which packs and
uploads the inputs again.  Every mesh's windows must equal the
one-device windows bit for bit, and the whole call's windows the
step's.

By default the meshes run on the card: on distinct CUDA devices where
there are enough, else all on cuda:0, where the shards serialize and
efficiency is not expected to scale.  --cpu runs every shard on the CPU
(the kernels' plain versions).  Without a CUDA device and without --cpu
it exits 1 and prints nothing on stdout.

Run from the repository root:

    python3 bench_scaling_torch.py [--cpu]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from garlic_tpu_torch.centromeres import Centromere
from garlic_tpu_torch.core.types import ChromData
from garlic_tpu_torch.logger import RunLog
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.parallel import engine
from garlic_tpu_torch.parallel.mesh import factor_devices, make_mesh

# bench_scaling.py's shape (:40) and its step's flags (:58, :66)
NIND, NLOCI, WINSIZE = 64, 200_000, 60
ERROR, MAX_GAP = 0.001, 200000
MESH_SIZES = (1, 2, 4, 8)
REPS = 10
# no centromere on the panel: bench_scaling.py's mask (:58-59)
NO_CENTROMERE = (10**12, 10**12 + 1)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_chrom(I: int, L: int) -> ChromData:
    """bench_scaling.py's seeded chromosome (:41-50)."""
    rng = np.random.default_rng(0)
    return ChromData(
        chrom="chr1",
        positions=np.cumsum(rng.integers(500, 3000, L)).astype(np.int64),
        gpos=np.zeros(L), locus_names=[f"r{i}" for i in range(L)],
        alleles=np.array(["A"] * L),
        genotypes=rng.integers(0, 3, (I, L)).astype(np.int8),
        freq=np.clip(rng.beta(1, 1, L), 0.02, 0.98))


def no_centromere(chrom: ChromData) -> Centromere:
    """A centromere table that places chrom's centromere past its last
    locus."""
    centro = Centromere("none", "none", "none", RunLog())
    centro.gaps = {chrom.chrom: NO_CENTROMERE}
    return centro


def mesh_devices(n: int, cpu: bool) -> list:
    """n devices for a mesh: the CPU n times with cpu, else n distinct
    CUDA devices where there are n, else cuda:0 n times."""
    if cpu:
        return ["cpu"] * n
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)]
    return ["cuda:0"] * n


def shard_inputs(chrom: ChromData, centro, mesh, W: int) -> list:
    """[(shard, (packed, table, mask), first locus of its block)] of every
    shard that holds windows: lod_windows_sharded's inputs, built and
    uploaded once."""
    L = chrom.nloci
    miss = engine._missing(chrom, centro, W, MAX_GAP)
    pk = cuda_lod.packed_host(chrom)
    parts = []
    for sh in engine.shard_blocks(chrom.nind, L, mesh, W):
        if sh.nw <= 0:
            continue
        a, b = sh.block(0, W - 1, L)
        blk = engine._Block(chrom, pk, sh.h0, sh.h1, a, b)
        parts.append((sh, engine._shard_inputs(
            blk, W, ERROR, False, miss[a:b - W + 1], sh.device), a))
    return parts


def step(parts: list, W: int) -> list:
    """One K1 launch per shard -> each shard's windows of its own starts."""
    return [cuda_lod.lod_windows(*inp, W)[:, sh.c0 - a:sh.c0 - a + sh.nw]
            for sh, inp, a in parts]


def synchronize(mesh) -> None:
    for d in {torch.device(d) for d in mesh.devices.reshape(-1)}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def stitch(shards, blocks, I: int, nwin: int) -> np.ndarray:
    """The [I, nwin] f32 window matrix of per-shard window blocks."""
    out = np.empty((I, nwin), dtype=np.float32)
    for sh, blk in zip(shards, blocks):
        out[sh.r0:sh.r1, sh.c0:sh.w1] = blk.cpu().numpy()
    return out


def measure(chrom: ChromData, centro, mesh, reps: int = REPS):
    """(seconds a step, the step's windows [I, nwin], seconds of one whole
    lod_windows_sharded call) on `mesh`; raises when the whole call's
    windows differ from the step's."""
    W = WINSIZE
    I, nwin = chrom.nind, chrom.nloci - W + 1
    parts = shard_inputs(chrom, centro, mesh, W)
    # the first launches, untimed; each step's outputs are dropped, so
    # the timed ones reuse their memory
    win = stitch([sh for sh, _, _ in parts], step(parts, W), I, nwin)
    synchronize(mesh)
    t0 = time.perf_counter()
    for _ in range(reps):
        step(parts, W)
    synchronize(mesh)
    dt = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    whole = engine.lod_windows_sharded(chrom, centro, W, ERROR, MAX_GAP, mesh)
    synchronize(mesh)
    whole_dt = time.perf_counter() - t0
    live = list(whole._live())
    got = stitch([sh for sh, _ in live], [b for _, b in live], I, nwin)
    if not np.array_equal(got.view(np.uint32), win.view(np.uint32)):
        raise AssertionError(f"{mesh}: lod_windows_sharded's windows differ "
                             "from the step's")
    return dt, win, whole_dt


def main(argv=None) -> int:
    """One JSON line per mesh size; returns the exit status.

    Adapted from bench_scaling.py:22: the port's engine in place of a
    jitted shard_map step, CUDA devices (or the CPU with --cpu) in place
    of a TPU or a virtual CPU mesh, and each mesh's windows checked."""
    argv = sys.argv[1:] if argv is None else argv
    cpu = "--cpu" in argv
    if not cpu and not torch.cuda.is_available():
        log("# no CUDA device is available; --cpu runs the plain versions "
            "on the CPU")
        return 1
    if cpu:
        log("# CPU: every shard runs the kernels' plain versions on the same"
            " cores, so efficiency is NOT expected to scale")
    elif torch.cuda.device_count() < max(MESH_SIZES):
        log(f"# {torch.cuda.device_count()} CUDA device(s): a mesh larger "
            "than that lies on cuda:0 alone, where its shards serialize, "
            "so efficiency is NOT expected to scale")
    chrom = make_chrom(NIND, NLOCI)
    centro = no_centromere(chrom)
    I, L, W = NIND, NLOCI, WINSIZE
    base = one = None
    for n in MESH_SIZES:
        n_dp, n_sp = factor_devices(n)
        devices = mesh_devices(n, cpu)
        mesh = make_mesh(n_dp, n_sp, devices)
        dt, win, whole_dt = measure(chrom, centro, mesh)
        if one is None:
            one = win
        elif not np.array_equal(win.view(np.uint32), one.view(np.uint32)):
            raise AssertionError(f"mesh {n_dp}x{n_sp}: windows differ from "
                                 "the one-device windows")
        wps = I * (L - W + 1) / dt
        if base is None:
            base = wps
        log(f"# mesh {n_dp}x{n_sp} over {devices}: K1 step "
            f"{dt * 1e3:.4f} ms; one whole lod_windows_sharded call "
            f"{whole_dt * 1e3:.4f} ms (host packing and upload included); "
            "windows bit-equal to one device's")
        print(json.dumps({
            "devices": n, "mesh": f"{n_dp}x{n_sp}",
            "windows_per_sec": round(wps),
            "speedup": round(wps / base, 2),
            "efficiency": round(wps / base / n, 2),
        }), flush=True)
    log(f"# launches {json.dumps(cuda_lod.LAUNCHES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
