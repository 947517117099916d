"""Compile-check and multi-device dryrun entry points of the port.

Counterpart of the root __graft_entry__.py (garlic_tpu's):

entry()             -> (fn, example_args): one launch of K2
                       (ops/cuda_lod.covered), the production kernel of
                       every pinned and automatic run: Phase I fused with
                       the coverage count and the tie-band flags;
dryrun_multichip(n) -> an n-device ("dp", "sp") mesh driven through the
                       functions a --tpu-mesh run takes:
                       allele_freq_sharded, lod_windows_sharded (K1 per
                       shard), compute_kde(mesh=...) (the transform's
                       partials added in shard order), the fused route
                       (K2 per shard) and select_size_classes(mesh=...)
                       (the EM's sums added in shard order).

Both run on the CUDA card unless the caller names a CPU device, where the
kernels' wrappers run their plain versions.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): fn(*example_args) launches K2 once over a
    64 x 4096 panel at W=60 (cutoff 1.5, the overlap threshold of
    --overlap-frac 0.25, no tie band) and returns its three u8 planes.
    device: the first CUDA device when None (none raises); "cpu" runs
    K2's plain version.

    Adapted from __graft_entry__.py:18, whose entry() runs the plain
    window scan: K2 in its place."""
    from .ops import cuda_lod
    from .runtime import resolve_devices
    W, I, L = 60, 64, 4096
    dev = resolve_devices(device)[0]
    rng = np.random.default_rng(0)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.01] = -9
    freq = rng.uniform(0.05, 0.95, size=L).astype(np.float32)
    packed = cuda_lod._upload(cuda_lod.pack_codes(geno), dev)
    table = cuda_lod.lod_table_f32(cuda_lod._upload(freq, dev), 0.001)
    miss = torch.zeros(L - W + 1, dtype=torch.uint8, device=dev)
    thr = float(math.ceil(0.25 * W))

    def fwd(packed, table, miss):
        return cuda_lod.covered(packed, table, miss, W, 1.5, thr, 0.0)

    return fwd, (packed, table, miss)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One pass of every sharded phase over an n_devices ("dp", "sp")
    mesh (parallel/mesh.factor_devices' shape: both axes real when
    n_devices allows), on a panel of 4 rows per dp shard and 64 loci per
    sp shard; raises when a result is out of range or the fused route's
    coverage differs from the split route's.  devices: the list the mesh
    is laid over (a device may repeat, as ["cuda:0"] * 4); every visible
    CUDA device when None.

    Adapted from __graft_entry__.py:40: the port's mesh and functions,
    and the fused K2 route beside the split one."""
    from .centromeres import Centromere
    from .core.types import MISSING, ChromData
    from .logger import RunLog
    from .ops import kde as kde_ops
    from .ops.device_win import FusedCov, covered_packed, thinned_block
    from .ops.gmm import select_size_classes
    from .parallel.engine import allele_freq_sharded, lod_windows_sharded
    from .parallel.mesh import factor_devices, make_mesh
    from .runtime import resolve_devices

    devices = resolve_devices(devices)
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    n_dp, n_sp = factor_devices(n_devices)
    mesh = make_mesh(n_dp, n_sp, devices[:n_devices])

    W = 8
    I, L = 4 * n_dp, 64 * n_sp
    rng = np.random.default_rng(1)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.01] = -9
    positions = np.cumsum(rng.integers(500, 3000, size=L)).astype(np.int64)

    # allele frequencies: exact counts summed over dp (and processes)
    freq = allele_freq_sharded(geno, mesh)
    if freq.shape != (L,) or not np.all((freq >= 0) & (freq <= 1)):
        raise AssertionError("allele frequencies out of [0, 1]")

    # Phase I: K1 per shard, halos from the host panel
    chrom = ChromData(
        chrom="chr1", positions=positions, gpos=np.zeros(L),
        locus_names=[f"r{i}" for i in range(L)],
        alleles=np.array(["A"] * L), genotypes=geno,
        freq=np.clip(freq, 0.02, 0.98))
    centro = Centromere("hg18", "none", "none", RunLog())
    dw = lod_windows_sharded(chrom, centro, W, 0.001, 200000, mesh)

    # Phase II: the thinned windows through the sharded Gauss transform
    samples = thinned_block(dw, W).ravel()
    samples = samples[samples != MISSING]
    kr = kde_ops.compute_kde(samples, mesh=mesh)
    if kr.x.shape != (512,) or not np.all(np.isfinite(kr.y)):
        raise AssertionError("the KDE is not finite")

    # Phase III: K2 per shard (the fused route) against the split one
    cut = float(np.median(samples))
    fused, _, _ = covered_packed(FusedCov(chrom, centro, W, 0.001, 200000,
                                          mesh), cut, W, 2.0)
    split, _, _ = covered_packed(dw, cut, W, 2.0)
    if not np.array_equal(fused, split):
        raise AssertionError("the fused and split coverage differ")

    # Phase IV: the sharded GMM-EM over synthetic ROH lengths
    rng2 = np.random.default_rng(2)
    lengths = np.concatenate([
        rng2.normal(5e5, 1e5, 600),
        rng2.normal(1.5e6, 2e5, 300),
        rng2.normal(4e6, 6e5, 120)]).clip(1e4, None)
    bounds, res = select_size_classes(lengths, 3, mesh=mesh)
    if len(bounds) != 2 or not np.isfinite(bounds).all() or \
            not res.converged:
        raise AssertionError("the size classes did not converge")

    host = dw.to_numpy()
    if host.shape != (I, L) or not np.isfinite(host[host != MISSING]).all():
        raise AssertionError("the window matrix is not finite")
