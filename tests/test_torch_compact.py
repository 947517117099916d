"""The device route of the 2-bit codes' column compaction
(ops/cuda_lod.packed_device, compact_2bit): where the monomorphic filter
has deferred a chromosome's compaction (io/filters._apply), Phase I
compacts the parent payload on the device in place of the host pass
gt_filter_pack_2bit.

On the CPU the route runs the plain version (compact_2bit_plain); each
case is held byte for byte, the missing tail codes included, to the host
pass (native.filter_pack_2bit_native) over the same rows and kept loci.
The kernel itself is compared with the plain version on the card (the
test marked gpu, skipped here)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from garlic_tpu_torch.core.types import ChromData
from garlic_tpu_torch.io import filters
from garlic_tpu_torch.native import filter_pack_2bit_native
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.parallel import engine
from garlic_tpu_torch.parallel.mesh import make_mesh

# the WGS benchmark's chromosome 1 (roh_bench/configs/kgp3-wgs.json): 108
# individuals, 820,835 loci, Beta(0.5, 0.5) frequencies clipped to
# [0.01, 0.99], a locus monomorphic among its 216 alleles with probability
# p^216 + (1 - p)^216
WGS_CHR1 = dict(nind=108, nloci=820_835, alleles=216)


def packed_chrom(I, L, seed):
    """A packed-only ChromData of I x L random 2-bit codes (code 3 among
    them: missing genotypes), its tail codes missing."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(I, 4 * ((L + 3) // 4)), dtype=np.uint8)
    codes[:, L:] = 3
    q = codes.reshape(I, -1, 4)
    pb = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
    return ChromData(chrom="chr1", positions=np.arange(L, dtype=np.int64),
                     gpos=np.zeros(L), locus_names=[""] * L,
                     alleles=np.full(L, "A"), genotypes=None,
                     freq=np.full(L, 0.5), geno2b=pb, nind=I)


def _drops(L, case):
    """The dropped loci of a case: a bool [L] mask."""
    drop = np.zeros(L, dtype=bool)
    if case == "first_and_last":
        drop[[0, L - 1]] = True
    elif case == "every_phase":  # parent positions of each idx & 3
        drop[[5, 10, 15, 20, 101, 102, 203, 304]] = True
    elif case == "runs":
        for k, at in enumerate(range(7, L - 20, 97)):
            drop[at:at + 1 + k % 9] = True
    elif case == "all_but_one":
        drop[:] = True
        drop[L // 2 + 1] = False
    elif case == "sparse":
        drop[np.random.default_rng(L).random(L) < 0.0175] = True
    elif case == "gap_and_alternate":  # a tile's range wider than the
        # kernel's stage; more runs than a thread keeps
        drop[L // 8:L // 2] = True
        drop[L * 3 // 4:L * 3 // 4 + 600:2] = True
    return drop


def _device(blk):
    """The route's codes of a deferred chromosome or block, on the CPU."""
    assert cuda_lod.deferred(blk)
    return cuda_lod.packed_device(blk, torch.device("cpu")).numpy()


def _host(pb, L, keep):
    return filter_pack_2bit_native(pb, L, keep)[0]


@pytest.mark.parametrize("case,I,L,mesh", [
    ("none", 5, 1001, None),
    ("first_and_last", 6, 1000, None),
    ("every_phase", 3, 997, None),
    ("runs", 7, 2002, None),
    ("all_but_one", 4, 999, None),
    ("sparse", 9, 4001, None),
    ("sparse", 9, 4002, None),
    ("sparse", 9, 4003, None),
    ("first_and_last", 1, 5, None),
    ("gap_and_alternate", 3, 40001, None),
    ("runs", 11, 3003, (2, 2)),
    ("sparse", 10, 5001, (2, 2)),
    ("first_and_last", 7, 2001, (2, 2)),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_device_compaction_is_the_host_pass(case, I, L, mesh):
    """The route's codes (the parent's rows and bytes that cover the kept
    loci, the index rebased to them, the plain compaction) equal the host
    pass's: the whole chromosome on the 1x1 mesh, each shard block (rows
    [r0, r1), loci [a, b) with K2's halos) of a 2x2 mesh; the deferred
    compaction is not fired."""
    c = packed_chrom(I, L, seed=L + I)
    drop = _drops(L, case)
    keep = ~drop
    if case == "none":  # the filter keeps every locus and defers nothing
        assert filters._apply(c, keep) is c and not cuda_lod.deferred(c)
        assert np.array_equal(cuda_lod.packed_device(
            c, torch.device("cpu")).numpy(), c.geno2b)
        return
    fc = filters._apply(c, keep)
    pb, idx = fc.geno2b_parent
    n = fc.nloci
    if mesh is None:
        got = _device(fc)
        assert fc._geno2b is None  # the host pass never ran
        want = _host(pb, L, keep)
        assert got.shape == (I, (n + 3) // 4)
        assert np.array_equal(got, want)
        assert np.array_equal(got, fc.geno2b)  # the thunk's bytes
        return
    W = 40
    m = make_mesh(*mesh, ["cpu"] * 4)
    blocks = [sh for sh in engine.shard_blocks(I, n, m, W) if sh.present]
    assert len(blocks) == 4
    for sh in blocks:
        a, b = sh.block(W, W - 1, n)
        blk = engine._Block(fc, None, sh.h0, sh.h1, a, b)
        k = np.zeros(L, dtype=bool)
        k[idx[a:b]] = True
        got = _device(blk)
        assert got.shape == (sh.rows, (b - a + 3) // 4)
        assert np.array_equal(got, _host(pb[sh.h0:sh.h1], L, k))
    assert fc._geno2b is None


def wgs_chr1_keep(seed):
    """The kept loci of a chromosome shaped as the WGS benchmark's
    chromosome 1 (WGS_CHR1): ~1.75% of the loci dropped."""
    rng = np.random.default_rng(seed)
    p = np.clip(rng.beta(0.5, 0.5, WGS_CHR1["nloci"]), 0.01, 0.99)
    mono = p ** WGS_CHR1["alleles"] + (1 - p) ** WGS_CHR1["alleles"]
    return rng.random(p.size) >= mono


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the WGS benchmark's chromosome-1 shape, and the cases of
# test_device_compaction_is_the_host_pass that make the kernel's paths
# and edges risky: the stage's fallback and the runs past kRuns
# (gap_and_alternate), rows and loci off the block's 16 and 2048, a tail
# word, one kept locus
@pytest.mark.gpu
@pytest.mark.parametrize("case,I,L", [
    ("wgs", WGS_CHR1["nind"], WGS_CHR1["nloci"]),
    ("gap_and_alternate", 37, 40001), ("sparse", 17, 4003),
    ("runs", 33, 3003), ("all_but_one", 5, 999), ("first_and_last", 1, 5),
    ("every_phase", 16, 997)])
def test_kernel_is_the_plain_version_on_card(cuda_device, case, I, L):
    """gt_compact_2bit against compact_2bit_plain on the card, whole and
    by 2x2 shard blocks; both equal the host pass."""
    keep = wgs_chr1_keep(seed=2) if case == "wgs" else ~_drops(L, case)
    fc = filters._apply(packed_chrom(I, L, seed=1), keep)
    pb, idx = fc.geno2b_parent
    before = cuda_lod.LAUNCHES["compact_2bit"]
    got = cuda_lod.packed_device(fc, cuda_device)
    flat = torch.from_numpy(np.ascontiguousarray(pb).reshape(-1)).to(
        cuda_device)
    plain = cuda_lod.compact_2bit_plain(
        flat, pb.shape[1], I, torch.from_numpy(idx.astype(np.int32)).to(
            cuda_device))
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["compact_2bit"] == before + 1
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy(), fc.geno2b)
    n, W = fc.nloci, min(60, fc.nloci // 2 + 1)
    for sh in engine.shard_blocks(I, n, make_mesh(2, 2, [cuda_device] * 4),
                                  W):
        if not sh.present:
            continue
        a, b = sh.block(W, W - 1, n)
        blk = engine._Block(fc, None, sh.h0, sh.h1, a, b)
        k = np.zeros(L, dtype=bool)
        k[idx[a:b]] = True
        assert np.array_equal(cuda_lod.packed_device(blk, cuda_device).cpu()
                              .numpy(), _host(pb[sh.h0:sh.h1], L, k))
