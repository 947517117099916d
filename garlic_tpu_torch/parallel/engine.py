"""Multi-device ROH engine: each phase's shards over a Mesh.

Counterpart of garlic_tpu/parallel/engine.py, whose shard_map programs
become one loop over the mesh's shards in the one process that drives
every device.  Every fast run goes through here: one device is the 1x1
mesh over it, whose one shard is the whole chromosome.  Each shard's
inputs are sliced from the host panel and uploaded to its device (where
the monomorphic filter's column compaction of the 2-bit codes is still
deferred, the shard's rows of the unfiltered codes go up and are
compacted there: cuda_lod.packed_device), its work is enqueued on that
device's current stream, and a reduction adds the shards' partials on
the mesh's first device in shard order, so its result does not depend
on the device count.  Whether shards on
different cards overlap is not measured (only one card has run them,
and the uploads are blocking copies from pageable host memory).

* Phase I, lod_windows_sharded: individuals over dp, loci over sp; a
  shard's inputs are its locus range plus the next winsize-1 loci, taken
  from the host panel (no exchange), and K1 (K3 for TGLS) runs on them.
  Every window is a fresh chain of W f32 adds from 0 in each kernel, so
  a shard's windows are the 1x1 mesh's bit for bit.  The result is a
  DeviceWin: per-shard window blocks and the layout.
* the fused route, covered_sharded: K2 (K4) per shard over its locus
  range with W loci to the left (the coverage of its first locus and of
  the one before it) and W-1 to the right; each shard keeps the covered
  plane of its own loci and the flags of its own window starts.
* Phase II, gauss_transform_sharded: the sources split over every shard,
  the [512] partials of ops/kde.py's transform (K7 per shard) added in
  shard order.
* Phase IV, fit_gmm_sharded: the lengths split over every shard, each
  EM iteration's packed sums (K8 in stats mode per shard, ops/gmm.
  em_stats) added in shard order; one shard of one process runs the
  whole loop as one launch of K8 in fit mode.
* the weighted path, ld_band_sharded + wlod_windows_sharded: int32 pair
  counts (K5 per shard) summed over dp (the band equals the 1x1 band bit
  for bit), the pair band's W-1 right-halo columns copied from the
  neighbour's device, and the wLOD window sums per shard (K6) in the j
  order of ops/device_wlod._wlod_windows_dev, the tie scale a max over
  the shards.

Computed halos (window columns, pair-band columns, the tie scale) are
device-to-device copies; on one card they are copies within it.

Across processes (parallel/multihost.py) each process launches only the
cells of the mesh it owns (Shard.live), over the rows it holds: the
whole panel, or its own dp rows (chrom.row0 onwards) on a per-process
load.  The float partials of Phase II and IV are gathered from every
process and added in shard order on each (so their bits are the one
process's); the LD pair counts and the allele-frequency counts, exact
integers, are summed by all_reduce, and the tie scale is a max.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops import cuda_lod
from ..ops import device_wlod as dw
from ..runtime import span, to_device, to_host
from ..ops.device_win import Coverage, DeviceWin, _Piece
from .mesh import AXIS_DP, AXIS_SP


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def check_halo_fits(L_padded: int, width: int, n_sp: int) -> None:
    """The ppermute halo pulls `width` columns from ONE right neighbor, so
    each sp shard must hold at least that many loci — otherwise x_blk[:, :w]
    silently clamps and the windows straddling two shards go wrong (or the
    trace dies with an opaque shape error).  Raise a clear error instead.

    Copy of garlic_tpu/parallel/engine.py:93."""
    per_shard = L_padded // n_sp
    if width > per_shard:
        raise ValueError(
            f"ERROR: winsize-1 = {width} exceeds the per-shard locus width "
            f"{per_shard} ({L_padded} loci over sp={n_sp}); reduce the sp "
            "axis of --tpu-mesh or the window size.")


def full_window_missing(positions: np.ndarray, winsize: int, max_gap: int,
                        cstart: int, cend: int) -> np.ndarray:
    """[L] bool mask: window-missing per start locus, True past nwin.

    Copy of garlic_tpu/parallel/engine.py:913."""
    from ..ops.lod import window_missing_mask
    L = positions.shape[0]
    nwin = max(L - winsize + 1, 0)
    m = np.ones(L, dtype=bool)
    m[:nwin] = window_missing_mask(positions, winsize, max_gap, cstart, cend)
    return m


@dataclass(frozen=True)
class Shard:
    """Cell (d, s) of the mesh for one chromosome: rows [r0, r1), its own
    loci [c0, c1) and own window starts [c0, w1), on `device`; owner:
    the rank of the process that launches it, own: whether that is this
    process; row0: the first row of the host panel it is sliced from (a
    per-process load holds rows row0..)."""
    d: int
    s: int
    device: torch.device
    r0: int
    r1: int
    c0: int
    c1: int
    w1: int
    owner: int = 0
    own: bool = True
    row0: int = 0

    @property
    def rows(self) -> int:
        return self.r1 - self.r0

    @property
    def n(self) -> int:
        return self.c1 - self.c0

    @property
    def nw(self) -> int:
        return self.w1 - self.c0

    @property
    def present(self) -> bool:
        """The cell holds rows and loci (on whichever process)."""
        return self.rows > 0 and self.n > 0

    @property
    def live(self) -> bool:
        """This process launches the cell, which holds rows and loci."""
        return self.own and self.present

    @property
    def h0(self) -> int:
        """The cell's first row in the host panel."""
        return self.r0 - self.row0

    @property
    def h1(self) -> int:
        return self.r1 - self.row0

    def block(self, left: int, right: int, nloci: int):
        """(a, b): the loci [a, b) of the own range with `left` loci of
        halo on the left and `right` on the right, clamped to the
        chromosome, a rounded down to a multiple of 4 (a whole byte of
        2-bit codes).  The halos each route reads: K1/K3 and the weighted
        scores (0, W-1), K2/K4 (W, W-1)."""
        return (max(0, self.c0 - left) // 4 * 4,
                min(nloci, self.c1 + right))


def shard_blocks(nind: int, nloci: int, mesh, winsize: int,
                 row0: int = 0) -> List[Shard]:
    """Every cell of `mesh` for an [nind, nloci] chromosome, dp-major.
    The layout is garlic_tpu's: each axis is rounded up to a multiple of
    its mesh axis (pad_for_mesh, garlic_tpu/parallel/engine.py:862), so
    each shard's slot is ceil(nind / dp) rows by ceil(nloci / sp) loci;
    nothing is padded, so the last shards of an axis are short, or
    empty.  A mesh with sp > 1 must hold winsize-1 loci per shard
    (check_halo_fits).  row0: the first row of this process's host
    panel, rows row0.. of the nind (0 when it holds them all): the
    extents of pad_local_for_mesh (:886), with no pad rows."""
    n_dp, n_sp = mesh.shape[AXIS_DP], mesh.shape[AXIS_SP]
    per_i, per_l = -(-nind // n_dp), -(-nloci // n_sp)
    if n_sp > 1:
        check_halo_fits(per_l * n_sp, winsize - 1, n_sp)
    nwin = max(nloci - winsize + 1, 0)
    out = []
    for d in range(n_dp):
        r0 = min(d * per_i, nind)
        r1 = min(r0 + per_i, nind)
        for s in range(n_sp):
            c0 = min(s * per_l, nloci)
            c1 = min(c0 + per_l, nloci)
            out.append(Shard(d, s, mesh.devices[d, s], r0, r1, c0, c1,
                             max(c0, min(c1, nwin)), int(mesh.owner[d, s]),
                             mesh.owns(d, s), row0))
    return out


class _Block:
    """Rows [r0, r1) of the host panel and loci [a, b) of a chromosome
    (a a multiple of 4), with what cuda_lod's input builders read of a
    chromosome: the 2-bit codes, freq and the TGLS error plane.  The codes
    are a byte slice of pk, the chromosome's packed codes; where pk is
    None, the chromosome's compaction is still deferred and the block
    holds it so too: the parent payload's rows and its own loci's parent
    positions (geno2b_parent), which cuda_lod.packed_device compacts on
    the shard's device."""

    geno_is_packed_only = True

    def __init__(self, chrom, pk: Optional[np.ndarray], r0: int, r1: int,
                 a: int, b: int):
        self.nind, self.nloci = r1 - r0, b - a
        if pk is None:
            pb, idx = chrom.geno2b_parent
            self._geno2b, self.geno2b_parent = None, (pb[r0:r1], idx[a:b])
        else:
            self._geno2b = pk[r0:r1, a // 4:(b + 3) // 4]
            self.geno2b_parent = None
        self.freq = chrom.freq[a:b]
        self.gl_codes = None if chrom.gl_codes is None \
            else chrom.gl_codes[r0:r1, a:b]
        self.gl_lut = chrom.gl_lut
        self._chrom, self._cut = chrom, (r0, r1, a, b)

    @property
    def geno2b(self) -> Optional[np.ndarray]:
        return self._geno2b

    @property
    def gl(self) -> np.ndarray:
        r0, r1, a, b = self._cut
        return np.asarray(self._chrom.gl)[r0:r1, a:b]


def _host_codes(c) -> Optional[np.ndarray]:
    """c's packed codes on the host (the span `pack`), or None where its
    column compaction is still deferred: each shard's block is then
    compacted on its device (cuda_lod.packed_device)."""
    if cuda_lod.deferred(c):
        return None
    with span("pack"):
        return cuda_lod.packed_host(c)


def _missing(chrom, centro, winsize: int, max_gap: int) -> np.ndarray:
    return full_window_missing(chrom.positions, winsize, max_gap,
                               centro.start(chrom.chrom),
                               centro.end(chrom.chrom))


def _shard_inputs(blk: _Block, winsize: int, error: float, use_gl: bool,
                  miss: np.ndarray, device):
    """One shard's kernel inputs on `device`: K1/K2's (2-bit codes,
    table, mask), or K3/K4's (TGLS term plane, mask) with use_gl; miss:
    the shard's slice of its chromosome's full_window_missing mask."""
    if use_gl:
        return cuda_lod.chrom_gl_inputs(blk, None, winsize, None, device,
                                        miss=miss)
    return cuda_lod.chrom_device_inputs(blk, None, winsize, error, None,
                                        device, miss=miss)


# ---------------------------------------------------------------------------
# Phase I: window matrices and the fused route
# ---------------------------------------------------------------------------

def lod_windows_sharded(chrom, centro, winsize: int, error: float,
                        max_gap: int, mesh, use_gl: bool = False
                        ) -> DeviceWin:
    """Phase-I window scan over a ("dp", "sp") mesh -> DeviceWin.

    Each shard runs K1 over the 2-bit codes, table and mask of its rows
    and of its loci plus the next winsize-1 (K3 over the TGLS term plane
    with use_gl: the error plane sliced like the genotypes), and keeps
    the windows of its own starts.  The mask is the chromosome's
    (full_window_missing), sliced.

    Adapted from garlic_tpu/parallel/engine.py:449 and its step,
    make_sharded_lod_fn (:498): a kernel launch per shard in place of a
    jitted shard_map step and of the XLA window sums, halos from the
    host panel in place of ppermute, and no padding."""
    W = winsize
    I, L = chrom.nind_global, chrom.nloci
    shards = shard_blocks(I, L, mesh, W, chrom.row0)
    with span("inputs"):
        with span("mask"):
            miss = _missing(chrom, centro, W, max_gap)
        pk = _host_codes(chrom)
    blocks = {}
    for sh in shards:
        if not sh.live:
            continue
        if sh.nw <= 0:
            win = torch.empty((sh.rows, 0), dtype=torch.float32,
                              device=sh.device)
        else:
            a, b = sh.block(0, W - 1, L)
            with span("inputs"):
                inp = _shard_inputs(_Block(chrom, pk, sh.h0, sh.h1, a, b),
                                    W, error, use_gl, miss[a:b - W + 1],
                                    sh.device)
            with span("dispatch"):
                win = (cuda_lod.window_sums if use_gl
                       else cuda_lod.lod_windows)(*inp, W)
            win = win[:, sh.c0 - a:sh.c0 - a + sh.nw]
        blocks[(sh.d, sh.s)] = win
    return DeviceWin(nind=I, nloci=L, nwin=max(L - W + 1, 0), shards=shards,
                     blocks=blocks, group=mesh.group)


def covered_sharded(fc, cutoff: float, winsize: int, threshold: float,
                    tie_delta: float) -> Optional[Coverage]:
    """The fused route of a FusedCov over its mesh: K2 (K4 for
    dictionary-form TGLS) per shard over its rows and its loci with W
    loci of halo on the left and W-1 on the right; each piece keeps the
    covered plane of the own loci, the coverage of the locus before them
    and the flags of the own window starts (_dispatch_fused,
    garlic_tpu/ops/device_win.py:599, per shard).  None for float-form
    TGLS: the caller takes the split path, as device_win.py:634-637
    does.  A chromosome shorter than the window has no windows and so
    no piece: nothing is covered."""
    c, W = fc.chrom, winsize
    if fc.use_gl and c.gl_codes is None:
        return None
    I, L = c.nind_global, c.nloci
    nwin = L - W + 1
    group = fc.mesh.group
    if nwin <= 0:
        return Coverage([], I, L, 0, group)
    with span("inputs"):
        with span("mask"):
            miss = _missing(c, fc.centro, W, fc.max_gap)
        pk = _host_codes(c)
    pieces = [covered_shard(fc, sh, pk, miss, cutoff, W, threshold,
                            tie_delta)
              for sh in shard_blocks(I, L, fc.mesh, W, c.row0) if sh.live]
    return Coverage(pieces, I, L, nwin, group)


def covered_shard(fc, sh: Shard, pk: Optional[np.ndarray],
                  miss: np.ndarray, cutoff: float, winsize: int,
                  threshold: float, tie_delta: float) -> _Piece:
    """One shard's K2 (K4) launch of covered_sharded: pk, the
    chromosome's packed codes (None: compacted on the device, _Block),
    miss its full_window_missing mask.  Its steps are the spans `inputs`
    (their upload, or the device compaction's `pack`, within) and
    `dispatch`."""
    W, L = winsize, fc.chrom.nloci
    a, b = sh.block(W, W - 1, L)
    with span("inputs"):
        inp = _shard_inputs(_Block(fc.chrom, pk, sh.h0, sh.h1, a, b), W,
                            fc.error, fc.use_gl, miss[a:b - W + 1],
                            sh.device)
    with span("dispatch"):
        cov, susw, above = (cuda_lod.covered_terms if fc.use_gl
                            else cuda_lod.covered)(*inp, W, cutoff,
                                                   threshold, tie_delta)
    o = sh.c0 - a
    return _Piece(cov[:, o:o + sh.n], susw[:, o:o + sh.nw],
                  above[:, o:o + sh.nw], cov[:, o - 1] if sh.c0 else None,
                  sh.r0, sh.c0)


def shard_holdings(c, winsize: int, planes: bool, mesh) -> dict:
    """Bytes each device holds for chromosome c between its dispatch and
    its fetch, summed over the shards it holds (a device listed twice
    counts both; the cells of other processes are theirs): the fused
    route's three u8 planes over each shard's block (planes: covered
    over its loci, suspect and above over its window starts), else the
    f32 windows of its own starts.  Transient inputs and the coverage
    program's temporaries are not counted: the other half of the budget
    is theirs, as in garlic_tpu's gate."""
    W = winsize
    out = {}
    for sh in shard_blocks(c.nind_global, c.nloci, mesh, W, c.row0):
        if not sh.live:
            continue
        if planes:
            a, b = sh.block(W, W - 1, c.nloci)
            byt = float(sh.rows) * ((b - a) + 2 * max(b - a - W + 1, 1))
        else:
            byt = 4.0 * sh.rows * max(sh.nw, 1)
        out[sh.device] = out.get(sh.device, 0.0) + byt
    return out


# ---------------------------------------------------------------------------
# Phase II and Phase IV reductions
# ---------------------------------------------------------------------------

def _split(n: int, mesh):
    """(device, start, stop, owner) of each shard of n points over every
    device of the mesh, dp-major, empty shards left out; owner: the rank
    of the process that computes it."""
    devs = mesh.devices.reshape(-1)
    owner = mesh.owner.reshape(-1)
    per = -(-n // len(devs))
    return [(dev, k * per, min(n, (k + 1) * per), int(owner[k]))
            for k, dev in enumerate(devs) if k * per < n]


def _gathered(parts: list, owners: list, width: int, mesh, tag: str
              ) -> list:
    """Every shard's [width] f64 partial, in shard order, on the mesh's
    first device: this process's own `parts` (its shards in order) and,
    across processes, every other process's, gathered as host arrays in
    one allgather (owners: each shard's owner rank, so every process
    knows how many partials each sends).  The mesh is laid
    process-major, so the processes' shards in rank order are the
    shards in order."""
    group, device = mesh.group, mesh.first
    if group.size == 1:
        return [p.to(device) for p in parts]
    counts = [owners.count(r) for r in range(group.size)]
    mine = np.zeros((max(counts), width), dtype=np.float64)
    if parts:
        mine[:len(parts)] = to_host(torch.stack(parts))
    return [to_device(torch.from_numpy(row.copy()), device)
            for r, block in enumerate(group.allgather(mine, tag))
            for row in block[:counts[r]]]


def gauss_transform_sharded(sources, targets, h, mesh) -> np.ndarray:
    """sum_j exp(-(x_j - t)^2 / h^2) at each target, as per-shard partial
    transforms (ops/kde.gauss_sums on each shard's device: K7 on a CUDA
    device, its plain version on the CPU) added on the mesh's first
    device in shard order: the Phase-II reduction (across processes,
    every shard's partial added on every process).  Returns the raw
    transform (no 1/n weighting) as [M] float64.

    Adapted from garlic_tpu/parallel/engine.py:250: no 1e30 sentinels
    and no power-of-two bucket, each shard's sources as they are."""
    from ..ops.kde import gauss_sums
    sources = np.asarray(sources)
    n = int(sources.shape[0])
    M = int(np.asarray(targets).shape[0])
    if n == 0:
        return np.zeros(M, dtype=np.float64)
    split = _split(n, mesh)
    parts = [gauss_sums(sources[lo:hi], targets, h, dev)
             for dev, lo, hi, r in split if r == mesh.group.rank]
    acc = None
    for part in _gathered(parts, [r for *_, r in split], M, mesh, "kde"):
        acc = part if acc is None else acc + part
    return to_host(acc)


def fit_gmm_sharded(x, k: int, w0, mu0, var0, mesh, max_iter: int = 1000,
                    precision: float = 1e-5):
    """Phase-IV GMM-EM over the mesh: the lengths split over every shard,
    each f64 iteration's packed sums added on the mesh's first device in
    shard order (ops/gmm.fit_em; across processes, every shard's sums
    gathered each iteration), with fit_gmm's convergence test and
    FloatingPointError on a collapsed component.  One process with one
    shard on a CUDA device (the 1x1 mesh) runs the whole loop as one
    launch of K8 in fit mode; more shards or processes run a host loop
    of K8's stats-mode E-steps (on the CPU, the plain loop).  CUDA runs
    f64, so there is no host-EM fallback.

    Adapted from garlic_tpu/parallel/engine.py:309: a host loop over the
    shards' E-steps in place of a while_loop of psums (the one-shard
    loop in one kernel), and no verbose line (select_size_classes prints
    it)."""
    from ..ops.gmm import fit_em
    x = np.ascontiguousarray(x, dtype=np.float64)
    split = _split(x.shape[0], mesh)
    shards = [to_device(torch.from_numpy(x[lo:hi]), dev)
              for dev, lo, hi, r in split if r == mesh.group.rank]
    owners = [r for *_, r in split]
    return fit_em(shards, k, w0, mu0, var0, mesh.first, max_iter, precision,
                  n=x.shape[0],
                  reduce=lambda parts: _gathered(parts, owners, 3 * k + 1,
                                                 mesh, "em"),
                  processes=mesh.group.size)


# ---------------------------------------------------------------------------
# Allele frequencies across processes
# ---------------------------------------------------------------------------

def _freq_from_counts(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den in f64 where den > 0, else 0 (loadTPEDData's
    nalleles / total, src/garlic-data.cpp:109-160)."""
    num = num.astype(np.float64)
    den = den.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(den > 0, num / den, 0.0)


def allele_freq_counts_sharded(num, den, mesh) -> np.ndarray:
    """Global allele frequencies from each process's partial count
    planes (the [L] '1'-allele and observed-allele counts over the rows
    it parsed, integer-valued f64 from the column-range parser): the
    counts summed exactly over the processes, then one division, so the
    frequencies are the full parse's bit for bit.

    Adapted from garlic_tpu/parallel/engine.py:169: an int64 all_reduce
    over the process group in place of a psum over dp."""
    counts = np.stack([np.asarray(num), np.asarray(den)]).astype(np.int64)
    counts = mesh.group.sum_int(counts, "freq")
    return _freq_from_counts(counts[0], counts[1])


def allele_freq_sharded(geno, mesh) -> np.ndarray:
    """Allele frequencies of an [I, L] int8 genotype panel (-9 missing)
    over the mesh: each shard this process owns counts the '1' alleles
    (g copies of it per genotype g in {0, 1, 2}) and the observed alleles
    (2 per called genotype) of its rows and loci on its device, in int64;
    the counts are summed over dp and over the processes, then divided
    once in f64.  Returns [L] f64.

    Adapted from garlic_tpu/parallel/engine.py:131: exact integer counts
    and an f64 division in place of the f32 psum of _freq_block."""
    geno = np.asarray(geno)
    I, L = geno.shape
    counts = np.zeros((2, L), dtype=np.int64)
    for sh in shard_blocks(I, L, mesh, 1):
        if not sh.live:
            continue
        g = to_device(torch.from_numpy(np.ascontiguousarray(
            geno[sh.r0:sh.r1, sh.c0:sh.c1])), sh.device)
        valid = g >= 0
        counts[0, sh.c0:sh.c1] += to_host(torch.where(
            valid, g, torch.zeros_like(g)).sum(0, dtype=torch.int64))
        counts[1, sh.c0:sh.c1] += 2 * to_host(
            valid.sum(0, dtype=torch.int64))
    counts = mesh.group.sum_int(counts, "freq")
    return _freq_from_counts(counts[0], counts[1])


# ---------------------------------------------------------------------------
# The weighted path
# ---------------------------------------------------------------------------

def _add(acc, part: torch.Tensor, device) -> torch.Tensor:
    """acc + part on `device`, in place; part itself when acc is None."""
    part = part.to(device)
    return part if acc is None else acc.add_(part)


def _column_counts(chrom, pk, col, a: int, b: int, W: int, phased: bool,
                   sub, dev0, mesh):
    """The pair counts (T, X) int32 [W, b-a] of the LD subsample's rows
    and, unphased, the homozygosity counts (tot, hom) int32 [b-a] over
    all rows, of this process's cells of one sp column (`col`, dp
    order), summed on dev0; zeros when it owns none of them.  Row
    chunks are sized by each cell's budget on `mesh`."""
    T = X = tot = hom = None
    for sh in col:  # dp order
        if not sh.live:
            continue
        pkd = cuda_lod._upload(pk[sh.h0:sh.h1, a // 4:(b + 3) // 4],
                               sh.device)
        C = dw._row_chunks(sh.rows, mesh.budget(sh.device), b - a,
                           dw._COUNT_BYTES)
        fc = (np.asarray(chrom.first_copy[sh.h0:sh.h1, a:b], dtype=bool)
              if phased else None)
        pks = pkd
        if sub is not None:  # the subsample's rows of this shard
            rows = sub[(sub >= sh.r0) & (sub < sh.r1)] - sh.r0
            pks = pkd.index_select(0, cuda_lod._upload(rows, sh.device))
            fc = None if fc is None else fc[rows]
        t, x = dw._pair_counts_chunked(pks, fc, b - a, W, C)
        T, X = _add(T, t, dev0), _add(X, x, dev0)
        if not phased:
            t, h = dw._hom_counts_chunked(pkd, b - a, C)
            tot, hom = _add(tot, t, dev0), _add(hom, h, dev0)
    if T is None:
        T = torch.zeros((W, b - a), dtype=torch.int32, device=dev0)
        X = torch.zeros_like(T)
        tot = hom = None if phased else torch.zeros(
            b - a, dtype=torch.int32, device=dev0)
    return T, X, tot, hom


def ld_band_sharded(chrom, winsize: int, phased: bool, sub_idx, mesh
                    ) -> dict:
    """The LD band over the mesh: {(d, s): [nw, W] f32, the band rows of
    shard (d, s)'s own window starts, on its device}, for the cells this
    process owns (calcLDData's per-chromosome step,
    garlic_tpu/ops/device_wlod.py:159): pair counts over the LD
    subsample's rows (all rows when sub_idx is None), HR^2 marginals
    over the full panel (unphased) or r^2 from the first-copy bits and
    the allele frequencies (phased).

    For each sp column, every dp shard uploads the 2-bit codes of its
    rows over the column's loci plus the next W-1 and counts (K5), as
    int32 over row chunks sized by the device budget, its LD-subsample
    rows' pairs (and, unphased, the homozygosity marginals over all its
    rows);
    the counts are summed over dp on the column's first device, and
    across processes by an exact all_reduce, so the pair band of the own
    loci is the 1x1 mesh's bit for bit.  The band assembly reads the
    pair band W-1 loci to the right, copied from the right neighbours'
    devices, and its rows go to every dp shard of the column.  A process
    that owns no cell of a column still makes the column's pair band,
    from the summed counts, on its first device: its left neighbour's
    halo may need it (sp across processes), so the halo is recomputed
    there, never sent.

    Adapted from garlic_tpu/parallel/engine.py:575: int32 counts in
    place of the f32 psum, the column halo from the host panel, and a
    right halo of the pair band in place of the row halos of (S, D)."""
    W = winsize
    I, L = chrom.nind_global, chrom.nloci
    shards = shard_blocks(I, L, mesh, W, chrom.row0)
    n_sp = mesh.shape[AXIS_SP]
    group = mesh.group
    pk = cuda_lod.packed_host(chrom)
    sub = None if sub_idx is None else np.asarray(sub_idx, dtype=np.int64)
    pair, home = {}, {}  # s -> pair band [W, n] of the column's own loci
    for s in range(n_sp):
        col = [sh for sh in shards if sh.s == s]
        head = col[0]
        if head.n <= 0:
            continue
        a, b = head.block(0, W - 1, L)
        mine = [sh for sh in col if sh.own]
        dev0 = home[s] = mine[0].device if mine else mesh.first
        T, X, tot, hom = _column_counts(chrom, pk, col, a, b, W, phased,
                                        sub, dev0, mesh)
        if group.size > 1:  # exact int32 sums over the processes
            T, X = (to_device(torch.from_numpy(group.sum_int(
                to_host(t), "ld-pairs")), dev0) for t in (T, X))
            if not phased:
                th = group.sum_int(to_host(torch.stack([tot, hom])),
                                   "ld-hom")
                tot, hom = (to_device(torch.from_numpy(v.copy()), dev0)
                            for v in th)
        hf = freq = None
        if phased:
            freq = cuda_lod._upload(
                np.asarray(chrom.freq[a:b], dtype=np.float32), dev0)
        else:
            hf = dw._hom_freq_from_counts(tot, hom)
        P = dw._pair_band(T, X, hf, freq, W)
        pair[s] = P[:, head.c0 - a:head.c0 - a + head.n]
    bands = {}
    for s in pair:
        head = shards[s]
        cells = [sh for sh in shards if sh.s == s and sh.own]
        if not cells:
            continue
        dev0 = home[s]
        if head.nw <= 0:
            band = torch.empty((0, W), dtype=torch.float32, device=dev0)
        else:
            stop = min(L, head.c1 + W - 1)
            parts = [pair[s]]
            for s2 in range(s + 1, n_sp):  # the right halo
                nb = shards[s2]
                if s2 in pair and stop > nb.c0:
                    parts.append(pair[s2][:, :stop - nb.c0].to(dev0))
            P = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            band = dw._assemble_band(P, W)[:, :head.nw].T
        for sh in cells:
            bands[(sh.d, s)] = band.to(sh.device)
    return bands


def wlod_windows_sharded(chrom, centro, bands: dict, winsize: int, error,
                         max_gap: int, use_gl: bool, mu: float, M: int,
                         mesh) -> DeviceWin:
    """Weighted Phase I over the mesh, given ld_band_sharded's bands ->
    DeviceWin with its tie_scale (calcwLOD, src/garlic-roh.cpp:144-277;
    garlic_tpu/ops/device_wlod.py:613, :698, :729).

    Each shard sums its own window starts, win[:, l] = sum_j
    score[:, l+j] * (1 / LD[l][j]), one product then one add per j, left
    to right from 0 (K6, ops/device_wlod.wlod_windows and
    wlod_windows_terms), over the scores of its rows and of its loci plus
    the next W-1: gathered from the 2-bit codes through the per-class
    table (scalar error, in row chunks sized by the device budget) or
    read from the host's f64 TGLS score plane shipped as f32.  The tie
    scale is the max over the shards (a pmax), and over the processes.

    Adapted from garlic_tpu/parallel/engine.py:769: the score halo from
    the host panel in place of ppermute, no padding."""
    from ..ops.lod import window_missing_mask
    from ..ops.wlod import wlod_scores
    W = winsize
    I, L = chrom.nind_global, chrom.nloci
    shards = shard_blocks(I, L, mesh, W, chrom.row0)
    nwin = max(L - W + 1, 0)
    pk = cuda_lod.packed_host(chrom)
    if use_gl:
        score = wlod_scores(chrom, None, True, mu, M).astype(np.float32)
        miss = window_missing_mask(chrom.positions, W, max_gap,
                                   centro.start(chrom.chrom),
                                   centro.end(chrom.chrom)).astype(np.uint8)
    elif nwin > 0:
        aux = dw._weighted_aux(chrom, centro, W, error, max_gap, mu, M)
    blocks, scales = {}, []
    for sh in shards:
        if not sh.live:
            continue
        dev = sh.device
        win = torch.empty((sh.rows, max(sh.nw, 0)), dtype=torch.float32,
                          device=dev)
        if sh.nw > 0:
            a, b = sh.block(0, W - 1, L)
            # offset-major [W, nw]: the band's transpose is its assembled
            # rows, so the reciprocal comes out contiguous
            inv_t = (1.0 / bands[(sh.d, sh.s)].T).contiguous()
            if use_gl:
                sc = cuda_lod._upload(score[sh.h0:sh.h1, sh.c0:b], dev)
                _, t = dw.wlod_windows_terms(
                    sc, inv_t, cuda_lod._upload(miss[sh.c0:sh.w1], dev), W,
                    out=win)
                scales.append(t.to(mesh.first))
            else:
                o = sh.c0 - a
                pkb = cuda_lod._upload(pk[sh.h0:sh.h1, a // 4:(b + 3) // 4],
                                       dev)
                ax = cuda_lod._upload(aux[:, a:b], dev)
                ms = (ax[4, o:o + sh.nw] != 0).to(torch.uint8)
                C = dw._row_chunks(sh.rows, mesh.budget(dev), b - a,
                                   dw._WINDOW_BYTES)
                for r in range(0, sh.rows, C):
                    _, t = dw.wlod_windows(pkb[r:r + C], ax[:4], inv_t, ms,
                                           W, col0=o, out=win[r:r + C])
                    scales.append(t.to(mesh.first))
        blocks[(sh.d, sh.s)] = win
    tie_scale = torch.stack(scales).amax() if scales else None
    if mesh.group.size > 1:  # the max over the processes' scales
        t = np.array([-np.inf if tie_scale is None else
                      float(tie_scale)], dtype=np.float32)
        t = float(mesh.group.max(t, "tie-scale")[0])
        tie_scale = None if t == -np.inf else torch.tensor(
            t, dtype=torch.float32, device=mesh.first)
    return DeviceWin(nind=I, nloci=L, nwin=nwin, shards=shards,
                     blocks=blocks, tie_scale=tie_scale, group=mesh.group)
