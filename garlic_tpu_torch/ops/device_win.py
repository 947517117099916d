"""Device-resident Phase-I results and the Phase-III coverage transfer.

Counterpart of garlic_tpu/ops/device_win.py over torch tensors.  Window
scores stay on the device; what crosses to the host is one int64 payload
per chromosome holding the coverage run edges and the tie-patrol suspect
windows, from which the host rebuilds the bit-packed coverage matrix
that the native run scan reads.

Every fast run lays its chromosomes on a mesh (parallel/mesh.py; one
device is the 1x1 mesh over it), and two Phase-I routes feed it, each
run per shard (parallel/engine.py):

* split (--raw-lod, runs with a float-matrix TGLS error plane, and the
  programmatic API): K1 (K3 for TGLS) writes each shard's window block
  (DeviceWin: the blocks and the layout); the coverage program below
  counts each shard's windows in plain torch.
* fused (every other run): K2 (K4 for dictionary-form TGLS) computes the
  window sums, cutoff flags, suspect flags and coverage counts in one
  kernel per shard (FusedCov); the window matrix never reaches device
  memory.

Either way the coverage handle holds one _Piece per shard, each on its
device; covered_fetch fetches each piece's edge payload and stitches
them, in locus order, into the packed rows of the whole chromosome.
Across processes (parallel/multihost.py) each process holds the pieces
and window blocks of its own cells: covered_fetch gathers every
process's payloads, so each assembles every row, and the window
accessors gather the blocks they read.

In streaming mode a split chromosome is a LazyWin (a thunk that makes
its DeviceWin) and a fused one a FusedCov with stream set: assembly
makes, fetches and drops them one at a time, so one chromosome's window
blocks or u8 planes are live at once.

The JAX edge extractor's static-shape machinery (tiered caps, the bitmap
fallback, the cumsum/searchsorted compaction) is not carried over:
torch.nonzero sizes its output from the data.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import MISSING
from ..runtime import span, to_device, to_host, waiting
from . import cuda_lod

_warned_full_transfer = False


@dataclass
class DeviceWin:
    """One chromosome's f32 window scores on the devices of a mesh (the
    counterpart of device_win.py:30 in an exactly sized, sharded layout):
    shards, the layout (parallel.engine.shard_blocks); blocks[(d, s)],
    the [rows, nw] windows of shard (d, s)'s rows and own window starts
    on its device, MISSING where the window is masked; blocks holds this
    process's cells (Shard.live), and the accessors gather the others'.
    Accessors present the reference's [nind, nloci] MISSING-tailed view.
    tie_scale: the weighted paths' f32 scalar (max finite |term|) on the
    mesh's first device, which scales the tie band in covered_dispatch.
    group: the mesh's multihost.Group (None: one process)."""
    nind: int
    nloci: int
    nwin: int
    shards: list
    blocks: dict
    tie_scale: torch.Tensor = None
    group: object = None

    @property
    def shape(self):
        return (self.nind, self.nloci)

    def __getitem__(self, idx):
        # row access transfers the full matrix (cached): fine for
        # --raw-lod dumps, a perf bug anywhere hot — warn once
        global _warned_full_transfer
        if not hasattr(self, "_host") and not _warned_full_transfer:
            _warned_full_transfer = True
            print("[garlic-tpu-torch] note: DeviceWin row access transfers "
                  "the full window matrix to host (expected for --raw-lod)",
                  file=sys.stderr)
        return self.to_numpy()[idx]

    def _live(self):
        return [(sh, self.blocks[(sh.d, sh.s)]) for sh in self.shards
                if sh.live]

    def _gather(self, cols, tag: str) -> list:
        """[(shard, host f32 array)] of every cell that holds rows and
        loci, on whichever process, in shard order: the columns
        range(*cols(sh)) of its [rows, nw] block (one allgather of every
        process's slices when the mesh spans processes)."""
        mine = [(sh, to_host(win[:, slice(*cols(sh))]))
                for sh, win in self._live()]
        if self.group is None or self.group.size == 1:
            return mine
        flat = np.concatenate([a.reshape(-1) for _, a in mine]
                              + [np.zeros(0, dtype=np.float32)])
        got = self.group.allgather_varlen(flat, tag)
        out, at = [], [0] * len(got)
        for sh in self.shards:
            if not sh.present:
                continue
            k = len(range(*cols(sh)))
            o = at[sh.owner]
            out.append((sh, got[sh.owner][o:o + sh.rows * k]
                        .reshape(sh.rows, k)))
            at[sh.owner] = o + sh.rows * k
        return out

    def to_numpy(self) -> np.ndarray:
        if not hasattr(self, "_host"):
            host = np.full((self.nind, self.nloci), float(MISSING))
            for sh, win in self._gather(lambda sh: (0, sh.nw), "windows"):
                host[sh.r0:sh.r1, sh.c0:sh.w1] = win
            self._host = host
        return self._host

    def thinned(self, step: int) -> np.ndarray:
        """win[:, ::step] in f64 on the host (see thinned_block)."""
        out = np.empty((self.nind, -(-self.nwin // step)))

        def cols(sh):  # from the shard's first start on the grid
            return (-(-sh.c0 // step) * step - sh.c0, max(sh.nw, 0), step)
        for sh, part in self._gather(cols, "windows"):
            k0 = -(-sh.c0 // step)
            out[sh.r0:sh.r1, k0:k0 + part.shape[1]] = part
        return out

    def _window_cols(self, d: int, lo: int, hi: int, device, tails=None):
        """Windows of starts [lo, hi) of row block d on `device`, copied
        from the shards that own them; tails: {(d, s): (first start,
        host array)} of other processes' cells (coverage's exchange)."""
        held = dict(self._live())
        parts = []
        for sh in self.shards:
            a, b = max(lo, sh.c0), min(hi, sh.w1)
            if sh.d != d or b <= a or not sh.present:
                continue
            if sh.own:
                parts.append(held[sh][:, a - sh.c0:b - sh.c0].to(device))
            else:
                t0, tail = tails[(sh.d, sh.s)]
                parts.append(to_device(torch.from_numpy(
                    np.ascontiguousarray(tail[:, a - t0:b - t0])), device))
        if not parts:
            rows = next(sh.rows for sh in self.shards if sh.d == d)
            return torch.empty((rows, 0), dtype=torch.float32, device=device)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def coverage(self, cutoff: float, threshold: float, tie_delta,
                 winsize: int) -> "Coverage":
        """Enqueue the plain-torch coverage program (see covered_dispatch)
        per shard, over its own window starts with the W windows left of
        them from its left neighbours (the coverage of its first locus
        and of the one before it).  When a row block's cells belong to
        several processes, every cell's last W windows are gathered
        first (the left neighbours of another process's cells).  The
        span `dispatch`."""
        with span("dispatch"):
            tails = None
            if any(len({sh.owner for sh in self.shards
                        if sh.d == d and sh.present}) > 1
                   for d in {sh.d for sh in self.shards}):
                def cols(sh):
                    return (max(0, sh.nw - winsize), max(sh.nw, 0))
                tails = {(sh.d, sh.s): (sh.c0 + cols(sh)[0], win)
                         for sh, win in self._gather(cols, "window-halo")}
            pieces = []
            for sh, _ in self._live():
                lo = max(0, sh.c0 - winsize)
                hi = max(lo, min(sh.c1, self.nwin))
                win = self._window_cols(sh.d, lo, hi, sh.device, tails)
                pieces.append(_coverage(win, lo, sh.c0, sh.n, sh.nw, cutoff,
                                        threshold,
                                        self.tie_band(tie_delta, sh.device),
                                        winsize, sh.r0))
            return Coverage(pieces, self.nind, self.nloci, self.nwin,
                            self.group)

    def tie_band(self, tie_delta, device):
        """The tie band on `device`: tie_delta, times the device scalar
        tie_scale where the windows carry one (weighted paths), with no
        host sync (device_win.py:575-576)."""
        if tie_delta and self.tie_scale is not None:
            return torch.tensor(tie_delta, dtype=torch.float32,
                                device=device) * self.tie_scale.to(device)
        return tie_delta


def is_device_win(obj) -> bool:
    """Copy of garlic_tpu/ops/device_win.py:80."""
    return isinstance(obj, DeviceWin)


class LazyWin:
    """Rematerializable window matrix (streaming mode): holds a thunk
    instead of device memory.  Consumers call make(), extract what they
    need (thinned samples, coverage bits, the --raw-lod rows) and drop
    the DeviceWin, so one chromosome's matrix is live at a time.

    Copy of garlic_tpu/ops/device_win.py:84."""

    __slots__ = ("_fn", "nind", "nloci")

    def __init__(self, fn, nind: int, nloci: int):
        self._fn = fn
        self.nind = nind
        self.nloci = nloci

    def make(self) -> DeviceWin:
        return self._fn()

    @property
    def shape(self):
        return (self.nind, self.nloci)

    def __getitem__(self, idx):
        return self.make().to_numpy()[idx]


def is_lazy_win(obj) -> bool:
    """Copy of garlic_tpu/ops/device_win.py:110."""
    return isinstance(obj, LazyWin)


class FusedCov:
    """Deferred fused Phase-I + coverage dispatch over a mesh: covered
    bits, suspect flags and above flags come straight out of kernel K2
    per shard, or K4 on a dictionary-form TGLS chromosome (use_gl)
    (parallel.engine.covered_sharded).  make() builds the split path's
    DeviceWin where the fused kernel does not apply (float-matrix TGLS).

    handle: a covered_dispatch result enqueued during Phase I (pinned
    runs: the cutoff, threshold and tie band are known there), so the
    kernels run on the devices while the host finishes Phase I.
    stream: streaming mode; assembly dispatches this chromosome only when
    it reaches it, and drops its planes before the next."""

    __slots__ = ("chrom", "centro", "winsize", "error", "max_gap", "mesh",
                 "handle", "use_gl", "stream")

    def __init__(self, chrom, centro, winsize: int, error: float,
                 max_gap: int, mesh, use_gl: bool = False,
                 stream: bool = False):
        self.chrom = chrom
        self.centro = centro
        self.winsize = winsize
        self.error = error
        self.max_gap = max_gap
        self.mesh = mesh
        self.handle = None
        self.use_gl = use_gl
        self.stream = stream

    @property
    def nind(self) -> int:
        return self.chrom.nind_global

    @property
    def nloci(self) -> int:
        return self.chrom.nloci

    @property
    def shape(self):
        return (self.nind, self.nloci)

    def make(self) -> DeviceWin:
        from ..parallel import engine
        return engine.lod_windows_sharded(self.chrom, self.centro,
                                          self.winsize, self.error,
                                          self.max_gap, self.mesh,
                                          self.use_gl)


def thinned_block(dwin: DeviceWin, step: int, ind_idx=None) -> np.ndarray:
    """win[:, ::step] sliced on the device, one device-to-host copy per
    shard, then f64 on the host ([I, ceil(nwin/step)]):
    convertWinData2DoubleData's thinning (src/garlic-data.cpp:2037), so
    only 1/step of the matrix crosses the link.  Counterpart of
    device_win.py:239.  The slice over the nwin window starts keeps the
    values of garlic_tpu's slice over all nloci slots, whose MISSING
    tail the caller drops."""
    out = dwin.thinned(step)
    if ind_idx is not None:
        out = out[ind_idx]
    return out


@dataclass
class _Piece:
    """One shard's coverage planes, on its device: cov [rows, n] over
    loci c0.., susw and above [rows, nw] over window starts c0.., and
    prev [rows], the coverage of locus c0 - 1 (None when c0 = 0), which
    decides whether locus c0 opens or closes a run.  r0: the first row."""
    cov: torch.Tensor
    susw: torch.Tensor
    above: torch.Tensor
    prev: object
    r0: int
    c0: int


@dataclass
class Coverage:
    """A covered_dispatch handle: the pieces of one chromosome
    [nind, nloci] (nwin window starts), one per shard this process owns;
    group: the mesh's multihost.Group (None: one process)."""
    pieces: list
    nind: int
    nloci: int
    nwin: int
    group: object = None


def _coverage(win: torch.Tensor, first: int, c0: int, n: int, nw: int,
              cutoff: float, threshold: float, delta, winsize: int,
              r0: int) -> _Piece:
    """Split-path coverage program (device_win.py:346) in plain torch.
    win: f32 windows of the global starts [first, first + k), k >= 0,
    holding every window that covers loci [c0 - 1, c0 + n) (first <=
    c0 - winsize where c0 > 0); the piece covers loci c0.. (n) and window
    starts c0.. (nw).  MISSING slots score -9999, far from any cutoff
    band; delta 0 flags nothing.  Counts are exact int32 sums."""
    c = torch.tensor(cutoff, dtype=torch.float32, device=win.device)
    d = torch.as_tensor(delta, dtype=torch.float32, device=win.device)
    above = win >= c
    susw = (win - c).abs() < d
    o = c0 - first
    if win.shape[1] == 0:
        cov = torch.zeros((win.shape[0], n), dtype=torch.bool,
                          device=win.device)
        prev = None
    else:
        counts = cuda_lod.window_counts(above, winsize) >= threshold
        cov = counts[:, o:o + n]
        prev = counts[:, o - 1] if c0 > 0 else None
    return _Piece(cov, susw[:, o:o + nw], above[:, o:o + nw], prev, r0, c0)


def _edges_payload(covered: torch.Tensor, susw: torch.Tensor,
                   above: torch.Tensor, prev=None) -> np.ndarray:
    """The edge extractor (device_win.py:391) in plain torch: one int64
    payload, one device-to-host copy:
    [nedge, nsusw, last(I), sus(I), sidx(nsusw), sside(nsusw),
     edges(nedge)].
    edges: sorted flat indices (row-major over [I, L]) of the 0->1 / 1->0
    coverage transitions, against prev [I] left of column 0 (0 when
    None); last: the row's final SNP is covered; sus: the row holds a
    suspect window; sidx/sside: flat indices over [I, nwin] of the
    suspect windows and their f32 side of the cutoff."""
    covered = covered.bool()
    susw = susw.bool()
    I, L = covered.shape
    last = covered[:, -1] if L else torch.zeros(I, dtype=torch.bool,
                                                device=covered.device)
    before = torch.zeros_like(covered)
    before[:, 1:] = covered[:, :-1]
    if prev is not None:
        before[:, 0] = prev.bool()
    with waiting(covered):  # nonzero reads its count from the device
        edges = torch.nonzero((covered != before).reshape(-1)).reshape(-1)
        sidx = torch.nonzero(susw.reshape(-1)).reshape(-1)
    sside = above.reshape(-1)[sidx].to(torch.int64)
    head = torch.tensor([edges.numel(), sidx.numel()], dtype=torch.int64,
                        device=covered.device)
    payload = torch.cat([head, last.to(torch.int64),
                         susw.any(dim=1).to(torch.int64), sidx, sside,
                         edges])
    return to_host(payload)


def covered_dispatch(dwin, cutoff: float, winsize: int, threshold: float,
                     tie_delta: float = 0.0) -> Coverage:
    """Enqueue one chromosome's coverage, each shard's on its device, and
    return a handle for covered_fetch.  A FusedCov launches K2 or K4 per
    shard (or returns the handle pre-enqueued during Phase I, or takes
    the split path where covered_sharded declines); a DeviceWin runs the
    plain-torch coverage program over K1's or K3's window blocks.  Kernel
    launches are asynchronous, so assemble_roh enqueues every resident
    chromosome before the first blocking fetch (streamed ones in turn).

    tie_delta > 0 also flags windows within tie_delta of the cutoff (the
    f32 error band); covered_fetch returns them for the tie patrol.  When
    the DeviceWin carries a tie_scale (weighted paths), tie_delta is a
    factor of that device scalar, multiplied on the device with no host
    sync (device_win.py:575-576)."""
    # coverage counts are exact integers, so `count >= threshold` over
    # f64 equals `count >= ceil(threshold)`, which is f32-exact
    thr = float(math.ceil(threshold))
    if isinstance(dwin, FusedCov):
        if dwin.handle is not None:  # pre-enqueued during Phase I
            return dwin.handle
        from ..parallel import engine
        h = engine.covered_sharded(dwin, cutoff, winsize, thr, tie_delta)
        if h is not None:
            return h
        dwin = dwin.make()
    return dwin.coverage(cutoff, thr, tie_delta, winsize)


def _set_bits(row: np.ndarray, o: int, c: int) -> None:
    """Set little-endian bits [o, c) in a packed u8 row.

    Copy of garlic_tpu/ops/device_win.py:509."""
    if c <= o:
        return
    bo, bc = o >> 3, c >> 3
    if bo == bc:
        row[bo] |= ((0xFF << (o & 7)) & 0xFF) & (0xFF >> (8 - (c & 7)))
        return
    if o & 7:
        row[bo] |= (0xFF << (o & 7)) & 0xFF
        bo += 1
    row[bo:bc] = 0xFF
    if c & 7:
        row[bc] |= 0xFF >> (8 - (c & 7))


def _edges_to_packed(idx: np.ndarray, last: np.ndarray, I: int,
                     outw: int) -> np.ndarray:
    """Reconstruct the bit-packed coverage matrix from run edges.

    idx: sorted flat indices of 0->1/1->0 transitions (row-major over
    [I, outw]); last: [I] bool, True when the row's final SNP is covered
    (closes the trailing run at outw).

    Copy of garlic_tpu/ops/device_win.py:525."""
    row_bytes = (outw + 7) // 8
    out = np.zeros((I, row_bytes), np.uint8)
    rows = idx // outw
    cols = idx % outw
    bounds = np.searchsorted(rows, np.arange(I + 1))
    for i in range(I):
        e = cols[bounds[i]:bounds[i + 1]]
        if last[i]:
            e = np.append(e, outw)
        for k in range(0, e.shape[0] - 1, 2):
            _set_bits(out[i], int(e[k]), int(e[k + 1]))
    return out


def covered_fetch(handle: Coverage):
    """(uint8 [I, ceil(L/8)] little-endian bit-packed coverage, bool [I]
    suspect-row flags, suspect-window detail (rows, wins, f32_above))
    for a covered_dispatch handle (covered_fetch, device_win.py:724).
    Each piece's payload is fetched and its indices moved to the
    chromosome's rows and columns; the pieces of several shards are then
    merged into row-major order.  Across processes every process's
    payloads are gathered first (each behind its piece's r0, c0, rows,
    n, nw and length), so every process gets every row.  The span
    `edges`, its blocking reads the spans `edges/wait`."""
    with span("edges"):
        return _covered_fetch(handle)


def _covered_fetch(handle: Coverage):
    I, L, nwin = handle.nind, handle.nloci, handle.nwin
    got = [(p.r0, p.c0, p.cov.shape[0], p.cov.shape[1], p.susw.shape[1],
            _edges_payload(p.cov, p.susw, p.above, p.prev))
           for p in handle.pieces]
    if handle.group is not None and handle.group.size > 1:
        flat = np.concatenate([np.concatenate([[*g[:5], g[5].size], g[5]])
                               for g in got] + [np.zeros(0, np.int64)])
        got = []
        for buf in handle.group.allgather_varlen(flat.astype(np.int64),
                                                 "edges"):
            o = 0
            while o < buf.size:
                r0, c0, rows, n, nw, k = (int(v) for v in buf[o:o + 6])
                got.append((r0, c0, rows, n, nw, buf[o + 6:o + 6 + k]))
                o += 6 + k
    last = np.zeros(I, dtype=bool)
    sus = np.zeros(I, dtype=bool)
    none = np.zeros(0, dtype=np.int64)  # a chromosome with no piece
    edges, sidx, sside = [none], [none], [none.astype(bool)]
    for r0, c0, rows, n, nw, m in got:
        nw = max(nw, 1)
        nedge, nsusw = int(m[0]), int(m[1])
        o = 2
        if c0 + n == L:
            last[r0:r0 + rows] = m[o:o + rows].astype(bool)
        sus[r0:r0 + rows] |= m[o + rows:o + 2 * rows].astype(bool)
        o += 2 * rows
        s = m[o:o + nsusw]
        sidx.append((r0 + s // nw) * max(nwin, 1) + c0 + s % nw)
        sside.append(m[o + nsusw:o + 2 * nsusw].astype(bool))
        o += 2 * nsusw
        e = m[o:o + nedge]
        edges.append((r0 + e // max(n, 1)) * L + c0 + e % max(n, 1))
    edges, sidx, sside = (np.concatenate(x) for x in (edges, sidx, sside))
    if len(got) > 1:
        edges.sort()
        order = np.argsort(sidx, kind="stable")
        sidx, sside = sidx[order], sside[order]
    susw_detail = (sidx // max(nwin, 1), sidx % max(nwin, 1), sside)
    return _edges_to_packed(edges, last, I, L), sus, susw_detail


def covered_packed(dwin, cutoff: float, winsize: int, threshold: float,
                   tie_delta: float = 0.0):
    """(bit-packed coverage, suspect-row flags, suspect-window detail):
    bit w is set when at least ceil(threshold) cutoff-passing windows
    span SNP w (src/garlic-roh.cpp:446-448)."""
    return covered_fetch(covered_dispatch(dwin, cutoff, winsize, threshold,
                                          tie_delta))
