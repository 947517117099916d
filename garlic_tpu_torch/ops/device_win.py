"""Device-resident Phase-I results and the Phase-III coverage transfer.

Counterpart of garlic_tpu/ops/device_win.py over torch tensors.  Window
scores stay on the device; what crosses to the host is one int64 payload
per chromosome holding the coverage run edges and the tie-patrol suspect
windows, from which the host rebuilds the bit-packed coverage matrix
that the native run scan reads.

Two Phase-I routes feed it:

* split (--raw-lod, runs with a float-matrix TGLS error plane, and the
  programmatic API): K1 (K3 for TGLS) writes the window matrix
  (DeviceWin); the coverage program below counts it in plain torch.
* fused (every other run): K2 (K4 for dictionary-form TGLS) computes the
  window sums, cutoff flags, suspect flags and coverage counts in one
  kernel (FusedCov); the window matrix never reaches device memory.

In streaming mode a split chromosome is a LazyWin (a thunk that makes
its DeviceWin) and a fused one a FusedCov with stream set: assembly
makes, fetches and drops them one at a time, so one chromosome's window
matrix or u8 planes is live at once.

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
from . import cuda_lod

_warned_full_transfer = False


@dataclass
class DeviceWin:
    """One chromosome's f32 window scores on the device: win [I, nwin]
    window-start columns, MISSING where the window is masked (the
    counterpart of device_win.py:30 in its exactly sized layout).
    Accessors present the reference's [nind, nloci] MISSING-tailed
    view.  tie_scale: the weighted paths' f32 device scalar (max finite
    |term|), which scales the tie band in covered_dispatch."""
    win: torch.Tensor
    nind: int
    nloci: int
    nwin: int
    tie_scale: torch.Tensor = None

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

    def to_numpy(self) -> np.ndarray:
        if not hasattr(self, "_host"):
            host = np.full((self.nind, self.nloci), float(MISSING))
            host[:, :self.nwin] = self.win.cpu().numpy()
            self._host = host
        return self._host


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
    """Deferred fused Phase-I + coverage dispatch: covered bits, suspect
    flags and above flags come straight out of kernel K2, or K4 on a
    dictionary-form TGLS chromosome (use_gl).  make() builds the split
    path's DeviceWin where the fused kernel does not apply (float-matrix
    TGLS).

    handle: a covered_dispatch result enqueued during Phase I (pinned
    runs: the cutoff, threshold and tie band are known there), so the
    kernel runs on the device while the host finishes Phase I.
    stream: streaming mode; assembly dispatches this chromosome only when
    it reaches it, and drops its planes before the next."""

    __slots__ = ("chrom", "centro", "winsize", "error", "max_gap",
                 "device", "handle", "use_gl", "stream")

    def __init__(self, chrom, centro, winsize: int, error: float,
                 max_gap: int, device, use_gl: bool = False,
                 stream: bool = False):
        self.chrom = chrom
        self.centro = centro
        self.winsize = winsize
        self.error = error
        self.max_gap = max_gap
        self.device = device
        self.handle = None
        self.use_gl = use_gl
        self.stream = stream

    @property
    def nind(self) -> int:
        return self.chrom.nind

    @property
    def nloci(self) -> int:
        return self.chrom.nloci

    @property
    def shape(self):
        return (self.nind, self.nloci)

    def make(self) -> DeviceWin:
        return lod_windows_device(self.chrom, self.centro, self.winsize,
                                  self.error, self.max_gap, self.device,
                                  self.use_gl)


def lod_windows_device(chrom, centro, winsize: int, error: float,
                       max_gap: int, device, use_gl: bool = False
                       ) -> DeviceWin:
    """Split Phase I with no host transfer of the result
    (device_win.py:162-233): K3 over the TGLS term plane (use_gl, both
    error-plane forms, :180-195), else K1."""
    I, L = chrom.nind, chrom.nloci
    nwin = max(L - winsize + 1, 0)
    if nwin == 0:
        win = torch.empty((I, 0), dtype=torch.float32, device=device)
        return DeviceWin(win=win, nind=I, nloci=L, nwin=0)
    if use_gl:
        win = cuda_lod.window_sums_gl_raw(chrom, centro, winsize, max_gap,
                                          device)
    else:
        win = cuda_lod.lod_windows_packed_raw(chrom, centro, winsize, error,
                                              max_gap, device)
    return DeviceWin(win=win, nind=I, nloci=L, nwin=nwin)


def thinned_block(dwin: DeviceWin, step: int, ind_idx=None) -> np.ndarray:
    """win[:, ::step] sliced on the device, one device-to-host copy, then
    f64 on the host ([I, ceil(nwin/step)]): convertWinData2DoubleData's
    thinning (src/garlic-data.cpp:2037), so only 1/step of the matrix
    crosses the link.  Counterpart of device_win.py:239.  The slice over
    the nwin window starts keeps the values of garlic_tpu's slice over
    all nloci slots, whose MISSING tail the caller drops."""
    out = dwin.win[:, ::step].cpu().numpy().astype(np.float64)
    if ind_idx is not None:
        out = out[ind_idx]
    return out


def _coverage(win: torch.Tensor, cutoff: float, threshold: float,
              delta: float, winsize: int, nloci: int):
    """Split-path coverage program (device_win.py:346) in plain torch:
    (covered bool [I, nloci], susw bool [I, nwin], above bool [I, nwin]).
    MISSING slots score -9999, far from any cutoff band; delta 0 flags
    nothing.  Counts are exact int32 sums."""
    c = torch.tensor(cutoff, dtype=torch.float32, device=win.device)
    d = torch.as_tensor(delta, dtype=torch.float32, device=win.device)
    above = win >= c
    susw = (win - c).abs() < d
    I, nwin = win.shape
    if nwin == 0:
        cov = torch.zeros((I, nloci), dtype=torch.bool, device=win.device)
    else:
        cov = cuda_lod.window_counts(above, winsize)[:, :nloci] >= threshold
    return cov, susw, above


def _edges_payload(covered: torch.Tensor, susw: torch.Tensor,
                   above: torch.Tensor) -> np.ndarray:
    """The edge extractor (device_win.py:391) in plain torch: one int64
    payload, one device-to-host copy:
    [nedge, nsusw, last(I), sus(I), sidx(nsusw), sside(nsusw),
     edges(nedge)].
    edges: sorted flat indices (row-major over [I, L]) of the 0->1 / 1->0
    coverage transitions; last: the row's final SNP is covered; sus: the
    row holds a suspect window; sidx/sside: flat indices over [I, nwin]
    of the suspect windows and their f32 side of the cutoff."""
    covered = covered.bool()
    susw = susw.bool()
    I, L = covered.shape
    last = covered[:, -1] if L else torch.zeros(I, dtype=torch.bool,
                                                device=covered.device)
    prev = torch.zeros_like(covered)
    prev[:, 1:] = covered[:, :-1]
    edges = torch.nonzero((covered != prev).reshape(-1)).reshape(-1)
    sidx = torch.nonzero(susw.reshape(-1)).reshape(-1)
    sside = above.reshape(-1)[sidx].to(torch.int64)
    head = torch.tensor([edges.numel(), sidx.numel()], dtype=torch.int64,
                        device=covered.device)
    payload = torch.cat([head, last.to(torch.int64),
                         susw.any(dim=1).to(torch.int64), sidx, sside,
                         edges])
    return payload.cpu().numpy()


def covered_dispatch(dwin, cutoff: float, winsize: int, threshold: float,
                     tie_delta: float = 0.0):
    """Enqueue one chromosome's coverage on the device and return a
    handle for covered_fetch.  A FusedCov launches K2 or K4 (or returns
    the handle pre-enqueued during Phase I, or takes the split path where
    _dispatch_fused declines); a DeviceWin runs the plain-torch coverage
    program over K1's or K3's window matrix.  Kernel launches are
    asynchronous, so assemble_roh enqueues every resident chromosome
    before the first blocking fetch (streamed ones in turn).

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
        h = _dispatch_fused(dwin, cutoff, winsize, thr, tie_delta)
        if h is not None:
            return h
        dwin = dwin.make()
    if tie_delta and dwin.tie_scale is not None:
        tie_delta = torch.tensor(tie_delta, dtype=torch.float32,
                                 device=dwin.win.device) * dwin.tie_scale
    cov, susw, above = _coverage(dwin.win, cutoff, thr, tie_delta, winsize,
                                 dwin.nloci)
    return cov, susw, above, dwin.nind, dwin.nloci


def _dispatch_fused(fc: FusedCov, cutoff: float, winsize: int,
                    threshold: float, tie_delta: float):
    """Run K2, or K4 for dictionary-form TGLS, for one chromosome
    (_dispatch_fused, device_win.py:599).  None -> the caller takes the
    split path: float-matrix TGLS, as device_win.py:634-637 does.  Exact
    sizing leaves no bucket-slack case; a chromosome shorter than the
    window has no windows and so nothing covered."""
    c = fc.chrom
    I, L = c.nind, c.nloci
    if L - winsize + 1 <= 0:
        z = torch.zeros((I, 0), dtype=torch.uint8, device=fc.device)
        return (torch.zeros((I, L), dtype=torch.uint8, device=fc.device),
                z, z, I, L)
    if fc.use_gl:
        if c.gl_codes is None:
            return None
        cov, susw, above = cuda_lod.covered_gl_raw(
            c, fc.centro, winsize, fc.max_gap, cutoff, threshold, tie_delta,
            fc.device)
    else:
        cov, susw, above = cuda_lod.covered_packed_raw(
            c, fc.centro, winsize, fc.error, fc.max_gap, cutoff, threshold,
            tie_delta, fc.device)
    return cov, susw, above, I, L


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


def covered_fetch(handle):
    """(uint8 [I, ceil(L/8)] little-endian bit-packed coverage, bool [I]
    suspect-row flags, suspect-window detail (rows, wins, f32_above))
    for a covered_dispatch handle (covered_fetch, device_win.py:724)."""
    cov, susw, above, I, L = handle
    m = _edges_payload(cov, susw, above)
    nedge, nsusw = int(m[0]), int(m[1])
    o = 2
    last = m[o:o + I].astype(bool)
    sus = m[o + I:o + 2 * I].astype(bool)
    o += 2 * I
    sidx = m[o:o + nsusw]
    sside = m[o + nsusw:o + 2 * nsusw].astype(bool)
    o += 2 * nsusw
    edges = m[o:o + nedge]
    nwin = susw.shape[1]
    susw_detail = (sidx // max(nwin, 1), sidx % max(nwin, 1), sside)
    return _edges_to_packed(edges, last, I, L), sus, susw_detail


def covered_packed(dwin, cutoff: float, winsize: int, threshold: float,
                   tie_delta: float = 0.0):
    """(bit-packed coverage, suspect-row flags, suspect-window detail):
    bit w is set when at least ceil(threshold) cutoff-passing windows
    span SNP w (src/garlic-roh.cpp:446-448)."""
    return covered_fetch(covered_dispatch(dwin, cutoff, winsize, threshold,
                                          tie_delta))
