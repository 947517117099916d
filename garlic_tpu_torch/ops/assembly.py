"""Phase III: ROH assembly from window scores or device coverage.

Copies of the host code in garlic_tpu/ops/assembly.py, whose module
imports garlic_tpu.ops.lod and therefore JAX.  The tie-patrol repair is
unchanged; _chrom_runs_native and assemble_roh dispatch to this
package's ops/device_win (torch tensors and the CUDA coverage kernel)
and extract the runs with the native library alone
(native.assemble_runs_native, the reference's edge quirks included),
which the port requires.

Reproduces assembleROHWindows (src/garlic-roh.cpp:409-546): every SNP
covered by a window scoring >= cutoff accumulates coverage counts; runs
start where coverage >= OVERLAP_THRESHOLD, split at >MAX_GAP gaps /
centromere straddles, close where coverage drops or the chromosome ends,
and are kept only if they span >= OVERLAP_THRESHOLD SNPs.

Under --tpu-profile each step of the fast engine's assembly is a span
(runtime.span: dispatch and edges in ops/device_win, patrol, scan,
calls) and the tie patrol's suspect windows and flipped rows are
counted (patrol.suspects, patrol.flip_rows).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..runtime import count, span
from .lod import pair_breaks


# copy of garlic_tpu/ops/assembly.py:48
@dataclass
class ROHCall:
    chrom_idx: int
    start: int      # physical start (bp)
    stop: int       # physical stop (bp)
    size: float     # bp length (stop-start+1) or cM length (gstop-gstart)


# copy of garlic_tpu/ops/assembly.py:56
@dataclass
class IndividualROH:
    ind_id: str
    calls: List[ROHCall] = field(default_factory=list)


# copy of garlic_tpu/ops/assembly.py:62
def overlap_threshold(overlap_frac: float, winsize: int) -> float:
    """clamp(frac*winsize, 1, winsize) (src/garlic-roh.cpp:422-424)."""
    t = overlap_frac * winsize
    t = t if t >= 1 else 1.0
    t = t if t <= winsize else float(winsize)
    return t


# copy of garlic_tpu/ops/assembly.py:170
def coverage_counts_batch(above: np.ndarray, winsize: int) -> np.ndarray:
    """Vectorized coverage_counts over [I, L] window-above flags."""
    cs = np.cumsum(above.astype(np.int64), axis=1)
    counts = cs.copy()
    counts[:, winsize:] -= cs[:, :-winsize]
    return counts


# copy of garlic_tpu/ops/assembly.py:178
def _repair_rows(packed: np.ndarray, sus, susw, chrom, exact_cover,
                 exact_window, ci: int) -> None:
    """Tie patrol: the device compares f32 window sums against the f32
    cutoff; windows further than the error band from the cutoff provably
    decide identically to f64, and the rare in-band ones are verified on
    the host — making the fast engine's BED identical to the oracle's by
    construction.

    With window detail (susw = (rows, wins, f32_above)) each suspect
    window's decision is re-derived as a ~winsize-term f64 sum
    (exact_window); only rows where a decision FLIPS pay the full exact
    rolling-engine recomputation (exact_cover) of their coverage bits.
    Without detail every flagged row is recomputed."""
    if exact_cover is None or sus is None:
        return
    nind = getattr(chrom, "nind_global", None) or chrom.nind
    rows = np.flatnonzero(sus[:nind])
    if rows.size == 0:
        return
    if susw is not None and exact_window is not None:
        si, sw, sside = susw
        live = si < nind
        si, sw, sside = si[live], sw[live], sside[live]
        if si.size:
            flip = exact_window(ci, si, sw, sside)
            rows = np.unique(si[flip])
        else:
            rows = si
        count("patrol.suspects", int(si.size))
        count("patrol.flip_rows", int(rows.size))
        if rows.size == 0:
            return
    fixed = exact_cover(ci, rows)          # bool [k, nloci]
    fb = np.packbits(fixed, axis=1, bitorder="little")
    packed[rows, :fb.shape[1]] = fb


# adapted from garlic_tpu/ops/assembly.py:223: dispatching to this
# package's device_win; the native library is required
def _chrom_runs_native(win, chrom, cutoff: float, winsize: int, max_gap: int,
                       cstart: int, cend: int, threshold: float, cm: bool,
                       handle=None, tie_delta: float = 0.0,
                       exact_cover=None, exact_window=None, ci: int = 0):
    """(ind, start, stop, size) arrays for one chromosome via the C++
    extractor.  handle: a pre-dispatched
    covered_dispatch result (assemble_roh enqueues every chromosome's
    device kernels before the first blocking fetch)."""
    from ..native import assemble_runs_native
    from .device_win import (DeviceWin, FusedCov, LazyWin, covered_fetch,
                             covered_packed)
    sus = susw = None
    if handle is not None:
        packed, sus, susw = covered_fetch(handle)
    elif isinstance(win, LazyWin):
        # streaming mode: materialize, extract coverage bits, drop
        packed, sus, susw = covered_packed(win.make(), cutoff, winsize,
                                           threshold, tie_delta)
    elif isinstance(win, (DeviceWin, FusedCov)):
        # a DeviceWin, or a streamed FusedCov: K2/K4 run here, in turn
        packed, sus, susw = covered_packed(win, cutoff, winsize, threshold,
                                           tie_delta)
    else:
        from ..native import covered_pack_native
        packed = covered_pack_native(win, winsize, cutoff, threshold)
    if sus is not None and exact_cover is not None:
        with span("patrol"):
            if not packed.flags.writeable:
                packed = np.array(packed)
            _repair_rows(packed, sus, susw, chrom, exact_cover,
                         exact_window, ci)
    with span("scan"):
        br = pair_breaks(chrom.positions, max_gap, cstart, cend)
        return assemble_runs_native(packed, br, chrom.positions, chrom.gpos,
                                    threshold, cm)


# adapted from garlic_tpu/ops/assembly.py:266: dispatching to this
# package's device_win (streamed FusedCov entries stay sequential like
# LazyWin); the native library is required
def assemble_roh(win_by_chr, chroms, ind_ids: List[str],
                 centro, cutoff: float, winsize: int, max_gap: int,
                 overlap_frac: float, cm: bool,
                 tie_delta: float = 0.0, exact_cover=None,
                 exact_window=None):
    """Full assembleROHWindows: returns (per-individual ROH, pooled lengths
    in the reference's (ind, chr, position) order).

    win_by_chr entries are numpy [I, L] window matrices (exact engine),
    DeviceWin (split fast path), FusedCov (fused fast path) or, in
    streaming mode, LazyWin and FusedCov with stream set.

    tie_delta/exact_cover/exact_window: the fast engine's tie patrol
    (_repair_rows)."""
    from .device_win import DeviceWin, FusedCov, covered_dispatch
    threshold = overlap_threshold(overlap_frac, winsize)
    nind = len(ind_ids)
    # enqueue every resident chromosome's coverage kernels up front so
    # chromosome N+1's device compute overlaps chromosome N's host-side
    # fetch + scan; streamed entries (LazyWin, FusedCov.stream) are made,
    # dispatched, fetched and dropped in turn, to bound device memory
    handles = [covered_dispatch(w, cutoff, winsize, threshold, tie_delta)
               if isinstance(w, DeviceWin)
               or (isinstance(w, FusedCov) and not w.stream) else None
               for w in win_by_chr]
    per_chrom = []
    for ci, chrom in enumerate(chroms):
        ind_arr, start_arr, stop_arr, size_arr = _chrom_runs_native(
            win_by_chr[ci], chrom, cutoff, winsize, max_gap,
            centro.start(chrom.chrom), centro.end(chrom.chrom), threshold,
            cm, handle=handles[ci], tie_delta=tie_delta,
            exact_cover=exact_cover, exact_window=exact_window, ci=ci)
        # individual-major: slice boundaries via searchsorted
        bounds = np.searchsorted(ind_arr, np.arange(nind + 1))
        per_chrom.append((bounds, start_arr, stop_arr, size_arr))

    with span("calls"):
        lengths: List[float] = []
        by_ind: List[IndividualROH] = []
        for i, ind_id in enumerate(ind_ids):
            rec = IndividualROH(ind_id=ind_id)
            for ci, (bounds, start_arr, stop_arr, size_arr) in \
                    enumerate(per_chrom):
                for k in range(bounds[i], bounds[i + 1]):
                    rec.calls.append(ROHCall(ci, int(start_arr[k]),
                                             int(stop_arr[k]),
                                             float(size_arr[k])))
                    lengths.append(float(size_arr[k]))
            by_ind.append(rec)
    return by_ind, np.asarray(lengths, dtype=np.float64)
