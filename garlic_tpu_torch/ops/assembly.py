"""Phase III: ROH assembly from window scores or device coverage.

Copies of the host code in garlic_tpu/ops/assembly.py, whose module
imports garlic_tpu.ops.lod and therefore JAX.  The run extraction, the
tie-patrol repair and the reference's edge quirks are unchanged; only
_chrom_runs_native and assemble_roh dispatch to this package's
ops/device_win (torch tensors and the CUDA coverage kernel).

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


# copy of garlic_tpu/ops/assembly.py:70
def coverage_counts(above: np.ndarray, winsize: int) -> np.ndarray:
    """int64 [L] counts of cutoff-passing windows covering each SNP."""
    k = np.ones(winsize, dtype=np.int64)
    return np.convolve(above.astype(np.int64), k, mode="full")[: above.shape[0]]


# copy of garlic_tpu/ops/assembly.py:79
def assemble_chromosome(win_row: np.ndarray, positions: np.ndarray,
                        gpos: np.ndarray, cutoff: float, winsize: int,
                        max_gap: int, cstart: int, cend: int,
                        threshold: float, cm: bool) -> List[tuple]:
    """ROH for one (individual, chromosome): list of (start, stop, size)."""
    above = win_row >= cutoff
    counts = coverage_counts(above, winsize)
    covered = counts >= threshold
    br = pair_breaks(positions, max_gap, cstart, cend)
    if np.any(positions <= 0):
        return _assemble_scan(covered, br, positions, gpos, threshold, cm)
    return _assemble_segments(covered, br, positions, gpos, threshold, cm)


# copy of garlic_tpu/ops/assembly.py:93
def _emit(out, positions, gpos, ps, pe, threshold, cm):
    if pe - ps + 1 >= threshold:
        if cm:
            size = float(gpos[pe] - gpos[ps])
        else:
            size = float(int(positions[pe]) - int(positions[ps]) + 1)
        out.append((int(positions[ps]), int(positions[pe]), size))


# copy of garlic_tpu/ops/assembly.py:102
def _assemble_segments(covered, br, positions, gpos, threshold, cm):
    L = covered.shape[0]
    out: List[tuple] = []
    c = covered.astype(np.int8)
    diffs = np.diff(c)
    starts = list(np.flatnonzero(diffs == 1) + 1)
    ends = list(np.flatnonzero(diffs == -1))
    if c[0]:
        starts.insert(0, 0)
    if c[-1]:
        ends.append(L - 1)
    for s, e in zip(starts, ends):
        # split points strictly inside (s, e]
        splits = np.flatnonzero(br[s + 1:e + 1]) + s + 1
        ps = s
        for w in splits:
            _emit(out, positions, gpos, ps, int(w) - 1, threshold, cm)
            ps = int(w)
        if ps == L - 1 and e == L - 1 and ps != s:
            # reopened at the chromosome's last SNP: lost (loop ends).
            continue
        if ps == s == e == L - 1:
            # opened at the chromosome's last SNP: lost.
            continue
        _emit(out, positions, gpos, ps, e, threshold, cm)
    return out


# copy of garlic_tpu/ops/assembly.py:130
def _assemble_scan(covered, br, positions, gpos, threshold, cm):
    """Faithful per-locus transliteration of src/garlic-roh.cpp:462-532."""
    L = covered.shape[0]
    out: List[tuple] = []
    win_start = -1
    win_start_idx = -1
    for w in range(L):
        if win_start < 0 and covered[w]:
            win_start = int(positions[w])
            win_start_idx = w
        elif covered[w] and br[w]:
            stop_idx = w - 1
            if stop_idx - win_start_idx + 1 >= threshold:
                _emit(out, positions, gpos, win_start_idx, stop_idx, threshold, cm)
            win_start = int(positions[w])
            win_start_idx = w
        elif win_start > 0 and not covered[w]:
            stop_idx = w - 1
            if stop_idx - win_start_idx + 1 >= threshold:
                _emit(out, positions, gpos, win_start_idx, stop_idx, threshold, cm)
            win_start = -1
            win_start_idx = -1
        elif win_start > 0 and w + 1 >= L:
            if w - win_start_idx + 1 >= threshold:
                _emit(out, positions, gpos, win_start_idx, w, threshold, cm)
            win_start = -1
            win_start_idx = -1
    return out


# copy of garlic_tpu/ops/assembly.py:160
def assemble_from_covered(covered_row: np.ndarray, positions: np.ndarray,
                          gpos: np.ndarray, max_gap: int, cstart: int,
                          cend: int, threshold: float, cm: bool) -> List[tuple]:
    """Run extraction given a precomputed covered mask (device fast path)."""
    br = pair_breaks(positions, max_gap, cstart, cend)
    if np.any(positions <= 0):
        return _assemble_scan(covered_row, br, positions, gpos, threshold, cm)
    return _assemble_segments(covered_row, br, positions, gpos, threshold, cm)


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


# copy of garlic_tpu/ops/assembly.py:223, dispatching to this package's
# device_win
def _chrom_runs_native(win, chrom, cutoff: float, winsize: int, max_gap: int,
                       cstart: int, cend: int, threshold: float, cm: bool,
                       handle=None, tie_delta: float = 0.0,
                       exact_cover=None, exact_window=None, ci: int = 0):
    """(ind, start, stop, size) arrays for one chromosome via the C++
    extractor, or None to fall back to Python.  handle: a pre-dispatched
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
        if packed is None:
            above = win >= cutoff
            covered = coverage_counts_batch(above, winsize) >= threshold
            packed = np.packbits(covered, axis=1, bitorder="little")
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


# copy of garlic_tpu/ops/assembly.py:266, dispatching to this package's
# device_win; streamed FusedCov entries stay sequential like LazyWin
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
    from .device_win import DeviceWin, FusedCov, LazyWin, covered_dispatch
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
        cstart = centro.start(chrom.chrom)
        cend = centro.end(chrom.chrom)
        runs = _chrom_runs_native(win_by_chr[ci], chrom, cutoff, winsize,
                                  max_gap, cstart, cend, threshold, cm,
                                  handle=handles[ci], tie_delta=tie_delta,
                                  exact_cover=exact_cover,
                                  exact_window=exact_window, ci=ci)
        if runs is None:
            w = win_by_chr[ci]
            covered = None
            h = handles[ci]
            if h is None and isinstance(w, (LazyWin, FusedCov)):
                h = covered_dispatch(w.make() if isinstance(w, LazyWin)
                                     else w, cutoff, winsize, threshold,
                                     tie_delta)
            if h is not None:
                from .device_win import covered_fetch
                packed, sus, _ = covered_fetch(h)
                bits = np.unpackbits(packed, axis=1, bitorder="little")
                covered = bits[:, :chrom.nloci].astype(bool)
                if exact_cover is not None and sus is not None:
                    rows = np.flatnonzero(sus[:nind])
                    if rows.size:
                        covered[rows] = exact_cover(ci, rows)[:, :chrom.nloci]
            calls_by_ind = []
            for i in range(nind):
                if covered is not None:
                    calls = assemble_from_covered(
                        covered[i], chrom.positions, chrom.gpos, max_gap,
                        cstart, cend, threshold, cm)
                else:
                    calls = assemble_chromosome(
                        w[i], chrom.positions, chrom.gpos, cutoff, winsize,
                        max_gap, cstart, cend, threshold, cm)
                calls_by_ind.append(calls)
            per_chrom.append(("py", calls_by_ind))
        else:
            ind_arr, start_arr, stop_arr, size_arr = runs
            # individual-major: slice boundaries via searchsorted
            bounds = np.searchsorted(ind_arr, np.arange(nind + 1))
            per_chrom.append(("nat", (bounds, start_arr, stop_arr, size_arr)))

    with span("calls"):
        lengths: List[float] = []
        by_ind: List[IndividualROH] = []
        for i, ind_id in enumerate(ind_ids):
            rec = IndividualROH(ind_id=ind_id)
            for ci in range(len(chroms)):
                kind, data = per_chrom[ci]
                if kind == "py":
                    for start, stop, size in data[i]:
                        rec.calls.append(ROHCall(ci, start, stop, size))
                        lengths.append(size)
                else:
                    bounds, start_arr, stop_arr, size_arr = data
                    for k in range(bounds[i], bounds[i + 1]):
                        rec.calls.append(ROHCall(ci, int(start_arr[k]),
                                                 int(stop_arr[k]),
                                                 float(size_arr[k])))
                        lengths.append(float(size_arr[k]))
            by_ind.append(rec)
    return by_ind, np.asarray(lengths, dtype=np.float64)
