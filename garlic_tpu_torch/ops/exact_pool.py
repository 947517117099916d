"""Phase II's exact f64 pool on the card: the thinned rolling LOD windows
of the requested rows, in one launch for every chromosome of a pool.

The fast engine's automatic runs pool the exact engine's f64 windows,
thinned by `step` and MISSING-filtered (pipeline._exact_thinned_samples),
because the nrd0 bandwidth, the KDE's grid and the .kde x column follow
their bits.  gt_exact_pool (csrc/exact_pool.cu) replaces no Pallas
kernel: it takes over the host pass gt_lod_windows_exact_thin
(native/garlic_native.cpp:1433) with the same adds in the same order, so
its samples are the host pass's bit for bit.  Its codes are the
chromosome's 2-bit codes on the card (cuda_lod.packed_device: compacted
there where the filter deferred the compaction), read through a row
index; its f64 tables are lod.lod_table's (numpy's log10), and its window
masks lod.window_missing_mask's, both made on the host.

thinned_samples is the route; exact_pool the wrapper, which sends CPU
tensors to exact_pool_plain beside it (the CPU tests' route) and
launches the kernel for CUDA tensors (counted in cuda_lod.LAUNCHES).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import MISSING
from ..runtime import count, to_device, to_host
from . import _build, cuda_lod
from .lod import lod_table, window_missing_mask

DESC = 8  # int64 fields a chromosome of the kernel's descriptor
# the kernel counts window positions in int32, a chunk and a window past L
MAX_LOCI = 1 << 30


def _nthin(L: int, step: int) -> int:
    return -(-L // step)


def exact_pool_plain(chroms, winsize: int, step: int) -> torch.Tensor:
    """Plain version of gt_exact_pool (see exact_pool), one step of the
    recurrence a window position over every chain (a chromosome's row) at
    once: a fresh sum of the W terms from 0.0 where a chain's run of live
    windows starts, else (acc - term(l - 1)) + term(l + W - 1)."""
    W = winsize
    dev = chroms[0][0].device
    Ls = [int(t.shape[1]) for _, _, t, _ in chroms]
    Rs = [int(r.shape[0]) for _, r, _, _ in chroms]
    nwins = [max(L - W + 1, 0) for L in Ls]
    nmax, n = max(nwins), sum(Rs)
    thin = torch.full((max(_nthin(L, step) for L in Ls), n), float(MISSING),
                      dtype=torch.float64, device=dev)
    if nmax > 0:
        # terms [l, chain] and missing windows [l, chain] (past a
        # chromosome's last window too)
        terms = torch.zeros((nmax + W - 1, n), dtype=torch.float64,
                            device=dev)
        miss = torch.ones((nmax, n), dtype=torch.bool, device=dev)
        col = 0
        for (codes, rows, table, m), L, R, nwin in zip(chroms, Ls, Rs,
                                                       nwins):
            if nwin > 0:
                terms[:L, col:col + R] = cuda_lod.table_terms(
                    codes[rows.long()], table).T
                miss[:nwin, col:col + R] = m.bool()[:, None]
            col += R
        fresh = torch.zeros((nmax, n), dtype=torch.float64, device=dev)
        for k in range(W):
            fresh += terms[k:k + nmax]
        start = ~miss
        start[1:] &= miss[:-1]
        # positions where some chain misses or starts a run (host bools)
        special = (miss | start).any(dim=1).tolist()
        acc = torch.zeros(n, dtype=torch.float64, device=dev)
        for l in range(nmax):
            if special[l]:
                roll = (acc - terms[l - 1]) + terms[l + W - 1] if l else acc
                acc = torch.where(start[l], fresh[l], roll)
            else:
                acc.sub_(terms[l - 1]).add_(terms[l + W - 1])
            if l % step == 0:
                thin[l // step] = torch.where(miss[l], float(MISSING), acc)
    parts, col = [], 0
    for L, R in zip(Ls, Rs):
        parts.append(thin[:_nthin(L, step), col:col + R].T.reshape(-1))
        col += R
    return torch.cat(parts)


def _check(chroms, winsize: int, step: int):
    if not chroms:
        raise ValueError("no chromosome to pool")
    if winsize < 1 or step < 1:
        raise ValueError(f"need winsize >= 1 and step >= 1 (winsize="
                         f"{winsize}, step={step})")
    dev = chroms[0][0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for codes, rows, table, miss in chroms:
        if codes.dtype != torch.uint8 or codes.dim() != 2:
            raise TypeError("codes must be a 2-D uint8 tensor")
        if rows.dtype != torch.int32 or rows.dim() != 1 \
                or rows.shape[0] < 1:
            raise TypeError("rows must be a non-empty 1-D int32 tensor")
        if table.dtype != torch.float64 or table.dim() != 2 \
                or table.shape[0] != 3:
            raise TypeError("table must be a [3, L] float64 tensor")
        L = table.shape[1]
        if not 1 <= L <= MAX_LOCI or winsize > MAX_LOCI:
            raise ValueError(f"L={L} and winsize={winsize} must lie in "
                             f"[1, {MAX_LOCI}]")
        if codes.shape[1] != (L + 3) // 4:
            raise ValueError(f"codes have {codes.shape[1]} bytes per row, "
                             f"expected {(L + 3) // 4} for L={L}")
        if miss.dtype != torch.uint8 \
                or tuple(miss.shape) != (max(L - winsize + 1, 0),):
            raise TypeError(f"miss must be a uint8 tensor of shape "
                            f"({max(L - winsize + 1, 0)},)")
        for t in (codes, rows, table, miss):
            if t.device != dev:
                raise ValueError("inputs lie on different devices")
            if not t.is_contiguous():
                raise ValueError("inputs must be contiguous")
    return dev


def exact_pool(chroms, winsize: int, step: int) -> torch.Tensor:
    """gt_exact_pool: f64 [sum of R * ceil(L / step)], chromosome-major,
    then rows in the given order, row-major: for each chromosome
    (codes u8 [I, ceil(L/4)], rows int32 [R], table f64 [3, L], miss u8
    [max(L - winsize + 1, 0)]) on one device, the thinned exact windows
    [R, ceil(L / step)] of its rows `rows` (gt_lod_windows_exact_thin's:
    window l at column l / step where l % step == 0, MISSING in every
    other column and where miss is set).  Every row must lie in its
    codes: the caller's to keep (thinned_samples), since the values of a
    device tensor cannot be read without waiting for it."""
    dev = _check(chroms, winsize, step)
    if dev.type == "cpu":
        return exact_pool_plain(chroms, winsize, step)
    nchains = sum(int(r.shape[0]) for _, r, _, _ in chroms)
    desc = np.zeros(DESC * len(chroms) + nchains, dtype=np.int64)
    off = at = 0
    for i, (codes, rows, table, miss) in enumerate(chroms):
        L, R = int(table.shape[1]), int(rows.shape[0])
        desc[DESC * i:DESC * (i + 1)] = (
            codes.data_ptr(), table.data_ptr(), miss.data_ptr(),
            rows.data_ptr(), off, codes.shape[1], L, _nthin(L, step))
        base = DESC * len(chroms) + at
        desc[base:base + R] = (i << 32) | np.arange(R, dtype=np.int64)
        off += R * _nthin(L, step)
        at += R
    desc_t = to_device(torch.from_numpy(desc), dev)
    out = torch.empty(off, dtype=torch.float64, device=dev)
    cuda_lod._launch("gt_exact_pool", "exact_pool", dev, desc_t.data_ptr(),
                     len(chroms), nchains, winsize, step, float(MISSING),
                     out.data_ptr())
    return out


def thinned_samples(chroms, centro, winsize: int, error: float,
                    max_gap: int, step: int, rows, device) -> list:
    """The exact pool's samples of each chromosome on `device` (one
    f64 array each, in chroms' order): the requested rows' thinned exact
    windows, MISSING and NaN filtered out, in the host pass's order (rows
    as given, row-major).  rows: per chromosome its requested rows (an
    index into its rows; None: every row).  The codes and the tables go
    up a chromosome at a time, the masks and the row indices in one copy
    each, one launch pools them all, one copy brings the windows back
    (the span `wait`); every device tensor is freed on return, the
    codes too, so a chromosome's deferred compaction stays deferred for
    Phase III.  Counted in pool.device, one a chromosome it pools."""
    held, masks, idx, spans = [], [], [], []
    for c, r in zip(chroms, rows):
        r = np.arange(c.nind) if r is None \
            else np.asarray(r, dtype=np.int64)
        nwin = c.nloci - winsize + 1
        if r.size == 0 or nwin <= 0:  # no window: nothing to pool
            spans.append(0)
            continue
        if r.min() < 0 or r.max() >= c.nind:
            raise IndexError(f"rows outside the {c.nind} of {c.chrom}")
        masks.append(window_missing_mask(
            c.positions, winsize, max_gap, centro.start(c.chrom),
            centro.end(c.chrom)))
        idx.append(r)
        held.append((cuda_lod.packed_device(c, device),
                     cuda_lod._upload(lod_table(c.freq, error)[:3], device)))
        spans.append(r.size * _nthin(c.nloci, step))
    count("pool.device", len(held))
    if not held:
        return [np.zeros(0) for _ in spans]
    miss = cuda_lod._upload(np.concatenate(masks).astype(np.uint8), device)
    rows_d = cuda_lod._upload(np.concatenate(idx).astype(np.int32), device)
    items, m0, r0 = [], 0, 0
    for (codes, table), m, r in zip(held, masks, idx):
        items.append((codes, rows_d[r0:r0 + r.size], table,
                      miss[m0:m0 + m.size]))
        m0 += m.size
        r0 += r.size
    flat = to_host(exact_pool(items, winsize, step))
    del held, items, miss, rows_d
    out, at = [], 0
    for n in spans:
        v = flat[at:at + n]
        out.append(v[(v != MISSING) & ~np.isnan(v)])
        at += n
    return out


def dadd_chain(x: torch.Tensor, n: int) -> torch.Tensor:
    """gt_dadd_chain: one thread's n rounds of (acc - x[0]) + x[1] from
    acc = x[2], two dependent f64 adds a round; f64 [1] on x's CUDA
    device.  Its time over 2 n is one dependent add's latency, the
    quantity that bounds a chain of gt_exact_pool (chip_smoke.py)."""
    if x.dtype != torch.float64 or tuple(x.shape) != (3,) \
            or x.device.type != "cuda" or n < 0:
        raise ValueError("x must be a float64 [3] CUDA tensor, n >= 0")
    out = torch.empty(1, dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = _build.library().gt_dadd_chain(
            x.device.index, x.data_ptr(), n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gt_dadd_chain launch failed: CUDA error {rc}")
    return out
