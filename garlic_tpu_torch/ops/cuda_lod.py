"""Phase-I LOD windows on the GPU: kernels K1-K4, their plain PyTorch
versions, and the device inputs they read.

Counterpart of garlic_tpu/ops/pallas_lod.py.  The four Pallas TPU
kernels are hand-written CUDA in csrc/lod_windows.cu:

* K1 lod_windows    <- _lod_windows_pallas_padded   (pallas_lod.py:93)
* K2 covered        <- _covered_pallas_padded       (pallas_lod.py:291)
* K3 window_sums    <- _window_sums_pallas_padded   (pallas_lod.py:175)
* K4 covered_terms  <- _covered_terms_pallas_padded (pallas_lod.py:402)

K1/K2 read 2-bit genotype codes and an f32 [3, L] LOD table; K3/K4 (the
TGLS path, per-genotype error) read an f32 [I, L] term plane that
gl_terms_f32 builds.  A fifth kernel, gt_compact_2bit
(csrc/compact_2bit.cu), replaces no Pallas kernel: where the monomorphic
filter's column compaction of a chromosome's codes is still deferred, it
compacts them to the kept loci on the device (packed_device), in place of
the host pass.  Each wrapper checks its inputs, sends a CPU tensor to the
plain version beside it and launches the kernel for a CUDA tensor (there
is no fallback from one to the other), and counts its launches in
LAUNCHES.  Tensors are sized exactly (nwin = L - W + 1 window starts, L
SNPs): the JAX package's power-of-two buckets and its _pad_codes_dev
existed to bound XLA recompiles.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.types import MISSING
from ..runtime import count, kernel_range, span, to_device
from . import _build
from .lod import window_missing_mask

# kernel launches by wrapper, over the process; chip_smoke.py zeroes and
# reads them, and --tpu-profile prints a call's (runtime.PhaseProfiler).
# K1-K4 keep the first four positions (resident_warps passes a key's
# position to the library); K5 and K6, the weighted path's kernels, are
# launched by ops/device_wlod.py, K7 (the Gauss transform) by ops/kde.py
# and K8 (the GMM-EM) by ops/gmm.py; compact_2bit is the codes'
# compaction (compact_2bit, here), exact_pool Phase II's exact f64 pool
# (ops/exact_pool.py)
LAUNCHES = {"lod_windows": 0, "covered": 0, "window_sums": 0,
            "covered_terms": 0, "pair_counts": 0, "wlod_windows": 0,
            "gauss_sums": 0, "gmm_em": 0, "compact_2bit": 0,
            "exact_pool": 0}


def decode_2bit(packed: torch.Tensor, nloci: int) -> torch.Tensor:
    """[I, ceil(L/4)] u8 little-endian 2-bit codes -> int8 [I, L]
    genotypes 0/1/2, code 3 -> -9 (missing).  Counterpart of
    pallas_lod._decode_2bit (:959) and the unpack in _packed_entry
    (:813-815).  The shifts are made on the device: a host tensor would
    be a copy that waits for the work already queued on the stream."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed.unsqueeze(-1) >> shifts) & 3
    codes = codes.reshape(packed.shape[0], -1)[:, :nloci]
    return torch.where(codes == 3, -9, codes.to(torch.int8)).to(torch.int8)


def _ratios(p: torch.Tensor, e):
    """(aut, non) pairs of genotype classes 0/1/2, in f32: the reference's
    formula (src/garlic-roh.cpp:355-386) in the JAX kernels' op order
    (pallas_lod.py:819-825, :619-625)."""
    one_minus = 1.0 - p
    non0 = one_minus * one_minus
    aut0 = (1.0 - e) * one_minus + e * non0
    non1 = 2.0 * p * one_minus
    aut1 = e * non1
    non2 = p * p
    aut2 = (1.0 - e) * p + e * non2
    return (aut0, non0), (aut1, non1), (aut2, non2)


def lod_table_f32(freq: torch.Tensor, error: float) -> torch.Tensor:
    """[3, L] f32 LOD table for genotype classes 0/1/2, monomorphic sites
    0: the f32 formula of pallas_lod._packed_entry (:816-834), op for op
    in eager torch."""
    p = freq.to(torch.float32)
    e = torch.tensor(error, dtype=torch.float32, device=p.device)
    mono = (p <= 0.0) | (p >= 1.0)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    return torch.stack([torch.where(mono, zero, torch.log10(a / n))
                        for a, n in _ratios(p, e)])


def gl_terms_f32(geno: torch.Tensor, freq: torch.Tensor,
                 err: torch.Tensor) -> torch.Tensor:
    """f32 [I, L] LOD terms with a per-genotype error plane (TGLS, the
    value replaces epsilon, src/garlic-roh.cpp:68,91-95): the counterpart
    of pallas_lod._gl_terms (:611), op for op in eager torch, with its
    (p <= 0) | (p >= 1) monomorphic test.  geno int8 [I, L] (values other
    than 0/1/2 add 0), freq [L], err f32 [I, L]."""
    p = freq.to(torch.float32)[None, :]
    r0, r1, r2 = (torch.log10(a / n) for a, n in _ratios(p, err))
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    a = torch.where(geno == 0, r0, torch.where(
        geno == 1, r1, torch.where(geno == 2, r2, zero)))
    mono = (p <= 0.0) | (p >= 1.0)
    return torch.where(mono, zero, a)


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors, and the reference the card is checked against)
# ---------------------------------------------------------------------------

def table_terms(packed: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """f32 [I, L] per-locus LOD terms of K1/K2's inputs; missing
    genotypes add 0."""
    g = decode_2bit(packed, table.shape[1])
    zero = torch.zeros((), dtype=torch.float32, device=table.device)
    return torch.where(g == 0, table[0], torch.where(
        g == 1, table[1], torch.where(g == 2, table[2], zero)))


def _window_sums(a: torch.Tensor, W: int) -> torch.Tensor:
    """Unmasked f32 window sums [I, nwin] of a term plane: W slice adds,
    left to right from 0, the kernels' order (no conv1d: cuDNN runs f32
    convolutions in TF32)."""
    nwin = a.shape[1] - W + 1
    acc = torch.zeros((a.shape[0], nwin), dtype=torch.float32,
                      device=a.device)
    for k in range(W):
        acc += a[:, k:k + nwin]
    return acc


def window_counts(above: torch.Tensor, W: int) -> torch.Tensor:
    """int32 [I, nwin + W - 1] coverage counts: count[s] = number of set
    flags over window starts [s - W + 1, s] (exact integer cumsum)."""
    I, nwin = above.shape
    pad = torch.zeros((I, nwin + 2 * (W - 1)), dtype=torch.int32,
                      device=above.device)
    pad[:, W - 1:W - 1 + nwin] = above
    cs = torch.cumsum(pad, dim=1, dtype=torch.int32)
    cs = torch.cat([torch.zeros((I, 1), dtype=torch.int32,
                                device=above.device), cs], dim=1)
    return cs[:, W:] - cs[:, :nwin + W - 1]


def window_sums_plain(terms, miss, winsize: int) -> torch.Tensor:
    """Plain version of K3: f32 [I, nwin], MISSING where miss is set."""
    win = _window_sums(terms, winsize)
    return torch.where(miss.bool()[None, :],
                       torch.tensor(float(MISSING), dtype=torch.float32,
                                    device=win.device), win)


def covered_terms_plain(terms, miss, winsize: int, cutoff: float,
                        thr: float, delta: float):
    """Plain version of K4: (covered u8 [I, L], susw u8 [I, nwin],
    above u8 [I, nwin])."""
    win = _window_sums(terms, winsize)
    live = ~miss.bool()[None, :]
    c = torch.tensor(cutoff, dtype=torch.float32, device=win.device)
    d = torch.tensor(delta, dtype=torch.float32, device=win.device)
    t = torch.tensor(thr, dtype=torch.float32, device=win.device)
    above = (win >= c) & live
    susw = ((win - c).abs() < d) & live
    cov = window_counts(above, winsize).to(torch.float32) >= t
    return (cov.to(torch.uint8), susw.to(torch.uint8),
            above.to(torch.uint8))


def compact_2bit_plain(parent, stride: int, rows: int, idx) -> torch.Tensor:
    """Plain version of gt_compact_2bit: u8 [rows, ceil(n/4)] 2-bit codes
    whose code o in row r is the code at position idx[o] of parent row r
    (its bytes from parent[r * stride]), missing codes (3) past n."""
    n = idx.shape[0]
    nb = (n + 3) // 4
    pos = idx.to(torch.int64)
    at = (torch.arange(rows, dtype=torch.int64, device=parent.device)[:, None]
          * stride + (pos >> 2))
    full = torch.full((rows, 4 * nb), 3, dtype=torch.uint8,
                      device=parent.device)
    full[:, :n] = (parent[at] >> ((pos & 3) * 2).to(torch.uint8)) & 3
    q = full.view(rows, nb, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def lod_windows_plain(packed, table, miss, winsize: int) -> torch.Tensor:
    """Plain version of K1: K3's over the table's terms."""
    return window_sums_plain(table_terms(packed, table), miss, winsize)


def covered_plain(packed, table, miss, winsize: int, cutoff: float,
                  thr: float, delta: float):
    """Plain version of K2: K4's over the table's terms."""
    return covered_terms_plain(table_terms(packed, table), miss, winsize,
                               cutoff, thr, delta)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_miss(tensors, miss, I: int, L: int, winsize: int) -> int:
    """Shared checks of every wrapper; returns nwin."""
    nwin = L - winsize + 1
    if winsize < 1 or nwin < 1 or I < 1:
        raise ValueError(f"need I >= 1 and 1 <= winsize <= L "
                         f"(I={I}, L={L}, winsize={winsize})")
    if miss.dtype != torch.uint8 or tuple(miss.shape) != (nwin,):
        raise TypeError(f"miss must be a uint8 tensor of shape ({nwin},)")
    dev = tensors[0].device
    for t in tuple(tensors) + (miss,):
        if t.device != dev:
            raise ValueError("inputs lie on different devices")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return nwin


def _check(packed, table, miss, winsize: int):
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError("packed must be a 2-D uint8 tensor")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or table.shape[0] != 3:
        raise TypeError("table must be a [3, L] float32 tensor")
    I, Lq = packed.shape
    L = table.shape[1]
    nwin = _check_miss((packed, table), miss, I, L, winsize)
    if Lq != (L + 3) // 4:
        raise ValueError(f"packed has {Lq} bytes per row, expected "
                         f"{(L + 3) // 4} for L={L}")
    return I, L, nwin


def _check_terms(terms, miss, winsize: int):
    if terms.dtype != torch.float32 or terms.dim() != 2:
        raise TypeError("terms must be a 2-D float32 tensor")
    I, L = terms.shape
    return I, L, _check_miss((terms,), miss, I, L, winsize)


def _launch(fn: str, key: str, device, *args) -> None:
    """Enqueue one kernel through the library's C launcher `fn` on
    PyTorch's current stream of `device`; raises on a launch error.  The
    launcher sets the CUDA device it launches on; the guard sets it back
    afterwards, so a mesh shard's launch on another card leaves the
    process's current device as it was.  In a trace the launch is the
    range garlic::<key> (runtime.kernel_range)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device), kernel_range(key):
        rc = getattr(_build.library(), fn)(device.index, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc}")
    LAUNCHES[key] += 1


def lod_windows(packed, table, miss, winsize: int) -> torch.Tensor:
    """K1: masked f32 window sums [I, nwin]."""
    I, L, nwin = _check(packed, table, miss, winsize)
    if packed.device.type == "cpu":
        return lod_windows_plain(packed, table, miss, winsize)
    out = torch.empty((I, nwin), dtype=torch.float32, device=packed.device)
    _launch("gt_lod_windows", "lod_windows", packed.device,
            packed.data_ptr(), table.data_ptr(), miss.data_ptr(),
            out.data_ptr(), I, L, packed.shape[1], winsize)
    return out


def resident_warps(key: str, winsize: int, device=None) -> int:
    """Warps of kernel `key` (a LAUNCHES key) that one SM holds at window
    size `winsize`, as its launch sizes its blocks: the occupancy the card
    allows (of 64 warps per SM), not a measured one."""
    device = torch.device("cuda") if device is None else torch.device(device)
    n = _build.library().gt_resident_warps(
        device.index or 0, list(LAUNCHES).index(key), winsize)
    if n < 0:
        raise RuntimeError(f"no occupancy for {key} at W={winsize}")
    return n


def _planes(dev, I: int, L: int, nwin: int):
    """Uninitialised (covered [I, L], susw [I, nwin], above [I, nwin])
    u8 outputs of K2/K4."""
    return (torch.empty((I, L), dtype=torch.uint8, device=dev),
            torch.empty((I, nwin), dtype=torch.uint8, device=dev),
            torch.empty((I, nwin), dtype=torch.uint8, device=dev))


def covered(packed, table, miss, winsize: int, cutoff: float, thr: float,
            delta: float):
    """K2: (covered u8 [I, L], susw u8 [I, nwin], above u8 [I, nwin]).
    thr is the already-ceiled overlap threshold; delta 0 flags no
    suspect."""
    I, L, nwin = _check(packed, table, miss, winsize)
    if packed.device.type == "cpu":
        return covered_plain(packed, table, miss, winsize, cutoff, thr,
                             delta)
    out = _planes(packed.device, I, L, nwin)
    _launch("gt_covered", "covered", packed.device, packed.data_ptr(),
            table.data_ptr(), miss.data_ptr(),
            *(t.data_ptr() for t in out), I, L, packed.shape[1], winsize,
            float(cutoff), float(thr), float(delta))
    return out


def compact_2bit(parent, stride: int, rows: int, idx) -> torch.Tensor:
    """gt_compact_2bit: u8 [rows, ceil(n/4)] codes of the n positions
    idx (int32) of `rows` rows of 2-bit codes, row r at parent[r * stride]
    (a flat u8 tensor), missing codes past n (compact_2bit_plain).  Every
    position must lie in its row and in parent: the caller's to keep
    (packed_device), since the values of a device tensor cannot be read
    without waiting for it."""
    if parent.dtype != torch.uint8 or parent.dim() != 1:
        raise TypeError("parent must be a 1-D uint8 tensor")
    if idx.dtype != torch.int32 or idx.dim() != 1 or idx.shape[0] < 1:
        raise TypeError("idx must be a non-empty 1-D int32 tensor")
    if rows < 1 or stride < 1 or (rows - 1) * stride >= parent.shape[0]:
        raise ValueError(f"{rows} rows of {stride} bytes do not lie in "
                         f"{parent.shape[0]} bytes")
    if idx.device != parent.device:
        raise ValueError("inputs lie on different devices")
    if not (parent.is_contiguous() and idx.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if parent.device.type == "cpu":
        return compact_2bit_plain(parent, stride, rows, idx)
    if parent.device.type != "cuda":
        raise ValueError(f"unsupported device {parent.device}")
    if parent.data_ptr() % 4 or idx.data_ptr() % 16:
        raise ValueError("parent must be 4-byte and idx 16-byte aligned")
    n = idx.shape[0]
    # the kernel's scratch: each group of 16 loci's runs
    plan = torch.empty(32 * ((n + 15) // 16), dtype=torch.uint8,
                       device=parent.device)
    out = torch.empty((rows, (n + 3) // 4), dtype=torch.uint8,
                      device=parent.device)
    _launch("gt_compact_2bit", "compact_2bit", parent.device,
            parent.data_ptr(), parent.shape[0], stride, idx.data_ptr(),
            plan.data_ptr(), out.data_ptr(), rows, n, out.shape[1])
    return out


def window_sums(terms, miss, winsize: int) -> torch.Tensor:
    """K3: masked f32 window sums [I, nwin] of an f32 term plane."""
    I, L, nwin = _check_terms(terms, miss, winsize)
    if terms.device.type == "cpu":
        return window_sums_plain(terms, miss, winsize)
    out = torch.empty((I, nwin), dtype=torch.float32, device=terms.device)
    _launch("gt_window_sums", "window_sums", terms.device, terms.data_ptr(),
            miss.data_ptr(), out.data_ptr(), I, L, winsize)
    return out


def covered_terms(terms, miss, winsize: int, cutoff: float, thr: float,
                  delta: float):
    """K4: K2's three u8 planes over an f32 term plane."""
    I, L, nwin = _check_terms(terms, miss, winsize)
    if terms.device.type == "cpu":
        return covered_terms_plain(terms, miss, winsize, cutoff, thr, delta)
    out = _planes(terms.device, I, L, nwin)
    _launch("gt_covered_terms", "covered_terms", terms.device,
            terms.data_ptr(), miss.data_ptr(), *(t.data_ptr() for t in out),
            I, L, winsize, float(cutoff), float(thr), float(delta))
    return out


# ---------------------------------------------------------------------------
# Device inputs
# ---------------------------------------------------------------------------

def _upload(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on `device` (plain H2D copy, the span
    `upload`).  Panel-cache payloads are read-only memory maps; the
    tensor is only read."""
    with span("upload"):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*not writable.*")
            t = torch.from_numpy(np.ascontiguousarray(arr))
        return to_device(t, device)


def _pack_numpy(geno: np.ndarray, L4: int) -> np.ndarray:
    """Pad to L4 loci with missing codes and pack 2-bit codes: the numpy
    branch of pallas_lod.pack_genotypes (:863-867), the tests' reference
    for the native packer."""
    I, L = geno.shape
    gp = np.full((I, L4), -9, dtype=np.int8)
    gp[:, :L] = geno
    codes = np.where(gp == -9, 3, gp).astype(np.uint8)
    v = np.ascontiguousarray(codes).reshape(I, -1).view(np.uint32)
    packed = ((v & 0x3) | ((v >> 6) & 0xC) | ((v >> 12) & 0x30)
              | ((v >> 18) & 0xC0))
    return packed.astype(np.uint8)


def pack_codes(geno: np.ndarray) -> np.ndarray:
    """u8 [I, ceil(L/4)] 2-bit codes of int8 [I, L] genotypes, missing
    codes past L: the native C++ packer."""
    rb = (geno.shape[1] + 3) // 4
    from ..native import pack_2bit_padded_native
    return pack_2bit_padded_native(geno, geno.shape[0], 4 * rb)


def packed_host(chrom) -> np.ndarray:
    """u8 [I, ceil(L/4)] 2-bit codes of one chromosome: the panel-cache /
    packed-filter bytes as they are, else the int8 genotypes packed."""
    if chrom.geno_is_packed_only:
        return chrom.geno2b[:, :(chrom.nloci + 3) // 4]
    return pack_codes(np.asarray(chrom.genotypes))


def deferred(chrom) -> bool:
    """Whether chrom's 2-bit codes still wait for the monomorphic
    filter's column compaction (io/filters._apply): no filtered bytes
    exist, and geno2b_parent holds the unfiltered parent payload and the
    kept loci's positions in it."""
    return (getattr(chrom, "geno2b_parent", None) is not None
            and chrom._geno2b is None)


def packed_device(chrom, device) -> torch.Tensor:
    """u8 [I, ceil(L/4)] 2-bit codes of one chromosome (or shard block)
    on `device`.  Where its compaction is still deferred, the host
    compaction never runs: the parent rows' bytes that cover its kept
    loci go up as they are (their row stride kept, no host copy), with
    the kept loci's positions rebased to those bytes, and compact_2bit
    compacts them there (counted in pack.device; the span `pack` holds
    these host steps).  Both inputs are freed on return, before any
    kernel's output planes are made.  Else packed_host's bytes go up."""
    if not deferred(chrom):
        return _upload(packed_host(chrom), device)
    with span("pack"):
        pb, idx = chrom.geno2b_parent
        p0 = int(idx[0]) // 4
        rows, stride = pb.shape[0], pb.strides[0]
        size = (rows - 1) * stride + int(idx[-1]) // 4 + 1 - p0
        flat = np.lib.stride_tricks.as_strided(pb[:, p0:], shape=(size,),
                                               strides=(1,))
        rel = np.empty(idx.shape[0], dtype=np.int32)
        np.subtract(idx, 4 * p0, out=rel, casting="unsafe")
        out = compact_2bit(_upload(flat, device), stride, rows,
                           _upload(rel, device))
        count("pack.device")
    return out


def _missing_mask(chrom, centro, winsize: int, max_gap: int, device,
                  miss=None):
    if miss is None:
        miss = window_missing_mask(
            chrom.positions, winsize, max_gap, centro.start(chrom.chrom),
            centro.end(chrom.chrom))
    return _upload(np.asarray(miss).astype(np.uint8), device)


def chrom_device_inputs(chrom, centro, winsize: int, error: float,
                        max_gap: int, device, miss=None):
    """One chromosome's K1/K2 inputs on `device`: (packed u8
    [I, ceil(L/4)], table f32 [3, L], window-missing mask u8 [nwin]),
    with nwin = L - winsize + 1 >= 1.  The codes go up as they are (a
    plain H2D copy; packed_device compacts them on the device where the
    filter's compaction is deferred) and the f32 table is built on the
    device; the input stage of lod_windows_pallas_prepacked_raw
    (pallas_lod.py:1261) and covered_pallas_prepacked_raw (:1352).  miss:
    the host mask [nwin] to upload (a mesh shard's slice of its
    chromosome's), else the mask of chrom.positions."""
    freq = _upload(np.asarray(chrom.freq, dtype=np.float32), device)
    return (packed_device(chrom, device), lod_table_f32(freq, error),
            _missing_mask(chrom, centro, winsize, max_gap, device, miss))


def chrom_gl_inputs(chrom, centro, winsize: int, max_gap: int, device,
                    miss=None):
    """One TGLS chromosome's K3/K4 inputs on `device`: (terms f32 [I, L],
    window-missing mask u8 [nwin]).  The 2-bit genotype codes go up as
    they are; the error plane goes up in the native reader's dictionary
    form (u8 codes [I, L] + f32 lut, gathered on the device: the K-way
    select of pallas_lod.py:686-688) or as the f32 cast of chrom.gl
    (:773); the plane is decoded on the device (_gl_codes_masked_entry,
    :668, and _gl_entry, :638, without their padding).  miss: as in
    chrom_device_inputs."""
    geno = decode_2bit(packed_device(chrom, device), chrom.nloci)
    freq = _upload(np.asarray(chrom.freq, dtype=np.float32), device)
    if chrom.gl_codes is not None:
        codes = _upload(chrom.gl_codes, device)
        lut = _upload(np.asarray(chrom.gl_lut, dtype=np.float32), device)
        err = torch.index_select(lut, 0, codes.reshape(-1).to(torch.int32))
        err = err.reshape(codes.shape)
    else:
        err = _upload(np.asarray(chrom.gl, dtype=np.float32), device)
    return (gl_terms_f32(geno, freq, err),
            _missing_mask(chrom, centro, winsize, max_gap, device, miss))
