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
gl_terms_f32 builds.  Each wrapper checks its inputs, sends a CPU tensor
to the plain version beside it and launches the kernel for a CUDA tensor
(there is no fallback from one to the other), and counts its launches in
LAUNCHES.  Tensors are sized exactly (nwin = L - W + 1 window starts, L
SNPs): the JAX package's power-of-two buckets and its _pad_codes_dev
existed to bound XLA recompiles.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.types import MISSING
from ..runtime import kernel_range, span, to_device
from . import _build
from .lod import window_missing_mask

# kernel launches by wrapper, over the process; chip_smoke.py zeroes and
# reads them, and --tpu-profile prints a call's (runtime.PhaseProfiler).
# K1-K4 keep the first four positions (resident_warps passes a key's
# position to the library); K5 and K6, the weighted path's kernels, are
# launched by ops/device_wlod.py, K7 (the Gauss transform) by ops/kde.py
# and K8 (the GMM-EM) by ops/gmm.py
LAUNCHES = {"lod_windows": 0, "covered": 0, "window_sums": 0,
            "covered_terms": 0, "pair_counts": 0, "wlod_windows": 0,
            "gauss_sums": 0, "gmm_em": 0}


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
    branch of pallas_lod.pack_genotypes (:863-867)."""
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
    codes past L: the native C++ packer, else numpy."""
    rb = (geno.shape[1] + 3) // 4
    from ..native import pack_2bit_padded_native
    packed = pack_2bit_padded_native(geno, geno.shape[0], 4 * rb)
    return packed if packed is not None else _pack_numpy(geno, 4 * rb)


def packed_host(chrom) -> np.ndarray:
    """u8 [I, ceil(L/4)] 2-bit codes of one chromosome: the panel-cache /
    packed-filter bytes as they are, else the int8 genotypes packed."""
    if chrom.geno_is_packed_only:
        return chrom.geno2b[:, :(chrom.nloci + 3) // 4]
    return pack_codes(np.asarray(chrom.genotypes))


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
    plain H2D copy) and the f32 table is built on the device; the input
    stage of lod_windows_pallas_prepacked_raw (pallas_lod.py:1261) and
    covered_pallas_prepacked_raw (:1352).  miss: the host mask [nwin] to
    upload (a mesh shard's slice of its chromosome's), else the mask of
    chrom.positions."""
    freq = _upload(np.asarray(chrom.freq, dtype=np.float32), device)
    return (_upload(packed_host(chrom), device), lod_table_f32(freq, error),
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
    geno = decode_2bit(_upload(packed_host(chrom), device), chrom.nloci)
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
