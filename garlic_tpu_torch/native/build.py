"""Build and bind the port's native host kernels (native/garlic_native.cpp).

Adapted from garlic_tpu/native/build.py for the entry points the port
calls: the library is required, as the CUDA kernels' library is
(ops/_build.py).  g++ compiles the source at first use into
<repo>/build/garlic_tpu_torch/, with OpenMP if it can, else without,
under a file name that carries a hash of the source and the flags, so an
edited source builds anew and an unchanged one loads the existing file;
a file lock keeps concurrent processes from building the same library
twice.  When g++ fails, library() raises BuildError with g++'s stderr.
A wrapper returns None only where its input decides (an anomalous freq
file, a TGLS file that cannot be opened, a non-contiguous array).  Each
function names its source line.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "garlic_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "garlic_tpu_torch")
# garlic_tpu/native/build.py:25-31: with OpenMP, else without
FLAGS = (["-O3", "-fPIC", "-shared", "-fopenmp"], ["-O3", "-fPIC", "-shared"])

_lock = threading.Lock()
_lib = None
loaded_path = None  # the library this process loaded, once it has


class BuildError(RuntimeError):
    """g++ built the library with neither set of FLAGS."""


def library_path(flags: List[str]) -> str:
    """The library's file for one set of flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgarlic_native_{h.hexdigest()[:16]}.so")


def _build() -> str:
    """The built library's path (built now if absent); raises BuildError
    with g++'s stderr when g++ fails with and without OpenMP.

    Adapted from garlic_tpu/native/build.py:22: the native library is
    required."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    errors = []
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build at a time
        for flags in FLAGS:
            so = library_path(flags)
            if os.path.exists(so):
                return so
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = ["g++"] + flags + ["-o", tmp, SRC, "-lz"]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except OSError as e:
                errors.append(f"{' '.join(cmd)}: {e}")
                continue
            except subprocess.CalledProcessError as e:
                errors.append(f"{' '.join(cmd)}:\n"
                              f"{e.stderr.decode(errors='replace')}")
                continue
            os.replace(tmp, so)
            return so
    raise BuildError(f"g++ could not build the native host library into "
                     f"{BUILD_DIR}/\n" + "\n".join(errors))


def library() -> ctypes.CDLL:
    """The native library, built on first use; raises BuildError with
    g++'s stderr when the build fails.

    Adapted from garlic_tpu/native/build.py:38 (_load): the native library
    is required."""
    global _lib, loaded_path
    with _lock:
        if _lib is not None:
            return _lib
        so = _build()
        lib = ctypes.CDLL(so)
        loaded_path = so
        lib.gt_tped_open.restype = ctypes.c_void_p
        lib.gt_tped_open.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                     ctypes.c_int]
        lib.gt_tped_open_range.restype = ctypes.c_void_p
        lib.gt_tped_open_range.argtypes = [ctypes.c_char_p, ctypes.c_char,
                                           ctypes.c_int, ctypes.c_int64,
                                           ctypes.c_int64]
        lib.gt_tped_nind_total.restype = ctypes.c_int64
        lib.gt_tped_nind_total.argtypes = [ctypes.c_void_p]
        lib.gt_tped_col0.restype = ctypes.c_int64
        lib.gt_tped_col0.argtypes = [ctypes.c_void_p]
        lib.gt_tped_copy_counts.restype = ctypes.c_int
        lib.gt_tped_copy_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        lib.gt_tped_nchrom.restype = ctypes.c_int
        lib.gt_tped_nchrom.argtypes = [ctypes.c_void_p]
        lib.gt_tped_nind.restype = ctypes.c_int64
        lib.gt_tped_nind.argtypes = [ctypes.c_void_p]
        lib.gt_tped_nloci.restype = ctypes.c_int64
        lib.gt_tped_nloci.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gt_tped_chrom_name.restype = ctypes.c_char_p
        lib.gt_tped_chrom_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gt_tped_names_size.restype = ctypes.c_int64
        lib.gt_tped_names_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gt_tped_copy.restype = None
        lib.gt_tped_copy.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p]
        lib.gt_tped_close.restype = None
        lib.gt_tped_close.argtypes = [ctypes.c_void_p]
        lib.gt_tped_copy_2bit.restype = None
        lib.gt_tped_copy_2bit.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p]
        lib.gt_gsl_sd.restype = ctypes.c_double
        lib.gt_gsl_sd.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64]
        lib.gt_lod_windows_exact.restype = None
        lib.gt_lod_windows_exact.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_write_freq_chrom.restype = ctypes.c_int
        lib.gt_write_freq_chrom.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.gt_read_freq.restype = ctypes.c_int
        lib.gt_read_freq.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_lod_windows_exact_tbl.restype = None
        lib.gt_lod_windows_exact_tbl.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
        lib.gt_lod_windows_exact_thin.restype = None
        lib.gt_lod_windows_exact_thin.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_filter_columns.restype = ctypes.c_int64
        lib.gt_filter_columns.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.gt_covered_pack.restype = None
        lib.gt_covered_pack.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.gt_hash128.restype = None
        lib.gt_hash128.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_uint64)]
        lib.gt_pack_2bit_padded.restype = None
        lib.gt_pack_2bit_padded.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int64]
        lib.gt_filter_pack_2bit.restype = ctypes.c_int64
        lib.gt_filter_pack_2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
        lib.gt_unpack_2bit.restype = None
        lib.gt_unpack_2bit.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int8)]
        lib.gt_set_threads.restype = None
        lib.gt_set_threads.argtypes = [ctypes.c_int]
        lib.gt_assemble_runs.restype = ctypes.c_int64
        lib.gt_assemble_runs.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.gt_tgls_open.restype = ctypes.c_void_p
        lib.gt_tgls_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.gt_tgls_dict.restype = ctypes.c_int
        lib.gt_tgls_dict.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_nrows.restype = ctypes.c_int64
        lib.gt_tgls_nrows.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_nlut.restype = ctypes.c_int64
        lib.gt_tgls_nlut.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_bad_row.restype = ctypes.c_int64
        lib.gt_tgls_bad_row.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_bad_cols.restype = ctypes.c_int64
        lib.gt_tgls_bad_cols.argtypes = [ctypes.c_void_p]
        lib.gt_tgls_get_lut.restype = None
        lib.gt_tgls_get_lut.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_double)]
        lib.gt_tgls_copy_codes.restype = None
        lib.gt_tgls_copy_codes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gt_tgls_copy_vals.restype = None
        lib.gt_tgls_copy_vals.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.gt_tgls_close.restype = None
        lib.gt_tgls_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_tgls_native(path: str, nind: int, row_counts):
    """Parse a TGLS file via the C++ reader (chunked gz + parallel
    tokenize + token dictionary; reference: readTGLSData,
    src/garlic-data.cpp:1516-1586).  Returns None when the file cannot
    be opened (the caller's Python reader then gives the reference's
    error).  Otherwise one of:

      {"bad_cols": N} — the first row the reference would read had N
         columns instead of nind+4 (a truncated file reads as 0, like
         the Python reader's ''.split()).
      {"mode": "codes", "lut": f64 [K] raw token values,
       "chroms": [u8 [nind, L] code matrices]} — dictionary mode.
      {"mode": "vals", "chroms": [f64 [nind, L]]} — fallback (the file
         has > 255 distinct tokens or tokens > 16 chars).

    Adapted from garlic_tpu/native/build.py:209: the native
    library is required."""
    lib = library()
    h = lib.gt_tgls_open(path.encode(), int(nind))
    if not h:
        return None
    try:
        needed = int(sum(int(x) for x in row_counts))
        bad_row = int(lib.gt_tgls_bad_row(h))
        nrows = int(lib.gt_tgls_nrows(h))
        if 0 <= bad_row < needed:
            return {"bad_cols": int(lib.gt_tgls_bad_cols(h))}
        if nrows < needed:
            return {"bad_cols": 0}
        out = []
        row0 = 0
        if lib.gt_tgls_dict(h):
            k = int(lib.gt_tgls_nlut(h))
            lut = np.empty(k, dtype=np.float64)
            lib.gt_tgls_get_lut(
                h, lut.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            for L in row_counts:
                codes = np.empty((int(nind), int(L)), dtype=np.uint8)
                lib.gt_tgls_copy_codes(
                    h, row0, int(L),
                    codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
                out.append(codes)
                row0 += int(L)
            return {"mode": "codes", "lut": lut, "chroms": out}
        for L in row_counts:
            vals = np.empty((int(nind), int(L)), dtype=np.float64)
            lib.gt_tgls_copy_vals(
                h, row0, int(L),
                vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
            out.append(vals)
            row0 += int(L)
        return {"mode": "vals", "chroms": out}
    finally:
        lib.gt_tgls_close(h)


def filter_pack_2bit_native(packed: np.ndarray, L: int, keep: np.ndarray):
    """Column-compact a packed [I, rb] genotype matrix by keep[L]; returns
    ([I, ceil(nkeep/4)] u8, nkeep).

    Adapted from garlic_tpu/native/build.py:264: the native
    library is required."""
    lib = library()
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    I, rb = p.shape
    k = np.ascontiguousarray(keep, dtype=np.uint8)
    nkeep = int(np.count_nonzero(k))
    rb_out = max((nkeep + 3) // 4, 1)
    out = np.empty((I, rb_out), dtype=np.uint8)
    lib.gt_filter_pack_2bit(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I, L, rb,
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rb_out)
    return out, nkeep


def unpack_2bit_native(packed: np.ndarray, L: int):
    """[I, row_bytes] u8 2-bit codes -> [I, L] int8 (0/1/2/-9) in one C++
    pass.

    Adapted from garlic_tpu/native/build.py:326: the native
    library is required."""
    lib = library()
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    I, rb = p.shape
    out = np.empty((I, L), dtype=np.int8)
    lib.gt_unpack_2bit(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I, L, rb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def gsl_sd_native(x: np.ndarray) -> Optional[float]:
    """gsl_stats_sd with GSL's exact FP semantics (80-bit x87 running-mean
    recurrences; see gt_gsl_sd) — the reference's nrd0 bandwidth input
    (src/garlic-kde.cpp:130-140).

    Adapted from garlic_tpu/native/build.py:341: the native
    library is required."""
    lib = library()
    x = np.ascontiguousarray(x, dtype=np.float64)
    if x.shape[0] < 2:
        return 0.0
    return float(lib.gt_gsl_sd(x, x.shape[0]))


def set_native_threads(n: int) -> None:
    """Cap the native library's OpenMP fan-out at n workers (--threads N,
    matching the reference's fixed thread count, src/garlic-roh.cpp:184-194).
    No-op when n <= 0.

    Adapted from garlic_tpu/native/build.py:354: the native
    library is required."""
    if n > 0:
        library().gt_set_threads(int(n))


def parse_tped_native(path: str, missing: str, want_fc: bool = False,
                      col_range=None) -> Optional[List[dict]]:
    """Parse a TPED via the C++ parser.  Returns per-chromosome dicts;
    raises IOError on a file the parser rejects (the caller's Python
    reader then gives the reference's error).
    Unphased (want_fc=False): genotypes emitted straight as 2-bit codes
    (fused transpose+pack, the int8 matrix never exists; want_packed=True
    there).  Phased (want_fc=True): int8 genotypes and the first-copy
    bits (want_fc=True, want_packed=False there).
    col_range=(col0, col1) stores only that genotype column slice
    (per-host sharded input): allele coding stays full-row exact and each
    chromosome dict additionally carries partial 'freq_num'/'freq_den'
    count planes over the stored range plus 'nind_total'/'row0'.

    Adapted from garlic_tpu/native/build.py:369: the two genotype forms
    chosen by want_fc alone."""
    lib = library()
    if col_range is None:
        h = lib.gt_tped_open(path.encode(), missing.encode()[0:1] or b"0",
                             1 if want_fc else 0)
    else:
        h = lib.gt_tped_open_range(
            path.encode(), missing.encode()[0:1] or b"0",
            1 if want_fc else 0, int(col_range[0]), int(col_range[1]))
    if not h:
        raise IOError(f"native TPED parse failed for {path}")
    try:
        nchrom = lib.gt_tped_nchrom(h)
        nind = lib.gt_tped_nind(h)
        nind_total = lib.gt_tped_nind_total(h)
        row0 = lib.gt_tped_col0(h)
        out = []
        for c in range(nchrom):
            L = lib.gt_tped_nloci(h, c)
            name = lib.gt_tped_chrom_name(h, c).decode()
            nsz = lib.gt_tped_names_size(h, c)
            positions = np.empty(L, dtype=np.int64)
            gpos = np.empty(L, dtype=np.float64)
            alleles = np.empty(L, dtype="S1")
            freq = np.empty(L, dtype=np.float64)
            names_buf = ctypes.create_string_buffer(int(nsz) + 1)
            geno = geno2b = fc = None
            if want_fc:
                geno = np.empty((nind, L), dtype=np.int8)
                fc = np.empty((nind, L), dtype=np.uint8)
                lib.gt_tped_copy(
                    h, c,
                    positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    gpos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    alleles.ctypes.data_as(ctypes.c_char_p),
                    geno.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                    fc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    names_buf)
            else:
                rb = (int(L) + 3) // 4
                geno2b = np.empty((nind, rb), dtype=np.uint8)
                lib.gt_tped_copy_2bit(
                    h, c,
                    positions.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    gpos.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    alleles.ctypes.data_as(ctypes.c_char_p),
                    geno2b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    rb,
                    freq.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    names_buf)
            fnum = fden = None
            if col_range is not None:
                fnum = np.empty(L, dtype=np.float64)
                fden = np.empty(L, dtype=np.float64)
                ok = lib.gt_tped_copy_counts(
                    h, c,
                    fnum.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                    fden.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
                if not ok:
                    fnum = fden = None
            from ..core.types import LocusNames
            out.append({
                "chrom": name,
                "positions": positions,
                "gpos": gpos,
                "alleles": alleles.astype("<U1"),
                "genotypes": geno,
                "geno2b": geno2b,
                "first_copy": fc.view(np.bool_) if fc is not None else None,
                "freq": freq,
                "freq_num": fnum,
                "freq_den": fden,
                "nind_total": int(nind_total),
                "row0": int(row0),
                "names": LocusNames(names_buf.raw[:nsz]),
            })
        return out
    finally:
        lib.gt_tped_close(h)


def pack_2bit_padded_native(geno: np.ndarray, I2: int, L2: int):
    """Fused pad+pack: [I, L] int8 (rows may be strided views) ->
    [I2, L2/4] u8 2-bit codes with missing padding.

    Adapted from garlic_tpu/native/build.py:471: the native
    library is required."""
    lib = library()
    I, L = geno.shape
    if geno.strides[1] != 1:
        geno = np.ascontiguousarray(geno)
    row_stride = geno.strides[0]
    out = np.empty((I2, L2 // 4), dtype=np.uint8)
    lib.gt_pack_2bit_padded(
        geno.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), I, L,
        row_stride,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), I2, L2 // 4)
    return out


def covered_pack_native(win: np.ndarray, winsize: int, cutoff: float,
                        threshold: float):
    """One-pass coverage+threshold+packbits over a f64 [I, L] window
    matrix.

    Adapted from garlic_tpu/native/build.py:489: the native
    library is required."""
    lib = library()
    w = np.ascontiguousarray(win, dtype=np.float64)
    I, L = w.shape
    row_bytes = (L + 7) // 8
    out = np.empty((I, row_bytes), dtype=np.uint8)
    lib.gt_covered_pack(
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), I, L, winsize,
        float(cutoff), float(threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), row_bytes)
    return out


def filter_columns_native(arr: np.ndarray, keep: np.ndarray):
    """In-place column compaction; returns a [:, :nkeep] view, or None
    when arr [I, L] is not C-contiguous.

    Adapted from garlic_tpu/native/build.py:507: the native
    library is required."""
    lib = library()
    if not arr.flags.c_contiguous:
        return None
    keep_u8 = np.ascontiguousarray(keep, dtype=np.uint8)
    I, L = arr.shape
    nkeep = lib.gt_filter_columns(
        arr.ctypes.data_as(ctypes.c_void_p), I, L, arr.itemsize,
        keep_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return arr[:, :nkeep]


def hash128_native(arr: np.ndarray) -> Optional[bytes]:
    """16-byte content digest of a C-contiguous array (OpenMP chunked
    mixing, ~memory-bandwidth speed), or None when arr is not.

    Adapted from garlic_tpu/native/build.py:521: the native
    library is required."""
    lib = library()
    if not arr.flags.c_contiguous:
        return None
    out = (ctypes.c_uint64 * 2)()
    lib.gt_hash128(arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes, out)
    return bytes(out)


def read_freq_native(path: str, names_raw: bytes, alleles: np.ndarray,
                     nloci: int) -> "np.ndarray | None":
    """Happy-path freq-file parse (5-column validation, locus-name match,
    allele flip); None on any anomaly — the caller falls
    back to the Python reader, whose error text matches the reference.

    Adapted from garlic_tpu/native/build.py:532: the native
    library is required."""
    lib = library()
    al = np.ascontiguousarray(alleles.astype("S1"))
    out = np.empty(nloci, dtype=np.float64)
    rc = lib.gt_read_freq(
        path.encode(), names_raw, len(names_raw),
        al.ctypes.data_as(ctypes.c_char_p), nloci,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out if rc == 0 else None


def write_freq_chrom_native(path: str, append: bool, chrom: str,
                            names: List[str], positions: np.ndarray,
                            alleles: np.ndarray, freq: np.ndarray) -> None:
    """Append one chromosome to the gz freq file; raises IOError when
    the write fails.

    Adapted from garlic_tpu/native/build.py:549: the native
    library is required."""
    lib = library()
    names_raw = names.raw if hasattr(names, "raw") else \
        "\n".join(names).encode()
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    al = np.ascontiguousarray(alleles.astype("S1"))
    fr = np.ascontiguousarray(freq, dtype=np.float64)
    rc = lib.gt_write_freq_chrom(
        path.encode(), 1 if append else 0, chrom.encode(), names_raw,
        len(names_raw),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        al.ctypes.data_as(ctypes.c_char_p),
        fr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pos.shape[0])
    if rc != 0:
        raise IOError(f"native freq write failed for {path}")


def assemble_runs_native(covered_packed: np.ndarray, br: np.ndarray,
                         positions: np.ndarray, gpos: np.ndarray,
                         threshold: float, cm: bool):
    """ROH runs for one chromosome from bit-packed coverage.

    Returns (ind[int32], start[i64], stop[i64], size[f64]) in individual-major
    order.

    Adapted from garlic_tpu/native/build.py:574: the native
    library is required."""
    lib = library()
    cp = np.ascontiguousarray(covered_packed, dtype=np.uint8)
    I, row_bytes = cp.shape
    brr = np.ascontiguousarray(br, dtype=np.uint8)
    pos = np.ascontiguousarray(positions, dtype=np.int64)
    gp = np.ascontiguousarray(gpos, dtype=np.float64)
    L = pos.shape[0]
    cap = max(1024, I * 64)
    while True:
        out_ind = np.empty(cap, dtype=np.int32)
        out_start = np.empty(cap, dtype=np.int64)
        out_stop = np.empty(cap, dtype=np.int64)
        out_size = np.empty(cap, dtype=np.float64)
        n = lib.gt_assemble_runs(
            cp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), row_bytes,
            brr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            gp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            I, L, float(threshold), 1 if cm else 0,
            out_ind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_stop.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out_size.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
        if n < 0:
            cap = -n
            continue
        return (out_ind[:n], out_start[:n], out_stop[:n], out_size[:n])


def lod_windows_exact_tbl_native(geno: np.ndarray, table: np.ndarray,
                                 missing: np.ndarray,
                                 winsize: int) -> Optional[np.ndarray]:
    """Exact f64 rolling LOD straight from genotypes + a [4, L] per-locus
    table (row 3 = missing = 0); skips materializing the [I, L] terms
    matrix.

    Adapted from garlic_tpu/native/build.py:612: the native
    library is required."""
    from ..core.types import MISSING
    lib = library()
    g = np.ascontiguousarray(geno, dtype=np.int8)
    t = np.ascontiguousarray(table, dtype=np.float64)
    I, L = g.shape
    assert t.shape == (4, L)
    nwin = max(L - winsize + 1, 0)
    miss = np.ascontiguousarray(missing, dtype=np.uint8)
    if miss.shape[0] < nwin:
        raise ValueError("missing mask too short")
    win = np.empty((I, L), dtype=np.float64)
    lib.gt_lod_windows_exact_tbl(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        I, L, winsize, float(MISSING),
        win.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return win


def lod_windows_exact_thin_native(geno: np.ndarray, table: np.ndarray,
                                  missing: np.ndarray, winsize: int,
                                  step: int) -> "Optional[np.ndarray]":
    """Thinned exact f64 rolling LOD: the identical rolling recurrence as
    lod_windows_exact_tbl_native, writing only columns 0, step, 2*step...
    -> [I, ceil(L/step)] (== win[:, ::step]); the full [I, L] matrix
    never exists.

    Adapted from garlic_tpu/native/build.py:639: the native
    library is required."""
    from ..core.types import MISSING
    lib = library()
    g = np.ascontiguousarray(geno, dtype=np.int8)
    t = np.ascontiguousarray(table, dtype=np.float64)
    I, L = g.shape
    assert t.shape == (4, L)
    nwin = max(L - winsize + 1, 0)
    miss = np.ascontiguousarray(missing, dtype=np.uint8)
    if miss.shape[0] < nwin:
        raise ValueError("missing mask too short")
    nthin = -(-L // step)
    out = np.empty((I, nthin), dtype=np.float64)
    lib.gt_lod_windows_exact_thin(
        g.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        I, L, winsize, step, float(MISSING),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def lod_windows_exact_native(terms: np.ndarray, missing: np.ndarray,
                             winsize: int) -> np.ndarray:
    """Adapted from garlic_tpu/native/build.py:670: the native
    library is required."""
    from ..core.types import MISSING
    lib = library()
    terms = np.ascontiguousarray(terms, dtype=np.float64)
    I, L = terms.shape
    nwin = max(L - winsize + 1, 0)
    miss = np.ascontiguousarray(missing, dtype=np.uint8)
    if miss.shape[0] < nwin:
        raise ValueError("missing mask too short")
    win = np.empty((I, L), dtype=np.float64)
    lib.gt_lod_windows_exact(
        terms.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        miss.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        I, L, winsize, float(MISSING),
        win.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return win

