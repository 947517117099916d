"""Build and bind the CUDA kernels in garlic_tpu_torch/csrc.

nvcc compiles every source under csrc/ into one shared library with a
plain C interface, for sm_90a, into <repo>/build/garlic_tpu_torch/ at
first use: one nvcc per .cu file, all started together, then one link;
the file name carries a hash of the sources and flags, so an edited
source builds anew and an unchanged one loads the existing file.
The library is loaded with ctypes.  Nothing here runs at import time: the
CPU tests import the port without nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "garlic_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's nvcc run (None: loaded)


class BuildError(RuntimeError):
    pass


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise BuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                         "/usr/local/cuda/bin)")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"liblod_windows_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Runs the commands side by side; raises BuildError with the first
    failure's stderr.  Returns their stdout + stderr texts."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise BuildError(f"nvcc failed ({p.returncode}): {' '.join(c)}"
                             f"\n{err}")
    return [out + err for out, err in outs]


def _compile(so: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cus]
    t0 = time.perf_counter()
    try:
        logs = _run_all([[_nvcc()] + NVCC_FLAGS + ["-c", "-o", o, c]
                         for c, o in zip(cus, objs)])
        logs += _run_all([[_nvcc(), "-shared", "-o", tmp] + objs])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    # ptxas' register / shared-memory report, kept beside the library
    with open(so[:-3] + ".log", "w") as f:
        f.write("".join(logs))
    os.replace(tmp, so)  # atomic: concurrent builders never see half a file


def library() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises BuildError with
    nvcc's stderr when the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gt_lod_windows.argtypes = [i, p, p, p, p, i, i, i, i, p]
        lib.gt_lod_windows.restype = i
        lib.gt_covered.argtypes = [i, p, p, p, p, p, p, i, i, i, i,
                                   fl, fl, fl, p]
        lib.gt_covered.restype = i
        lib.gt_window_sums.argtypes = [i, p, p, p, i, i, i, p]
        lib.gt_window_sums.restype = i
        lib.gt_covered_terms.argtypes = [i, p, p, p, p, p, i, i, i,
                                         fl, fl, fl, p]
        lib.gt_covered_terms.restype = i
        lib.gt_resident_warps.argtypes = [i, i, i]
        lib.gt_resident_warps.restype = i
        lib.gt_pair_counts.argtypes = [i, p, p, p, p, i, i, i, i, i, i, p]
        lib.gt_pair_counts.restype = i
        lib.gt_wlod_windows.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i,
                                        i, p]
        lib.gt_wlod_windows.restype = i
        lib.gt_wlod_windows_terms.argtypes = [i, p, p, p, p, p, i, i, i, i,
                                              i, p]
        lib.gt_wlod_windows_terms.restype = i
        d, ll = ctypes.c_double, ctypes.c_longlong
        lib.gt_gauss_sums.argtypes = [i, p, p, fl, i, i, p, i, p, i, p, p, p,
                                      p, p]
        lib.gt_gauss_sums.restype = i
        u = ctypes.c_uint
        lib.gt_expf_underflow.argtypes = [i, u, u, p, p]
        lib.gt_expf_underflow.restype = i
        lib.gt_gmm_em_scratch.argtypes = [i, i, i, i]
        lib.gt_gmm_em_scratch.restype = ll
        lib.gt_gmm_em_path.argtypes = [i, i, i, i]
        lib.gt_gmm_em_path.restype = i
        lib.gt_gmm_em.argtypes = [i, p, i, i, d, p, p, p, p, p, i, d, d, i,
                                  i, p]
        lib.gt_gmm_em.restype = i
        lib.gt_compact_2bit.argtypes = [i, p, ll, ll, p, p, p, i, i, i, p]
        lib.gt_compact_2bit.restype = i
        lib.gt_exact_pool.argtypes = [i, p, i, i, i, i, d, p, p]
        lib.gt_exact_pool.restype = i
        lib.gt_dadd_chain.argtypes = [i, p, ll, p, p]
        lib.gt_dadd_chain.restype = i
        _lib = lib
        return lib


def ptxas_report() -> str:
    """nvcc's -Xptxas -v output for the current library ('' before a
    build in this checkout)."""
    log = library_path()[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()
