"""Phase IV: the size classes from a Gaussian mixture fitted by EM.

Counterpart of garlic_tpu/ops/gmm.py.  The host EM (fit_gmm), GMMResult,
the %g guard (_g_format_stable) and the host path of selectSizeClasses
are copies of garlic_tpu's (each names its source line; the boundary
root finder is ops/brent.py); what moves to the device is the EM loop
that garlic_tpu runs as an f64 lax.while_loop on a mesh
(fit_gmm_sharded, parallel/engine.py:309-443), here fit_em over the
shards of the fast engine's mesh: on one CUDA device of one process the
whole loop is one launch of the hand kernel K8 (csrc/kde_gmm.cu, fit
mode); over several shards or processes a host loop whose E-steps are
K8 in stats mode on CUDA shards; on the CPU the plain loop (fit_em_plain
over _em_stats, K8's plain versions, which chip_smoke.py also holds K8
to on the card).  K8's launches count in cuda_lod.LAUNCHES["gmm_em"].
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import span, to_device, to_host, waiting
from . import _build
from .cuda_lod import _launch

# garlic_tpu/ops/gmm.py:23 (-0.5 * np.log(2.0 * np.pi), the same double)
_LOG2PI_C = -0.5 * math.log(2.0 * math.pi)


@dataclass
class GMMResult:
    """Copy of garlic_tpu/ops/gmm.py:27."""
    weights: np.ndarray   # [K] mixture coefficients
    means: np.ndarray     # [K]
    variances: np.ndarray  # [K]
    loglikelihood: float
    bic: float
    converged: bool
    iterations: int


def gmm_sufficient_stats(x: np.ndarray, w: np.ndarray, mu: np.ndarray,
                         var: np.ndarray):
    """One E-step over data x -> (sum_wj, sum_wj_xj, sum_wj_xj2, loglik).

    Matches GMM::update's math (src/gmm.cpp:276-331): log responsibilities
    log(a_k) + normalLog, logsumexp per point, an extra normalization by the
    (==1) sum of responsibilities, then weighted moment sums.

    Copy of garlic_tpu/ops/gmm.py:37."""
    with np.errstate(divide="ignore", invalid="ignore"):
        lw = np.log(w)[None, :]                              # [1,K]
        lv = np.log(var)[None, :]
        d = x[:, None] - mu[None, :]                         # [N,K]
        logp = lw + (_LOG2PI_C - 0.5 * lv - (d * d) / (2.0 * var[None, :]))
    lmax = np.max(logp, axis=1, keepdims=True)
    tmp = lmax[:, 0] + np.log(np.sum(np.exp(logp - lmax), axis=1))
    loglik = float(np.sum(tmp))
    resp = np.exp(logp - tmp[:, None])                       # [N,K]
    den = np.sum(resp, axis=1, keepdims=True)
    r = resp / den
    sum_wj = r.sum(axis=0)
    sum_wj_xj = (x[:, None] * r).sum(axis=0)
    sum_wj_xj2 = ((x * x)[:, None] * r).sum(axis=0)
    return sum_wj, sum_wj_xj, sum_wj_xj2, loglik


def fit_gmm(x: np.ndarray, k: int, w0: np.ndarray, mu0: np.ndarray,
            var0: np.ndarray, max_iter: int = 1000, precision: float = 1e-5,
            verbose: bool = False) -> GMMResult:
    """Copy of garlic_tpu/ops/gmm.py:61."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    w, mu, var = w0.copy(), mu0.copy(), var0.copy()
    last_ll = -np.finfo(np.float64).max
    ll = last_ll
    bic = np.finfo(np.float64).max
    converged = False
    if verbose:
        print(f"Begin GMM estimation with k = {k} Gaussians...", file=sys.stderr)
    it = 0
    for it in range(1, max_iter + 1):
        s_w, s_wx, s_wx2, ll = gmm_sufficient_stats(x, w, mu, var)
        with np.errstate(divide="ignore", invalid="ignore"):
            w = s_w / float(n)
            mu = s_wx / s_w
            var = s_wx2 / s_w - mu * mu
        if not np.all(np.isfinite(mu)) or not np.all(np.isfinite(var)):
            raise FloatingPointError(
                "GMM component collapsed (non-finite parameters)")
        bic = -2.0 * ll + (3.0 * k - 1) * np.log(n)
        if abs(ll - last_ll) <= precision:
            converged = True
            break
        last_ll = ll
    return GMMResult(weights=w, means=mu, variances=var, loglikelihood=ll,
                     bic=float(bic), converged=converged, iterations=it)


def _g_format_stable(res: "GMMResult", rel: float = 3e-12) -> bool:
    """True when every logged GMM parameter formats to the same %g string
    under a +-rel relative perturbation — i.e. no parameter sits within
    the calibrated device-vs-host EM deviation (~1e-13 relative, margin
    here 3e-12) of a %g rounding boundary, so the device fit's .log lines
    are guaranteed byte-identical to the host fit's.

    Copy of garlic_tpu/ops/gmm.py:92."""
    from ..core.fmt import g
    for arr in (res.weights, res.means, res.variances):
        for v in arr:
            v = float(v)
            d = abs(v) * rel
            if g(v + d) != g(v) or g(v - d) != g(v):
                return False
    return True



def _em_stats(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
              var: torch.Tensor) -> torch.Tensor:
    """One E-step, packed [s0 (K), s1 (K), s2 (K), loglik]: GMM::update's
    math (src/gmm.cpp:276-331) in the op order of
    garlic_tpu.ops.gmm.gmm_sufficient_stats.  All four are sums over the
    points, so a caller holding a shard of x sums the packed vector over
    its shards (one all-reduce) and gets the whole panel's statistics.
    The plain version of K8's stats mode."""
    lw = torch.log(w)[None, :]
    lv = torch.log(var)[None, :]
    d = x[:, None] - mu[None, :]
    logp = lw + (_LOG2PI_C - 0.5 * lv - (d * d) / (2.0 * var[None, :]))
    lmax = logp.max(dim=1, keepdim=True).values
    tmp = lmax[:, 0] + torch.log(torch.exp(logp - lmax).sum(dim=1))
    resp = torch.exp(logp - tmp[:, None])
    r = resp / resp.sum(dim=1, keepdim=True)
    return torch.cat([r.sum(dim=0), (x[:, None] * r).sum(dim=0),
                      ((x * x)[:, None] * r).sum(dim=0), tmp.sum()[None]])


# K8's launch paths (csrc/kde_gmm.cu gt_gmm_em): 0 lets the kernel choose
# (em_auto_path: one cluster where N x the lanes a point takes fit in its
# threads, else the grid-wide launch)
EM_PATHS = {"auto": 0, "cluster": 1, "grid": 2}
_em_scratch = {}  # (device index, N, K, path) -> doubles of scratch


def em_path(device, N: int, K: int, path: str = "auto"):
    """(path, blocks, points resident, lanes a point) K8 takes for N
    points and K components on a CUDA device: path "cluster" or
    "grid"."""
    dev = torch.device(device)
    with torch.cuda.device(dev):
        got = _build.library().gt_gmm_em_path(dev.index, N, K,
                                               EM_PATHS[path])
    if got < 0:
        raise RuntimeError(f"gt_gmm_em_path failed: CUDA error {-got}")
    return (("cluster", "grid")[got % 4 - 1], got % 4096 // 4,
            bool(got // 4096 % 2), got // 8192)


def _em_launch(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
               var: torch.Tensor, out: torch.Tensor, fit: bool,
               n: float = 0.0, max_iter: int = 0,
               precision: float = 0.0, path: str = "auto") -> None:
    """One launch of K8 (gt_gmm_em, csrc/kde_gmm.cu) over the f64 points
    x with the f64 [K] parameters w, mu, var, all on one CUDA device,
    into out; raises on a launch error.  The launch shape is the
    library's, cached per (device, N, K, path); scratch is allocated only
    where the shape needs it (the grid-wide launch's partials)."""
    k = int(w.shape[0])
    for t in (x, w, mu, var, out):
        if t.dtype != torch.float64 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError("K8 takes contiguous 1-D float64 tensors")
        if t.device != x.device or x.device.type != "cuda":
            raise ValueError("K8's tensors must lie on one CUDA device")
    if tuple(mu.shape) != (k,) or tuple(var.shape) != (k,) or k < 1:
        raise ValueError("w, mu and var must share one shape [K], K >= 1")
    N = int(x.shape[0])
    if N < 1:
        raise ValueError("K8 needs at least one point")
    dev = x.device
    key = (dev.index, N, k, path)
    need = _em_scratch.get(key)
    if need is None:
        with torch.cuda.device(dev):
            need = _build.library().gt_gmm_em_scratch(dev.index, N, k,
                                                      EM_PATHS[path])
        if need < 0:
            raise RuntimeError(f"gt_gmm_em_scratch failed: CUDA error "
                               f"{-need}")
        _em_scratch[key] = need
    scratch = (torch.empty(need, dtype=torch.float64, device=dev)
               if need else None)
    _launch("gt_gmm_em", "gmm_em", dev, x.data_ptr(), N, k, float(n),
            w.data_ptr(), mu.data_ptr(), var.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), int(max_iter), float(precision), _LOG2PI_C,
            int(fit), EM_PATHS[path])


def em_stats(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
             var: torch.Tensor) -> torch.Tensor:
    """_em_stats's packed sums: its plain version on a CPU tensor, K8 in
    stats mode on a CUDA tensor (the sums in the kernel's fixed order)."""
    if x.device.type == "cpu":
        return _em_stats(x, w, mu, var)
    out = torch.empty(3 * int(w.shape[0]) + 1, dtype=torch.float64,
                      device=x.device)
    _em_launch(x, w, mu, var, out, fit=False)
    return out


def _em_result(w, mu, var, ll: float, done: bool, it: int, k: int,
               n: int) -> GMMResult:
    if not (np.all(np.isfinite(mu)) and np.all(np.isfinite(var))):
        raise FloatingPointError(
            "GMM component collapsed (non-finite parameters)")
    bic = -2.0 * ll + (3.0 * k - 1) * np.log(n)
    return GMMResult(weights=w, means=mu, variances=var, loglikelihood=ll,
                     bic=float(bic), converged=done, iterations=it)


def _em_loop(stats, shards, k: int, w0, mu0, var0, device, max_iter: int,
             precision: float, n: int, reduce) -> GMMResult:
    """fit_em's loop, each shard's E-step by stats (see fit_em)."""
    w, mu, var = (to_device(torch.from_numpy(np.array(a, dtype=np.float64)),
                            device) for a in (w0, mu0, var0))
    last_ll = ll = -np.finfo(np.float64).max
    it, done = 0, False
    while not done and it < max_iter:
        parts = [stats(x, w.to(x.device), mu.to(x.device), var.to(x.device))
                 for x in shards]
        s = None
        for part in (reduce(parts) if reduce is not None
                     else [p.to(device) for p in parts]):
            s = part if s is None else s + part
        s0, s1, s2 = s[:k], s[k:2 * k], s[2 * k:3 * k]
        w, mu = s0 / float(n), s1 / s0
        var = s2 / s0 - mu * mu
        finite = torch.isfinite(mu).all() & torch.isfinite(var).all()
        with waiting(s):
            ll, ok = torch.stack([s[3 * k],
                                  finite.to(torch.float64)]).tolist()
        conv = abs(ll - last_ll) <= precision
        done = conv or not ok
        if not done:
            last_ll = ll
        it += 1
    w, mu, var = (to_host(a) for a in (w, mu, var))
    return _em_result(w, mu, var, ll, done, it, k, n)


def fit_em_plain(shards, k: int, w0: np.ndarray, mu0: np.ndarray,
                 var0: np.ndarray, device, max_iter: int = 1000,
                 precision: float = 1e-5, n: int = None,
                 reduce=None) -> GMMResult:
    """fit_em with the plain E-step (_em_stats) on every device: the plain
    version of K8 (the loop a CPU run takes, and what chip_smoke.py holds
    K8's fit mode to on the card)."""
    if n is None:
        n = sum(int(x.shape[0]) for x in shards)
    return _em_loop(_em_stats, shards, k, w0, mu0, var0, device, max_iter,
                    precision, n, reduce)


def fit_em(shards, k: int, w0: np.ndarray, mu0: np.ndarray,
           var0: np.ndarray, device, max_iter: int = 1000,
           precision: float = 1e-5, n: int = None,
           reduce=None, processes: int = 1) -> GMMResult:
    """GMM-EM in f64 over the f64 tensors `shards` (the points, split over
    devices), the parameters on `device`.

    Each iteration is one fused E+M pass: every shard's packed E-step
    sums (em_stats: the plain _em_stats on a CPU shard, K8 in stats mode
    on a CUDA one) are added on `device` in shard order, and one host
    read takes the log-likelihood and a finiteness flag of the new
    parameters.  The loop stops on |ll - last_ll| <= precision (conv),
    on non-finite parameters (bad, raised below) or at max_iter, and
    last_ll keeps its value on the iteration that stops, as the
    while_loop's carry of garlic_tpu/parallel/engine.py:374-397 does.
    One process holding one CUDA shard (the 1x1 mesh's run): the whole
    loop runs in one launch of K8 in fit mode, with the same semantics,
    and the host reads the fit once.
    n: the number of points (the shards' when None); reduce: maps the
    shards' sums to every shard's of the run, in order and on `device`
    (a run over several processes holds only its own shards; None: the
    shards' own sums); processes: the number of processes the run's
    shards are split over."""
    if n is None:
        n = sum(int(x.shape[0]) for x in shards)
    if (processes == 1 and len(shards) == 1
            and shards[0].device.type == "cuda"):
        x = shards[0]
        w, mu, var = (to_device(torch.from_numpy(
            np.array(a, dtype=np.float64)), x.device) for a in (w0, mu0, var0))
        out = torch.empty(3 * k + 4, dtype=torch.float64, device=x.device)
        _em_launch(x, w, mu, var, out, fit=True, n=n, max_iter=max_iter,
                   precision=precision)
        got = to_host(out)
        return _em_result(got[:k].copy(), got[k:2 * k].copy(),
                          got[2 * k:3 * k].copy(), float(got[3 * k]),
                          bool(got[3 * k + 2]), int(got[3 * k + 1]), k, n)
    return _em_loop(em_stats, shards, k, w0, mu0, var0, device, max_iter,
                    precision, n, reduce)


# copy of garlic_tpu/ops/gmm.py:127 with the device EM of fit_gmm_sharded
def select_size_classes(lengths: np.ndarray, nclust: int, log=None,
                        mesh=None):
    """selectSizeClasses (src/garlic-roh.cpp:935-1003): fit the GMM, sort
    the components by mean, log their parameters, then root-find the K-1
    pairwise Gaussian intersections as the size-class boundaries.

    mesh: the fast engine's parallel.mesh.Mesh.  garlic_tpu's rule picks
    the EM: over a mesh of several devices it runs there at every size,
    as its --tpu-mesh runs do; over one device (the 1x1 mesh) at >= 4096
    ROH (parallel.engine.fit_gmm_sharded).  A device fit with a logged
    parameter near a %g rounding boundary is rerun on the host
    (_g_format_stable), so the .log lines equal the host fit's.  None, or
    fewer ROH on one device: the host EM."""
    from .brent import find_boundary
    lengths = np.asarray(lengths, dtype=np.float64)
    var = float(np.var(lengths, ddof=1))
    mean = float(np.mean(lengths))
    k = nclust
    w0 = np.full(k, 1.0 / k)
    mu0 = np.array([mean * (n + 1) / (k + 1) for n in range(k)])
    var0 = np.array([var * (n + 1) / k for n in range(k)])
    with span("em"):
        if mesh is not None and (mesh.size > 1
                                 or lengths.shape[0] >= 4096):
            from ..parallel.engine import fit_gmm_sharded
            print(f"Begin GMM estimation with k = {k} Gaussians...",
                  file=sys.stderr)
            res = fit_gmm_sharded(lengths, k, w0, mu0, var0, mesh,
                                  max_iter=1000, precision=1e-5)
            if not _g_format_stable(res):
                res = fit_gmm(lengths, k, w0, mu0, var0, max_iter=1000,
                              precision=1e-5, verbose=False)
        else:
            res = fit_gmm(lengths, k, w0, mu0, var0, max_iter=1000,
                          precision=1e-5, verbose=True)
    order = np.argsort(res.means, kind="stable")
    size_class = "A"
    for i in range(k):
        j = order[i]
        if log is not None:
            log.log("Gaussian class", size_class, nl=False)
            log.log(" ( mixture, mean, std ) = (", float(res.weights[j]),
                    nl=False)
            log.log(",", float(res.means[j]), nl=False)
            log.log(",", float(res.variances[j]), nl=False)
            log.log(" )")
        size_class = chr(ord(size_class) + 1)
    bounds = []
    with span("roots"):
        for i in range(1, k):
            a, b = order[i - 1], order[i]
            bounds.append(find_boundary(
                res.means[a], res.variances[a], res.weights[a],
                res.means[b], res.variances[b], res.weights[b],
                max_iter=1000, epsabs=1e-4))
    return bounds, res
