"""Plain NumPy reference of one GARLIC v1.1.6a call, the benchmark's yardstick.

From a panel (panel.Panel: genotypes as copies of allele A) and the
call's flags it works out again everything a call derives: the allele
coding and frequencies, the monomorphic filter, the LOD terms, the
rolling window sums in GARLIC's order, the KDE subsample, the pooled
and thinned windows, the KDE, the cutoff, the coverage and the runs,
the Gaussian mixture and the size bounds, and the BED rows.  Written
from GARLIC's semantics (src/garlic-roh.cpp, src/garlic-kde.cpp,
src/gmm.cpp, src/BoundFinder.cpp, GSL's brent and gsl_stats_sd); it
imports nothing of the program under test.

`dtype` is the precision of every floating-point step: float64 is
GARLIC's; float32 is the benchmark's control (PERF.md), which has to
come out as not correct.

The default reference of a configuration (harness.reference_for): a
configuration's own, named by its "reference" key, has the same
parse(argv) and call(panel, argv, dt) and may import this module's
phases.  parse refuses a flag that changes a call's outputs and that the
reference does not implement (refuse_unread).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .centromeres import centromere

MISSING = -9999.0  # a missing window's score (src/garlic-data.h:24)
VERSION = "1.1.6a"  # GARLIC's version in the BED track lines
COLORS = ["228,26,28", "77,175,74", "55,126,184", "152,78,163",
          "255,127,0", "255,255,51", "166,86,40", "247,129,191",
          "153,153,153"]
DBL_MIN = 2.2250738585072014e-308
DBL_MAX = 1.7976931348623157e+308
DBL_EPS = 2.220446049250313e-16


def g(x: float) -> str:
    """A double as C++'s ostream prints it (printf %g)."""
    return f"{float(x):g}"


# the flags the reference implements; of the others it lets pass only
# those that leave a call's outputs as they are (the engine's --tpu-*,
# --threads, --out)
READS = frozenset({"--build", "--winsize", "--error", "--lod-cutoff",
                   "--size-bounds", "--nclust", "--kde-subsample",
                   "--tpu-seed", "--max-gap", "--overlap-frac"})
NEUTRAL = frozenset({"--threads", "--out"})


def flag_values(argv: List[str]) -> dict:
    """{flag: [its values]} of a call's flags."""
    kv, i = {}, 0
    while i < len(argv):
        name = argv[i]
        vals = []
        i += 1
        while i < len(argv) and not argv[i].startswith("--"):
            vals.append(argv[i])
            i += 1
        kv[name] = vals
    return kv


def refuse_unread(kv: dict, reads=READS) -> None:
    """Raises ValueError naming every flag of kv outside `reads` that
    can change a call's outputs: a reference that ignored one would
    judge the call against another call's outputs."""
    bad = [n for n in kv if n not in reads and n not in NEUTRAL
           and not n.startswith("--tpu-")]
    if bad:
        raise ValueError(f"the reference does not implement {' '.join(bad)}"
                         ": it cannot judge a call with them")


@dataclass
class Flags:
    """The flags of a call that the reference reads."""
    build: str
    winsize: int
    error: float
    lod_cutoff: Optional[float] = None   # None: automatic
    bounds: Optional[List[float]] = None  # None: automatic
    nclust: int = 3
    kde_subsample: int = 20
    seed: int = -1
    max_gap: int = 200000
    overlap_frac: float = 0.25

    @classmethod
    def parse(cls, argv: List[str]) -> "Flags":
        kv = flag_values(argv)
        refuse_unread(kv)
        f = cls(build=kv["--build"][0], winsize=int(kv["--winsize"][0]),
                error=float(kv["--error"][0]))
        if "--lod-cutoff" in kv:
            f.lod_cutoff = float(kv["--lod-cutoff"][0])
        if "--size-bounds" in kv:
            f.bounds = [float(v) for v in kv["--size-bounds"]]
        for key, attr, typ in (("--nclust", "nclust", int),
                               ("--kde-subsample", "kde_subsample", int),
                               ("--tpu-seed", "seed", int),
                               ("--max-gap", "max_gap", int),
                               ("--overlap-frac", "overlap_frac", float)):
            if key in kv:
                setattr(f, attr, typ(kv[key][0]))
        return f


@dataclass
class Call:
    """What a call produces: the BED's lines, and the cutoff and bounds
    it selected (None where pinned)."""
    bed: List[str]
    cutoff: Optional[float] = None
    bounds: Optional[List[float]] = None
    nroh: int = 0
    kde_points: int = 0


# ---------------------------------------------------------------- Phase I

def coded(gt: np.ndarray):
    """TPED allele coding (src/garlic-data.cpp:100-135) of locus-major
    genotypes gt [L, I]: the counted allele is the first non-missing
    allele of the row, so a row whose first genotype is homozygous for
    the other allele counts the other.  Returns (codes int8 [L, I], -9
    missing; frequency f64 [L])."""
    nonmiss = gt >= 0
    first = np.argmax(nonmiss, axis=1)
    g_first = gt[np.arange(gt.shape[0]), first]
    flip = nonmiss.any(axis=1) & (g_first == 0)
    codes = np.where(flip[:, None] & nonmiss, 2 - gt, gt).astype(np.int8)
    count = np.where(nonmiss, codes, 0).sum(axis=1, dtype=np.int64)
    total = 2 * nonmiss.sum(axis=1, dtype=np.int64)
    freq = np.zeros(gt.shape[0], dtype=np.float64)
    np.divide(count, total, out=freq, where=total > 0)
    return codes, freq


def lod_table(freq: np.ndarray, error: float, dt) -> np.ndarray:
    """[4, L] LOD of genotypes 0, 1, 2 and missing (0): log10 of the
    autozygous over the non-autozygous probability (src/garlic-roh.cpp:
    18-44), each in the reference's operation order."""
    p = freq.astype(dt)
    e = dt(error)
    one = dt(1.0)
    q = one - p
    with np.errstate(divide="ignore", invalid="ignore"):
        non0 = q * q
        aut0 = (one - e) * q + e * non0
        non1 = dt(2.0) * p * q
        aut1 = e * non1
        non2 = p * p
        aut2 = (one - e) * p + e * non2
        t = np.zeros((4, p.shape[0]), dtype=dt)
        t[0] = np.log10(aut0 / non0)
        t[1] = np.log10(aut1 / non1)
        t[2] = np.log10(aut2 / non2)
    return t


def pair_breaks(pos: np.ndarray, max_gap: int, cs: int, ce: int):
    """bool [L]: the pair (l-1, l) is further apart than max_gap or
    touches the centromere (inGap, src/garlic-roh.cpp:11-16)."""
    b = np.zeros(pos.shape[0], dtype=bool)
    p0, p1 = pos[:-1], pos[1:]
    touch = (((cs <= p0) & (ce >= p0)) | ((cs <= p1) & (ce >= p1))
             | ((cs >= p0) & (ce <= p1)))
    b[1:] = (p1 - p0 > max_gap) | touch
    return b


def window_missing(pos: np.ndarray, W: int, max_gap: int, cs: int, ce: int):
    """bool [nwin]: window l (loci l..l+W-1) is not scored: its first
    locus lies in the centromere, or a pair inside it breaks
    (src/garlic-roh.cpp:50-75)."""
    nwin = pos.shape[0] - W + 1
    br = pair_breaks(pos, max_gap, cs, ce).astype(np.int64)
    c = np.concatenate([[0], np.cumsum(br)])
    inside = (c[W:W + nwin] - c[1:nwin + 1]) > 0
    return inside | ((pos[:nwin] >= cs) & (pos[:nwin] <= ce))


def rolling_windows(terms: List[np.ndarray], missing: List[np.ndarray],
                    W: int) -> List[np.ndarray]:
    """[nwin, I] window sums of each chromosome in calcLOD's order
    (src/garlic-roh.cpp:46-126): a run of scored windows starts with a
    left-to-right sum, then each window is (previous - head) + tail.
    Unscored windows hold MISSING.  terms: [L, I] a chromosome.  Every
    run of every chromosome rolls at once, one column block each."""
    runs = []
    for ci, m in enumerate(missing):
        ok = np.concatenate([[0], (~m).astype(np.int8), [0]])
        edges = np.flatnonzero(np.diff(ok))
        runs += [(ci, s, e - s) for s, e in zip(edges[::2], edges[1::2])]
    I = terms[0].shape[1]
    dt = terms[0].dtype
    n = max([r[2] for r in runs], default=0)
    stack = np.zeros((n + W - 1, len(runs) * I), dtype=dt)
    for j, (ci, s, k) in enumerate(runs):
        stack[:k + W - 1, j * I:(j + 1) * I] = terms[ci][s:s + k + W - 1]
    rolled = np.empty((n, stack.shape[1]), dtype=dt)
    acc = np.zeros(stack.shape[1], dtype=dt)
    for k in range(W):
        acc = acc + stack[k]
    if n:
        rolled[0] = acc
    for l in range(1, n):
        np.subtract(acc, stack[l - 1], out=acc)
        np.add(acc, stack[l + W - 1], out=acc)
        rolled[l] = acc
    out = []
    for m in missing:
        w = np.empty((m.shape[0], I), dtype=dt)
        w[m] = MISSING
        out.append(w)
    for j, (ci, s, k) in enumerate(runs):
        out[ci][s:s + k] = rolled[:k, j * I:(j + 1) * I]
    return out


@dataclass
class Chrom:
    name: str
    pos: np.ndarray     # kept loci
    win: np.ndarray     # [nwin, I] window sums
    breaks: np.ndarray  # [L] pair breaks


def phase1(panel, fl: Flags, dt) -> List[Chrom]:
    """Coding, frequencies, the monomorphic filter
    (src/garlic-data.cpp:871-930), the LOD terms and the window sums."""
    names, poss, terms, miss, brk = [], [], [], [], []
    for ci, name in enumerate(panel.chroms):
        codes, freq = coded(np.ascontiguousarray(panel.genotypes[ci].T))
        keep = (freq > 0.0) & (freq < 1.0)
        codes, freq = codes[keep], freq[keep]
        pos = panel.positions[ci][keep]
        cs, ce = centromere(fl.build, name)
        table = np.ascontiguousarray(lod_table(freq, fl.error, dt).T)
        idx = np.where(codes < 0, 3, codes).astype(np.int64)
        idx += 4 * np.arange(freq.shape[0])[:, None]
        terms.append(table.reshape(-1)[idx])                     # [L, I]
        miss.append(window_missing(pos, fl.winsize, fl.max_gap, cs, ce))
        brk.append(pair_breaks(pos, fl.max_gap, cs, ce))
        names.append(name)
        poss.append(pos)
    wins = rolling_windows(terms, miss, fl.winsize)
    return [Chrom(*a) for a in zip(names, poss, wins, brk)]


# ---------------------------------------------------------------- Phase II

def subsample(nind: int, k: int, seed: int) -> np.ndarray:
    """The KDE's individuals: k of nind drawn without replacement by
    numpy's Generator from --tpu-seed, in panel order (gsl_ran_choose's
    contract, src/garlic-data.cpp:2079-2095); all when k >= nind or
    k <= 0."""
    if k >= nind or k <= 0:
        return np.arange(nind)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(nind, size=k, replace=False))


def pool(chroms: List[Chrom], rows: np.ndarray, step: int) -> np.ndarray:
    """The KDE's samples: every step-th window of the chosen rows,
    chromosome-major, then row, then window, MISSING dropped
    (convertSubsetWinData2DoubleData, src/garlic-data.cpp:2096-2150)."""
    parts = []
    for c in chroms:
        w = c.win[::step][:, rows].T.reshape(-1)
        parts.append(w[(w != MISSING) & ~np.isnan(w)])
    return np.concatenate(parts)


def gsl_sd(x: np.ndarray, dt) -> float:
    """gsl_stats_sd: running-mean recurrences, accumulated in x87
    extended precision as GARLIC's build does (long double here); in the
    control's float32, in float32."""
    ext = np.longdouble if dt == np.float64 else np.float32
    n = x.shape[0]
    if n < 2:
        return 0.0
    mean = ext(0.0)
    for i, v in enumerate(x.tolist()):
        mean += (ext(v) - mean) / ext(i + 1)
    m = dt(mean)
    var = ext(0.0)
    for i, v in enumerate(x.tolist()):
        d = ext(dt(v - m))
        var += (d * d - var) / ext(i + 1)
    return float(np.sqrt(dt(n) / dt(n - 1) * dt(var)))


def gsl_quantile(x: np.ndarray, f: float) -> float:
    """gsl_stats_quantile_from_sorted_data: linear interpolation."""
    idx = (x.shape[0] - 1) * f
    lhs = int(idx)
    delta = idx - lhs
    if lhs == x.shape[0] - 1:
        return float(x[lhs])
    return float((1 - delta) * x[lhs] + delta * x[lhs + 1])


def kde(samples: np.ndarray, dt):
    """computeKDE (src/garlic-kde.cpp:14-140): nrd0 bandwidth, 512
    targets from min - 3h to max + 3h, the exact Gauss transform, the
    density normalised to integrate to 1.  Returns (x, y)."""
    x = np.sort(samples.astype(dt))
    n = x.shape[0]
    iqr = gsl_quantile(x, 0.75) - gsl_quantile(x, 0.25)
    h = 0.9 * min(gsl_sd(x, dt), iqr / 1.34) * float(n) ** -0.2
    mn, mx = float(x[0]) - 3.0 * h, float(x[-1]) + 3.0 * h
    t = ((np.arange(1, 513, dtype=np.float64) / 512) * (mx - mn)
         + mn).astype(dt)
    spacing = t[1] - t[0]
    neg = dt(-1.0 / (h * h))
    src = samples.astype(dt)
    y = np.zeros(512, dtype=dt)
    for s in range(0, n, 1 << 13):
        d = src[s:s + (1 << 13), None] - t[None, :]
        y += np.exp(np.maximum(d * d * neg, dt(-700.0))).sum(axis=0)
    y = y * dt(1.0 / n)
    y = y / (y.sum() * spacing)
    return t.astype(np.float64), y.astype(np.float64)


class CutoffError(Exception):
    pass


def min_between_modes(x: np.ndarray, y: np.ndarray, winsize: int) -> float:
    """get_min_btw_modes (src/garlic-kde.cpp:142-272), quirks kept: the
    windowed argmax starts from DBL_MIN with a strict >, so an all
    non-positive window points before itself (read here as index 0);
    the run-length count of distinct window maxima writes slot 1 at
    i == 1; the two most frequent counts, then the two largest values
    among them, then the last index holding each; the strict-< argmin
    between; and |x / winsize| < 1 or else 0."""
    size = x.shape[0]
    n = size - 20
    maxes = np.zeros(n)
    counts = np.zeros(n)
    j = 0
    for i in range(n):
        w = y[i:i + 20]
        arg = int(np.argmax(w)) if w.max() > DBL_MIN else -1
        m = y[max(arg + i, 0)]
        if i == 1:
            maxes[1] = m
            counts[1] += 1
        elif maxes[j] == m:
            counts[j] += 1
        else:
            j += 1
            maxes[j] = m
            counts[j] += 1
    top, second = counts[0], 0.0
    for i in range(1, n):
        if top <= counts[i]:
            second, top = top, counts[i]
        elif second <= counts[i]:
            second = counts[i]
    first_max = second_max = -1.0
    for i in range(n):
        if counts[i] == top or counts[i] == second:
            v = maxes[i]
            if first_max <= v:
                second_max, first_max = first_max, v
            elif second_max <= v:
                second_max = v
    left = right = -1
    for i in range(size):
        if y[i] == first_max:
            left = i
        if y[i] == second_max:
            right = i
    if right < left:
        left, right = right, left
    if left < 0:
        raise CutoffError("no KDE modes")
    best, arg = DBL_MAX, -1
    for i in range(left, right + 1):
        if best > y[i]:
            best, arg = y[i], i
    c = float(x[arg])
    return c if abs(c / winsize) < 1 else 0.0


# -------------------------------------------------------------- Phase III

def runs(chroms: List[Chrom], cutoff: float, fl: Flags, nind: int, dt):
    """assembleROHWindows (src/garlic-roh.cpp:409-546): a locus is
    covered where at least thr windows that hold it score >= cutoff
    (thr = overlap_frac * winsize, clamped to [1, winsize]); a run is a
    stretch of covered loci, split where a pair breaks, kept when it
    spans >= thr loci and does not start at the chromosome's last locus.
    Returns (ind, chrom, start, stop, size) arrays in the order the
    pipeline pools the lengths: individual, chromosome, position."""
    W = fl.winsize
    thr = min(max(fl.overlap_frac * W, 1.0), float(W))
    cut = dt(cutoff)
    per = [[None] * len(chroms) for _ in range(nind)]
    for ci, c in enumerate(chroms):
        L, nwin = c.pos.shape[0], c.win.shape[0]
        above = np.ascontiguousarray((c.win >= cut).T)             # [I, nwin]
        lo = np.maximum(np.arange(L) - W + 1, 0)
        brn = np.zeros(L, dtype=bool)
        brn[:-1] = c.breaks[1:]
        cs = np.zeros(L + 1, dtype=np.int32)
        for i in range(nind):
            np.cumsum(above[i], dtype=np.int32, out=cs[1:nwin + 1])
            cs[nwin + 1:] = cs[nwin]
            cov = (cs[1:] - cs[lo]) >= thr
            prev = np.concatenate([[False], cov[:-1]])
            nxt = np.concatenate([cov[1:], [False]])
            sw = np.flatnonzero(cov & (~prev | c.breaks))
            ew = np.flatnonzero(cov & (~nxt | brn))
            keep = (ew - sw + 1 >= thr) & (sw != L - 1)
            start, stop = c.pos[sw[keep]], c.pos[ew[keep]]
            per[i][ci] = (np.full(start.shape, i), np.full(start.shape, ci),
                          start, stop, stop - start + 1)
    rows = [p for ind in per for p in ind]
    return tuple(np.concatenate(a) for a in zip(*rows))


# --------------------------------------------------------------- Phase IV

def em(x: np.ndarray, k: int, dt, max_iter: int = 1000,
       precision: float = 1e-5):
    """GMM::estimate's EM (src/gmm.cpp:276-331): starting weights 1/k,
    means mean*(n+1)/(k+1), variances var*(n+1)/k; log responsibilities
    normalised by logsumexp, then the moment updates, until the
    log-likelihood moves by at most `precision`."""
    x = x.astype(dt)
    n = x.shape[0]
    var0 = float(np.var(x, ddof=1))
    mean = float(np.mean(x))
    w = np.full(k, 1.0 / k, dtype=dt)
    mu = np.array([mean * (i + 1) / (k + 1) for i in range(k)], dtype=dt)
    var = np.array([var0 * (i + 1) / k for i in range(k)], dtype=dt)
    c = dt(-0.5 * math.log(2.0 * math.pi))
    last = -DBL_MAX
    for _ in range(max_iter):
        d = x[:, None] - mu[None, :]
        logp = np.log(w)[None, :] + (c - dt(0.5) * np.log(var)[None, :]
                                     - (d * d) / (dt(2.0) * var[None, :]))
        lmax = logp.max(axis=1, keepdims=True)
        tot = lmax[:, 0] + np.log(np.exp(logp - lmax).sum(axis=1))
        ll = float(tot.sum())
        r = np.exp(logp - tot[:, None])
        r = r / r.sum(axis=1, keepdims=True)
        sw = r.sum(axis=0)
        mu = (x[:, None] * r).sum(axis=0) / sw
        var = ((x * x)[:, None] * r).sum(axis=0) / sw - mu * mu
        w = sw / dt(n)
        if not (np.all(np.isfinite(mu)) and np.all(np.isfinite(var))):
            raise FloatingPointError("a component collapsed")
        if abs(ll - last) <= precision:
            break
        last = ll
    return (w.astype(np.float64), mu.astype(np.float64),
            var.astype(np.float64))


def _pdf(x: float, s: float) -> float:
    u = x / abs(s)
    return (1.0 / (abs(s) * math.sqrt(2.0 * math.pi))) * math.exp(-u * u / 2)


def boundary(mu1, v1, w1, mu2, v2, w2, epsrel: float = 1e-4,
             max_iter: int = 1000) -> float:
    """BoundFinder::findBoundary (src/BoundFinder.cpp:7-88): the root of
    w1 N(x; mu1) - w2 N(x; mu2) between the means by GSL's Brent-Dekker
    solver (roots/brent.c), stopped by gsl_root_test_interval with
    epsabs 0 and epsrel 1e-4."""
    s1, s2 = math.sqrt(v1), math.sqrt(v2)

    def f(x):
        return w1 * _pdf(x - mu1, s1) - w2 * _pdf(x - mu2, s2)

    lo, hi = min(mu1, mu2), max(mu1, mu2)
    a, b = lo, hi
    fa, fb = f(a), f(b)
    c, fc, d, e = b, fb, b - a, b - a
    for _ in range(max_iter):
        ac_equal = False
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            ac_equal = True
            c, fc, d, e = a, fa, b - a, b - a
        if abs(fc) < abs(fb):
            ac_equal = True
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol = 0.5 * DBL_EPS * abs(b)
        m = 0.5 * (c - b)
        if fb == 0.0 or abs(m) <= tol:
            return b
        if abs(e) < tol or abs(fa) <= abs(fb):
            d = e = m
        else:
            s = fb / fa
            if ac_equal:
                p, q = 2.0 * m * s, 1.0 - s
            else:
                q, r = fa / fc, fb / fc
                p = s * (2.0 * m * q * (q - r) - (b - a) * (r - 1.0))
                q = (q - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0:
                q = -q
            else:
                p = -p
            if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                e, d = d, p / q
            else:
                d = e = m
        a, fa = b, fb
        b += d if abs(d) > tol else (tol if m > 0 else -tol)
        fb = f(b)
        cb = a if (fb < 0 and fc < 0) or (fb > 0 and fc > 0) else c
        x0, x1 = (b, cb) if b < cb else (cb, b)
        min_abs = min(abs(x0), abs(x1)) if (x0 > 0) == (x1 > 0) and \
            x0 != 0 and x1 != 0 else 0.0
        if x1 - x0 < epsrel * min_abs:
            return b
    raise ArithmeticError("the boundary did not converge")


def size_bounds(lengths: np.ndarray, k: int, dt) -> List[float]:
    """selectSizeClasses (src/garlic-roh.cpp:935-1003): the fit's
    components by mean, and the k-1 boundaries between neighbours."""
    w, mu, var = em(lengths, k, dt)
    o = np.argsort(mu, kind="stable")
    return [boundary(mu[o[i - 1]], var[o[i - 1]], w[o[i - 1]],
                     mu[o[i]], var[o[i]], w[o[i]]) for i in range(1, k)]


# ------------------------------------------------------------------ a call

def bed_lines(panel, chroms, roh, bounds) -> List[str]:
    """writeROHData (src/garlic-roh.cpp:574-650): per individual a track
    line, then its runs with their size class and colour."""
    ind, ci, start, stop, size = roh
    # the first bound above the size names the class (src/garlic-roh.cpp:
    # 613-627)
    below = size[:, None] < np.asarray(bounds, dtype=np.float64)[None, :]
    classes = np.where(below.any(axis=1), below.argmax(axis=1), len(bounds))
    lines = []
    cut = np.searchsorted(ind, np.arange(len(panel.ind_ids) + 1))
    for i, iid in enumerate(panel.ind_ids):
        lines.append(f'track name="Ind: {iid} Pop:{panel.pop} ROH" '
                     f'description="Ind: {iid} Pop:{panel.pop} ROH from '
                     f'GARLIC v{VERSION}" visibility=2 itemRgb="On"')
        for r in range(cut[i], cut[i + 1]):
            cls = int(classes[r])
            name = chroms[ci[r]].name
            if name[0] not in "cC":
                name = "chr" + name
            lines.append(f"{name}\t{start[r]}\t{stop[r]}\t{chr(65 + cls)}\t"
                         f"{int(size[r])}\t.\t0\t0\t{COLORS[min(cls, 8)]}")
    return lines


def parse(argv: List[str]) -> Flags:
    """The call's flags as the reference reads them; ValueError on one
    that it does not implement (refuse_unread)."""
    return Flags.parse(argv)


def call(panel, argv: List[str], dt=np.float64) -> Call:
    """The reference's outputs of `garlic --tped <panel> ... argv`."""
    fl = parse(argv)
    chroms = phase1(panel, fl, dt)
    nind = len(panel.ind_ids)
    cutoff, npts = fl.lod_cutoff, 0
    if cutoff is None:
        rows = subsample(nind, fl.kde_subsample, fl.seed)
        samples = pool(chroms, rows, fl.winsize)
        npts = samples.shape[0]
        x, y = kde(samples, dt)
        try:
            cutoff = min_between_modes(x, y, fl.winsize)
        except CutoffError:
            cutoff = -1.0
    roh = runs(chroms, cutoff, fl, nind, dt)
    bounds = fl.bounds
    auto_bounds = bounds is None
    if auto_bounds:
        bounds = size_bounds(roh[4].astype(np.float64), fl.nclust, dt)
    return Call(bed=bed_lines(panel, chroms, roh, bounds),
                cutoff=None if fl.lod_cutoff is not None else cutoff,
                bounds=bounds if auto_bounds else None,
                nroh=int(roh[0].shape[0]), kde_points=npts)
