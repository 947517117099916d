"""Brent root solver for pairwise Gaussian intersections.

Faithful port of GSL's Brent-Dekker solver (gsl_root_fsolver_brent) driven
the way BoundFinder drives it (src/BoundFinder.cpp:7-88): bracket =
[min(mu1,mu2), max(mu1,mu2)], f(x) = a1 N(x; mu1, s1) - a2 N(x; mu2, s2),
stopping when gsl_root_test_interval(x_lo, x_hi, epsabs=0, epsrel=1e-4)
passes.  The stopping point determines the printed boundary, so the
iteration sequence matters.

Copy of garlic_tpu/ops/brent.py: the port imports nothing of garlic_tpu.
Each function and class names its source line.
"""

from __future__ import annotations

import math

_DBL_EPSILON = 2.220446049250313e-16


class BrentError(Exception):
    """Copy of garlic_tpu/ops/brent.py:18."""
    pass


def _gaussian_pdf(x: float, sigma: float) -> float:
    """gsl_ran_gaussian_pdf: N(0, sigma) density at x.

    Copy of garlic_tpu/ops/brent.py:22."""
    u = x / abs(sigma)
    return (1.0 / (abs(sigma) * math.sqrt(2.0 * math.pi))) * math.exp(-u * u / 2.0)


def _test_interval(x_lo: float, x_hi: float, epsabs: float, epsrel: float) -> bool:
    """gsl_root_test_interval (GSL roots/convergence.c).

    Copy of garlic_tpu/ops/brent.py:28."""
    abs_lo, abs_hi = abs(x_lo), abs(x_hi)
    if (x_lo > 0 and x_hi > 0) or (x_lo < 0 and x_hi < 0):
        min_abs = min(abs_lo, abs_hi)
    else:
        min_abs = 0.0
    tolerance = epsabs + epsrel * min_abs
    return (x_hi - x_lo) < tolerance


def brent_root(f, x_lo: float, x_hi: float, max_iter: int,
               epsabs: float, epsrel: float) -> float:
    """GSL brent solver loop as BoundFinder::findBoundary runs it
    (src/BoundFinder.cpp:43-80).

    Copy of garlic_tpu/ops/brent.py:39."""
    a, b = x_lo, x_hi
    fa, fb = f(a), f(b)
    if (fa < 0 and fb < 0) or (fa > 0 and fb > 0):
        raise BrentError("endpoints do not straddle y=0")
    c, fc = b, fb
    d = b - a
    e = b - a
    r = 0.5 * (x_lo + x_hi)

    for _ in range(max_iter):
        # --- one brent_iterate (GSL roots/brent.c) ---
        ac_equal = False
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            ac_equal = True
            c, fc = a, fa
            d = b - a
            e = b - a
        if abs(fc) < abs(fb):
            ac_equal = True
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol = 0.5 * _DBL_EPSILON * abs(b)
        m = 0.5 * (c - b)
        if fb == 0.0:
            return b
        if abs(m) <= tol:
            return b
        if abs(e) < tol or abs(fa) <= abs(fb):
            d = m
            e = m
        else:
            s = fb / fa
            if ac_equal:
                p = 2.0 * m * s
                q = 1.0 - s
            else:
                q = fa / fc
                rr = fb / fc
                p = s * (2.0 * m * q * (q - rr) - (b - a) * (rr - 1.0))
                q = (q - 1.0) * (rr - 1.0) * (s - 1.0)
            if p > 0:
                q = -q
            else:
                p = -p
            if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                e = d
                d = p / q
            else:
                d = m
                e = m
        a, fa = b, fb
        if abs(d) > tol:
            b += d
        else:
            b += tol if m > 0 else -tol
        fb = f(b)
        # --- bounds update + BoundFinder's convergence test ---
        r = b
        cb = c
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            cb = a
        lo, hi = (b, cb) if b < cb else (cb, b)
        if _test_interval(lo, hi, epsabs, epsrel):
            return r
    raise BrentError(f"Root finder failed to converge after {max_iter} iterations.")


def find_boundary(mu1: float, var1: float, w1: float,
                  mu2: float, var2: float, w2: float,
                  max_iter: int = 1000, epsabs: float = 1e-4) -> float:
    """BoundFinder::findBoundary: root of a1 N(.;mu1) - a2 N(.;mu2) between
    the two means.  NOTE BoundFinder passes its `error` as GSL's *epsrel*
    (gsl_root_test_interval(x_lo, x_hi, 0, error), src/BoundFinder.cpp:58).

    Copy of garlic_tpu/ops/brent.py:110."""
    s1 = math.sqrt(var1)
    s2 = math.sqrt(var2)

    def f(x: float) -> float:
        return w1 * _gaussian_pdf(x - mu1, s1) - w2 * _gaussian_pdf(x - mu2, s2)

    lo = min(mu1, mu2)
    hi = max(mu1, mu2)
    return brent_root(f, lo, hi, max_iter=max_iter, epsabs=0.0, epsrel=epsabs)
