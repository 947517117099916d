"""Winsize smoothness ("wiggle") metric.

Port of calculateWiggle (src/garlic-kde.cpp:3-12): scales the density by 100
IN PLACE, then sums windowed linear-fit residual sums-of-squares / winsize
over all 20-point windows.  The linear fit follows gsl_fit_linear: running
means, slope from centered cross-moments, residuals dy - c1*dx.

Copy of garlic_tpu/ops/wiggle.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

import numpy as np

from .kde import KDEResult


def _gsl_fit_linear_sumsq(x: np.ndarray, y: np.ndarray) -> float:
    """Residual sum of squares from gsl_fit_linear (GSL fit/linear.c).

    Copy of garlic_tpu/ops/wiggle.py:16."""
    m_x = float(np.mean(x))
    m_y = float(np.mean(y))
    dx = x - m_x
    dy = y - m_y
    m_dx2 = float(np.mean(dx * dx))
    m_dxdy = float(np.mean(dx * dy))
    c1 = m_dxdy / m_dx2
    d = dy - c1 * dx
    return float(np.sum(d * d))


def calculate_wiggle(kde: KDEResult, winsize: int = 20) -> float:
    """NOTE: mutates kde.y (multiplies by 100) exactly as the reference does.
    In selectWinsize (src/garlic-roh.cpp:820-834) the KDE is cloned and
    written AFTER calculateWiggle ran, so the auto-winsize .kde file and the
    cutoff search both see the x100-scaled density — mode finding is
    scale-invariant so the cutoff is unaffected, but the written bytes are
    not.  pipeline.py preserves this ordering.

    Copy of garlic_tpu/ops/wiggle.py:29."""
    kde.y *= 100.0
    tot = 0.0
    for i in range(kde.size - winsize):
        sumsq = _gsl_fit_linear_sumsq(kde.x[i:i + winsize], kde.y[i:i + winsize])
        tot += sumsq / float(winsize)
    return tot
