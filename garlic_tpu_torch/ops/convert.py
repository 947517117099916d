"""Window-matrix flattening for the KDE, with thinning and subsampling.

Copies from garlic_tpu/ops/convert.py: convertWinData2DoubleData /
convertSubsetWinData2DoubleData (src/garlic-data.cpp:2026-2150) over the
exact engine's host window matrices and the device window matrices of
the programmatic API (DeviceWin, or a streamed LazyWin: thinned on the
device, device_win.thinned_block), and the KDE subsample.  The CLI's
fast engine pools the exact sampler's values instead
(pipeline._exact_thinned_samples).  Each function names its source line.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.types import MISSING


def win_to_samples(win_by_chr: List[np.ndarray], step: int,
                   ind_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """Every `step`-th window slot per chromosome and individual, MISSING
    and NaN dropped, in (chromosome, individual, window) order.

    Copy of garlic_tpu/ops/convert.py:20."""
    from .device_win import is_device_win, is_lazy_win, thinned_block
    parts = []
    for win in win_by_chr:
        if is_lazy_win(win):
            # streaming mode: materialize one chromosome, sample, drop
            thinned = thinned_block(win.make(), step, ind_idx=ind_idx)
        elif is_device_win(win):
            # device slice: only 1/step of the matrix crosses the host link
            thinned = thinned_block(win, step, ind_idx=ind_idx)
        else:
            w = win if ind_idx is None else win[ind_idx]
            thinned = w[:, ::step]
        flat = thinned.reshape(-1)  # row-major: individual-major, window-minor
        mask = (flat != MISSING) & ~np.isnan(flat)
        parts.append(flat[mask])
    return np.concatenate(parts) if parts else np.zeros(0)


def choose_subsample(nind: int, subsample: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Random individual subset preserving original order, like
    gsl_ran_choose (src/garlic-data.cpp:2079-2095).  subsample >= nind uses
    everyone.

    Copy of garlic_tpu/ops/convert.py:40."""
    if subsample >= nind or subsample <= 0:
        return np.arange(nind)
    return np.sort(rng.choice(nind, size=subsample, replace=False))
