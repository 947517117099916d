"""LOD cutoff discovery: minimum between the two dominant KDE modes.

Faithful port of get_min_btw_modes / get_arg_max / get_arg_min
(src/garlic-kde.cpp:142-272), including its idiosyncrasies:

* the windowed argmax initializes its running max to DBL_MIN (the smallest
  positive double), so all-nonpositive windows return index -1
  (src/garlic-kde.cpp:241-256) — we clamp the resulting out-of-bounds read
  to index 0 (the reference reads one double before the array; replicating
  undefined behavior is impossible, and it only arises when the first 20
  density values are exactly zero);
* the run-length "unique max" counting scheme with its special-cased i==1
  write (src/garlic-kde.cpp:156-170);
* top-two-count selection, then top-two values among those, then the LAST
  grid index holding each value (src/garlic-kde.cpp:172-222);
* the final sanity check |x[minIndex]/winsize| < 1 else 0
  (src/garlic-kde.cpp:231-232).

Do not "fix" this function: every downstream byte of output depends on its
exact argmax/argmin behavior (SURVEY.md hard part d).

Copy of garlic_tpu/ops/cutoff.py: the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

import numpy as np

_DBL_MIN = 2.2250738585072014e-308  # numeric_limits<double>::min()
_DBL_MAX = 1.7976931348623157e+308


class CutoffError(Exception):
    """Copy of garlic_tpu/ops/cutoff.py:31."""
    pass


def _arg_min(vals: np.ndarray) -> int:
    """get_arg_min (src/garlic-kde.cpp:258-272): strict <, init DBL_MAX.

    Copy of garlic_tpu/ops/cutoff.py:46."""
    m = _DBL_MAX
    arg = -1
    for i, v in enumerate(vals):
        if m > v:
            m = v
            arg = i
    return arg


# Measured bound on FIGTree's absolute y error across oracle draws:
# <= ~2.5e-3 * ymax (6 runs, fixed panel; BASELINE.md round 4).  Used by
# the tie probe's perturbations and by the deterministic valley
# reachability criterion (tests/util.oracle_cutoff_reachable) with a
# small margin.
FIGTREE_ABS_ERR = 3e-3


def get_min_btw_modes(x: np.ndarray, y: np.ndarray, wsize: int) -> float:
    """Copy of garlic_tpu/ops/cutoff.py:65."""
    return get_min_btw_modes_indices(x, y, wsize)[0]


def get_min_btw_modes_indices(x: np.ndarray, y: np.ndarray, wsize: int):
    """get_min_btw_modes + the located indices:
    (cutoff, left_max_index, right_max_index, min_index).  The index
    triple feeds the randomized-oracle acceptance machinery (which grid
    points FIGTree's error could turn into the argmin); the cutoff value
    is bit-identical to the reference's.

    Copy of garlic_tpu/ops/cutoff.py:69."""
    size = x.shape[0]
    winsize = 20
    n = size - winsize
    uniq_maxes = np.zeros(n, dtype=np.float64)
    uniq_counts = np.zeros(n, dtype=np.float64)

    # Windowed running max per start (vectorized equivalent of repeated
    # get_arg_max calls; the strict-> + DBL_MIN init means a window of values
    # all <= DBL_MIN yields the element BEFORE the window, clamped here to 0).
    index = 0
    for i in range(n):
        arg = _arg_max_window(y, i, winsize)
        maxes = y[max(arg + i, 0)]
        if i == 1:
            uniq_maxes[1] = maxes
            uniq_counts[1] += 1
        elif uniq_maxes[index] == maxes:
            uniq_counts[index] += 1
        else:
            index += 1
            uniq_maxes[index] = maxes
            uniq_counts[index] += 1

    max_count = uniq_counts[0]
    second_max_count = 0.0
    for i in range(1, n):
        if max_count <= uniq_counts[i]:
            second_max_count = max_count
            max_count = uniq_counts[i]
        elif second_max_count <= uniq_counts[i]:
            second_max_count = uniq_counts[i]

    values = [uniq_maxes[i] for i in range(n)
              if uniq_counts[i] == max_count or uniq_counts[i] == second_max_count]

    first_max = -1.0
    second_max = -1.0
    for v in values:
        if first_max <= v:
            second_max = first_max
            first_max = v
        elif second_max <= v:
            second_max = v

    left_max_index = -1
    right_max_index = -1
    for i in range(size):
        if y[i] == first_max:
            left_max_index = i
        if y[i] == second_max:
            right_max_index = i
    if right_max_index < left_max_index:
        left_max_index, right_max_index = right_max_index, left_max_index
    if left_max_index < 0:
        raise CutoffError("failed to locate KDE modes")

    min_index = _arg_min(y[left_max_index:right_max_index + 1]) + left_max_index
    if abs(x[min_index] / wsize) < 1:
        return (float(x[min_index]), left_max_index, right_max_index,
                min_index)
    return 0.0, left_max_index, right_max_index, min_index


def cutoff_tie_probe(x: np.ndarray, y: np.ndarray, wsize: int,
                     rel: float = 0.1, abs_rel: float = 3e-3,
                     K: int = 32) -> list:
    """Alternative cutoffs the ORACLE could select on this density.

    The reference evaluates the KDE with FIGTree, whose k-center
    clustering seeds rand() with time(NULL) inside Cluster() (verified by
    disassembling the oracle binary: KCenterClustering::Cluster calls
    time->srand->rand) — its Phase II is randomized run-to-run by design,
    with observed |y_figtree - y_exact| up to ~9% relative in low-density
    regions (measured; see BASELINE.md round-4 notes).  Our y is the
    exact transform (the fixed point FIGTree approximates), so when two
    valley/mode candidates sit within FIGTree's error of each other the
    oracle's draw decides, and no deterministic implementation can match
    every draw.

    This probe re-runs the quirk-faithful finder on K seeded
    perturbations y*(1 + rel*u1) + ymax*abs_rel*u2, u ~ U(-1, 1)
    (deterministic: fixed rng), and returns the sorted list of cutoffs
    that differ from the unperturbed one — empty means the selection is
    stable at the FIGTree error scale and a BED diff vs the oracle is a
    real bug, non-empty means the run sits in the documented
    randomized-oracle class.  Both noise terms are measured bounds:
    FIGTree's error is ABSOLUTE (<= ~2.5e-3*ymax observed across draws),
    which in low-density tails dwarfs the values themselves — on
    degenerate (unimodal/shifted) densities the min-between-modes scan
    walks regions where the oracle's y ordering is effectively random.

    Copy of garlic_tpu/ops/cutoff.py:138."""
    try:
        base = get_min_btw_modes(x, y, wsize)
    except CutoffError:
        return []
    rng = np.random.default_rng(0)
    ymax = float(np.max(y)) if y.size else 0.0
    alts = set()
    for _ in range(K):
        yp = y * (1.0 + rel * rng.uniform(-1.0, 1.0, size=y.shape[0])) \
            + ymax * abs_rel * rng.uniform(-1.0, 1.0, size=y.shape[0])
        try:
            c = get_min_btw_modes(x, yp, wsize)
        except CutoffError:
            continue
        if c != base:
            alts.add(float(c))
    # Truncation ladder (round 5): FIGTree's far-field y values are EXACT
    # ZEROS (cluster contributions below its truncation radius are
    # dropped), while the exact transform's are tiny positives — and
    # get_min_btw_modes' run-length mode counting branches on exact
    # equality, so a zero tail can relocate BOTH modes wholesale, far
    # beyond any additive-noise model.  (Observed on a weighted panel:
    # exact y selects -0.805 with modes at grid 432/486; the same y with
    # values <= 1e-16*ymax zeroed selects the oracle's -6.841 with modes
    # at 70/510 — every truncation threshold from 1e-16 to 1e-4 agrees.)
    # The ladder reproduces that structure deterministically.
    for t in (1e-300, 1e-16, 1e-13, 1e-10, 1e-8, 1e-6, 1e-4, 1e-3):
        yt = np.where(y <= t * ymax, 0.0, y)
        try:
            c = get_min_btw_modes(x, yt, wsize)
        except CutoffError:
            continue
        if c != base:
            alts.add(float(c))
    return sorted(alts)


def _arg_max_window(y: np.ndarray, start: int, winsize: int) -> int:
    """Windowed get_arg_max on y[start:start+winsize].  Uses numpy argmax on
    the common path (some value > DBL_MIN) and the faithful scalar scan on
    ties; numpy argmax returns the FIRST maximal index, matching the strict->
    update rule.

    Copy of garlic_tpu/ops/cutoff.py:202."""
    w = y[start:start + winsize]
    m = w.max()
    if m > _DBL_MIN:
        return int(np.argmax(w))
    return -1
