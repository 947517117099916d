"""The port's mode finder (garlic_tpu_torch.ops.cutoff) against the
verbatim scalar port of the reference (src/garlic-kde.cpp:142-234) that
tests/test_cutoff_property.py holds garlic_tpu to, on the same 24
adversarial densities, and against garlic_tpu itself: the cutoff, the
located indices and the tie probe, also on edge densities: too few
points, a head of exact zeros, NaN and infinities, modes of exactly equal
height, plateaus at a window's edge, the scan's i == 1 write."""

from __future__ import annotations

import numpy as np
import pytest

from garlic_tpu.ops import cutoff as cutoff_ops
from garlic_tpu_torch.ops import cutoff as port_cutoff
from tests.test_cutoff_property import _density, min_btw_modes_scalar

PACKAGES = {"garlic_tpu": cutoff_ops, "garlic_tpu_torch": port_cutoff}


@pytest.mark.parametrize("seed", range(24))
def test_matches_scalar_port(seed):
    _check_scalar(port_cutoff, *_density(seed))


def _check_scalar(mod, x, y):
    try:
        expect = min_btw_modes_scalar(list(x), list(y), 60)
    except Exception:
        with pytest.raises(Exception):
            mod.get_min_btw_modes(x, y, 60)
        return
    got = mod.get_min_btw_modes(x, y, 60)
    assert got == expect, (got, expect)


def _bimodal(size=512):
    x = np.linspace(-3, 3, size)
    return x, (np.exp(-0.5 * (x + 1.5) ** 2 / 0.2)
               + 0.6 * np.exp(-0.5 * (x - 1.5) ** 2 / 0.3))


def _edge(name):
    """An edge density (x, y) of the mode finder."""
    x, y = _bimodal()
    if name == "size21-zero-head":  # one window start, its max 0
        return x[:21].copy(), np.r_[np.zeros(20), 0.5]
    if name.startswith("size"):  # too few points, or 1-2 window starts
        n = int(name[4:])
        return x[:n].copy(), y[:n].copy()
    if name == "zero-head":  # the DBL_MIN rule's -1, read at index 0
        y[:40] = 0.0
    elif name == "zero-head-short":  # the first window alone is all zero
        y[:20] = 0.0
    elif name == "tiny-head":  # positive but <= DBL_MIN among zeros
        y[:60] = 0.0
        y[30] = 1e-310
    elif name == "negative-zero-head":
        y[:30] = -0.0
    elif name == "nan-inside":
        y[[100, 101, 300]] = np.nan
    elif name == "nan-head":
        y[:3] = np.nan
    elif name == "nan-everywhere":
        y[:] = np.nan
    elif name.startswith("nan-") and name.endswith("-rising"):
        # NaN among the top counts' values: the last window starts'
        # (tail), or the i == 1 write's (head)
        y = np.linspace(0.1, 1.0, 512)
        at = slice(488, 491) if name == "nan-tail-rising" else slice(0, 3)
        y[at] = np.nan
    elif name == "posinf":
        y[200] = np.inf
    elif name == "neginf":
        y[[50, 260, 261]] = -np.inf
    elif name == "dblmax-valley":  # _arg_min never picks DBL_MAX or inf
        y = np.round(y * 20) / 20
        y[220:300] = np.finfo(np.float64).max
        y[240] = np.inf
    elif name in ("dblmax-modes", "inf-modes"):  # both modes in one run
        y = np.full(512, 0.1)
        y[50:200] = y[240:400] = (np.inf if name == "inf-modes"
                                  else np.finfo(np.float64).max)
    elif name == "equal-modes":  # two modes of exactly the same height
        y = np.round(y * 50) / 50
        y[np.argmax(y[256:]) + 256] = y.max()
    elif name == "equal-modes-wide":
        y = np.minimum(y, 0.55)
    elif name == "plateau-start":  # a 20-point plateau at the grid's head
        y[:20] = y.max()
    elif name == "plateau-end":
        y[-20:] = y.max()
    elif name == "plateau-window":  # plateaus exactly one window wide
        y = np.round(y * 8) / 8
        y[100:120] = 0.9
        y[380:400] = 0.9
    elif name == "i1-write":  # the first two window maxes differ
        y = np.linspace(1.0, 0.0, 512) + np.r_[np.zeros(256), y[256:]]
    elif name == "i1-write-zero":  # max 0 at start 0, the i == 1 write
        y[:20] = 0.0
        y[20] = 2.0
    elif name == "constant":
        y = np.full(512, 0.25)
    elif name == "all-zero":
        y = np.zeros(512)
    elif name == "negative":
        y = -np.abs(y)
    return x, y


EDGES = ["size0", "size5", "size19", "size20", "size21", "size22",
         "size21-zero-head", "zero-head", "zero-head-short", "tiny-head",
         "negative-zero-head", "nan-inside", "nan-head", "nan-everywhere",
         "nan-head-rising", "nan-tail-rising", "posinf", "neginf",
         "dblmax-valley", "dblmax-modes", "inf-modes", "equal-modes",
         "equal-modes-wide", "plateau-start", "plateau-end",
         "plateau-window", "i1-write", "i1-write-zero", "constant",
         "all-zero", "negative"]
# Held to garlic_tpu alone (test_port_equals_garlic_tpu): the scalar
# port's get_arg_max skips NaN inside a window, garlic_tpu's windowed max
# reads a window holding NaN as all <= DBL_MIN; and where no mode is
# located the reference reads before the array (undefined), the scalar
# port reads from its end, and both packages raise CutoffError.
_NOT_SCALAR = ("nan-inside", "nan-head", "nan-everywhere",
               "nan-head-rising", "nan-tail-rising", "size22",
               "size21-zero-head", "constant")


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("name", [e for e in EDGES if e not in _NOT_SCALAR])
def test_edge_matches_scalar_port(pkg, name):
    _check_scalar(PACKAGES[pkg], *_edge(name))


def _outcome(fn, *args):
    """fn's result, or the name of the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:
        return type(e).__name__


def _random_density(seed):
    """Quantized noise over a bimodal density, with zeroed, NaN, +inf and
    repeated stretches: many exact ties between window maxes."""
    rng = np.random.default_rng(seed)
    x, y = _bimodal()
    y = np.round((y + rng.uniform(0, 0.3, 512)) * rng.integers(2, 40)) / 10
    for _ in range(rng.integers(0, 4)):
        a = rng.integers(0, 500)
        y[a:a + rng.integers(1, 40)] = rng.choice([0.0, y[a], np.nan,
                                                   np.inf, -0.0])
    return x, y


CASES = ([("density", s) for s in range(24)] + [("edge", e) for e in EDGES]
         + [("random", s) for s in range(40)])


@pytest.mark.parametrize("kind,case", CASES,
                         ids=[f"{k}-{c}" for k, c in CASES])
def test_port_equals_garlic_tpu(kind, case):
    """The port's scan (cutoff and the located indices, or the exception's
    type) and tie probe are garlic_tpu's."""
    x, y = {"density": _density, "edge": _edge,
            "random": _random_density}[kind](case)
    for fn in ("get_min_btw_modes_indices", "cutoff_tie_probe"):
        got = _outcome(getattr(port_cutoff, fn), x, y, 60)
        want = _outcome(getattr(cutoff_ops, fn), x, y, 60)
        assert got == want, (fn, got, want)
    if len(y) >= 20:
        # the scan's first pass: the value each window start reads
        want = [y[max(cutoff_ops._arg_max_window(y, i, 20) + i, 0)]
                for i in range(len(y) - 20)]
        got = port_cutoff._window_maxes(y[None])[0]
        assert got.tobytes() == np.array(want, np.float64).tobytes()


def test_probe_scans_what_the_counter_counts(monkeypatch):
    """cutoff_tie_probe scans PROBE_SCANS densities where its base scan
    locates the modes, the count pipeline._cutoff_from_kde adds to
    cutoff.scans beside the selection's one."""
    rows = []
    scan = port_cutoff._window_maxes

    def counted(ys):
        rows.append(ys.shape[0])
        return scan(ys)

    monkeypatch.setattr(port_cutoff, "_window_maxes", counted)
    x, y = _bimodal()
    port_cutoff.cutoff_tie_probe(x, y, 60)
    assert sum(rows) == port_cutoff.PROBE_SCANS == 41
