"""K2's share of its roofline, in %: the least time the card could take
for K2's work in a call over the device time the trace gives K2.

K2 (gt_covered, csrc/lod_windows.cu) scores a chromosome's windows and
counts their coverage.  Its work, from the call's shapes (I individuals,
L loci after the monomorphic filter, nwin = L - W + 1 windows), the same
whatever kernel does it: the adds that the window sums need in GARLIC's
rolling order (reference.rolling_windows: W - 1 for a row's first
window, then one subtraction and one add a window), I * (W - 1 +
2 * (nwin - 1)), at sms x f32 lanes x clock; and each byte read once and
written once, at the HBM rate: the 2-bit codes I * ceil(L / 4), the f32
LOD table 3 * L * 4, the window mask nwin in; the covered plane I * L
and the suspect and above planes I * nwin each out.  The bound is the
larger of the two; at the cells' shapes the bytes set it, the adds'
term being some seventeenth of theirs."""

import math


def bound_s(peaks, nind, kept, winsize):
    adds = nbytes = 0
    for L in kept:
        nwin = L - winsize + 1
        adds += nind * (winsize - 1 + 2 * (nwin - 1))
        nbytes += (nind * math.ceil(L / 4) + 12 * L + nwin
                   + nind * L + 2 * nind * nwin)
    lanes = peaks["sms"] * peaks["f32_lanes_per_sm"] * peaks["clock_hz"]
    return max(adds / lanes, nbytes / peaks["hbm_bytes_per_s"])


def read(w):
    if w.peaks is None:
        return None
    need = took = 0.0
    for c in w.calls:
        k2 = (c.trace or {}).get("ops", {}).get("K2")
        if k2:
            need += bound_s(w.peaks, w.nind, w.kept[c.panel], w.winsize)
            took += k2[1] / 1e3
    return 100.0 * need / took if took > 0 else None
