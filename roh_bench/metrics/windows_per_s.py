"""Windows scored per second over the whole window: individuals x the
sum over chromosomes of (L - W + 1) generated loci, times the calls
completed, over the window's seconds (bench.py's window count, taken
over all the calls and all the time)."""


def read(w):
    per_call = w.nind * sum(L - w.winsize + 1 for L in w.snps)
    done = sum(1 for c in w.calls if c.rc == 0)
    return per_call * done / w.seconds if w.seconds > 0 else None
