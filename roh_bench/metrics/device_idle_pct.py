"""Share of the traced calls' windows in which the device ran no
kernel, copy or memset (the union rule of trace.trace_summary), in %."""


def read(w):
    tr = [c.trace for c in w.calls if c.trace]
    win = sum(t["window"] for t in tr)
    if not tr or win <= 0:
        return None
    return 100.0 * (1.0 - sum(t["busy"] for t in tr) / win)
