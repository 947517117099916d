"""Mean device ms a traced call spends in host-to-device copies."""


def read(w):
    tr = [c.trace for c in w.calls if c.trace]
    return sum(t["kinds"]["H2D"] for t in tr) / len(tr) if tr else None
