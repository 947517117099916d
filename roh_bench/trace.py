"""Reading a call's torch.profiler trace: the device's busy and idle
time, device time by kind and by operation, and the idle gaps by phase
and host operation.

Frozen copies of chip_smoke.py's reader, so that a later change to the
smoke cannot move the benchmark's numbers: K_SYMBOLS (chip_smoke.py:373),
DEVICE_CATS and MARK (:366-367), kernel_name (:2847), _union (:2864),
_copy_kind (:2875), _gap_host (:2882) and trace_summary (:2899).  The
summary also returns every operation and gap, where the smoke keeps the
top few, so that the benchmark can add them up over a window of calls.
"""

from __future__ import annotations

import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "garlic::mark:"
# a hand kernel's symbol, demangled or not, and its K-name: the first
# pattern that matches names it (K6's symbol holds K1's name)
K_SYMBOLS = ((r"wlod_windows_kernel", "K6"), (r"pair_counts_kernel", "K5"),
             (r"lod_windows_kernel.*PlaneTerms", "K3"),
             (r"lod_windows_kernel", "K1"),
             (r"covered_kernel.*PlaneTerms", "K4"), (r"covered_kernel", "K2"),
             (r"k7_[a-z]+_kernel", "K7"), (r"(?<![A-Za-z_])em_kernel", "K8"))


def kernel_name(symbol):
    """A device kernel's name: a hand kernel's K-name (K_SYMBOLS), else
    the function's own name without its scope, template and parameters,
    with the functor of a templated kernel (elementwise, reduce) in
    brackets."""
    for pattern, k in K_SYMBOLS:
        if re.search(pattern, symbol):
            return k
    s = symbol.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", s, maxsplit=1)[0]
    rest = s[len(base):]
    base = base.rsplit("::", 1)[-1]
    fn = re.search(r"\b([A-Za-z_]\w*?(?:Functor\w*|_functor|_kernel_cuda|"
                   r"_kernel_impl|_kernel))\b", rest)
    return f"{base}[{fn.group(1)}]" if fn else base


def _union(spans):
    """The spans (start, end) merged: sorted, disjoint [start, end]s."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _copy_kind(name):
    for tag, kind in (("HtoD", "H2D"), ("DtoH", "D2H"), ("DtoD", "D2D")):
        if tag in name:
            return kind
    return "memcpy"


def _gap_host(host, a, b):
    """(name, share of the gap) of the host operation in the gap [a, b]:
    the innermost (shortest) host event that covers at least half of it,
    else "python" and the share of the gap no host event covers."""
    best = None
    for e in host:
        cover = min(e["ts"] + e["dur"], b) - max(e["ts"], a)
        if cover >= 0.5 * (b - a) and (best is None or e["dur"] < best[1]):
            best = (e["name"], e["dur"], cover)
    if best is not None:
        return best[0], best[2] / (b - a)
    covered = sum(y - x for x, y in _union(
        (max(e["ts"], a), min(e["ts"] + e["dur"], b)) for e in host
        if e["ts"] < b and e["ts"] + e["dur"] > a))
    return "python", 1.0 - covered / (b - a)


def trace_summary(doc, top_gaps=10):
    """What a call's Chrome trace (`doc`, the parsed JSON that
    runtime.PhaseProfiler writes) says; times in ms.  The traced window
    runs from the trace's first event to its last garlic::mark:* (the
    call's last phase mark).  The device is busy in the union of its
    kernels, copies and memsets inside the window; the rest of the
    window is its idle gaps, each named by the phases it falls in and
    the host operation in it.  Returns window, busy, kinds (device ms by
    kind), ops (name -> [count, ms], hand kernels by K-name), gaps (the
    top_gaps longest as (ms, phases, host operation, its share)) and
    marks."""
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    marks = sorted((e["ts"], e["name"][len(MARK):]) for e in ev
                   if e["name"].startswith(MARK))
    if not marks:
        raise ValueError(f"the trace holds no {MARK}* event")
    t0, t1 = min(e["ts"] for e in ev), marks[-1][0]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                  for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0)
    edges = [t0] + [x for span in busy for x in span] + [t1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                   if b > a), reverse=True)[:top_gaps]
    phases = [(s, e, name) for s, (e, name)
              in zip([t0] + [m[0] for m in marks[:-1]], marks)]
    host = [e for e in ev if e.get("cat") not in DEVICE_CATS + (
        "Trace", "gpu_user_annotation", "overhead")
        and not e["name"].startswith(MARK)]
    kinds = dict.fromkeys(("kernels", "H2D", "D2H", "D2D", "memcpy",
                           "memset"), 0.0)
    ops = {}
    for e in dev:
        if e["cat"] == "kernel":
            name, kind = kernel_name(e["name"]), "kernels"
        else:
            name = e["name"]
            kind = "memset" if e["cat"] == "gpu_memset" else \
                _copy_kind(name)
        kinds[kind] += e["dur"] / 1e3
        n_ms = ops.setdefault(name, [0, 0.0])
        n_ms[0] += 1
        n_ms[1] += e["dur"] / 1e3
    return {
        "window": (t1 - t0) / 1e3,
        "busy": sum(b - a for a, b in busy) / 1e3,
        "kinds": kinds, "ops": ops,
        "gaps": [(g / 1e3, "+".join(name for s, e, name in phases
                                    if s < b and e > a),
                  *_gap_host(host, a, b)) for g, a, b in gaps],
        "marks": [name for _, name in marks]}
