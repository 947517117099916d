"""Device runtime helpers for the port's fast engine, and its recorder of
phases, spans and counters (--tpu-profile)."""

from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import threading
import time

import torch

# the runs of this process that took a trace, for unique file names
_TRACES = itertools.count()

DEFAULT_HBM_BUDGET = 8 * 1024 ** 3  # bytes; CPU runs have no device memory

# the pipeline's phases, in the order its marks close them
PHASES = ("load", "freq", "filter", "phase1-lod", "phase2-cutoff",
          "phase3-assembly", "phase4-gmm", "write-bed")

# the running call's recorder: an enabled PhaseProfiler from its start()
# to its close(), else None, and span(), count() and the helpers below
# do nothing
_REC = None


def _checked(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def resolve_devices(device=None) -> list:
    """The fast engine's devices, for its mesh to span: None means every
    visible CUDA device, and raises when there is none (the fast engine
    never drops silently to the CPU; the CPU tests ask for it explicitly
    with "cpu"); a list, each of its entries (a device may repeat); else
    the one device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if isinstance(device, (list, tuple)):
        if not device:
            raise RuntimeError("an empty device list")
        return [_checked(d) for d in device]
    return [_checked(device)]


class _Off:
    """The shared span of a call that records nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager that times one step of the running call.

    With no recorder it is a shared no-op (one global read).  Under
    --tpu-profile the step is kept as (path, parent, thread, start, end),
    its times in ns on time.time_ns()'s clock, which is the trace's
    (its ts + baseTimeNanoseconds); and while the call's trace records, a
    span on the thread that started the recorder is also the trace range
    garlic::span:<path>.  path: `name` under the innermost span open on
    this thread (the main thread's phase, when no step is open), or
    `name` itself where no span is open or it holds a "/"."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(key: str, n: int = 1) -> None:
    """Adds n to the running call's counter `key` (see
    PhaseProfiler.counters); nothing without a recorder."""
    rec = _REC
    if rec is not None:
        with rec._lock:
            rec._counts[key] = rec._counts.get(key, 0) + n


def kernel_range(key: str):
    """The trace range garlic::<key> around a hand kernel's launch while
    the running call's trace records, else the shared no-op."""
    rec = _REC
    if rec is None or rec._trace is None:
        return _OFF
    return torch.profiler.record_function(f"garlic::{key}")


def waiting(t: torch.Tensor):
    """span("wait") around a host step that blocks on t's device (a
    synchronize, a blocking copy, a size read); the no-op for a CPU
    tensor, which waits for no device."""
    return _OFF if t.device.type == "cpu" else span("wait")


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """t.to(device); a copy from the host to a device counts its bytes
    in h2d_bytes."""
    out = t.to(device)
    if _REC is not None and t.device.type == "cpu" \
            and out.device.type != "cpu":
        count("h2d_bytes", t.numel() * t.element_size())
    return out


def to_host(t: torch.Tensor):
    """t as a host numpy array: from a device, one blocking copy, timed as
    a `wait` span and counted in d2h_bytes; a CPU tensor's own memory."""
    if t.device.type == "cpu":
        return t.numpy()
    with span("wait"):
        out = t.cpu()
    count("d2h_bytes", out.numel() * out.element_size())
    return out.numpy()


class _Span:
    __slots__ = ("rec", "name", "path", "parent", "t0", "range")

    def __init__(self, rec, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        self.rec._open(self, time.time_ns())
        return self

    def __exit__(self, *exc):
        self.rec._close(self, time.time_ns())
        return False


class PhaseProfiler:
    """The run's recorder under --tpu-profile: phases, the spans inside
    them and per-call counters.

    start() opens the first phase (PHASES[0]); mark(name) closes the
    open one, after a synchronize on a CUDA device (the span <phase>/wait)
    so that queued kernels are charged to the phase that enqueued them,
    and opens the next.  While the recorder runs, runtime.span() keeps
    every step any module times, under its phase, and runtime.count()
    the call's counters.  report() prints to stderr, after the call's
    last step (call/finish):
      * the phase breakdown (the phases' seconds and rates);
      * the span breakdown, one line a span path below the phases, its
        seconds summed over the call and its count:
        `[profile]   <path>   <seconds>s  <n> spans`, with call/start
        (the run's entry to the first phase), call/finish (the .freq.gz
        writer's join and the log's close), call/export (the trace's
        stop and export) and freq-writer (the writer thread's work);
        call/start, call/export and freq-writer are not in the trace;
      * `[profile] counters {json}`: this call's kernel launches
        (ops/cuda_lod.LAUNCHES and ops/device_wlod.CALLS since start()),
        h2d_bytes and d2h_bytes (to_device, to_host), the pool's pooled
        and replayed and the chromosomes it pooled on a device
        (pool.device) and on the host (pool.host), the sidecar's and the
        .freq.gz blob's hit and miss, the tie patrol's suspects and
        flip_rows, and the 2-bit codes' column compactions on a device
        (pack.device, one a shard) and on the host (pack.host, one a
        chromosome), and the densities
        the cutoff search scanned (cutoff.scans: 42 per cutoff selected,
        the selection and its rivals' probe);
      * on a fast run its device budget on the mesh's first device (its
        share of the card), its device-memory peak on a CUDA device, and
        the exchanges of a multi-process run's group.
    mesh: the fast engine's parallel.mesh.Mesh, None on the exact engine.
    t_call: the call's entry, ns on time.time_ns()'s clock (None: the
    recorder's making).

    When GARLIC_TPU_TRACE_DIR is set, start() also starts a
    torch.profiler trace of the run (garlic_tpu/runtime.py:28-35): the
    host's operators, and on a CUDA device its kernels and copies.  The
    range garlic::span:call holds the call from the trace's start to its
    stop, each phase is a range garlic::span:<phase> in it, each mark a
    zero-length range garlic::mark:<phase> after it, each span of the
    main thread a range garlic::span:<path> and each kernel launch a
    range garlic::<kernel> (ops/cuda_lod._launch).  close(), which report()
    calls, stops the trace and writes it to
    <dir>/garlic_tpu_torch.<host>.p<rank>.<pid>.<n>.pt.trace.json, a
    Chrome trace that Perfetto and TensorBoard open; the pipeline calls
    it on every exit of a run.  A trace that cannot start or be written
    says so on stderr and changes nothing else of the run."""

    def __init__(self, enabled: bool, mesh=None, group=None, t_call=None):
        self.enabled = enabled
        self.mesh = mesh
        self.device = None if mesh is None else torch.device(mesh.first)
        self.group = group
        self.phases = []
        # (path, parent path or None, thread ident, start ns, end ns)
        self.spans = []
        self._t_call = time.time_ns() if t_call is None else t_call
        self._trace = None
        self._call_range = None
        self._started = False
        self._phase = None
        self._main = None
        self._local = threading.local()
        self._lock = threading.Lock()
        self._counts = {}
        self._base = {}
        self._t0 = self._t_call

    # -- spans ---------------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, sp: _Span, now: int) -> None:
        stack = self._stack()
        parent = stack[-1].path if stack else None
        sp.parent = None if "/" in sp.name else parent
        sp.path = sp.name if sp.parent is None else f"{parent}/{sp.name}"
        sp.range = None
        if self._trace is not None and threading.get_ident() == self._main:
            sp.range = torch.profiler.record_function(
                f"garlic::span:{sp.path}")
            sp.range.__enter__()
        stack.append(sp)
        sp.t0 = now

    def _close(self, sp: _Span, now: int) -> None:
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
        self.spans.append((sp.path, sp.parent, threading.get_ident(),
                           sp.t0, now))

    def span_table(self) -> dict:
        """{path: [seconds, self seconds, count]} of the call's spans in
        the order they first opened; a span's self time is its time less
        its children's."""
        out = {}
        for path, _, _, t0, t1 in sorted(self.spans, key=lambda s: s[3]):
            row = out.setdefault(path, [0.0, 0.0, 0])
            row[0] += (t1 - t0) / 1e9
            row[1] += (t1 - t0) / 1e9
            row[2] += 1
        for path, parent, _, t0, t1 in self.spans:
            if parent is not None and parent in out:
                out[parent][1] -= (t1 - t0) / 1e9
        return out

    # -- counters ------------------------------------------------------------
    def counters(self) -> dict:
        """This call's counters (see the class)."""
        from .ops.cuda_lod import LAUNCHES
        from .ops.device_wlod import CALLS
        now = {**LAUNCHES, **CALLS}
        c = self._counts
        return {
            "launches": {k: v - self._base.get(k, 0) for k, v in now.items()},
            "h2d_bytes": c.get("h2d_bytes", 0),
            "d2h_bytes": c.get("d2h_bytes", 0),
            "pool": {k: c.get(f"pool.{k}", 0)
                     for k in ("pooled", "replayed", "device", "host")},
            "sidecar": {k: c.get(f"sidecar.{k}", 0) for k in ("hit", "miss")},
            "freq_blob": {k: c.get(f"freq_blob.{k}", 0)
                          for k in ("hit", "miss")},
            "patrol": {k: c.get(f"patrol.{k}", 0)
                       for k in ("suspects", "flip_rows")},
            "pack": {k: c.get(f"pack.{k}", 0) for k in ("device", "host")},
            "cutoff": {"scans": c.get("cutoff.scans", 0)}}

    # -- the call ------------------------------------------------------------
    def start(self) -> None:
        """Becomes the running recorder, starts the trace (see the class)
        and opens the first phase; call/start ends here."""
        global _REC
        if not self.enabled:
            return
        from .ops.cuda_lod import LAUNCHES
        from .ops.device_wlod import CALLS
        self._base = {**LAUNCHES, **CALLS}
        self._counts = {}
        self._main = threading.get_ident()
        self._started = True
        tdir = os.environ.get("GARLIC_TPU_TRACE_DIR")
        if tdir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            rank = 0 if self.group is None else self.group.rank
            path = os.path.join(
                tdir, f"garlic_tpu_torch.{socket.gethostname()}.p{rank}."
                      f"{os.getpid()}.{next(_TRACES)}.pt.trace.json")
            try:
                os.makedirs(tdir, exist_ok=True)
                trace = profile(activities=activities)
                trace.start()
            except Exception as e:  # the run goes on untraced, and says so
                print(f"[profile] trace: torch.profiler did not start: "
                      f"{e!r}", file=sys.stderr)
            else:
                self._trace = (trace, path)
                # the traced call, so that a host stretch that no one
                # phase or step holds half of is still named in the trace
                self._call_range = torch.profiler.record_function(
                    "garlic::span:call")
                self._call_range.__enter__()
        _REC = self
        now = time.time_ns()
        self.spans.append(("call/start", None, self._main, self._t_call,
                           now))
        self._next_phase(now)

    def _next_phase(self, now: int) -> None:
        """Opens the phase after the marked ones, if one is left."""
        if len(self.phases) < len(PHASES):
            self._phase = _Span(self, PHASES[len(self.phases)])
            self._open(self._phase, now)
        self._t0 = now

    def end_phases(self, now: int = None) -> None:
        """Closes the open phase, and every step still open above it: an
        early return's or a raise's; its time is then no phase's."""
        if self._phase is None:
            return
        now = time.time_ns() if now is None else now
        stack = self._stack()
        while stack and stack[-1] is not self._phase:
            self._close(stack[-1], now)
        self._close(self._phase, now)
        self._phase = None

    def mark(self, name: str, items: float = 0.0, unit: str = ""):
        if not self.enabled or not self._started:
            return
        if self.device is not None and self.device.type == "cuda":
            with span("wait"):
                torch.cuda.synchronize(self.device)
        now = time.time_ns()
        self.end_phases(now)
        if self._trace is not None:
            with torch.profiler.record_function(f"garlic::mark:{name}"):
                pass
        self.phases.append((name, (now - self._t0) / 1e9, items, unit))
        self._next_phase(now)

    def close(self) -> None:
        """Stops the trace, if one runs, and writes its file (timed as
        call/export); the recorder stops recording."""
        global _REC
        self.end_phases()
        if _REC is self:
            _REC = None
        if self._trace is None:
            return
        (trace, path), self._trace = self._trace, None
        t0 = time.time_ns()
        try:
            self._call_range.__exit__(None, None, None)
            trace.stop()
            trace.export_chrome_trace(path)
        except Exception as e:
            print(f"[profile] trace: writing {path} failed: {e!r}",
                  file=sys.stderr)
        self.spans.append(("call/export", None, self._main, t0,
                           time.time_ns()))

    def report(self):
        """Closes the recorder and prints the report (see the class); a
        call that never started its recorder prints nothing."""
        if not self.enabled:
            return
        self.close()
        if not self._started:
            return
        total = sum(p[1] for p in self.phases)
        print("[profile] phase breakdown:", file=sys.stderr)
        for name, dt, items, unit in self.phases:
            rate = f"  ({items / dt:,.0f} {unit}/s)" if items and dt > 0 \
                else ""
            print(f"[profile]   {name:<18} {dt:8.3f}s{rate}",
                  file=sys.stderr)
        print(f"[profile]   {'TOTAL':<18} {total:8.3f}s", file=sys.stderr)
        print("[profile] span breakdown:", file=sys.stderr)
        for path, (sec, _, n) in self.span_table().items():
            if path not in PHASES:
                print(f"[profile]   {path:<34} {sec:.6f}s  {n} spans",
                      file=sys.stderr)
        print(f"[profile] counters {json.dumps(self.counters())}",
              file=sys.stderr)
        if self.mesh is not None:
            n = self.mesh.sharers[self.device]
            share = self.mesh.budget(self.device)
            print(f"[profile] device budget {share:.0f} bytes on "
                  f"{self.device}: 1/{n} of the card's, shared "
                  f"by {n} process{'es' if n > 1 else ''}", file=sys.stderr)
        if self.device is not None and self.device.type == "cuda":
            print(f"[profile] device-memory peak "
                  f"{torch.cuda.max_memory_allocated(self.device)} bytes",
                  file=sys.stderr)
        if self.group is not None and self.group.size > 1:
            print(self.group.report(), file=sys.stderr)


def hbm_budget(device) -> float:
    """Usable device-memory bytes for window planes on one card.

    `GARLIC_TPU_HBM_BUDGET` (raw bytes, one card's, as in the JAX
    package) overrides; else 90% of the CUDA device's total memory
    (torch.cuda.mem_get_info); else 8 GiB (CPU runs).  Processes that
    share the card split it: parallel.mesh.Mesh.budget gives each its
    share."""
    v = os.environ.get("GARLIC_TPU_HBM_BUDGET")
    if v:
        return float(v)
    dev = torch.device(device)
    if dev.type == "cuda":
        _, total = torch.cuda.mem_get_info(dev)
        return 0.9 * float(total)
    return float(DEFAULT_HBM_BUDGET)
