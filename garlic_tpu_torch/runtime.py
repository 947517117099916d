"""Device runtime helpers for the port's fast engine."""

from __future__ import annotations

import itertools
import json
import os
import socket
import sys
import time

import torch

# the runs of this process that took a trace, for unique file names
_TRACES = itertools.count()

DEFAULT_HBM_BUDGET = 8 * 1024 ** 3  # bytes; CPU runs have no device memory


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


class PhaseProfiler:
    """Per-phase wall-clock + throughput counters (--tpu-profile).

    start() opens the first phase; mark() closes the current one (on a
    CUDA device it synchronizes first, so queued kernels are charged to
    the phase that enqueued them).  report() prints a summary to stderr:
    the phases, this process's kernel launches and weighted programs
    (ops/cuda_lod.LAUNCHES, ops/device_wlod.CALLS), on a fast run its
    device budget on the mesh's first device (its share of the card),
    its device-memory peak on a CUDA device, and the exchanges of a
    multi-process run's group.  mesh: the fast engine's
    parallel.mesh.Mesh, None on the exact engine.

    When GARLIC_TPU_TRACE_DIR is set, start() also starts a
    torch.profiler trace of the run (garlic_tpu/runtime.py:28-35): the
    host's operators, and on a CUDA device its kernels and copies.  Each
    mark() puts a zero-length range garlic::mark:<phase> in it, and each
    kernel launch a range garlic::<kernel> (ops/cuda_lod._launch).
    close(), which report() calls, stops the trace and writes it to
    <dir>/garlic_tpu_torch.<host>.p<rank>.<pid>.<n>.pt.trace.json, a
    Chrome trace that Perfetto and TensorBoard open; the pipeline calls
    it on every exit of a run.  A trace that cannot start or be written
    says so on stderr and changes nothing else of the run."""

    def __init__(self, enabled: bool, mesh=None, group=None):
        self.enabled = enabled
        self.mesh = mesh
        self.device = None if mesh is None else torch.device(mesh.first)
        self.group = group
        self.phases = []
        self._trace = None
        self._t0 = time.perf_counter()

    def start(self) -> None:
        """Opens the first phase, and the trace (see the class)."""
        tdir = os.environ.get("GARLIC_TPU_TRACE_DIR")
        if self.enabled and tdir:
            from torch.profiler import ProfilerActivity, profile
            from .ops import cuda_lod
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
                cuda_lod.TRACING = True
        self._t0 = time.perf_counter()

    def close(self) -> None:
        """Stops the trace, if one runs, and writes its file."""
        if self._trace is None:
            return
        from .ops import cuda_lod
        (trace, path), self._trace = self._trace, None
        cuda_lod.TRACING = False
        try:
            trace.stop()
            trace.export_chrome_trace(path)
        except Exception as e:
            print(f"[profile] trace: writing {path} failed: {e!r}",
                  file=sys.stderr)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str, items: float = 0.0, unit: str = ""):
        if not self.enabled:
            return
        self._sync()
        now = time.perf_counter()
        if self._trace is not None:
            with torch.profiler.record_function(f"garlic::mark:{name}"):
                pass
        self.phases.append((name, now - self._t0, items, unit))
        self._t0 = now

    def report(self):
        if not self.enabled:
            return
        self.close()
        total = sum(p[1] for p in self.phases)
        print("[profile] phase breakdown:", file=sys.stderr)
        for name, dt, items, unit in self.phases:
            rate = f"  ({items / dt:,.0f} {unit}/s)" if items and dt > 0 \
                else ""
            print(f"[profile]   {name:<18} {dt:8.3f}s{rate}",
                  file=sys.stderr)
        print(f"[profile]   {'TOTAL':<18} {total:8.3f}s", file=sys.stderr)
        from .ops.cuda_lod import LAUNCHES
        from .ops.device_wlod import CALLS
        print(f"[profile] launches {json.dumps({**LAUNCHES, **CALLS})}",
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
