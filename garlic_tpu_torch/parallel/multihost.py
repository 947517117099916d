"""Multi-process runs of the port: one process per host.

Counterpart of garlic_tpu/parallel/multihost.py.  Every host runs the
same command; the three environment variables wire the processes into
one torch.distributed process group, and --tpu-mesh then spans every
process's devices (parallel/mesh.py: each cell of the mesh is owned by
the process whose device it is):

    GARLIC_TPU_COORD=host0:8476 GARLIC_TPU_NUM_PROCS=4 \\
    GARLIC_TPU_PROC_ID=$SLURM_PROCID \\
    python -m garlic_tpu_torch --tped ... --tpu-mesh 16x2

There is no counterpart of JAX's Cloud-TPU autodetect: without the
variables the run is one process, and a set of them that is not
complete is refused.

The group's backend is gloo, on the card too: every exchange between
processes is of host arrays (partials fetched from the devices), as
every exchange garlic_tpu makes outside a shard_map is a
multihost_utils.process_allgather of host arrays, and NCCL refuses two
ranks of one communicator on one device, which is how a run is laid on
one card.  The kernels still run on each process's devices.

Float reductions across processes are an allgather of each shard's
partial followed by the same ordered add on every process, so their
bits do not depend on the process count; integer counts and maxima,
which are exact in any order, use all_reduce.  Each exchange is
counted per tag (calls, bytes, seconds: Group.stats).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Tuple

import numpy as np

ENV = ("GARLIC_TPU_COORD", "GARLIC_TPU_NUM_PROCS", "GARLIC_TPU_PROC_ID")
# a collective (or the rendezvous) that waits longer than this ends the
# run with an error: a stuck process stops its peers in minutes
TIMEOUT_S = 300


class Group:
    """The processes of one run, and the exchanges between them over
    torch.distributed's gloo group; Group() is a run of one process,
    whose exchanges return their input.

    stats: tag -> [calls, bytes, seconds] of this process's exchanges;
    bytes counts the copies of its own data the other processes
    receive ((size - 1) times the local buffer, the root's for a
    broadcast), computed from the buffers' sizes; seconds is the wall
    time inside the exchange, waiting for the peers included."""

    def __init__(self, rank: int = 0, size: int = 1):
        self.rank = rank
        self.size = size
        self.stats = {}

    def _count(self, tag: str, nbytes: int, t0: float) -> None:
        s = self.stats.setdefault(tag, [0, 0, 0.0])
        s[0] += 1
        s[1] += int(nbytes) * (self.size - 1)
        s[2] += time.perf_counter() - t0

    @staticmethod
    def _bytes(arr: np.ndarray):
        import torch
        return torch.from_numpy(
            np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy())

    def allgather(self, arr, tag: str) -> np.ndarray:
        """[size, *arr.shape] of every process's `arr` (same shape and
        dtype everywhere), in rank order; the dtype is kept."""
        arr = np.asarray(arr)
        if self.size == 1:
            return arr[None]
        if arr.size == 0:  # the same shape on every process
            return np.empty((self.size,) + arr.shape, dtype=arr.dtype)
        import torch
        import torch.distributed as dist
        t0 = time.perf_counter()
        x = self._bytes(arr)
        out = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(out, x)
        self._count(tag, x.numel(), t0)
        return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                         for o in out])

    def allgather_varlen(self, arr, tag: str) -> list:
        """Every process's 1-D `arr` (lengths may differ, the dtype is
        the same everywhere), in rank order: the lengths are gathered,
        the arrays padded to the longest and gathered, then cut back
        (garlic_tpu/pipeline.py:1643-1660)."""
        arr = np.ascontiguousarray(arr).reshape(-1)
        if self.size == 1:
            return [arr]
        ns = self.allgather(np.array([arr.size], dtype=np.int64), tag)[:, 0]
        pad = np.zeros(max(int(ns.max()), 1), dtype=arr.dtype)
        pad[:arr.size] = arr
        allp = self.allgather(pad, tag)
        return [allp[r, :int(ns[r])] for r in range(self.size)]

    def broadcast(self, arr, tag: str) -> np.ndarray:
        """Process 0's `arr` on every process (same shape and dtype)."""
        arr = np.asarray(arr)
        if self.size == 1:
            return arr
        import torch.distributed as dist
        t0 = time.perf_counter()
        x = self._bytes(arr)
        dist.broadcast(x, src=0)
        self._count(tag, x.numel() if self.rank == 0 else 0, t0)
        return x.numpy().view(arr.dtype).reshape(arr.shape)

    def _all_reduce(self, arr, op, tag: str) -> np.ndarray:
        arr = np.asarray(arr)
        if self.size == 1:
            return arr
        import torch
        import torch.distributed as dist
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(arr).copy())
        dist.all_reduce(x, op=op)
        self._count(tag, x.numel() * x.element_size(), t0)
        return x.numpy()

    def sum_int(self, arr, tag: str) -> np.ndarray:
        """The sum over the processes of an integer array: exact, so the
        backend's order does not matter."""
        import torch.distributed as dist
        arr = np.asarray(arr)
        if arr.dtype.kind not in "iu":
            raise TypeError(f"sum_int of a {arr.dtype} array")
        return self._all_reduce(arr, dist.ReduceOp.SUM, tag)

    def max(self, arr, tag: str) -> np.ndarray:
        """The elementwise maximum over the processes (order-free)."""
        import torch.distributed as dist
        return self._all_reduce(arr, dist.ReduceOp.MAX, tag)

    def any(self, flag: bool, tag: str) -> bool:
        """True on every process when `flag` is true on one of them."""
        return bool(self.max(np.array([1 if flag else 0], dtype=np.int32),
                             tag)[0])

    def close(self) -> None:
        """Leave the process group (a no-op for one process)."""
        if self.size > 1:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()

    def report(self) -> str:
        """One line per tag: calls, bytes and seconds of the exchanges."""
        return "\n".join(
            f"[garlic-tpu-torch] exchange {tag}: {c} calls, {b} bytes, "
            f"{s:.6f}s" for tag, (c, b, s) in sorted(self.stats.items()))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> Group:
    """The run's Group: explicit arguments, else the GARLIC_TPU_COORD /
    GARLIC_TPU_NUM_PROCS / GARLIC_TPU_PROC_ID variables.  None of them
    set: one process.  Some but not all: ValueError with one ERROR line
    (nothing waits on a rendezvous that cannot complete).  All: a gloo
    process group over tcp://COORD whose collectives, and the
    rendezvous, give up after TIMEOUT_S seconds (RuntimeError).

    Adapted from garlic_tpu/parallel/multihost.py:41: a torch.distributed
    group in place of jax.distributed, no autodetect, and the group
    returned in place of a flag."""
    env = [os.environ.get(v) or None for v in ENV]
    vals = [coordinator, num_processes, process_id]
    vals = [e if v is None else v for v, e in zip(vals, env)]
    if all(v is None for v in vals):
        return Group()
    missing = [name for name, v in zip(ENV, vals) if v is None]
    if missing:
        raise ValueError(f"ERROR: a multi-process run needs all of "
                         f"{', '.join(ENV)}; {', '.join(missing)} not set")
    try:
        size, rank = int(vals[1]), int(vals[2])
    except ValueError:
        raise ValueError(f"ERROR: {ENV[1]} and {ENV[2]} must be integers")
    if size < 1 or not 0 <= rank < size:
        raise ValueError(f"ERROR: {ENV[2]}={rank} is not a process of "
                         f"{ENV[1]}={size}")
    if size == 1:
        return Group()
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://{vals[0]}", world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Group(rank, size)


def initialize_from_env() -> Group:
    """Pipeline entry hook: the run's Group from the three variables
    (Group() when none is set).

    Adapted from garlic_tpu/parallel/multihost.py:88: the Group in place
    of (process_count, process_index)."""
    return initialize_distributed()


def host_individual_range(nind: int, mesh) -> Tuple[int, int]:
    """This process's contiguous [start, stop) of the individual axis
    when each process loads only its own rows: the rows of the dp rows
    of `mesh` it owns (each dp row a slot of ceil(nind / dp) rows, as
    parallel.engine.shard_blocks lays them), which on a dp-aligned
    layout is garlic_tpu/pipeline.py:419-429's range.

    Adapted from garlic_tpu/parallel/multihost.py:76: the range over the
    mesh's dp slots in place of ceil(nind / processes)."""
    from .mesh import AXIS_DP
    per = -(-nind // mesh.shape[AXIS_DP])
    rows = [d for d in range(mesh.shape[AXIS_DP])
            if (mesh.owner[d] == mesh.group.rank).any()]
    if not rows:
        return nind, nind
    start = min(rows[0] * per, nind)
    return start, min((rows[-1] + 1) * per, nind)


def dp_layout_aligned(mesh) -> bool:
    """True when every process's devices form whole dp rows of `mesh`
    (the condition for per-process dp-row blocks: each process brings
    the same number of devices, that count divides into complete sp
    rows, the dp extent splits evenly over the processes and the mesh
    uses every device).

    Adapted from garlic_tpu/parallel/multihost.py:147: the local device
    counts come from the mesh, which holds every process's."""
    from .mesh import AXIS_DP, AXIS_SP
    counts = mesh.counts
    d, p = counts[0], len(counts)
    n_dp, n_sp = mesh.shape[AXIS_DP], mesh.shape[AXIS_SP]
    return (all(c == d for c in counts) and d % n_sp == 0
            and n_dp % p == 0 and n_dp * n_sp == d * p)
