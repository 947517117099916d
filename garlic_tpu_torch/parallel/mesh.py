"""The device mesh of the port's multi-device runs.

Counterpart of garlic_tpu/parallel/mesh.py.  A run over several devices
lays its shards on a 2-D logical mesh:

* ``dp`` — individuals: every per-individual computation is independent
  across this axis; the LD pair counts, the KDE partials and the GMM
  sufficient statistics are summed over it.
* ``sp`` — loci along a chromosome: a window that straddles a shard edge
  reads the loci of its right neighbour, so each shard's inputs carry a
  (winsize-1)-locus halo (parallel/engine.py).

One process drives every device of the mesh: each shard's tensors live
on its device and its kernels are launched on that device's current
stream.  Whether the shards of different cards then overlap is not
measured: only meshes laid on one card have run, and each shard's
inputs go up in a blocking copy from pageable host memory, which may
keep the host from launching the next shard until the last copy is
done.  A device may appear more than once in the list; its shards then
run one after the other on it (the way to lay a mesh onto fewer cards).
A single device is the 1x1 mesh over it: every fast run has a mesh.

Across processes (parallel/multihost.py) the mesh is laid over every
process's devices, process-major, as jax.devices() orders them: each
cell has an owner process, and a process launches only its own cells;
the partials of the reductions go to every process, which adds them in
shard order on its first device of the mesh.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

AXIS_DP = "dp"
AXIS_SP = "sp"


def factor_devices(n: int, max_sp: int = 4) -> Tuple[int, int]:
    """Pick a (dp, sp) factorization of n devices.

    dp (individuals) is the primary axis — it scales without communication —
    so sp only grows when dp alone cannot use the devices or when asked.

    Copy of garlic_tpu/parallel/mesh.py:30."""
    sp = 1
    for cand in range(min(max_sp, n), 0, -1):
        if n % cand == 0:
            sp = cand
            break
    return n // sp, sp


class Mesh:
    """devices: [n_dp, n_sp] torch devices (an object array), the device
    of each cell this process owns and None for another process's cell;
    owner: [n_dp, n_sp] int, the rank of the process that owns the cell;
    group: the run's multihost.Group; counts: each process's number of
    devices (the list it brought); local: this process's devices.
    shape: the axis sizes by name, as jax.sharding.Mesh.shape; size:
    n_dp * n_sp."""

    def __init__(self, devices: np.ndarray, owner: np.ndarray = None,
                 group=None, counts=None, local=None):
        from .multihost import Group
        self.devices = devices
        self.owner = (np.zeros(devices.shape, dtype=np.int64)
                      if owner is None else owner)
        self.group = Group() if group is None else group
        self.counts = [int(devices.size)] if counts is None else counts
        self.local = list(devices.reshape(-1)) if local is None else local
        self.shape = {AXIS_DP: devices.shape[0], AXIS_SP: devices.shape[1]}
        self.size = int(devices.size)

    def owns(self, d: int, s: int) -> bool:
        """Whether this process launches cell (d, s)."""
        return int(self.owner[d, s]) == self.group.rank

    @property
    def first(self) -> torch.device:
        """The device that holds this process's reductions: its first
        cell's device (the mesh's first device on one process), or its
        first device when it owns no cell."""
        mine = self.devices[self.owner == self.group.rank]
        return mine[0] if mine.size else self.local[0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[AXIS_DP]}x{self.shape[AXIS_SP]} over "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(n_dp: int, n_sp: int, devices: Sequence, group=None,
              counts: Sequence[int] = None) -> Mesh:
    """Build a ("dp", "sp") Mesh over the first n_dp * n_sp of `devices`
    (torch devices or their names); with a Group of several processes,
    `devices` is this process's list, and the mesh is laid over every
    process's list in rank order.  counts: every process's number of
    devices, in rank order (gathered here, one allgather, when not
    given); a process knows only its own devices, and another's cells
    hold None.

    Adapted from garlic_tpu/parallel/mesh.py:43: explicit sizes and
    devices, torch devices, and an object array in place of
    jax.sharding.Mesh."""
    local = [torch.device(d) for d in devices]
    if group is None or group.size == 1:
        counts = [len(local)]
    elif counts is None:
        counts = group.allgather(np.array([len(local)], dtype=np.int64),
                                 "mesh")[:, 0]
    counts = [int(c) for c in counts]
    rank = 0 if group is None else group.rank
    placed = [(r, local[i] if r == rank else None)
              for r, c in enumerate(counts) for i in range(c)]
    n = len(placed)
    if n_dp * n_sp > n:
        raise ValueError(f"mesh {n_dp}x{n_sp} exceeds {n} devices")
    devs = np.empty(n_dp * n_sp, dtype=object)
    devs[:] = [d for _, d in placed[: n_dp * n_sp]]
    owner = np.array([r for r, _ in placed[: n_dp * n_sp]], dtype=np.int64)
    return Mesh(devs.reshape(n_dp, n_sp), owner.reshape(n_dp, n_sp), group,
                counts, local)
