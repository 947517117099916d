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

Processes may share a card (the one-card layout of a multi-process run):
the exchange that lays the mesh also carries an identity of each
process's cards, so each process knows how many processes drive each of
its devices (Mesh.sharers) and budgets only its share of the card
(Mesh.budget).
"""

from __future__ import annotations

import hashlib
import socket
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..runtime import hbm_budget

AXIS_DP = "dp"
AXIS_SP = "sp"
# the distinct cards one process may bring to a multi-process run: the
# survey's row has a fixed width, so it stays one allgather
MAX_CARDS = 64


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
    devices (the list it brought); local: this process's devices;
    sharers: local device -> the number of the run's processes that
    drive its card (1 unless surveyed: survey_devices).
    shape: the axis sizes by name, as jax.sharding.Mesh.shape; size:
    n_dp * n_sp."""

    def __init__(self, devices: np.ndarray, owner: np.ndarray = None,
                 group=None, counts=None, local=None, sharers=None):
        from .multihost import Group
        self.devices = devices
        self.owner = (np.zeros(devices.shape, dtype=np.int64)
                      if owner is None else owner)
        self.group = Group() if group is None else group
        self.counts = [int(devices.size)] if counts is None else counts
        self.local = list(devices.reshape(-1)) if local is None else local
        self.sharers = (dict.fromkeys(self.local, 1) if sharers is None
                        else sharers)
        self.shape = {AXIS_DP: devices.shape[0], AXIS_SP: devices.shape[1]}
        self.size = int(devices.size)

    def budget(self, device) -> float:
        """This process's device-memory budget on `device` (one of its
        own): the card's (runtime.hbm_budget) split evenly among the
        processes that drive it, so their gates together admit what
        one card holds."""
        return hbm_budget(device) / self.sharers[torch.device(device)]

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


def card_identity(device) -> int:
    """A nonzero int64 naming the physical card of a torch device across
    processes: a hash of the host name and the CUDA device's UUID, or of
    the host name and the device type (a process's CPU is its host's)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        i = torch.cuda.current_device() if dev.index is None else dev.index
        tag = str(torch.cuda.get_device_properties(i).uuid)
    else:
        tag = dev.type
    h = hashlib.blake2b(f"{socket.gethostname()}/{tag}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little", signed=True) or 1


def survey_devices(devices: Sequence, group=None
                   ) -> Tuple[List[int], Dict[torch.device, int]]:
    """(counts, sharers): every process's number of devices, in rank
    order, and for each of this process's devices the number of
    processes that drive its card (this one included).  One allgather
    (tag "mesh") of a fixed-width row per process: its device count,
    then the identities of its distinct cards (card_identity), zero
    padded to MAX_CARDS.  A device listed twice by one process counts
    that process once.  Without a group of several processes: no
    exchange, and every device has one sharer."""
    local = [torch.device(d) for d in devices]
    if group is None or group.size == 1:
        return [len(local)], dict.fromkeys(local, 1)
    ids = {d: card_identity(d) for d in local}
    cards = sorted(set(ids.values()))
    if len(cards) > MAX_CARDS:
        raise ValueError(f"{len(cards)} distinct cards in one process; at "
                         f"most {MAX_CARDS}")
    row = np.zeros(1 + MAX_CARDS, dtype=np.int64)
    row[0] = len(local)
    row[1:1 + len(cards)] = cards
    table = group.allgather(row, "mesh")
    counts = [int(c) for c in table[:, 0]]
    sharers = {d: int((table[:, 1:] == i).any(axis=1).sum())
               for d, i in ids.items()}
    return counts, sharers


def make_mesh(n_dp: int, n_sp: int, devices: Sequence, group=None,
              counts: Sequence[int] = None, sharers: dict = None) -> Mesh:
    """Build a ("dp", "sp") Mesh over the first n_dp * n_sp of `devices`
    (torch devices or their names); with a Group of several processes,
    `devices` is this process's list, and the mesh is laid over every
    process's list in rank order.  counts, sharers: survey_devices'
    (surveyed here, one allgather, when counts is not given); a process
    knows only its own devices, and another's cells hold None.

    Adapted from garlic_tpu/parallel/mesh.py:43: explicit sizes and
    devices, torch devices, an object array in place of
    jax.sharding.Mesh, and the processes that share a card."""
    local = [torch.device(d) for d in devices]
    if group is None or group.size == 1:
        counts = [len(local)]
    elif counts is None:
        counts, sharers = survey_devices(local, group)
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
                counts, local, sharers)
