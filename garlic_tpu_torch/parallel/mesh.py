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
    """devices: [n_dp, n_sp] torch devices (an object array); shape: the
    axis sizes by name, as jax.sharding.Mesh.shape; size: n_dp * n_sp."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {AXIS_DP: devices.shape[0], AXIS_SP: devices.shape[1]}
        self.size = int(devices.size)

    @property
    def first(self) -> torch.device:
        """The device that holds the mesh's reductions."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[AXIS_DP]}x{self.shape[AXIS_SP]} over "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(n_dp: int, n_sp: int, devices: Sequence) -> Mesh:
    """Build a ("dp", "sp") Mesh over the first n_dp * n_sp of `devices`
    (torch devices or their names).

    Adapted from garlic_tpu/parallel/mesh.py:43: explicit sizes and
    devices, torch devices, and an object array in place of
    jax.sharding.Mesh."""
    n = len(devices)
    if n_dp * n_sp > n:
        raise ValueError(f"mesh {n_dp}x{n_sp} exceeds {n} devices")
    devs = np.empty(n_dp * n_sp, dtype=object)
    devs[:] = [torch.device(d) for d in devices[: n_dp * n_sp]]
    return Mesh(devs.reshape(n_dp, n_sp))
