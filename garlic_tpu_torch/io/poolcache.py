"""Phase-II exact-sample pool cache (a `--tpu-panel-cache` sidecar).

Copy of garlic_tpu/io/poolcache.py with its three known faults mended:

1. `pool_key` hashes `first_copy` on phased runs (garlic_tpu's key leaves
   it out, :54, so a re-phased panel would reuse a stale pool);
2. the meta records the pool's content digest beside its key, and
   `lookup` rejects a `.npy` whose digest differs (garlic_tpu replaces the
   `.npy` before the `.json`, :151, so a lookup can pair old meta with
   new data);
3. each (winsize, step) key has its own slot (garlic_tpu keeps one slot
   per sidecar, :109, which every auto-winsize candidate overwrites):
   file names carry the key, and at most MAX_SLOTS slots are kept per
   sidecar, the least recently stored evicted first.

Files, next to the `.gtpc` sidecar:

  <sidecar>.p2pool.<key>.npy    the pool in its original pooling order, f64
  <sidecar>.p2pool.<key>.json   {key, digest, n, h, mn, mx}; floats as C
                                hex literals, bit-exact

The grid scalars are what ops.kde._kde_grid computes from the
pool, so a warm run rebuilds the identical 512-point grid.  The store is
synchronous: a cold run is bound by parsing the panel, and a pool written
before the run ends is there for the next run, in or out of process.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

import numpy as np

from ..core.digest import content_digest

MAX_SLOTS = 8  # pools kept per sidecar


# copy of garlic_tpu/io/poolcache.py:37, first_copy hashed when phased
def pool_key(chroms, winsize: int, step: int, error: float, max_gap: int,
             use_gl: bool, centro, weighted: bool = False, mu: float = 0.0,
             M: int = 0, phased: bool = False,
             sub_idx=None) -> Optional[bytes]:
    """16-byte content key of everything the pool's values depend on, or
    None when a chromosome lacks the sidecar-derived genotype digest."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    h.update(np.array([winsize, step, max_gap, M],
                      dtype=np.int64).tobytes())
    h.update(np.array([error, mu], dtype=np.float64).tobytes())
    h.update(bytes([use_gl, weighted, phased]))
    if sub_idx is not None:
        h.update(np.ascontiguousarray(sub_idx, dtype=np.int64).tobytes())
    for c in chroms:
        if c.geno2b_digest is None:
            return None
        h.update(c.chrom.encode())
        h.update(c.geno2b_digest)
        h.update(np.array([centro.start(c.chrom), centro.end(c.chrom)],
                          dtype=np.int64).tobytes())
        h.update(content_digest(np.ascontiguousarray(c.positions)))
        h.update(content_digest(np.ascontiguousarray(c.freq)))
        if weighted:
            h.update(content_digest(np.ascontiguousarray(c.gpos)))
        if phased:
            if c.first_copy is None:
                return None
            h.update(content_digest(np.ascontiguousarray(c.first_copy)))
        if use_gl:
            if c.gl_codes is not None:
                h.update(content_digest(c.gl_codes))
                h.update(content_digest(np.ascontiguousarray(c.gl_lut)))
            else:
                h.update(content_digest(np.ascontiguousarray(c.gl)))
    return h.digest()


class PoolEntry:
    """A validated cache hit: the grid scalars and the pool (read-only
    mmap, already checked against the stored digest)."""

    __slots__ = ("pool", "n", "h", "mn", "mx")

    def __init__(self, pool: np.ndarray, n: int, h: float, mn: float,
                 mx: float):
        self.pool, self.n = pool, n
        self.h, self.mn, self.mx = h, mn, mx

    # copy of garlic_tpu/io/poolcache.py:82
    def grid(self):
        """(h, targets, spacing, n): _kde_grid's arithmetic replayed from
        the stored scalars (mx += 3h; mn -= 3h; targets = (i/512)*(mx-mn)
        + mn)."""
        CUT, M = 3.0, 512
        mn = self.mn - CUT * self.h
        mx = self.mx + CUT * self.h
        i = np.arange(1, M + 1, dtype=np.float64)
        targets = (i / M) * (mx - mn) + mn
        return self.h, targets, targets[1] - targets[0], self.n


class PoolCache:
    """Pipeline-facing handle: closes over the run's chroms and parameters
    so lookups and stores only need (winsize, step)."""

    def __init__(self, sidecar: str, key_fn):
        self._sidecar = sidecar
        self._key_fn = key_fn   # (winsize, step) -> bytes | None

    def _paths(self, key: bytes):
        base = f"{self._sidecar}.p2pool.{key.hex()}"
        return base + ".npy", base + ".json"

    def lookup(self, winsize: int, step: int) -> Optional[PoolEntry]:
        key = self._key_fn(winsize, step)
        if key is None:
            return None
        npy, meta = self._paths(key)
        try:
            with open(meta) as f:
                m = json.load(f)
            if m.get("key") != key.hex():
                return None
            pool = np.load(npy, mmap_mode="r")
            if pool.dtype != np.float64 or pool.ndim != 1 or \
                    content_digest(pool).hex() != m.get("digest"):
                return None
            return PoolEntry(pool, int(m["n"]), float.fromhex(m["h"]),
                             float.fromhex(m["mn"]), float.fromhex(m["mx"]))
        except (OSError, ValueError, KeyError):
            return None

    def store(self, winsize: int, step: int, samples: np.ndarray):
        """Compute the grid scalars (the one nrd0 sort this run needs
        anyway) and persist the pool and scalars.  Returns (h, targets,
        spacing, n), or None for an empty pool.  A failed write is never
        a run failure."""
        from ..ops.kde import _kde_grid
        if samples.size == 0:
            return None  # the caller takes the uncached path
        key = self._key_fn(winsize, step)
        h, targets, spacing = _kde_grid(samples)
        grid = (h, targets, spacing, int(samples.size))
        if key is None or samples.nbytes > (512 << 20):
            # unkeyable, or an unthinned (--no-kde-thinning) WGS pool: a
            # multi-GB sidecar is worse than recomputing
            return grid
        pool = np.ascontiguousarray(samples, dtype=np.float64)
        npy, meta = self._paths(key)
        try:
            with open(npy + ".tmp", "wb") as f:  # a handle: np.save would
                np.save(f, pool)                 # append .npy to the name
            os.replace(npy + ".tmp", npy)
            with open(meta + ".tmp", "w") as f:
                json.dump({"key": key.hex(),
                           "digest": content_digest(pool).hex(),
                           "n": int(pool.size), "h": float(h).hex(),
                           "mn": float(np.min(pool)).hex(),
                           "mx": float(np.max(pool)).hex()}, f)
            os.replace(meta + ".tmp", meta)
            self._evict()
        except OSError:
            pass
        return grid

    def _evict(self) -> None:
        """Keep the MAX_SLOTS most recently stored slots of this sidecar."""
        metas = glob.glob(glob.escape(self._sidecar) + ".p2pool.*.json")
        if len(metas) <= MAX_SLOTS:
            return
        metas.sort(key=os.path.getmtime)
        for meta in metas[:len(metas) - MAX_SLOTS]:
            for path in (meta[:-len(".json")] + ".npy", meta):
                try:
                    os.remove(path)
                except OSError:
                    pass
