"""Content digests for genotype payloads.

The fast engine keys its device-resident genotype cache (and the prefetch
stash) by a 16-byte digest of the packed 2-bit bytes.  Hashing 50 MB per
run costs ~0.1 s at --threads 1, so the digest is computed ONCE — when the
panel-cache sidecar is written — and then *derived* through the monomorphic
filter: the filtered bytes are a pure function of (unfiltered bytes, keep
mask), so H(parent_digest, keep_digest) identifies them without touching
the big array.  Every 16-byte value is domain-separated so a derived digest
can never alias a raw content hash.

Copy of garlic_tpu/core/digest.py (content_digest adapted: the native
hash alone, the port requires the library): the port imports nothing of
garlic_tpu. Each function and class names its source line.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def content_digest(arr: np.ndarray) -> bytes:
    """16-byte digest of an array's bytes, made C-contiguous (native
    OpenMP gt_hash128 at memory-bandwidth speed).

    Adapted from garlic_tpu/core/digest.py:21: the native library is
    required."""
    from ..native import hash128_native
    return hash128_native(np.ascontiguousarray(arr))


def derived_digest(parent: Optional[bytes], keep: np.ndarray) -> Optional[bytes]:
    """Digest of the column-compacted payload filter_pack_2bit produces
    from a parent payload with digest `parent` and the boolean keep mask.
    None when the parent digest is unknown (caller falls back to hashing
    the materialized bytes).

    Copy of garlic_tpu/core/digest.py:34."""
    if parent is None:
        return None
    kd = content_digest(np.packbits(np.asarray(keep, dtype=bool)))
    h = hashlib.blake2b(digest_size=16)
    h.update(b"gtfilt1")
    h.update(parent)
    h.update(kd)
    h.update(int(keep.shape[0]).to_bytes(8, "little"))
    return h.digest()
