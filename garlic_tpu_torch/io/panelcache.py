"""Panel-cache sidecar writer (<tped>.gtpc).

garlic_tpu/io/panelcache.py writes the sidecar through _collect_arrays,
which imports garlic_tpu.ops.pallas_lod (and so JAX) on every call.  The
port's loader always parses genotypes straight to 2-bit codes, so the
payload is already packed and this copy needs no packer.  Reading the
sidecar (load_cache) and the container format stay garlic_tpu's: both
packages read each other's sidecars.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from garlic_tpu.core.digest import content_digest
from garlic_tpu.io.panelcache import _ALIGN, _MAGIC, _src_probe, cache_path


# copy of garlic_tpu/io/panelcache.py:53, 2-bit payloads only
def _collect_arrays(chroms: List[dict]):
    """The per-chromosome array dict the container serializes."""
    arrays = {}
    for i, c in enumerate(chroms):
        if c.get("geno2b") is None:
            raise ValueError("the port's panel cache stores 2-bit parses "
                             "only")
        arrays[f"c{i}_pos"] = np.asarray(c["positions"], dtype=np.int64)
        arrays[f"c{i}_gpos"] = np.asarray(c["gpos"], dtype=np.float64)
        arrays[f"c{i}_alleles"] = np.asarray(c["alleles"], dtype="<U1")
        arrays[f"c{i}_freq"] = np.asarray(c["freq"], dtype=np.float64)
        names = c["names"]
        raw = names.raw if hasattr(names, "raw") else \
            "\n".join(names).encode()
        arrays[f"c{i}_names"] = np.frombuffer(raw, dtype=np.uint8)
        # parser emitted packed codes directly (tail codes already 3)
        arrays[f"c{i}_geno2b"] = np.ascontiguousarray(c["geno2b"])
    return arrays


# copy of garlic_tpu/io/panelcache.py:90
def save_cache(tpedfile: str, chroms: List[dict], nind: int,
               tped_missing: str = "0"):
    """Write the sidecar (best effort: failures are silent — the TPED is
    always the source of truth).  Returns the per-chromosome
    packed-payload digests."""
    path = cache_path(tpedfile)
    arrays = _collect_arrays(chroms)
    digests = [content_digest(arrays[f"c{i}_geno2b"]).hex()
               for i in range(len(chroms))]
    dig_bytes = [bytes.fromhex(d) for d in digests]
    try:
        probe = _src_probe(tpedfile)
    except OSError:
        return dig_bytes
    meta = {"nind": int(nind), "nchrom": len(chroms),
            "missing": str(tped_missing), "src_probe": probe,
            "chrom_names": [str(c["chrom"]) for c in chroms],
            "geno2b_digest": digests, "arrays": {}}
    # lay out sections after a fixed-size header slot
    hdr_probe = dict(meta)
    hdr_probe["arrays"] = {
        k: {"dtype": a.dtype.str, "shape": list(a.shape), "offset": 0}
        for k, a in arrays.items()}
    # probe offsets are "0"; real ones are up to 16 digits each
    hdr_cap = len(json.dumps(hdr_probe).encode()) + 16 * len(arrays) + 256
    off = len(_MAGIC) + 8 + hdr_cap
    for k, a in arrays.items():
        off = -(-off // _ALIGN) * _ALIGN
        meta["arrays"][k] = {"dtype": a.dtype.str, "shape": list(a.shape),
                             "offset": off}
        off += a.nbytes
    hdr = json.dumps(meta).encode()
    if len(hdr) > hdr_cap:  # cannot happen (16-digit slack); skip, don't die
        return dig_bytes
    try:
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(np.uint64(hdr_cap).tobytes())
            f.write(hdr.ljust(hdr_cap, b" "))
            for k, a in arrays.items():
                f.seek(meta["arrays"][k]["offset"])
                f.write(np.ascontiguousarray(a).data)
        os.replace(tmp, path)
    except OSError:
        pass
    return dig_bytes
