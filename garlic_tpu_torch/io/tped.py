"""TPED loading for the port.

garlic_tpu/io/tped.py parses and reads sidecars without JAX, but its
load_tped writes a cold run's sidecar through garlic_tpu's panelcache
writer, which imports JAX.  This copy of load_tped writes it through
io/panelcache.py here and always asks the native parser for 2-bit
codes; parsing itself stays garlic_tpu's.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np

from garlic_tpu.core.types import Dataset
from garlic_tpu.io import panelcache as gt_panelcache
from garlic_tpu.io.tped import _assemble_from_native, _load_tped_python

from . import panelcache


# copy of garlic_tpu/io/tped.py:128 for unphased, single-process loads
# with genotypes parsed to 2-bit codes (packed_geno=True)
def load_tped(tpedfile: str, tped_missing: str = "0", nresample: int = 0,
              auto_freq: bool = True, log=None,
              rng: Optional[np.random.Generator] = None,
              panel_cache: bool = False) -> Tuple[Dataset, int]:
    """Load a TPED file into a Dataset. Returns (dataset, total_loci).

    Mirrors loadTPEDData (src/garlic-data.cpp:10-177). Frequency
    resampling draws `nresample` Bernoulli(freq) trials
    (src/garlic-data.cpp:142-148) from the given generator."""
    if not os.path.exists(tpedfile):
        if log is not None:
            log.err("ERROR: Failed to open", tpedfile)
        raise FileNotFoundError(tpedfile)
    native = None
    from_cache = False
    if panel_cache:
        native = gt_panelcache.load_cache(tpedfile, want_fc=False,
                                          tped_missing=tped_missing)
        from_cache = native is not None
        if from_cache:
            print(f"Loaded panel cache {gt_panelcache.cache_path(tpedfile)}",
                  file=sys.stderr)
    if native is None:
        try:
            from garlic_tpu.native import parse_tped_native
            native = parse_tped_native(tpedfile, tped_missing,
                                       want_fc=False, want_packed=True)
        except Exception:
            native = None

    if native is not None:
        ds, num_loci = _assemble_from_native(native, False, auto_freq, log)
        if panel_cache:
            ds.panel_cache_file = gt_panelcache.cache_path(tpedfile)
        if panel_cache and not from_cache:
            digs = panelcache.save_cache(
                tpedfile, native,
                ds.nind if ds.ind_ids else
                (ds.chroms[0].nind if ds.chroms else 0),
                tped_missing=tped_missing)
            if digs:
                # attach the payload digests to the COLD run's chroms too
                # (warm loads read them from the sidecar header)
                for c, d in zip(ds.chroms, digs):
                    c.geno2b_digest = d
    else:
        ds, num_loci = _load_tped_python(tpedfile, tped_missing, False,
                                         auto_freq, log)

    if auto_freq and nresample > 0:
        if rng is None:
            rng = np.random.default_rng()
        for c in ds.chroms:
            # Binomial(nresample, freq)/nresample; a freq of 0 (including the
            # total==0 case) resamples to 0 (src/garlic-data.cpp:142-148).
            counts = rng.binomial(nresample, np.clip(c.freq, 0.0, 1.0))
            c.freq = counts.astype(np.float64) / float(nresample)
    return ds, num_loci
