"""Binary panel-cache sidecars: <tped>.gtpc and the TGLS <tgls>.gtlc.

Copies of garlic_tpu/io/panelcache.py (the container format, the
readers, the .gtlc reader and writer), so both packages read each
other's sidecars.  The .gtpc writer differs only in its packer:
garlic_tpu packs int8 genotypes (phased parses) with
garlic_tpu.ops.pallas_lod, the port with ops/cuda_lod.pack_codes, which
gives the same bytes.  Each function names its source line.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from ..core.digest import content_digest

_MAGIC = b"GTPCv3\n\0"  # garlic_tpu/io/panelcache.py:27
_ALIGN = 64  # garlic_tpu/io/panelcache.py:28


def _src_probe(path: str) -> str:
    """Cheap content digest of a source file: size + blake2b of its
    first and last MiB.  mtime alone misses a file swapped with a
    preserved/older timestamp (cp -p, archive restore); this catches it
    without re-reading multi-GB inputs, matching the .freq.gz sidecar's
    content-validation convention.

    Copy of garlic_tpu/io/panelcache.py:31."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    st = os.stat(path)
    h.update(str(st.st_size).encode())
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
        if st.st_size > 2 << 20:
            f.seek(st.st_size - (1 << 20))
            h.update(f.read(1 << 20))
    return h.hexdigest()


def cache_path(tpedfile: str) -> str:
    """Copy of garlic_tpu/io/panelcache.py:49."""
    return tpedfile + ".gtpc"


# copy of garlic_tpu/io/panelcache.py:53, packing int8 genotypes with the
# port's packer (ops/cuda_lod.pack_codes)
def _collect_arrays(chroms: List[dict]):
    """The per-chromosome array dict the container serializes: 2-bit
    codes (as parsed, or packed from a phased parse's int8 genotypes) and,
    for phased parses, the bit-packed first-copy plane c{i}_fc."""
    arrays = {}
    for i, c in enumerate(chroms):
        arrays[f"c{i}_pos"] = np.asarray(c["positions"], dtype=np.int64)
        arrays[f"c{i}_gpos"] = np.asarray(c["gpos"], dtype=np.float64)
        arrays[f"c{i}_alleles"] = np.asarray(c["alleles"], dtype="<U1")
        arrays[f"c{i}_freq"] = np.asarray(c["freq"], dtype=np.float64)
        names = c["names"]
        raw = names.raw if hasattr(names, "raw") else \
            "\n".join(names).encode()
        arrays[f"c{i}_names"] = np.frombuffer(raw, dtype=np.uint8)
        if c.get("geno2b") is not None:
            # parser emitted packed codes directly (tail codes already 3)
            arrays[f"c{i}_geno2b"] = np.ascontiguousarray(c["geno2b"])
        else:
            from ..ops.cuda_lod import pack_codes
            arrays[f"c{i}_geno2b"] = pack_codes(
                np.ascontiguousarray(c["genotypes"]))
        fc = c.get("first_copy")
        if fc is not None:
            arrays[f"c{i}_fc"] = np.packbits(np.asarray(fc, dtype=bool),
                                             axis=1)
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


_TGLS_MAGIC = b"GTLCv1\n\0"  # garlic_tpu/io/panelcache.py:148


def tgls_cache_path(tglsfile: str) -> str:
    """Copy of garlic_tpu/io/panelcache.py:151."""
    return tglsfile + ".gtlc"


def save_tgls_cache(tglsfile: str, nind: int, row_counts, mode: str,
                    lut_raw, mats) -> None:
    """TGLS sidecar: skip re-parsing the likelihood file on repeated
    runs (same container layout as the .gtpc).  Stores the RAW parsed
    values (pre --gl-type conversion, so one sidecar serves any type):
    dictionary mode = per-chrom u8 code matrices + the raw-value lut;
    fallback mode = per-chrom f64 matrices.  Best effort — failures are
    silent, the TGLS file stays the source of truth.

    Copy of garlic_tpu/io/panelcache.py:155."""
    path = tgls_cache_path(tglsfile)
    arrays = {}
    if mode == "codes":
        arrays["lut"] = np.asarray(lut_raw, dtype=np.float64)
    for i, m in enumerate(mats):
        arrays[f"c{i}"] = np.ascontiguousarray(m)
    try:
        probe = _src_probe(tglsfile)
    except OSError:
        return
    meta = {"nind": int(nind), "mode": mode, "src_probe": probe,
            "row_counts": [int(x) for x in row_counts], "arrays": {}}
    hdr_probe = dict(meta)
    hdr_probe["arrays"] = {
        k: {"dtype": a.dtype.str, "shape": list(a.shape), "offset": 0}
        for k, a in arrays.items()}
    hdr_cap = len(json.dumps(hdr_probe).encode()) + 16 * len(arrays) + 256
    off = len(_TGLS_MAGIC) + 8 + hdr_cap
    for k, a in arrays.items():
        off = -(-off // _ALIGN) * _ALIGN
        meta["arrays"][k] = {"dtype": a.dtype.str, "shape": list(a.shape),
                             "offset": off}
        off += a.nbytes
    hdr = json.dumps(meta).encode()
    if len(hdr) > hdr_cap:
        return
    try:
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(_TGLS_MAGIC)
            f.write(np.uint64(hdr_cap).tobytes())
            f.write(hdr.ljust(hdr_cap, b" "))
            for k, a in arrays.items():
                f.seek(meta["arrays"][k]["offset"])
                f.write(a.data)
        os.replace(tmp, path)
    except OSError:
        pass


def load_tgls_cache(tglsfile: str, nind: int, row_counts):
    """Load the TGLS sidecar if present, newer than the TGLS file, and
    shaped for this panel (nind + per-chromosome row counts — a changed
    TPED misses).  Returns the same dict shape parse_tgls_native yields
    (with RAW values) or None.  Code/value matrices stay zero-copy
    read-only views into the file map.

    Copy of garlic_tpu/io/panelcache.py:203."""
    path = tgls_cache_path(tglsfile)
    try:
        if os.path.getmtime(path) < os.path.getmtime(tglsfile):
            return None
        with open(path, "rb") as f:
            if f.read(len(_TGLS_MAGIC)) != _TGLS_MAGIC:
                return None
            hdr_cap = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
            if hdr_cap > 1 << 28:
                return None
            meta = json.loads(f.read(hdr_cap).decode())
        mm = np.memmap(path, dtype=np.uint8, mode="r")
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    try:
        if int(meta["nind"]) != int(nind):
            return None
        if meta.get("src_probe") != _src_probe(tglsfile):
            return None  # TGLS content changed under a preserved mtime
        if [int(x) for x in meta["row_counts"]] != \
                [int(x) for x in row_counts]:
            return None
        specs = meta["arrays"]
        mats = [_view(mm, specs[f"c{i}"])
                for i in range(len(meta["row_counts"]))]
        if meta["mode"] == "codes":
            return {"mode": "codes",
                    "lut": np.array(_view(mm, specs["lut"])),
                    "chroms": mats}
        return {"mode": "vals", "chroms": mats}
    except (KeyError, ValueError, TypeError, IndexError):
        return None


def _view(mm: np.memmap, spec) -> np.ndarray:
    """Copy of garlic_tpu/io/panelcache.py:243."""
    dt = np.dtype(spec["dtype"])
    shape = tuple(spec["shape"])
    n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    off = int(spec["offset"])
    if off < 0 or n < 0 or off + n > mm.size:
        raise ValueError("truncated panel cache section")
    return np.ndarray(shape, dtype=dt, buffer=mm.data[off:off + n])


def load_cache(tpedfile: str, want_fc: bool,
               tped_missing: str = "0",
               col_range=None) -> Optional[List[dict]]:
    """Load the sidecar if present, newer than the TPED, and parsed with the
    same parse-affecting parameters; None to fall back to parsing.

    Small per-locus arrays (positions/gpos/freq) are copied out — later
    stages may in-place them — while the large genotype sections stay
    read-only zero-copy views into the file map (every consumer only
    reads: filter/pack, content hash, device upload).

    col_range=(c0, c1): per-host sharded input — only that individual-row
    slice of the packed genotypes is exposed (zero-copy row views; host
    RAM and upload bytes scale 1/num_hosts).  The sidecar's freq plane is
    the full-panel value, so the dicts carry it directly (freq_num/den
    stay absent — no psum needed on warm loads); the stored full-panel
    geno2b digest is dropped (the slice hashes differently).

    Copy of garlic_tpu/io/panelcache.py:253."""
    from ..core.types import LocusNames

    path = cache_path(tpedfile)
    try:
        if os.path.getmtime(path) < os.path.getmtime(tpedfile):
            return None
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                return None
            hdr_cap = int(np.frombuffer(f.read(8), dtype=np.uint64)[0])
            if hdr_cap > 1 << 28:
                return None
            meta = json.loads(f.read(hdr_cap).decode())
        mm = np.memmap(path, dtype=np.uint8, mode="r")
    except (OSError, ValueError, json.JSONDecodeError):
        return None
    try:
        if str(meta.get("missing")) != str(tped_missing):
            return None  # cached parse used a different missing code
        if meta.get("src_probe") != _src_probe(tpedfile):
            return None  # TPED content changed under a preserved mtime
        nchrom = int(meta["nchrom"])
        specs = meta["arrays"]
        digs = meta.get("geno2b_digest") or [None] * nchrom
        nind_file = int(meta["nind"])
        c0, c1 = 0, nind_file
        if col_range is not None:
            c0 = max(min(int(col_range[0]), nind_file), 0)
            c1 = max(min(int(col_range[1]), nind_file), c0)
        sliced = col_range is not None and (c0, c1) != (0, nind_file)
        out = []
        for i in range(nchrom):
            # stays packed: ChromData materializes the int8 view lazily,
            # and the fast-engine path never needs it at all
            packed = _view(mm, specs[f"c{i}_geno2b"])
            if sliced:
                packed = packed[c0:c1]
            pos = np.array(_view(mm, specs[f"c{i}_pos"]))
            L = pos.shape[0]
            fc = None
            if want_fc:
                key = f"c{i}_fc"
                if key not in specs:
                    return None  # cache lacks phased bits; re-parse
                fcp = _view(mm, specs[key])
                if sliced:
                    fcp = fcp[c0:c1]
                fc = np.unpackbits(fcp, axis=1)[:, :L].view(np.bool_)
            al = _view(mm, specs[f"c{i}_alleles"])
            if al.dtype.kind == "S":   # older sidecar: stored S1 bytes
                al = al.astype("<U1")
            out.append({
                "chrom": meta["chrom_names"][i],
                "positions": pos,
                "gpos": np.array(_view(mm, specs[f"c{i}_gpos"])),
                "alleles": al,
                "genotypes": None,
                "geno2b": packed,
                "geno2b_digest": (bytes.fromhex(digs[i])
                                  if digs[i] and not sliced else None),
                "first_copy": fc,
                "freq": np.array(_view(mm, specs[f"c{i}_freq"])),
                "nind_total": nind_file if sliced else None,
                "row0": c0 if sliced else 0,
                "names": LocusNames(
                    _view(mm, specs[f"c{i}_names"]).tobytes()),
            })
        return out
    except (KeyError, ValueError, TypeError, IndexError):
        # corrupt/truncated sidecar: the TPED is the source of truth
        return None
