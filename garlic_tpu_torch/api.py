"""Programmatic API: the four-phase ROH pipeline as Python calls.

Counterpart of garlic_tpu/api.py, for notebooks and services that want
the computation without the CLI's file outputs:

    from garlic_tpu_torch import api
    ds = api.load_panel("data.tped.gz", "data.tfam")
    res = api.call_roh(ds, winsize=60, error=0.001, engine="fast")
    res.cutoff, res.bounds, res.calls[0].calls[:3]

Every knob mirrors the CLI flag of the same name; defaults match
src/garlic-cli.cpp.  Engines: "exact" (f64 on the host, the reference's
numbers) or "fast" (the f32 window matrices of kernel K1, or K3 with a
TGLS file, on a CUDA device; the automatic cutoff from their thinned
windows, as garlic_tpu's API does).  Like garlic_tpu's API, the fast
engine has no tie patrol (its calls can differ from the CLI's where a
window lies within f32 rounding of the cutoff), pools the device
windows rather than the CLI's exact Phase-II sampler, and keeps every
chromosome's window matrix on the device at once.  The fast engine
runs over a mesh (parallel.mesh.make_mesh; one device is the 1x1 mesh),
its windows made per shard (parallel.engine.lod_windows_sharded), as
garlic_tpu's does on a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .centromeres import Centromere
from .core.types import Dataset
from .io import filters, genmap
from .io import tfam as tfam_io, tgls as tgls_io, tped as tped_io
from .logger import RunLog
from .ops import assembly, convert, cutoff as cutoff_ops, gmm
from .ops import kde as kde_ops
from .ops import lod as lod_ops


@dataclass
class ROHResult:
    """The calls of one call_roh, with the cutoff, bounds and window size
    they were made with (and the KDE when the cutoff was automatic).

    Copy of garlic_tpu/api.py:33."""
    calls: List[assembly.IndividualROH]
    lengths: np.ndarray
    cutoff: float
    bounds: List[float]
    winsize: int
    kde: Optional[kde_ops.KDEResult] = None
    chrom_names: List[str] = field(default_factory=list)

    def to_rows(self):
        """Flat (ind_id, chrom, start, stop, size, size_class) tuples."""
        out = []
        for rec in self.calls:
            for c in rec.calls:
                cls = "A"
                for b in self.bounds:
                    if c.size > b:
                        cls = chr(ord(cls) + 1)
                out.append((rec.ind_id, self.chrom_names[c.chrom_idx],
                            c.start, c.stop, c.size, cls))
        return out


def load_panel(tped: str, tfam: str, tgls: Optional[str] = None,
               gl_type: str = "GQ", tped_missing: str = "0",
               mapfile: Optional[str] = None, build: str = "hg19",
               centromere_file: Optional[str] = None,
               phased: bool = False,
               seed: Optional[int] = None,
               panel_cache: bool = False) -> Dataset:
    """Load and filter a panel (TPED/TFAM + optional TGLS / genetic map).

    Monomorphic (and, with a map, out-of-bounds) sites are dropped, and
    genetic positions interpolated, exactly as the CLI pipeline does.
    panel_cache=True round-trips the parses through the .gtpc/.gtlc
    sidecars (the CLI's --tpu-panel-cache).

    Adapted from garlic_tpu/api.py:56: the port's load_tped takes
    auto_freq before phased, so both go by keyword."""
    log = RunLog()
    rng = np.random.default_rng(seed)
    centro = Centromere(build if not centromere_file else "none",
                        centromere_file or "none", "none", log)
    ds, _ = tped_io.load_tped(tped, tped_missing, 0, auto_freq=True,
                              log=log, rng=rng, panel_cache=panel_cache,
                              phased=phased)
    ds.ind_ids, ds.pop = tfam_io.read_tfam(tfam, log)
    if tgls:
        tgls_io.read_tgls(tgls, ds.chroms, ds.nind, gl_type, log,
                          panel_cache=panel_cache)
        ds._use_gl = True
    else:
        ds._use_gl = False
    if mapfile:
        scaffolds = genmap.load_map_scaffold(mapfile, centro, log)
        ds.chroms, _ = filters.filter_monomorphic_and_oob(ds.chroms,
                                                          scaffolds)
        for c, s in zip(ds.chroms, scaffolds):
            c.gpos, _ = genmap.interpolate_genetic_map(c.positions, s)
    else:
        ds.chroms, _ = filters.filter_monomorphic(ds.chroms)
    ds._centro = centro
    return ds


def call_roh(ds: Dataset, winsize: int = 60, error: float = 0.001,
             max_gap: int = 200000, overlap_frac: float = 0.25,
             cutoff: Optional[float] = None,
             bounds: Optional[List[float]] = None, nclust: int = 3,
             kde_thin: bool = True, cm: bool = False,
             engine: str = "exact", mesh=None, device=None) -> ROHResult:
    """Phases I-IV on a loaded panel.  cutoff/bounds default to automatic
    discovery (KDE min-between-modes / GMM intersections, the EM on the
    host).

    mesh: a parallel.mesh.Mesh that engine="fast" runs over: K1 (K3
    with TGLS) per shard and the transform's partials per shard.  None
    means the 1x1 mesh over `device`: None there means CUDA, and without
    a CUDA device it raises RuntimeError (it never falls back to the
    CPU; the tests pass "cpu" to run the kernels' plain versions).

    Adapted from garlic_tpu/api.py:94: the device argument, and the
    port's Phase-I route (parallel.engine.lod_windows_sharded, TGLS
    included)."""
    if engine not in ("exact", "fast"):
        raise ValueError(f"unknown engine {engine!r} (exact or fast)")
    if engine == "fast" and mesh is None:
        from .parallel.mesh import make_mesh
        from .runtime import resolve_devices
        try:
            mesh = make_mesh(1, 1, resolve_devices(device))
        except RuntimeError as e:
            raise RuntimeError(f'call_roh(engine="fast") needs a CUDA device:'
                               f' {e}; use engine="exact" on the CPU') from e
    centro = getattr(ds, "_centro", None) or Centromere(
        "hg19", "none", "none", RunLog())
    use_gl = getattr(ds, "_use_gl", False)

    win_by_chr = []
    for c in ds.chroms:
        if engine == "fast":
            from .parallel.engine import lod_windows_sharded
            win_by_chr.append(lod_windows_sharded(
                c, centro, winsize, error, max_gap, mesh, use_gl))
        else:
            win_by_chr.append(lod_ops.calc_lod_windows(
                c, centro, winsize, error, max_gap, use_gl))

    kr = None
    if cutoff is None:
        samples = convert.win_to_samples(
            win_by_chr, winsize if kde_thin else 1)
        kr = kde_ops.compute_kde(samples,
                                 mesh=mesh if engine == "fast" else None)
        cutoff = cutoff_ops.get_min_btw_modes(kr.x, kr.y, winsize)

    calls, lengths = assembly.assemble_roh(
        win_by_chr, ds.chroms, ds.ind_ids, centro, cutoff, winsize,
        max_gap, overlap_frac, cm)

    if bounds is None:
        bounds, _ = gmm.select_size_classes(lengths, nclust)
    return ROHResult(calls=calls, lengths=lengths, cutoff=float(cutoff),
                     bounds=list(bounds), winsize=winsize, kde=kr,
                     chrom_names=[c.chrom for c in ds.chroms])
