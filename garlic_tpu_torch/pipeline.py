"""End-to-end ROH-calling pipeline of the port.

Counterpart of garlic_tpu/pipeline.py for single-host TPED runs, with
or without a --tgls per-genotype error file, --phased first copies, a
--map genetic map (--weighted LD-weighted LOD, --cm lengths): load (with
the --tpu-panel-cache sidecars) -> allele frequencies -> monomorphic
(and, with a map, out-of-bounds) filter -> window size (pinned,
--auto-winsize or --winsize-multi) -> Phase I -> Phase II (pinned or
automatic LOD cutoff) -> Phase III (coverage, tie patrol, run assembly)
-> Phase IV (pinned or automatic size bounds) -> BED; also --freq-only.
The .log lines and their order are the JAX package's, byte for byte.

Engines: `fast` (also what the default `auto` means) runs Phase I on a
CUDA device through the hand-written kernels (ops/cuda_lod.py: K2 fused
with the coverage count, K1 for --raw-lod; with --tgls, K4 fused for
dictionary-form error planes and K3 otherwise) or, on --weighted runs,
the LD pair-count and wLOD window kernels K5 and K6 around the
plain-torch band programs (ops/device_wlod.py), and the KDE's Gauss
transform and the GMM's EM on the same device
(ops/kde.py, ops/gmm.py); without a CUDA device it exits 1 and
names `--tpu-engine exact`, the f64 numpy/C++ engine on the host, which
runs only when asked for.  When the chromosomes' device holdings exceed
half the device budget, Phase I streams: one chromosome at a time is
made, counted and dropped.  Phase II pools the exact engine's f64
windows on both engines (the fast engine through _exact_thinned_samples
and the pool cache), so the .kde x column is the same on both.
The fast engine runs over a parallel.mesh.Mesh (parallel/engine.py):
--tpu-mesh DPxSP (or auto) lays it over several devices, else it is the
1x1 mesh over one device; individuals over dp, loci over sp, the kernels
per shard, the Phase-II transform and the Phase-IV EM reduced over the
shards, so every mesh gives the 1x1 mesh's outputs.  With the
GARLIC_TPU_COORD / NUM_PROCS / PROC_ID variables the run is one of
several cooperating processes (parallel/multihost.py: a gloo process
group): the mesh spans every process's devices, each process launches
its own cells, a dp-aligned layout loads only the process's own rows,
and process N > 0 writes <out>.procN.*, every process the whole BED.
The package imports nothing of garlic_tpu: the host code it shares
with it is its own copy (cli, io/, core/, native/, ops/).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import cli, native
from .centromeres import Centromere
from .cli import CLIError, ParsedArgs
from .core.types import MISSING, ChromData, GarlicDataError
from .io import bed, filters, freqfile, genmap, kdefile, rawlod, tfam, tgls
from .io import tped
from .logger import RunLog
from .ops import assembly, convert, cutoff as cutoff_ops, density
from .ops import device_win, gmm, kde
from .ops import ld as ld_ops
from .ops import lod as lod_ops
from .ops import wiggle as wiggle_ops
from .ops import wlod as wlod_ops
from .parallel import multihost
from .parallel.mesh import factor_devices, make_mesh, survey_devices
from .runtime import count, span
from .version import OUTPUT_COMPAT_VERSION

AUTO_WINSIZE_THRESHOLD = 0.50  # garlic_tpu/pipeline.py:33


def _resolve_mesh(spec: str, devices: list, group=None):
    """Parse 'DPxSP' (or 'auto': factor all the devices) and build the
    Mesh over `devices`; no spec (or a 1-device one) is the 1x1 mesh
    over the first device.  A malformed spec, or one larger than the
    device count, raises CLIError with garlic_tpu's message.  group: the
    run's multihost.Group; over several processes the device count is
    every process's (survey_devices' one allgather, which make_mesh then
    lays out) and a mesh of more than one device spans them, while no
    spec leaves each process on its own 1x1 mesh, as garlic_tpu's
    single-device processes.  Every mesh knows how many of the run's
    processes drive each of its devices' cards (the same survey), so
    processes that share a card split its budget.

    Adapted from garlic_tpu/pipeline.py:55: the devices are the run's
    (run_main's `device`), and one device is a mesh too."""
    counts, sharers = survey_devices(devices, group)
    if spec in ("none", "", "1", "1x1"):
        return make_mesh(1, 1, devices, sharers=sharers)
    ndev = int(sum(counts))
    if spec == "auto" and ndev <= 1:
        return make_mesh(1, 1, devices, sharers=sharers)
    if spec == "auto":
        n_dp, n_sp = factor_devices(ndev)
    else:
        try:
            parts = spec.lower().replace(",", "x").split("x")
            n_dp = int(parts[0])
            n_sp = int(parts[1]) if len(parts) > 1 else 1
        except (ValueError, IndexError):
            raise CLIError(f"ERROR: bad {cli.ARG_MESH} spec '{spec}' "
                           "(expected DPxSP, e.g. 4x2, or auto)")
    if n_dp * n_sp > ndev:
        raise CLIError(f"ERROR: mesh {n_dp}x{n_sp} exceeds {ndev} devices")
    if n_dp * n_sp == 1:
        return make_mesh(1, 1, devices, sharers=sharers)
    return make_mesh(n_dp, n_sp, devices, group, counts, sharers)


def _resolve_engine(name: str) -> str:
    """auto -> fast: the port's engine is the CUDA one (garlic_tpu's
    pipeline.py:81 picks fast on a TPU).  Without a CUDA device the run
    then exits 1 in run_main; the exact engine runs only when asked for."""
    if name == "auto":
        return "fast"
    if name not in ("exact", "fast"):
        raise CLIError(f"ERROR: unknown engine {name}")
    return name


def run_main(argv: List[str], prog: str = "garlic-tpu-torch",
             device=None) -> int:
    """Entry point; returns the process exit status (the reference's
    codes, including 0 on a CLI parse failure, src/garlic-main.cpp:31-32).

    device: where the fast engine runs: a device, or a list of devices
    that --tpu-mesh spans (a device may repeat: its shards then share
    it; without --tpu-mesh the run takes the first); None means every
    visible CUDA device, and a fast (or auto) run without one exits 1
    and names --tpu-engine exact.  The CPU tests pass "cpu", or
    ["cpu"] * 8 for meshes.  On a multi-process run (the three
    GARLIC_TPU_* variables) `device` is this process's list.  A set of
    the variables that is incomplete, or a process group that does not
    form, exits 1 with one ERROR line; so does a native host library
    that g++ cannot build (native.library)."""
    t_call = time.time_ns()  # --tpu-profile's call/start begins here
    log = RunLog()
    try:
        args = cli.parse_command_line(argv)
    except CLIError as e:
        print(str(e), file=sys.stderr)
        return 0
    if args is None:  # --help
        return 0
    try:
        group = multihost.initialize_from_env()
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 1
    except RuntimeError as e:
        print(f"ERROR: the process group did not form: {e}",
              file=sys.stderr)
        return 1
    try:
        return _main(args, argv, prog, log, device, group, t_call)
    finally:
        log.close()
        group.close()


def _main(args: ParsedArgs, argv: List[str], prog: str, log: RunLog,
          device, group, t_call: int) -> int:
    """run_main once the process group (of one process, or several) is
    formed."""
    try:
        engine = _resolve_engine(args[cli.ARG_ENGINE])
    except CLIError as e:
        print(str(e), file=sys.stderr)
        return -1
    mesh = None
    if engine == "fast":
        from .runtime import resolve_devices
        try:
            devices = resolve_devices(device)
        except RuntimeError as e:
            print(f"ERROR: {cli.ARG_ENGINE} {args[cli.ARG_ENGINE]} needs a "
                  f"CUDA device: {e}; run {cli.ARG_ENGINE} exact on the CPU",
                  file=sys.stderr)
            return 1
    try:
        native.library()
    except native.BuildError as e:
        print(f"ERROR: {str(e).splitlines()[0]}", file=sys.stderr)
        return 1
    # garlic_tpu resolves --tpu-mesh on the fast engine only, after
    # --freq-only has returned (pipeline.py:382-393): a spec it would
    # refuse is logged there by _run_impl
    mesh_err = None
    if engine == "fast" and not args[cli.ARG_FREQ_ONLY]:
        try:
            mesh = _resolve_mesh(args[cli.ARG_MESH], devices, group)
        except CLIError as e:
            mesh_err = str(e)
    return _run(args, argv, prog, log, engine, mesh_err, mesh, group,
                t_call)


# garlic_tpu/pipeline.py:36 (PipelineState) for one process
@dataclass
class _PhaseII:
    """What Phase II reads besides the window matrices."""
    log: RunLog
    rng: np.random.Generator
    engine: str
    mesh: object = None  # the fast engine's parallel.mesh.Mesh
    # (winsize, step, rows) -> the exact f64 pooled samples; set on fast
    # runs, so the bandwidth, the grid and the .kde x column are the
    # exact engine's
    exact_sampler: object = None
    # io.poolcache.PoolCache next to the --tpu-panel-cache sidecar, or
    # None (no sidecar, or --resample)
    pool_cache: object = None


# copy of garlic_tpu/pipeline.py:121
class _FreqWriter:
    """Background .freq.gz writer overlapping Phase I (the reference writes
    synchronously before Phase I, src/garlic-main.cpp:245-253; the writer
    only reads per-locus arrays, which filtering re-slices rather than
    mutates).  finish() is idempotent and runs on EVERY exit path so a
    write failure surfaces as a logged error and a nonzero exit."""

    def __init__(self):
        self._thread = None
        self._exc = []

    def start(self, outfile: str, chroms, log, blob: str = None) -> None:
        import threading

        def _write():
            try:
                with span("freq-writer"):
                    freqfile.write_freq(outfile + ".freq", chroms, log,
                                        blob=blob)
            except BaseException as e:  # surfaced at finish()
                self._exc.append(e)

        self._thread = threading.Thread(target=_write, daemon=False)
        self._thread.start()

    def finish(self):
        """Join and hand back the writer's exception (once), or None."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return self._exc.pop() if self._exc else None


# garlic_tpu/pipeline.py:154, with the profiler made here so that its
# trace closes, and its report prints, on every exit of the run
def _run(args: ParsedArgs, argv: List[str], prog: str, log: RunLog,
         engine: str, mesh_err: Optional[str], mesh, group,
         t_call: int) -> int:
    from .runtime import PhaseProfiler
    fw = _FreqWriter()
    prof = PhaseProfiler(args[cli.ARG_PROFILE], mesh, group, t_call)
    try:
        rc = _run_impl(args, argv, prog, log, fw, prof, engine, mesh_err,
                       mesh, group)
    finally:
        prof.end_phases()  # an early return's, or a raise's, open phase
        with span("call/finish"):
            werr = fw.finish()
            if werr is not None:
                log.err("ERROR: Failed writing allele frequency data:",
                        str(werr))
            log.close()
        prof.report()  # closes the trace too
    if werr is not None:
        return 1 if rc == 0 else rc
    return rc


# garlic_tpu/pipeline.py:171-930 with the port's engines and mesh; the
# validation and .log lines are kept verbatim so the .log matches the JAX
# package's
def _run_impl(args: ParsedArgs, argv: List[str], prog: str, log: RunLog,
              fw: _FreqWriter, prof, engine: str, mesh_err: Optional[str],
              mesh, group) -> int:
    outfile = args[cli.ARG_OUTFILE]
    # secondary processes write <out>.procN, so co-located processes do
    # not race on one file (pipeline.py:179-183)
    if group.rank > 0:
        outfile = outfile + f".proc{group.rank}"
    log.init(outfile)
    log.log(" ".join([prog] + list(argv)))
    log.log("Output file basename:", outfile)

    argerr = False
    tpedfile = args[cli.ARG_TPED]
    tfamfile = args[cli.ARG_TFAM]
    tglsfile = args[cli.ARG_TGLS]
    argerr = argerr or cli.check_required_files(log, tpedfile, tfamfile)
    if argerr:
        return -1
    log.log("TPED file:", tpedfile)

    tped_missing = args[cli.ARG_TPED_MISSING]
    log.log("TPED missing data code:", tped_missing)
    log.log("TFAM file:", tfamfile)
    log.log("TGLS file:", tglsfile)

    gl_type = args[cli.ARG_GL_TYPE]
    argerr = argerr or cli.check_gl_type(log, gl_type, tglsfile)
    log.log("Genotype likelihood format:", gl_type)

    weighted = args[cli.ARG_WEIGHTED]
    mapfile = args[cli.ARG_MAP]
    cm = args[cli.ARG_CM]
    argerr = argerr or cli.check_cm(log, mapfile, cm)
    if argerr:
        return -1
    log.log("Measure ROH in genetic distance units:", cm)
    argerr = argerr or cli.check_map_file(log, mapfile, weighted or cm)
    log.log("Weighted LOD:", weighted)
    if weighted:
        log.log("Map file:", mapfile)

    build = args[cli.ARG_BUILD]
    argerr = argerr or cli.check_build(log, build)
    if argerr:
        return -1
    log.log("Genome build:", build)

    centromere_file = args[cli.ARG_CENTROMERE_FILE]
    argerr = argerr or cli.check_build_and_centromere_file(log, build,
                                                           centromere_file)
    if argerr:
        return -1
    log.log("User defined centromere file:", centromere_file)

    nresample = args[cli.ARG_RESAMPLE]
    freqfile_arg = args[cli.ARG_FREQ_FILE]
    freq_only_flag = args[cli.ARG_FREQ_ONLY]
    err_flag, auto_freq = cli.check_auto_freq(log, freqfile_arg,
                                              freq_only_flag)
    argerr = argerr or err_flag
    if argerr:
        return -1
    log.log("Calculate allele frequencies only:", freq_only_flag)
    log.log("Calculate allele frequencies from data:", auto_freq)
    if not auto_freq:
        log.log("Allele frequencies file:", freqfile_arg)
    else:
        if nresample <= 0:
            log.log("Allele frequencies resampled: FALSE")
        else:
            log.log("Allele frequencies resampled:", nresample)

    multi_winsizes = args[cli.ARG_WINSIZE_MULTI]
    err_flag, winsize_explore = cli.check_multi_winsizes(log, multi_winsizes)
    argerr = argerr or err_flag
    if argerr:
        return -1
    log.log("Explore window sizes:", winsize_explore)
    if winsize_explore:
        log.logv("User defined window sizes:", multi_winsizes)

    auto_winsize = args[cli.ARG_AUTO_WINSIZE]
    log.log("Automatic window size:", auto_winsize)

    auto_winsize_step = args[cli.ARG_AUTO_WINSIZE_STEP]
    argerr = argerr or cli.check_auto_winsize_step(log, auto_winsize_step)
    if argerr:
        return -1
    log.log("Automatic window step size:", auto_winsize_step)

    winsize = args[cli.ARG_WINSIZE]
    argerr = argerr or cli.check_winsize(log, winsize, winsize_explore,
                                         auto_winsize, weighted)
    if argerr:
        return -1
    if not winsize_explore and not auto_winsize:
        log.log("User defined window size:", winsize)

    lod_cutoff = args[cli.ARG_LOD_CUTOFF]
    auto_cutoff = cli.check_auto_cutoff(lod_cutoff)
    log.log("Choose LOD score cutoff automatically:", auto_cutoff)
    if not auto_cutoff:
        log.log("User defined LOD score cutoff:", lod_cutoff)

    bound_sizes = list(args[cli.ARG_BOUND_SIZE])
    err_flag, auto_bounds = cli.check_bound_sizes(log, bound_sizes)
    argerr = argerr or err_flag
    if argerr:
        return -1
    log.log("Choose ROH class thresholds automatically:", auto_bounds)
    if not auto_bounds:
        log.logv("User defined ROH class thresholds:", bound_sizes)

    num_threads = args[cli.ARG_THREADS]
    argerr = argerr or cli.check_threads(log, num_threads)
    log.log("Threads:", num_threads)
    native.set_native_threads(num_threads)  # caps OpenMP in the host kernels

    error = args[cli.ARG_ERROR]
    argerr = argerr or cli.check_error(log, error, tglsfile)
    if argerr:
        return -1
    log.log("Genotyping error:", error)

    max_gap = args[cli.ARG_MAX_GAP]
    argerr = argerr or cli.check_max_gap(log, max_gap)
    if argerr:
        return -1
    log.log("Max gap:", max_gap)

    overlap_frac = args[cli.ARG_OVERLAP_FRAC]
    argerr = argerr or cli.check_overlap_frac(log, overlap_frac)
    if argerr:
        return -1
    auto_overlap_frac = args[cli.ARG_AUTO_OVERLAP_FRAC]
    if auto_overlap_frac:
        log.log("Overlap fraction: automatic")
    elif overlap_frac != 0:
        log.log("Overlap fraction:", overlap_frac)
    else:
        log.log("Overlap fraction: 1/winsize")

    mu = args[cli.ARG_MU]
    argerr = argerr or cli.check_mu(log, mu)
    if argerr:
        return -1
    log.log("mu:", mu)

    M = args[cli.ARG_M]
    argerr = argerr or cli.check_m(log, M)
    if argerr:
        return -1
    log.log("M:", M)

    nclust = args[cli.ARG_NCLUST]
    argerr = argerr or cli.check_nclust(log, nclust)
    if argerr:
        return -1
    log.log("# GMM clusters:", nclust)

    kde_subsample = args[cli.ARG_KDE_SUBSAMPLE]
    if kde_subsample <= 0:
        log.log("# of rand individuals for KDE: ALL")
    else:
        log.log("# of rand individuals for KDE:", kde_subsample)

    ld_subsample = args[cli.ARG_LD_SUBSAMPLE]
    if ld_subsample <= 0:
        log.log("# of rand individuals for LD: ALL")
    else:
        log.log("# of rand individuals for LD:", ld_subsample)

    raw_lod = args[cli.ARG_RAW_LOD]
    log.log("Output raw LOD scores:", raw_lod)

    phased = args[cli.ARG_PHASED]
    log.log("Use r2 for weighting phased data:", phased)

    thin = not args[cli.ARG_KDE_THINNING]
    log.log("Use thinning for KDE estimation:", thin)

    use_gl = False
    seed = args[cli.ARG_SEED]
    eff_seed = None if seed < 0 else seed
    if eff_seed is None and group.size > 1:
        # process 0 draws the run seed and broadcasts it: every process
        # must draw the same --kde-subsample / --ld-subsample indices and
        # --resample binomials (pipeline.py:358-372)
        local = np.zeros(1, dtype=np.int32)
        if group.rank == 0:
            local[0] = np.random.default_rng().integers(0, 2 ** 31 - 1)
        eff_seed = int(group.broadcast(local, "seed")[0]) & 0x7FFFFFFF
    rng = np.random.default_rng(eff_seed)
    prof.start()

    if freq_only_flag:
        tped.freq_only(tpedfile, outfile, nresample, tped_missing, log,
                       rng)
        return 0
    if mesh_err is not None:  # garlic_tpu/pipeline.py:388-393
        log.err(mesh_err)
        return -1
    col_range = _col_range(mesh, tpedfile)

    # ---------------- Datafile reading ----------------
    centro = Centromere(build, centromere_file, cli.DEFAULT_CENTROMERE_FILE,
                        log)
    try:
        # unphased: 2-bit codes on both engines (io/tped.py), which the
        # fast engine uploads as they are; phased: int8 and first copies
        ds, num_loci = tped.load_tped(
            tpedfile, tped_missing, nresample, auto_freq, log, rng,
            panel_cache=args[cli.ARG_PANEL_CACHE], phased=phased,
            col_range=col_range)
        if col_range is not None and auto_freq:
            with span("global-freq"):
                _global_freq(ds, mesh, nresample, rng)
        if os.environ.get("GT_FREQ_DEBUG"):
            _freq_debug(ds)
        if os.environ.get("GT_LOAD_STATS"):
            _load_stats(ds)
        log.log("Total loci:", num_loci)
        with span("tfam"):
            ds.ind_ids, ds.pop = tfam.read_tfam(tfamfile, log)
        num_ind = ds.nind
        log.log("Population:", ds.pop)
        log.log("Total diploid individuals:", num_ind)
        for c in ds.chroms:
            if c.nind_global != num_ind:
                log.err("ERROR: TPED and TFAM disagree on individual count.")
                return 1

        if tglsfile != cli.DEFAULT_TGLS:
            with span("tgls"):
                tgls.read_tgls(tglsfile, ds.chroms, num_ind, gl_type, log,
                               panel_cache=bool(args[cli.ARG_PANEL_CACHE]),
                               col_range=col_range)
            use_gl = True

        scaffolds = None
        if weighted or cm:
            with span("map"):
                scaffolds = genmap.load_map_scaffold(mapfile, centro, log)
            if len(scaffolds) != len(ds.chroms):
                log.err("ERROR: Scaffold genetic map does not have the same "
                        "number of chromosomes as data.")
                return -1
    except (GarlicDataError, FileNotFoundError):
        # expected load failure: ERROR text already in .error (the
        # reference's catch(...) { return 1; }, src/garlic-main.cpp:210-242)
        return 1
    except Exception as e:
        log.err("ERROR: Internal failure while loading data:", repr(e))
        return 1
    prof.mark("load", num_loci * ds.nind, "genotypes")

    # ---------------- Allele frequencies ----------------
    if auto_freq:
        # computed-from-data, non-resampled freqs are a pure function of
        # the panel-cache sidecar: cache the finished gz blob next to it
        blob = (ds.panel_cache_file + ".freq.gz"
                if ds.panel_cache_file is not None and nresample == 0
                else None)
        fw.start(outfile, list(ds.chroms), log, blob=blob)
    else:
        print(f"Loading user provided allele frequencies from {freqfile_arg}")
        try:
            freqfile.read_freq(freqfile_arg, ds.chroms, log)
        except (GarlicDataError, FileNotFoundError):
            return -1
        except Exception as e:
            log.err("ERROR: Internal failure while reading allele "
                    "frequencies:", repr(e))
            return -1
    prof.mark("freq", num_loci, "loci")

    # ---------------- Filtering ----------------
    if weighted or cm:
        with span("monomorphic"):
            ds.chroms, new_loci = filters.filter_monomorphic_and_oob(
                ds.chroms, scaffolds)
        log.log("Monomorphic or out of bounds loci filtered:",
                num_loci - new_loci)
        num_interp = 0
        with span("interpolate"):
            for c, s in zip(ds.chroms, scaffolds):
                c.gpos, n = genmap.interpolate_genetic_map(c.positions, s)
                num_interp += n
        log.log("Number of genetic map locations interpolated:", num_interp)
    else:
        with span("monomorphic"):
            ds.chroms, new_loci = filters.filter_monomorphic(ds.chroms)
        log.log("Monomorphic loci filtered:", num_loci - new_loci)
    log.log("Total loci used for analysis:", new_loci)
    num_loci = new_loci
    prof.mark("filter", num_loci, "loci")

    variant_density = -1.0
    if (auto_winsize and weighted) or auto_overlap_frac:
        variant_density = density.calc_density(num_loci, ds.chroms, centro)

    st = _PhaseII(log=log, rng=rng, engine=engine, mesh=mesh)
    # the processes among which the panel's rows are split: the run's on
    # a per-process load, else this process alone, which holds them all.
    # Every process takes the same exchanges: col_range was decided
    # identically on each before the parse (pipeline.py:606-612)
    row_group = group if col_range is not None else multihost.Group()
    if engine == "fast" and not weighted:
        # Phase II pools the exact engine's f64 rolling windows (the f32
        # device windows would shift the nrd0 bandwidth and with it every
        # .kde x value), so no device window matrix is needed for it;
        # assembly keeps the device kernels and the tie patrol
        # (pipeline.py:600-634).  A per-process load pools its own rows
        # and gathers them in rank order, the global row order.
        st.exact_sampler = \
            lambda wq, step, rows: _exact_thinned_samples_sharded(
                ds.chroms, centro, wq, error, max_gap, use_gl, step, rows,
                row_group, mesh)
        # never across processes: a hit on one and a miss on another
        # would split their exchanges (pipeline.py:621-629)
        if group.size == 1 and ds.panel_cache_file is not None \
                and nresample == 0:
            from .io.poolcache import PoolCache, pool_key
            st.pool_cache = PoolCache(
                ds.panel_cache_file,
                lambda wq, stp: pool_key(ds.chroms, wq, stp, error,
                                         max_gap, use_gl, centro))

    # ---------------- Winsize resolution ----------------
    kde_result = None
    if winsize_explore and auto_winsize and not weighted:
        kde_result, winsize = _select_winsize_from_list(
            st, ds, centro, multi_winsizes, error, use_gl, max_gap,
            kde_subsample, outfile, thin)
        if kde_result is None:
            return 1
    elif winsize_explore:
        _explore_winsizes(st, ds, centro, multi_winsizes, error, use_gl,
                          max_gap, kde_subsample, outfile, weighted, M, mu,
                          phased, thin, ld_subsample, row_group)
        return 0
    elif auto_winsize:
        if not weighted:
            try:
                kde_result, winsize = _select_winsize(
                    st, ds, centro, winsize, auto_winsize_step, error,
                    use_gl, max_gap, kde_subsample, outfile, thin)
            except GarlicDataError:
                return 1
            except Exception as e:
                log.err("ERROR: Internal failure during window size "
                        "selection:", repr(e))
                return 1
            if kde_result is None:
                return 1
        else:
            winsize = density.select_winsize_weighted(variant_density)
        log.log("Selected window size:", winsize)

    print(f"Window size: {winsize}")

    if auto_overlap_frac:
        overlap_frac = density.select_overlap_frac(variant_density, winsize)
        log.log("Selected overlap fraction:", overlap_frac)

    # ---------------- Phase I ----------------
    wpair_cache = {}
    sub_idx = None
    if weighted:
        print("Calculating LD matrix.", file=sys.stderr)
        sub_idx = _ld_subsample_idx(ds.nind, ld_subsample, rng)
        if engine == "fast":
            # Phase II pools the exact f64 thinned wLOD samples; the pair
            # band memoizes into wpair_cache, which the weighted tie
            # patrol shares (pipeline.py:678-706); a per-process load
            # pools its own rows against the summed global pair band
            st.exact_sampler = \
                lambda wq, step, rows: _exact_thinned_wsamples(
                    ds.chroms, centro, wq, error, max_gap, use_gl, step,
                    rows, mu, M, phased, sub_idx, wpair_cache, row_group)
            if group.size == 1 and ds.panel_cache_file is not None \
                    and nresample == 0:
                from .io.poolcache import PoolCache, pool_key
                st.pool_cache = PoolCache(
                    ds.panel_cache_file,
                    lambda wq, stp: pool_key(
                        ds.chroms, wq, stp, error, max_gap, use_gl,
                        centro, weighted=True, mu=mu, M=M, phased=phased,
                        sub_idx=sub_idx))
        win_by_chr = _calc_wlod_windows(engine, mesh, ds, centro, winsize,
                                        error, max_gap, use_gl, mu, M,
                                        phased, sub_idx)
    else:
        # Fast runs fuse Phase I INTO the coverage kernel (K2, or K4 for
        # dictionary-form TGLS): the [I, nwin] f32 window matrix never
        # reaches device memory.  Only --raw-lod takes the split path
        # (K1, or K3), which writes the matrix.  garlic_tpu also splits
        # automatic-cutoff runs (pipeline.py:744-745), because its Phase
        # II pools device windows; the port's pools the exact sampler's.
        fused = engine == "fast" and not raw_lod
        fused_args = None
        if fused and not auto_cutoff:
            # pre-resolve the tie band + threshold so each chromosome's
            # K2 launch is enqueued during Phase I; automatic-cutoff runs
            # dispatch in assembly, once Phase II has chosen the cutoff
            with span("tie-band"):
                band = _tie_band(ds.chroms, winsize, error, use_gl)
            fused_args = (lod_cutoff,
                          assembly.overlap_threshold(overlap_frac, winsize),
                          band)
        win_by_chr = _calc_lod_windows(engine, mesh, ds, centro, winsize,
                                       error, max_gap, use_gl, fused,
                                       fused_args)
    # the freq writer keeps running through Phase III; _run's finally
    # joins it and reports a failure with exit 1
    prof.mark("phase1-lod",
              sum(max(c.nloci - winsize + 1, 0) for c in ds.chroms)
              * ds.nind, "windows")

    if raw_lod:
        try:
            rawlod.write_win_data(win_by_chr,
                                  [c.chrom for c in ds.chroms], ds.pop,
                                  outfile)
        except Exception as e:
            log.err("ERROR: Failed to write raw LOD windows:", repr(e))
            return -1

    # ---------------- Phase II: cutoff ----------------
    if auto_cutoff:
        if kde_result is None:
            lod_cutoff = _select_lod_cutoff(
                st, win_by_chr, ds, kde_subsample,
                kdefile.make_kde_filename(outfile, winsize),
                winsize if thin else 1, winsize)
        else:
            lod_cutoff = _cutoff_from_kde(st, kde_result, winsize)
        log.log("Selected LOD score cutoff:", lod_cutoff)
    else:
        print(f"User defined LOD score cutoff: {lod_cutoff}")
    prof.mark("phase2-cutoff")

    # ---------------- Phase III: assembly ----------------
    print("Assembling ROH windows")
    # Tie patrol (fast engine): windows inside the f32 error band around
    # the cutoff are re-derived in f64 on the host and flipped rows get
    # their coverage recomputed with the exact engine, so the fast BED is
    # the exact engine's by construction (pipeline.py:800-835).  Each
    # process verifies the suspect rows it holds and the results are
    # gathered (_owned_row_patrol; one process holds them all).
    tie_delta, exact_cover, exact_window = 0.0, None, None
    if engine == "fast" and weighted:
        tie_delta, exact_cover, exact_window = _weighted_patrol(
            ds, centro, winsize, error, max_gap, use_gl, mu, M, phased,
            sub_idx, wpair_cache, overlap_frac, lod_cutoff, row_group)
    elif engine == "fast":
        with span("tie-band"):
            tie_delta = _tie_band(ds.chroms, winsize, error, use_gl)

        def exact_cover(ci, rows):
            thr = assembly.overlap_threshold(overlap_frac, winsize)
            rows = np.asarray(rows, dtype=np.int64)
            out = []
            # row blocks bound the [k, L] f64/int64 temporaries
            for s in range(0, rows.size, 64):
                sub = _subset_chrom_rows(ds.chroms[ci], rows[s:s + 64])
                w = lod_ops.calc_lod_windows(sub, centro, winsize, error,
                                             max_gap, use_gl)
                out.append(assembly.coverage_counts_batch(
                    w >= lod_cutoff, winsize) >= thr)
            return np.concatenate(out, axis=0) if out else \
                np.zeros((0, ds.chroms[ci].nloci), dtype=bool)

        def exact_window(ci, rows, wins, sides):
            return _exact_window_flips(ds.chroms[ci], rows, wins, sides,
                                       winsize, error, use_gl, lod_cutoff)

        exact_cover, exact_window = _owned_row_patrol(
            ds, row_group, exact_cover, exact_window)

    roh_by_ind, lengths = assembly.assemble_roh(
        win_by_chr, ds.chroms, ds.ind_ids, centro, lod_cutoff, winsize,
        max_gap, overlap_frac, cm, tie_delta=tie_delta,
        exact_cover=exact_cover, exact_window=exact_window)
    prof.mark("phase3-assembly", float(lengths.size), "ROH")

    # ---------------- Phase IV: size classes ----------------
    if auto_bounds:
        print(f"Fitting {nclust}-component GMM for size classification")
        try:
            bound_sizes, _ = gmm.select_size_classes(lengths, nclust, log,
                                                     mesh=mesh)
        except Exception as e:
            # The reference aborts inside GSL here (collapsed component /
            # root bracket failure); we fail cleanly instead.
            log.err("ERROR: GMM size classification failed:", str(e))
            log.err("\tToo few ROH calls or degenerate length distribution; "
                    "size boundaries can be supplied with --size-bounds.")
            return 1
        log.logv("Selected ROH size boundaries = (", bound_sizes, nl=False)
        log.log(" )")
    else:
        log.logv("User provided ROH size boundaries = (", bound_sizes,
                 nl=False)
        log.log(" )")
    prof.mark("phase4-gmm")
    print("Writing ROH tracts.")
    bed.write_roh(bed.make_roh_filename(outfile), roh_by_ind,
                  [c.chrom for c in ds.chroms], bound_sizes, ds.pop,
                  OUTPUT_COMPAT_VERSION, cm, log)
    prof.mark("write-bed")
    print("Finished.")
    return 0


# garlic_tpu/pipeline.py:936 for the port's engines
def _calc_lod_windows(engine: str, mesh, ds, centro, winsize: int,
                      error: float, max_gap: int, use_gl: bool,
                      fused: bool = False, fused_args=None,
                      ind_idx: Optional[np.ndarray] = None):
    """calcLODWindows (src/garlic-roh.cpp:279-309).

    mesh: the fast engine's Mesh (None on the exact engine); each
    chromosome's shards run over it (parallel/engine.py).  fused:
    FusedCov entries for assembly (K2, or K4 for dictionary-form TGLS);
    fused_args = (cutoff, threshold, tie_delta) enqueues each
    chromosome's kernels immediately.  The split fast path (K1, or K3
    for TGLS) keeps every window block on its device.  When what the
    fast chromosomes' shards hold on some device at once would exceed
    half that device's budget (_device_holdings), Phase I streams as
    garlic_tpu's does (pipeline.py:953-972,999-1004): split entries
    become LazyWin thunks and fused ones are not pre-enqueued, so
    assembly makes, fetches and drops one chromosome at a time.
    ind_idx: the rows to compute (the winsize searches'
    --kde-subsample individuals)."""
    from .core.pbar import Bar
    from .parallel import engine as par
    print(f"Calculating LOD scores with winsize {winsize}.", file=sys.stderr)
    streaming = False
    if engine == "fast":
        held = _device_holdings(ds.chroms, winsize, use_gl, fused, mesh)
        for dev, est in held.items():
            budget = 0.5 * mesh.budget(dev)
            if est > budget:
                streaming = True
                print(f"[garlic-tpu-torch] Phase I device holdings ~"
                      f"{est / 1e9:.1f} GB exceed half the "
                      f"{2 * budget / 1e9:.1f} GB device budget; streaming "
                      "per chromosome", file=sys.stderr)
                break
        # one mode for every process: streaming reorders the exchanges
        # of assembly (dispatch and fetch chromosome by chromosome)
        streaming = mesh.group.any(streaming, "gate")
    out = []
    for c in ds.chroms:
        print(f"{c.chrom}    ", file=sys.stderr, end="")
        # reference quirk: the unweighted bar's total is NLOCI but it
        # advances once per INDIVIDUAL (src/garlic-roh.cpp:40,48)
        bar = Bar(total=c.nloci)
        if ind_idx is not None:
            c = _subset_chrom(c, ind_idx)
        if engine == "fast" and fused:
            fc = device_win.FusedCov(c, centro, winsize, error, max_gap,
                                     mesh, use_gl, stream=streaming)
            if fused_args is not None and not streaming:
                fc.handle = device_win.covered_dispatch(
                    fc, fused_args[0], winsize, fused_args[1],
                    fused_args[2])
            out.append(fc)
            bar.advance(c.nind)
        elif engine == "fast" and streaming:
            out.append(device_win.LazyWin(
                (lambda c=c: par.lod_windows_sharded(
                    c, centro, winsize, error, max_gap, mesh, use_gl)),
                nind=c.nind_global, nloci=c.nloci))
            bar.advance(c.nind)
        elif engine == "fast":
            out.append(par.lod_windows_sharded(c, centro, winsize, error,
                                               max_gap, mesh, use_gl))
            bar.advance(c.nind)
        else:
            out.append(lod_ops.calc_lod_windows(c, centro, winsize, error,
                                                max_gap, use_gl, bar=bar))
        bar.finalize()
    return out


def _device_holdings(chroms, winsize: int, use_gl: bool, fused: bool,
                     mesh) -> dict:
    """Bytes each device of the mesh holds at once when every fast
    chromosome is resident (parallel.engine.shard_holdings; a device
    listed twice holds both of its shards): the three u8 planes of K2/K4
    on the fused route, else the f32 windows of K1/K3 (a float-form TGLS
    chromosome takes that route inside covered_dispatch)."""
    from .parallel.engine import shard_holdings
    out = {}
    for c in chroms:
        planes = fused and not (use_gl and c.gl_codes is None)
        for dev, b in shard_holdings(c, winsize, planes, mesh).items():
            out[dev] = out.get(dev, 0.0) + b
    return out


# the weighted Phase-I loop of garlic_tpu/pipeline.py:707-735
def _calc_wlod_windows(engine: str, mesh, ds, centro, winsize: int,
                       error: float, max_gap: int, use_gl: bool, mu: float,
                       M: int, phased: bool, sub_idx):
    """calcwLOD per chromosome (src/garlic-roh.cpp:134-277): the fast
    engine's DeviceWin over its mesh, with its tie_scale (the band of
    parallel.engine.ld_band_sharded, the windows of wlod_windows_sharded,
    garlic_tpu/pipeline.py:713-722), or the exact engine's f64 LD band
    and window matrix on the host."""
    from .core.pbar import Bar
    from .parallel import engine as par
    print(f"Calculating LOD scores with winsize {winsize}.", file=sys.stderr)
    out = []
    for c in ds.chroms:
        print(f"{c.chrom}    ", file=sys.stderr, end="")
        bar = Bar(total=c.nind)
        if engine == "fast":
            ld = par.ld_band_sharded(c, winsize, phased, sub_idx, mesh)
            out.append(par.wlod_windows_sharded(c, centro, ld, winsize, error,
                                                max_gap, use_gl, mu, M, mesh))
            bar.advance(c.nind)
        else:
            ldm = ld_ops.calc_ld(c, winsize, phased, sub_idx, engine="exact")
            out.append(wlod_ops.wlod_windows(c, centro, ldm, winsize, error,
                                             max_gap, use_gl, mu, M,
                                             bar=bar))
        bar.finalize()
    return out


# the weighted tie patrol of garlic_tpu/pipeline.py:836-893
def _weighted_patrol(ds, centro, winsize: int, error: float, max_gap: int,
                     use_gl: bool, mu: float, M: int, phased: bool, sub_idx,
                     wpair_cache: dict, overlap_frac: float, cutoff: float,
                     group):
    """(tie_delta, exact_cover, exact_window) of a weighted fast run.
    1/LD can amplify terms arbitrarily, so the band's scale rides each
    DeviceWin as a device scalar (tie_scale, max finite |term|) and
    tie_delta is only the 256 * eps32 * W factor (the margin of
    _tie_band).  The reference's wLOD windows are fresh sums, so the
    per-window f64 verification is its exact value.  group: the
    processes among which the rows are split (one process when it holds
    them all): each process verifies the suspects of its own rows, the
    suspect windows' band rows from pair counts summed over the
    processes (_exact_wlod_window_flips), and recomputes the flipped
    rows it holds over the whole chromosome's band, made from pair
    counts summed the same way (_wpair_band; _owned_row_patrol gathers
    the rows).  Both are exchanges every process makes, owning suspect
    rows or not."""
    bands = {}

    def band(ci):
        if ci not in bands:
            # the exact band from the pair band the Phase-II sampler may
            # already have memoized (calc_ld(engine="exact") ==
            # assemble_ld_exact(pair_ld))
            bands[ci] = ld_ops.assemble_ld_exact(
                _wpair_band(ds.chroms, ci, winsize, phased, sub_idx,
                            wpair_cache, group), winsize)
        return bands[ci]

    def exact_cover(ci, rows):
        band(ci)  # an exchange on a per-process load: always first
        thr = assembly.overlap_threshold(overlap_frac, winsize)
        rows = np.asarray(rows, dtype=np.int64)
        out = []
        for s in range(0, rows.size, 64):  # bound [k, L] temporaries
            sub = _subset_chrom_rows(ds.chroms[ci], rows[s:s + 64])
            w = wlod_ops.wlod_windows(sub, centro, band(ci), winsize, error,
                                      max_gap, use_gl, mu, M)
            out.append(assembly.coverage_counts_batch(w >= cutoff, winsize)
                       >= thr)
        return np.concatenate(out, axis=0) if out else \
            np.zeros((0, ds.chroms[ci].nloci), dtype=bool)

    def exact_window(ci, rows, wins, sides):
        return _exact_wlod_window_flips(
            ds.chroms[ci], rows, wins, sides, winsize, error, use_gl, mu, M,
            phased, sub_idx, cutoff, P=wpair_cache.get((ci, winsize)),
            group=group)

    exact_cover = _owned_row_patrol(ds, group, exact_cover, None)[0]
    return 256.0 * 2.0 ** -23 * winsize, exact_cover, exact_window


def _col_range(mesh, tpedfile: str):
    """This process's (c0, c1) of the individuals when it loads only its
    own rows, else None: on a fast run whose mesh spans processes in a
    dp-aligned layout (multihost.dp_layout_aligned), decided before the
    parse from the mesh and the file's width, identically on every
    process, with its stderr line; a panel too small for process 0 to
    hold fewer than all rows is loaded whole by every process.

    garlic_tpu/pipeline.py:398-432 inline there; the range here comes
    from multihost.host_individual_range over the mesh."""
    if mesh is None or mesh.group.size == 1:
        return None
    # a missing file falls through to load_tped's logged ERROR
    if not (multihost.dp_layout_aligned(mesh) and os.path.exists(tpedfile)):
        return None
    from .parallel.mesh import AXIS_DP
    nind_file = tped.peek_nind(tpedfile)
    n_dp = mesh.shape[AXIS_DP]
    per = -(-max(nind_file, 1) // n_dp) * n_dp // mesh.group.size
    # per >= nind would hand process 0 the whole panel while the others
    # hold parts: their exchanges would no longer match
    if nind_file <= 0 or per >= nind_file:
        return None
    col_range = multihost.host_individual_range(nind_file, mesh)
    print(f"[garlic-tpu-torch] sharded input: process {mesh.group.rank} "
          f"holds individuals [{col_range[0]}, {col_range[1]}) of "
          f"{nind_file}", file=sys.stderr)
    return col_range


def _global_freq(ds, mesh, nresample: int, rng) -> None:
    """The allele frequencies of a per-process load, for the whole panel:
    the count planes summed over the processes and divided once
    (parallel.engine.allele_freq_counts_sharded).  A warm sidecar holds
    the global frequencies and no planes; the processes first gather
    which of them hold planes, and when any holds none every process
    takes the frequencies of the lowest such rank.  Then --resample
    draws on the global frequencies with the common seed.

    garlic_tpu/pipeline.py:445-489 inline there."""
    from .parallel.engine import allele_freq_counts_sharded
    group = mesh.group
    have_counts = all(c.freq_num is not None for c in ds.chroms)
    flags = group.allgather(np.array([1 if have_counts else 0],
                                     dtype=np.int32), "freq")[:, 0]
    if flags.all():
        for c in ds.chroms:
            c.freq = allele_freq_counts_sharded(c.freq_num, c.freq_den, mesh)
            c.freq_num = c.freq_den = None
    else:
        src = int(np.flatnonzero(flags == 0)[0])
        for c in ds.chroms:
            plane = (np.zeros(c.nloci, dtype=np.float64) if have_counts
                     else np.asarray(c.freq, dtype=np.float64))
            c.freq = group.allgather(plane, "freq")[src]
            c.freq_num = c.freq_den = None
    if nresample > 0:
        for c in ds.chroms:
            # deferred from load_tped: resample the GLOBAL freq
            # (src/garlic-data.cpp:142-148)
            counts = rng.binomial(nresample, np.clip(c.freq, 0.0, 1.0))
            c.freq = counts.astype(np.float64) / float(nresample)


# garlic_tpu/pipeline.py:490-496
def _freq_debug(ds) -> None:
    """GT_FREQ_DEBUG: a hash of each chromosome's allele frequencies, on
    stderr."""
    import hashlib
    for c in ds.chroms:
        fh = hashlib.blake2b(np.ascontiguousarray(
            np.asarray(c.freq, dtype=np.float64)).tobytes(),
            digest_size=8).hexdigest()
        print(f"[gt_freq] {c.chrom} {fh}", file=sys.stderr)


def _load_stats(ds) -> None:
    """GT_LOAD_STATS: the rows and genotype bytes this process loaded and
    its peak RSS so far, on stderr (garlic_tpu/pipeline.py:497-510)."""
    import resource
    tot = rows = 0
    for c in ds.chroms:
        rows = max(rows, c.nind)
        for a in (c._geno, c._geno2b, c.first_copy):
            if a is not None:
                tot += a.nbytes
    print(f"[garlic-tpu-torch] load-stats: rows={rows} geno_bytes={tot} "
          f"maxrss_kb={resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}",
          file=sys.stderr)


def _owned_row_patrol(ds, group, cover_local, window_local):
    """Tie-patrol wrappers over the rows split among `group` (a process
    that holds them all is a group of one): suspect rows index the
    GLOBAL individual axis but each host only holds
    [row0, row0 + nind); every host f64-verifies the rows it owns and the
    per-row results merge with a rank-ordered allgather-OR (suspect sets
    are tiny — bytes, not matrices).  The merged result is identical on
    every process, so each one applies the same repairs to its gathered
    coverage.  Both call the local function on every process, owning
    suspect rows or not: the weighted ones make exchanges of their own
    (the weighted run verifies its windows itself and passes no
    window_local).

    Adapted from garlic_tpu/pipeline.py:1275: the Group's exchanges in
    place of process_allgather."""

    def exact_cover(ci, rows):
        # gather only each host's OWNED rows, bit-packed
        c = ds.chroms[ci]
        r0, nown = c.row0, c.nind
        L = c.nloci
        rb = (L + 7) // 8
        rows = np.asarray(rows, dtype=np.int64)
        owned = (rows >= r0) & (rows < r0 + nown)
        cov = cover_local(ci, rows[owned] - r0)
        cov_own = np.packbits(cov, axis=1, bitorder="little") \
            if owned.any() else np.zeros((0, rb), dtype=np.uint8)
        om = group.allgather(owned.astype(np.uint8), "patrol").astype(bool)
        allp = group.allgather_varlen(cov_own.reshape(-1), "patrol")
        out_p = np.zeros((rows.size, rb), dtype=np.uint8)
        for r in range(group.size):
            idx = np.flatnonzero(om[r])
            out_p[idx] = allp[r].reshape(-1, rb)[:idx.size]
        return np.unpackbits(out_p, axis=1,
                             bitorder="little")[:, :L].astype(bool)

    def exact_window(ci, rows, wins, sides):
        c = ds.chroms[ci]
        r0, nown = c.row0, c.nind
        rows = np.asarray(rows, dtype=np.int64)
        owned = (rows >= r0) & (rows < r0 + nown)
        flips = np.zeros(rows.size, dtype=bool)
        flips[owned] = window_local(
            ci, rows[owned] - r0, np.asarray(wins)[owned],
            np.asarray(sides)[owned])
        return group.allgather(flips.astype(np.uint8),
                               "patrol").any(axis=0)

    return exact_cover, exact_window


def _exact_thinned_samples_sharded(chroms, centro, winsize: int,
                                   error: float, max_gap: int, use_gl: bool,
                                   step: int, rows, group,
                                   mesh) -> np.ndarray:
    """The Phase-II sampler of the fast engine's unweighted runs: the
    exact f64 thinned samples of the requested rows that each process of
    `group` holds (one process when it holds them all), then the
    per-chromosome pools concatenate across ranks — rank r holds global
    rows [r*per, (r+1)*per), so rank-order concatenation reproduces the
    reference's exact chrom-major/row-major pooling order.  The pools'
    lengths differ per process: a variable-length gather, f64 kept.

    Where a scalar error and a one-device mesh hold the rows, one launch
    on that device pools every chromosome (ops/exact_pool, pool.device);
    else (TGLS, or a mesh of several devices) _exact_thinned_samples
    pools each on the host (pool.host).  Both give the same bits.

    Adapted from garlic_tpu/pipeline.py:1620: the Group's exchange in
    place of process_allgather, and the device route."""
    local = []
    for c in chroms:
        if rows is None:
            local.append(None)  # all locally-held rows, in order
        else:
            rr = np.asarray(rows, dtype=np.int64)
            local.append(rr[(rr >= c.row0) & (rr < c.row0 + c.nind)]
                         - c.row0)
    if not use_gl and mesh.size == 1:
        from .ops.exact_pool import thinned_samples
        parts = thinned_samples(chroms, centro, winsize, error, max_gap,
                                step, local, mesh.first)
    else:
        parts = (_exact_thinned_samples([c], centro, winsize, error,
                                        max_gap, use_gl, step, r)
                 for c, r in zip(chroms, local))
    out = []
    for part in parts:
        out += group.allgather_varlen(part.astype(np.float64), "samples")
    return np.concatenate(out) if out else np.zeros(0)


# adapted from garlic_tpu/pipeline.py:1392: the native library is required
def _exact_thinned_samples(chroms, centro, winsize: int, error: float,
                           max_gap: int, use_gl: bool, step: int,
                           rows) -> np.ndarray:
    """The exact engine's pooled Phase-II samples: per chromosome, the f64
    ROLLING window sequence (the thinned values depend on the full
    rolling history, src/garlic-roh.cpp:76-103) for the requested rows,
    thinned by `step` and MISSING-filtered exactly like
    convertWinData2DoubleData (src/garlic-data.cpp:2026-2150).  Row
    chunks of 64 bound the [k, L] f64 temporaries; without TGLS the
    native thinned kernel never builds the full window matrix.  Counted
    in pool.host, one a chromosome."""
    from .native import lod_windows_exact_thin_native
    parts = []
    for c in chroms:
        count("pool.host")
        r = np.arange(c.nind) if rows is None \
            else np.asarray(rows, dtype=np.int64)
        if not use_gl:
            table = lod_ops.lod_table(c.freq, error)
            nwin = max(c.nloci - winsize + 1, 0)
            miss8 = np.zeros(max(nwin, 1), dtype=np.uint8)
            if nwin > 0:
                miss8[:] = lod_ops.window_missing_mask(
                    c.positions, winsize, max_gap, centro.start(c.chrom),
                    centro.end(c.chrom)).astype(np.uint8)
        for s in range(0, r.size, 64):
            sub = _subset_chrom(c, r[s:s + 64])
            if use_gl:
                w = lod_ops.calc_lod_windows(sub, centro, winsize, error,
                                             max_gap, use_gl)[:, ::step]
            else:
                w = lod_windows_exact_thin_native(sub.genotypes, table,
                                                  miss8, winsize, step)
            flat = w.reshape(-1)
            m = (flat != MISSING) & ~np.isnan(flat)
            parts.append(flat[m])
    return np.concatenate(parts) if parts else np.zeros(0)


def _ld_subsample_idx(nind: int, ld_subsample: int,
                      rng: np.random.Generator) -> Optional[np.ndarray]:
    """Copy of garlic_tpu/pipeline.py:1385."""
    if ld_subsample >= nind or ld_subsample <= 0:
        return None
    return np.sort(rng.choice(nind, size=ld_subsample, replace=False))


def _wpair_band(chroms, ci: int, winsize: int, phased: bool, sub_idx,
                cache: dict, group) -> np.ndarray:
    """Exact pairwise LD band P of the whole panel for one chromosome,
    memoized per (chromosome, winsize) — shared between the weighted
    exact Phase-II sampler and the weighted tie patrol so the
    O(L*W*I_sub) pair counting runs at most once per run.  Each process
    counts the integer joint-count planes of the rows it holds (the
    global --ld-subsample meets its own rows), the planes are summed
    exactly over `group`, the processes among which the rows are split
    (one process holds them all), and the exact division sequence
    (pair_ld_*_from_counts) follows: pair_ld's bits on any split.  An
    exchange: every process calls this for the same (chromosome,
    winsize) sequence.

    Adapted from garlic_tpu/pipeline.py:1441 with the per-host counts of
    its _wpair_band_sharded (:1455): an int64 all_reduce in place of the
    allgather and host sum."""
    key = (ci, winsize)
    P = cache.get(key)
    if P is not None:
        return P
    c = chroms[ci]
    rows = None
    if sub_idx is not None:
        rr = np.asarray(sub_idx, dtype=np.int64)
        rows = rr[(rr >= c.row0) & (rr < c.row0 + c.nind)] - c.row0
    g = c.genotypes if rows is None else c.genotypes[rows]
    if phased:
        fcl = c.first_copy if rows is None else c.first_copy[rows]
        n1, n2 = ld_ops.pair_counts_r2(g, fcl, winsize)
    else:
        n1, n2 = ld_ops.pair_counts_hr2(g, winsize)
    # marginal hom freqs over ALL individuals (never subsampled,
    # src/garlic-data.cpp:648)
    hom, tot = ld_ops.geno_hom_counts(c.genotypes)
    flat = np.concatenate([n1.reshape(-1), n2.reshape(-1), hom, tot])
    if flat.dtype.kind == "f":  # integer-valued counts
        flat = flat.astype(np.int64)
    tot_planes = group.sum_int(flat, "patrol-ld")
    sz = n1.size
    n1g = tot_planes[:sz].reshape(n1.shape).astype(n1.dtype)
    n2g = tot_planes[sz:2 * sz].reshape(n1.shape).astype(n2.dtype)
    if phased:
        P = ld_ops.pair_ld_r2_from_counts(n1g, n2g, c.freq, winsize)
    else:
        HA = ld_ops.geno_hom_freq_from_counts(
            tot_planes[2 * sz:2 * sz + hom.size].astype(hom.dtype),
            tot_planes[2 * sz + hom.size:].astype(tot.dtype))
        P = ld_ops.pair_ld_hr2_from_counts(n1g, n2g, HA, winsize)
    cache[key] = P
    return P


def _exact_thinned_wsamples(chroms, centro, winsize: int, error,
                            max_gap: int, use_gl: bool, step: int, rows,
                            mu: float, M: int, phased: bool, sub_idx,
                            pair_cache: dict, group) -> np.ndarray:
    """The exact engine's pooled Phase-II samples for WEIGHTED runs: the
    f64 wLOD window values at the thinned positions, in the reference's
    pooling order (chrom-major, row-major; convertWinData2DoubleData,
    src/garlic-data.cpp:2026-2150).  The reference's wLOD has no rolling
    recurrence, so only the thinned window positions are evaluated: the
    exact LD band rows assemble per position from the memoized pair band
    (_wpair_band, summed over `group`, the processes among which the
    rows are split; one process holds them all) and each window sums in
    wlod_windows' j-loop order.  Each process pools the requested rows
    it holds, and the per-chromosome pools concatenate in rank order
    (rank r holds global rows [r*per, (r+1)*per), so rank order IS the
    reference's pooling order).

    Adapted from garlic_tpu/pipeline.py:1570 with the per-host pools of
    its _exact_thinned_wsamples_sharded (:1504): the Group's exchanges
    in place of process_allgather."""
    from .ops.lod import window_missing_mask
    out = []
    for ci, c in enumerate(chroms):
        L = c.nloci
        nwin = L - winsize + 1
        r0, nown = c.row0, c.nind
        if rows is None:
            local_rows = np.arange(nown, dtype=np.int64)
        else:
            rr = np.asarray(rows, dtype=np.int64)
            local_rows = rr[(rr >= r0) & (rr < r0 + nown)] - r0
        part = np.zeros(0, dtype=np.float64)
        if nwin > 0:
            # an exchange: unconditional on every rank (local_rows may
            # be empty here while another rank owns samples)
            P = _wpair_band(chroms, ci, winsize, phased, sub_idx,
                            pair_cache, group)
            ws = np.arange(0, nwin, step)
            missing = window_missing_mask(
                c.positions, winsize, max_gap, centro.start(c.chrom),
                centro.end(c.chrom))[ws]
            inv = 1.0 / ld_ops.assemble_ld_exact_rows(P, winsize, ws)
            parts = []
            for s in range(0, local_rows.size, 64):  # bound [k, L] temps
                sub = _subset_chrom(c, local_rows[s:s + 64])
                score = wlod_ops.wlod_scores(sub, error, use_gl, mu, M)
                acc = np.zeros((score.shape[0], ws.size), dtype=np.float64)
                for j in range(winsize):
                    # reference i-loop order (src/garlic-roh.cpp:259-272):
                    # score[i] * (1.0 / LD[l][i-l]), exactly wlod_windows
                    acc = acc + score[:, ws + j] * inv[:, j][None, :]
                w = np.where(missing[None, :], float(MISSING), acc)
                flat = w.reshape(-1)
                m2 = (flat != MISSING) & ~np.isnan(flat)
                parts.append(flat[m2])
            if parts:
                part = np.concatenate(parts)
        out += group.allgather_varlen(part, "samples")
    return np.concatenate(out) if out else np.zeros(0)


# garlic_tpu/pipeline.py:1663 without the hybrid (compute_kde_hybrid) and
# in-graph (compute_kde_wins) branches, which the port does not carry
# (ops/kde.py)
def _compute_kde_for(st: _PhaseII, win_by_chr, step: int, ind_idx, log,
                     exact=None):
    """Phase-II dispatch.  exact=(winsize, rows) on the fast engine: pool
    the exact f64 samples on the host (or replay them from the pool
    cache), so the bandwidth, the grid and the .kde x column match the
    exact engine bit for bit, then run the transform over the fast
    engine's mesh.  The exact engine pools its own f64
    window matrices and transforms on the host."""
    if exact is not None and st.exact_sampler is not None:
        wq, rows = exact
        grid = None
        if rows is None and st.pool_cache is not None:
            with span("pool-replay"):  # the lookup, and a hit's replay
                ent = st.pool_cache.lookup(wq, step)
                if ent is not None:
                    # warm hit: grid scalars replayed bit-exactly, the
                    # pool mapped in its original pooling order
                    grid, samples = ent.grid(), ent.pool
        else:
            ent = None
        if ent is not None:
            count("pool.replayed")
        else:
            with span("pool"):
                samples = st.exact_sampler(wq, step, rows)
                if rows is None and st.pool_cache is not None:
                    grid = st.pool_cache.store(wq, step, samples)
            count("pool.pooled")
        with span("kde"):
            return kde.compute_kde(samples, log, grid=grid, mesh=st.mesh)
    with span("pool"):
        samples = convert.win_to_samples(win_by_chr, step, ind_idx=ind_idx)
    count("pool.pooled")
    with span("kde"):
        return kde.compute_kde(samples, log)


# adapted from garlic_tpu/pipeline.py:1727 (the search: _cutoff_from_kde)
def _select_lod_cutoff(st: _PhaseII, win_by_chr, ds, kde_subsample: int,
                       kdeoutfile: str, step: int, wsize: int) -> float:
    """selectLODCutoff (src/garlic-roh.cpp:667-697): thin/subsample, KDE,
    write, min-between-modes.  Failures return -1 and the pipeline
    continues, exactly like the reference."""
    log = st.log
    idx = None
    if kde_subsample > 0:
        idx = convert.choose_subsample(ds.nind, kde_subsample, st.rng)
        log.logn("Individuals used for KDE: ")
        for i in idx:
            log.logn(ds.ind_ids[i])
            log.logn(" ")
        log.logn("\n")
    print("Estimating distribution of raw LOD score windows:",
          file=sys.stderr)
    kr = _compute_kde_for(st, win_by_chr, step, idx, log,
                          exact=(wsize, idx))
    try:
        with span("write-kde"):
            kdefile.write_kde(kr, kdeoutfile, log)
    except Exception:
        return -1.0
    return _cutoff_from_kde(st, kr, wsize)


def _cutoff_error(log) -> None:
    log.err("ERROR: Failed to find the minimum between modes in the LOD "
            "score density.")
    log.err("\tResults from density estimation have been written to file "
            "for inspection.")
    log.err("\tA cutoff can be manually specified on the command line with",
            cli.ARG_LOD_CUTOFF)


# copy of garlic_tpu/pipeline.py:1761
def _report_cutoff_rivals(kr, wsize: int, cutoff: float) -> None:
    """stderr-only note when the automatic cutoff has FIGTree-error-scale
    rivals: the reference's Phase II is randomized run to run
    (time-seeded FIGTree clustering, ops.cutoff.cutoff_tie_probe), so on
    such densities it selects different cutoffs on different runs.
    Never written to .log (a compared artifact)."""
    try:
        alts = cutoff_ops.cutoff_tie_probe(kr.x, kr.y, wsize)
    except Exception:
        return
    if alts:
        # the 3 rivals nearest the selection; the count carries the rest
        near = sorted(alts, key=lambda a: abs(a - cutoff))[:3]
        more = len(alts) - len(near)
        tail = " (+%d more)" % more if more > 0 else ""
        print("[garlic-tpu-torch] note: auto-KDE cutoff %g has %d FIGTree-"
              "error-scale rival(s), nearest %s%s; the reference's "
              "randomized Phase II (time-seeded FIGTree) may pick any "
              "reachable rival on a given run"
              % (cutoff, len(alts), ", ".join("%g" % a for a in near),
                 tail), file=sys.stderr)


# adapted from garlic_tpu/pipeline.py:1787 (the search's spans)
def _cutoff_from_kde(st: _PhaseII, kde_result, wsize: int) -> float:
    """selectLODCutoff(KDEResult*) (src/garlic-roh.cpp:652-664): the
    selection (span search/modes), then the stderr note of its rivals
    (search/rivals); counts the density scans in cutoff.scans."""
    with span("search"):
        with span("modes"):
            count("cutoff.scans")
            try:
                c = cutoff_ops.get_min_btw_modes(kde_result.x, kde_result.y,
                                                 wsize)
            except Exception:
                _cutoff_error(st.log)
                return -1.0
        with span("rivals"):
            count("cutoff.scans", cutoff_ops.PROBE_SCANS)
            _report_cutoff_rivals(kde_result, wsize, c)
    return c


# copy of garlic_tpu/pipeline.py:1801
def _subset_for_kde(st: _PhaseII, ds, kde_subsample: int):
    """subsetData (src/garlic-data.cpp:2171-2244) + its log line."""
    idx = convert.choose_subsample(ds.nind, kde_subsample, st.rng)
    st.log.loga("Individuals used for KDE:", [ds.ind_ids[i] for i in idx])
    return idx


def _candidate_kde(st: _PhaseII, ds, centro, wq: int, error: float,
                   use_gl: bool, max_gap: int, ind_idx, thin: bool):
    """The KDE of one winsize candidate (the loop bodies of
    garlic_tpu/pipeline.py:1830-1836,1859-1864,1941-1947, one process).
    garlic_tpu's fast engine computes each candidate's device windows
    only to feed its hybrid transform; the port's fast engine pools the
    exact sampler's values, so it computes none.  The exact engine pools
    its own f64 matrices over the --kde-subsample rows."""
    win_by_chr = None
    if st.engine == "exact":
        win_by_chr = _calc_lod_windows("exact", None, ds, centro, wq, error,
                                       max_gap, use_gl, ind_idx=ind_idx)
    return _compute_kde_for(st, win_by_chr, wq if thin else 1, None,
                            st.log, exact=(wq, ind_idx))


# copy of garlic_tpu/pipeline.py:1818
def _select_winsize(st: _PhaseII, ds, centro, winsize: int, step: int,
                    error: float, use_gl: bool, max_gap: int,
                    kde_subsample: int, outfile: str, thin: bool):
    """selectWinsize (src/garlic-roh.cpp:766-850): grow winsize by step
    until the wiggle metric <= 0.5."""
    log = st.log
    ind_idx = (_subset_for_kde(st, ds, kde_subsample)
               if kde_subsample > 0 else None)
    log.log("Searching for acceptable window size, smoothness threshold:",
            AUTO_WINSIZE_THRESHOLD)
    log.log("winsize\tsmoothness")
    wq = winsize
    while True:
        kr = _candidate_kde(st, ds, centro, wq, error, use_gl, max_gap,
                            ind_idx, thin)
        # calculate_wiggle scales kr.y by 100 in place, before the clone
        # that is written (src/garlic-roh.cpp:820-834)
        mse = wiggle_ops.calculate_wiggle(kr)
        log.log("", wq, nl=False)
        log.log("\t", mse)
        if mse <= AUTO_WINSIZE_THRESHOLD:
            selected = kr.clone()
            kdefile.write_kde(selected,
                              kdefile.make_kde_filename(outfile, wq), log)
            return selected, wq
        wq += step


# copy of garlic_tpu/pipeline.py:1847
def _select_winsize_from_list(st: _PhaseII, ds, centro, multi: List[int],
                              error: float, use_gl: bool, max_gap: int,
                              kde_subsample: int, outfile: str, thin: bool):
    """selectWinsizeFromList (src/garlic-roh.cpp:852-933)."""
    log = st.log
    ind_idx = (_subset_for_kde(st, ds, kde_subsample)
               if kde_subsample > 0 else None)
    log.log("Searching for acceptable window size, smoothness threshold:",
            AUTO_WINSIZE_THRESHOLD)
    log.log("winsize\tsmoothness")
    for i, wq in enumerate(multi):
        kr = _candidate_kde(st, ds, centro, wq, error, use_gl, max_gap,
                            ind_idx, thin)
        mse = wiggle_ops.calculate_wiggle(kr)
        log.log("", wq, nl=False)
        log.log("\t", mse)
        if mse <= AUTO_WINSIZE_THRESHOLD or i == len(multi) - 1:
            selected = kr.clone()
            kdefile.write_kde(selected,
                              kdefile.make_kde_filename(outfile, wq), log)
            return selected, wq
    return None, 0


# garlic_tpu/pipeline.py:1875 without the per-host branches: the fast
# engine makes no device windows here, so its mesh only runs the
# transform (_compute_kde_for)
def _explore_winsizes(st: _PhaseII, ds, centro, multi: List[int],
                      error: float, use_gl: bool, max_gap: int,
                      kde_subsample: int, outfile: str, weighted: bool,
                      M: int, mu: float, phased: bool, thin: bool,
                      ld_subsample: int, group):
    """exploreWinsizes (src/garlic-roh.cpp:699-763): dump a KDE per
    candidate winsize and exit.  Weighted runs redraw the LD subsample
    for each candidate (the reference's per-candidate calcLDData); the
    fast engine then pools the exact sampler's f64 values, as on
    unweighted runs (_candidate_kde), so it computes no device windows
    (its global --kde-subsample rows meet the rows each process of
    `group` holds), and the exact engine pools its own f64 window
    matrices over the --kde-subsample rows."""
    ind_idx = (_subset_for_kde(st, ds, kde_subsample)
               if kde_subsample > 0 else None)
    for wq in multi:
        if not weighted:
            kr = _candidate_kde(st, ds, centro, wq, error, use_gl, max_gap,
                                ind_idx, thin)
            kdefile.write_kde(kr, kdefile.make_kde_filename(outfile, wq),
                              st.log)
            continue
        sub_idx = _ld_subsample_idx(ds.nind, ld_subsample, st.rng)
        win_by_chr = None
        if st.engine == "fast":
            st.exact_sampler = (
                lambda w2, step, rows, _si=sub_idx: _exact_thinned_wsamples(
                    ds.chroms, centro, w2, error, max_gap, use_gl, step,
                    rows, mu, M, phased, _si, {}, group))
        else:
            win_by_chr = []
            for c in ds.chroms:
                cc = c if ind_idx is None else _subset_chrom(c, ind_idx)
                ldm = ld_ops.calc_ld(c, wq, phased, sub_idx, engine="exact")
                win_by_chr.append(wlod_ops.wlod_windows(
                    cc, centro, ldm, wq, error, max_gap, use_gl, mu, M))
        kr = _compute_kde_for(st, win_by_chr, wq if thin else 1, None,
                              st.log, exact=(wq, ind_idx))
        kdefile.write_kde(kr, kdefile.make_kde_filename(outfile, wq),
                          st.log)


# copy of garlic_tpu/pipeline.py:1030
def _tie_band(chroms, winsize: int, error: float, use_gl: bool) -> float:
    """Suspect half-width for the fast engine's tie patrol: a bound on
    |win_f32 - win_f64| for one window sum, 256 * eps32 * W * tmax
    (tmax = the largest |per-locus LOD term|).  The factor was calibrated
    on the TPU kernels; chip_smoke.py measures this port's ratio on the
    card against it, with and without TGLS errors.

    tmax comes from corner evaluation (O(L) min/max instead of a full
    f64 table build): every term is monotone in p and the heterozygote
    term is exactly log10(e), so the extremes sit at (min/max freq) x
    (min/max error)."""
    eps = 2.0 ** -23
    tmax = 1.0
    for c in chroms:
        tmax = max(tmax, _corner_tmax(c, error, use_gl))
    return 256.0 * eps * winsize * tmax


_corner_tmax_cache = {}


# copy of garlic_tpu/pipeline.py:1057
def _corner_tmax(c, error: float, use_gl: bool) -> float:
    """max |per-locus LOD term| bound for one chromosome by corner
    evaluation, memoized per freq array."""
    key = (id(c.freq), float(error), bool(use_gl))
    hit = _corner_tmax_cache.get(key)
    if hit is not None and hit[0] is c.freq:
        return hit[1]
    tmax = _corner_tmax_compute(c, error, use_gl)
    if len(_corner_tmax_cache) >= 8:
        _corner_tmax_cache.pop(next(iter(_corner_tmax_cache)))
    _corner_tmax_cache[key] = (c.freq, tmax)
    return tmax


# copy of garlic_tpu/pipeline.py:1075
def _corner_tmax_compute(c, error: float, use_gl: bool) -> float:
    tmax = 1.0
    f = np.asarray(c.freq, dtype=np.float64)
    live = (f > 0) & (f < 1)
    if not live.any():
        return tmax
    if not use_gl:
        es = (float(error),)
    elif c.gl_codes is not None:
        es = (float(np.min(c.gl_lut)), float(np.max(c.gl_lut)))
    else:
        es = (float(np.min(c.gl)), float(np.max(c.gl)))
    for p in (float(f[live].min()), float(f[live].max())):
        for e in es:
            for v in ((1.0 - e) / (1.0 - p) + e, e, (1.0 - e) / p + e):
                tmax = max(tmax, abs(float(np.log10(v))))
    return tmax


def _geno_cols_slice(c, w: int, W: int) -> np.ndarray:
    """int8 genotype codes [I, W] for loci [w, w+W) — decoded from the
    2-bit form when the chromosome is packed-only.

    Copy of garlic_tpu/pipeline.py:1095."""
    if not c.geno_is_packed_only:
        return np.asarray(c.genotypes[:, w:w + W])
    b = c.geno2b[:, w // 4:-(-(w + W) // 4)]
    codes = np.stack([(b >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(b.shape[0], -1)
    g = codes[:, w % 4:w % 4 + W]
    return np.where(g == 3, -9, g).astype(np.int8)


def _wlod_score_slice(c, i: int, w: int, W: int, error, use_gl: bool,
                      mu: float, M: int) -> np.ndarray:
    """f64 weighted per-locus scores for individual i, loci [w, w+W) —
    exactly wlod_scores' values/order ((lod * nomut) * norec,
    src/garlic-roh.cpp:249) without materializing the [I, L] matrix.

    Copy of garlic_tpu/pipeline.py:1107."""
    from .ops.lod import lod_terms
    g = _geno_row_slice(c, i, w, W)
    if use_gl and c.gl_codes is not None:
        e = c.gl_lut[c.gl_codes[i, w:w + W]][None, :]
    elif use_gl:
        e = np.asarray(c.gl[i, w:w + W], dtype=np.float64)[None, :]
    else:
        e = error
    base = lod_terms(g[None, :], c.freq[w:w + W], e)[0]
    pos = c.positions.astype(np.float64)
    gpos = c.gpos.astype(np.float64)
    dpos = np.empty(W)
    dg = np.empty(W)
    dpos[0] = pos[w] if w == 0 else pos[w] - pos[w - 1]
    dg[0] = gpos[w] if w == 0 else gpos[w] - gpos[w - 1]
    dpos[1:] = pos[w + 1:w + W] - pos[w:w + W - 1]
    dg[1:] = gpos[w + 1:w + W] - gpos[w:w + W - 1]
    nomut = np.exp(-2.0 * M * mu * dpos)
    norec = np.exp(-2.0 * M * 1.0 * dg)
    return (base * nomut) * norec


def _exact_wlod_band_rows(c, wins, winsize: int, phased: bool, sub_idx,
                          P: np.ndarray = None, group=None) -> np.ndarray:
    """f64 LD band rows [len(wins), W] of the windows starting at wins:
    the values and per-entry summation order of ops/ld.py's exact engine
    (LD[l][j] = sum over the window members k, in order, of ld(k, l+j);
    the reference's ldHR2/ldR2 k-loop, src/garlic-data.cpp:521-535), for
    every window at once.  Each window's pair values come from its locus
    slice [w, w+W) alone through the exact engine's pair formulas, or
    from the full pair band P when one is memoized.

    The slices of a block of windows are laid side by side, so one call
    of the pair formulas serves the block: a pair inside a slice gets the
    counts and the elementwise f64 arithmetic it gets alone, and a pair
    that straddles two slices is computed but never read.  The formulas
    run from their exact integer counts (ld_ops.pair_counts_*, the
    homozygosity counts), which on a per-process load (group) are summed
    over the processes first: an exchange per block of windows, so every
    process passes the same wins."""
    from .ops import ld as ld_ops
    wins = np.asarray(wins, dtype=np.int64)
    W = winsize
    if P is not None:
        return ld_ops.assemble_ld_exact_rows(P, W, wins)
    group = multihost.Group() if group is None else group
    rows = None  # the LD subsample's rows this process holds
    if sub_idx is not None:
        rr = np.asarray(sub_idx, dtype=np.int64)
        rows = rr[(rr >= c.row0) & (rr < c.row0 + c.nind)] - c.row0
    # Q[m, j] = ld(w + m, w + j) within a window, 1 on the diagonal
    # (_pair_lookup): member m's pair with site j
    a = np.arange(W)
    lo = np.minimum(a[:, None], a[None, :])
    d = np.abs(a[:, None] - a[None, :])
    out = np.empty((wins.size, W))
    for s in range(0, wins.size, 1024):  # bound the [I, k*W] slices
        blk = wins[s:s + 1024]
        g = np.concatenate([_geno_cols_slice(c, int(w), W) for w in blk],
                           axis=1)
        cols = (blk[:, None] + a).reshape(-1)
        if phased:
            n = ld_ops.pair_counts_r2(g, c.first_copy[:, cols], W, rows)
        else:
            n = ld_ops.pair_counts_hr2(g, W, rows) + ld_ops.geno_hom_counts(g)
        n = np.split(group.sum_int(np.concatenate(
            [x.reshape(-1) for x in n]), "patrol-ld"),
            np.cumsum([x.size for x in n])[:-1])
        n1, n2 = (x.reshape(-1, W) for x in n[:2])
        if phased:
            P2 = ld_ops.pair_ld_r2_from_counts(n1, n2, c.freq[cols], W)
        else:
            P2 = ld_ops.pair_ld_hr2_from_counts(
                n1, n2, ld_ops.geno_hom_freq_from_counts(n[2], n[3]), W)
        Q = np.where(d == 0, 1.0, P2.reshape(blk.size, W, W)[:, lo, d])
        acc = np.zeros((blk.size, W))
        for m in range(W):  # the k-loop order, from 0.0
            acc = acc + Q[:, m, :]
        out[s:s + blk.size] = acc
    return out


def _exact_wlod_window_flips(c, rows, wins, sides, winsize: int, error,
                             use_gl: bool, mu: float, M: int, phased: bool,
                             sub_idx, cutoff: float,
                             P: np.ndarray = None, group=None) -> np.ndarray:
    """Weighted tie-patrol verification: per suspect (row, window), does
    the f64 decision flip versus the device's f32 one?  The reference's
    wLOD has no rolling update (src/garlic-roh.cpp:259-272), so this f64
    recomputation is its exact value: the window's LD row from
    _exact_wlod_band_rows, the scores from _wlod_score_slice, summed in
    the reference's i-loop order.  group: a per-process load's Group;
    rows then index the whole panel, every process passes every suspect,
    verifies those of the rows it holds against band rows made from
    counts summed over the processes, and the flips are gathered.

    Adapted from garlic_tpu/pipeline.py:1134, which assembles each
    distinct window's band row alone (W^2 scalar-sized steps), and on a
    per-process load from the whole chromosome's summed pair band
    (_wpair_band); here the distinct windows' rows are assembled
    together, with the same values."""
    wins = np.asarray(wins, dtype=np.int64)
    rows = np.asarray(rows, dtype=np.int64)
    distinct, which = np.unique(wins, return_inverse=True)
    band_rows = _exact_wlod_band_rows(c, distinct, winsize, phased,
                                      sub_idx, P, group)
    flips = np.zeros(len(rows), dtype=bool)
    for k in np.flatnonzero((rows >= c.row0) & (rows < c.row0 + c.nind)):
        i, w = int(rows[k]) - c.row0, int(wins[k])
        score = _wlod_score_slice(c, i, w, winsize, error, use_gl, mu, M)
        with np.errstate(divide="ignore", invalid="ignore"):
            # a zero band entry divides to inf exactly as the reference's
            # score/LD does; non-finite sums escalate below
            terms = score * (1.0 / band_rows[which[k]])
            s = float(np.cumsum(terms)[-1])  # the reference's i-loop order
        if not np.isfinite(s):
            flips[k] = True  # inf/nan band: escalate to the exact row
            continue
        flips[k] = (s >= cutoff) != bool(sides[k])
    if group is not None:
        flips = group.allgather(flips.astype(np.uint8), "patrol").any(axis=0)
    return flips


def _geno_row_slice(c, i: int, w: int, W: int) -> np.ndarray:
    """int8 genotype codes [W] for individual i, loci [w, w+W) — decoded
    from the 2-bit form when the chromosome is packed-only, so the tie
    patrol never materializes the full int8 matrix.

    Copy of garlic_tpu/pipeline.py:1185."""
    if not c.geno_is_packed_only:
        return np.asarray(c.genotypes[i, w:w + W])
    b = c.geno2b[i, w // 4:-(-(w + W) // 4)]
    codes = np.stack([(b >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(-1)
    g = codes[w % 4:w % 4 + W]
    return np.where(g == 3, -9, g).astype(np.int8)


# copy of garlic_tpu/pipeline.py:1198
def _exact_window_flips(c, rows, wins, sides, winsize: int, error: float,
                        use_gl: bool, cutoff: float) -> np.ndarray:
    """Per suspect (row, window): does the f64 'window >= cutoff'
    decision FLIP versus the device's f32 one (`sides`)?  The tie
    patrol's cheap verification stage — ~winsize-term fresh f64 sums.

    The oracle accumulates most windows by the ROLLING subtract/add
    recurrence, whose value can differ from a fresh left-to-right sum by
    up to ~n_updates rounding errors; a suspect whose fresh sum lands
    within that drift bound of the cutoff is reported as flipped, which
    routes its row to the full exact rolling recomputation."""
    nwin = max(c.positions.shape[0] - winsize + 1, 1)
    tmax = _corner_tmax(c, error, use_gl)
    esc = max(1e-9, 4.0 * nwin * 2.0 ** -52 * (winsize + 1) * tmax)
    rows = np.asarray(rows, dtype=np.int64)
    wins = np.asarray(wins, dtype=np.int64)
    W = winsize
    # one batched gather for ALL suspects; per-row cumsum == the
    # sequential left-to-right f64 sum
    gv = _geno_windows_batch(c, rows, wins, W)
    cols = wins[:, None] + np.arange(W)
    if use_gl and c.gl_codes is not None:
        e = c.gl_lut[c.gl_codes[rows[:, None], cols]]
    elif use_gl:
        e = np.asarray(c.gl, dtype=np.float64)[rows[:, None], cols]
    else:
        e = error
    fv = c.freq[cols]
    terms = lod_ops.lod_terms(gv, fv, e)
    s = np.cumsum(terms, axis=1, dtype=np.float64)[:, -1]
    unsure = np.abs(s - cutoff) < esc
    return unsure | ((s >= cutoff) != np.asarray(sides).astype(bool))


# copy of garlic_tpu/pipeline.py:1244
def _geno_windows_batch(c, rows: np.ndarray, wins: np.ndarray,
                        W: int) -> np.ndarray:
    """int8 genotype codes [k, W] for suspect (row, window-start) pairs —
    decoded straight from the 2-bit packed bytes when the chromosome is
    packed-only (gathers only the ~W/4 bytes each suspect needs)."""
    if not c.geno_is_packed_only:
        cols = wins[:, None] + np.arange(W)
        return np.asarray(c.genotypes)[rows[:, None], cols]
    if c._geno2b is None and c.geno2b_parent is not None:
        # compaction still deferred: decode per-element from the
        # UNFILTERED parent payload via the kept-column index map
        pb, idx = c.geno2b_parent
        pidx = idx[wins[:, None] + np.arange(W)]       # parent columns
        byts = pb[rows[:, None], pidx >> 2]
        g = (byts >> ((pidx & 3) * 2)) & 3
        return np.where(g == 3, -9, g).astype(np.int8)
    rb = c.geno2b.shape[1]
    nbytes = W // 4 + 2  # covers any w%4 alignment
    bidx = np.minimum(wins[:, None] // 4 + np.arange(nbytes), rb - 1)
    byts = c.geno2b[rows[:, None], bidx]                   # [k, nbytes]
    k = rows.shape[0]
    codes = np.stack([(byts >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(k, 4 * nbytes)
    cols = (wins % 4)[:, None] + np.arange(W)
    g = np.take_along_axis(codes, cols, axis=1)
    return np.where(g == 3, -9, g).astype(np.int8)


# copy of garlic_tpu/pipeline.py:1343
def _subset_chrom_rows(c, idx):
    """_subset_chrom for a FEW rows without firing the whole-matrix
    packed-column compaction: decode the selected rows from the
    UNFILTERED parent payload and column-gather the kept loci."""
    if not (c.geno_is_packed_only and c._geno2b is None
            and c.geno2b_parent is not None):
        return _subset_chrom(c, idx)
    pb, kidx = c.geno2b_parent
    rows_b = np.asarray(pb[np.asarray(idx, dtype=np.int64)])
    k = rows_b.shape[0]
    codes = np.stack([(rows_b >> s) & 3 for s in (0, 2, 4, 6)],
                     axis=-1).reshape(k, -1)
    g = codes[:, kidx]
    g = np.where(g == 3, -9, g).astype(np.int8)
    return ChromData(chrom=c.chrom, positions=c.positions, gpos=c.gpos,
                     locus_names=c.locus_names, alleles=c.alleles,
                     genotypes=g, freq=c.freq,
                     first_copy=None if c.first_copy is None
                     else c.first_copy[idx],
                     gl=None if c._gl is None else c._gl[idx],
                     gl_codes=None if c.gl_codes is None
                     else c.gl_codes[idx],
                     gl_lut=c.gl_lut)


# copy of garlic_tpu/pipeline.py:1371
def _subset_chrom(c, idx):
    packed = c.geno_is_packed_only
    return ChromData(chrom=c.chrom, positions=c.positions, gpos=c.gpos,
                     locus_names=c.locus_names, alleles=c.alleles,
                     genotypes=None if packed else c.genotypes[idx],
                     freq=c.freq,
                     first_copy=None if c.first_copy is None
                     else c.first_copy[idx],
                     gl=None if c._gl is None else c._gl[idx],
                     gl_codes=None if c.gl_codes is None
                     else c.gl_codes[idx],
                     gl_lut=c.gl_lut,
                     geno2b=c.geno2b[idx] if packed else None)
