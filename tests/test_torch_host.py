"""The port's own host code against garlic_tpu's, on the CPU.

garlic_tpu_torch imports nothing of garlic_tpu: it carries copies of the
host code it needs (CLI, parsers, panel cache, KDE grid, GMM, cutoff
search, the native C++ library).  These tests hold each copy to its
source: the copied definitions' code is garlic_tpu's (docstrings and the
package name of absolute imports aside), the native entry points give
equal results on the same seeded inputs, the host numerics are equal bit
for bit, and no module of the port (nor chip_smoke.py) imports garlic_tpu
or JAX.  Tolerances: none; every comparison is exact.
"""

from __future__ import annotations

import ast
import gzip
import os
import re
import sys

import numpy as np
import pytest

from garlic_tpu import cli as gt_cli
from garlic_tpu import native as gt_native
from garlic_tpu.ops import cutoff as gt_cutoff
from garlic_tpu.ops import gmm as gt_gmm
from garlic_tpu.ops import kde as gt_kde
from garlic_tpu.version import OUTPUT_COMPAT_VERSION as GT_VERSION
from garlic_tpu_torch import cli, native
from garlic_tpu_torch.ops import cutoff, gmm, kde
from garlic_tpu_torch.version import OUTPUT_COMPAT_VERSION

sys.path.insert(0, os.path.dirname(__file__))
from util import make_panel, write_tgls, write_tped  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "garlic_tpu_torch")
# the JAX package, JAX, and the JAX package's benchmark scripts (the port's
# bench_torch.py and bench_scaling_torch.py carry copies of what they need)
REFUSED = ("garlic_tpu", "jax", "jaxlib", "bench", "bench_scaling")


def _port_sources():
    out = []
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(REPO, f)
                          for f in ("chip_smoke.py", "chip_ab.py",
                                    "bench_torch.py",
                                    "bench_scaling_torch.py")]


# ---------------------------------------------------------------------------
# Isolation
# ---------------------------------------------------------------------------

def _refused_imports(path):
    """(line, module) of every import of garlic_tpu, JAX, bench.py or
    bench_scaling.py in a file: import statements, and __import__ /
    importlib.import_module with a constant name."""
    tree = ast.parse(open(path).read())
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            names = [node.args[0].value]
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in REFUSED]
    return found


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_file_imports_no_garlic_tpu_or_jax(path):
    assert _refused_imports(path) == []


def test_refused_import_finder_sees_every_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import garlic_tpu.cli\nfrom jax import numpy\n"
                   "import garlic_tpu_torch.cli\nfrom . import x\n"
                   "import bench_scaling\nfrom bench import run_ours\n"
                   "import bench_torch\n"
                   "def f():\n    __import__('jaxlib')\n"
                   "    importlib.import_module('garlic_tpu.ops')\n")
    assert [n for _, n in _refused_imports(str(src))] == [
        "garlic_tpu.cli", "jax", "bench_scaling", "bench", "jaxlib",
        "garlic_tpu.ops"]


# ---------------------------------------------------------------------------
# Copied definitions: the code is garlic_tpu's
# ---------------------------------------------------------------------------

# a source file as a path from the repository's root: a module of
# garlic_tpu, or one of its root benchmark scripts
_SOURCE = r"(garlic_tpu/\S+?\.py|bench(?:_scaling)?\.py)"
_COPY = re.compile(rf"Copy of {_SOURCE}:(\d+)\.")


def _strip(node):
    """The node's AST dump without docstrings, with absolute imports of
    garlic_tpu_torch read as garlic_tpu."""
    node = ast.parse(ast.unparse(node)).body[0]
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if (isinstance(n, (ast.FunctionDef, ast.ClassDef,
                           ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            n.body = body[1:] or [ast.Pass()]
        if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            n.module = re.sub(r"^garlic_tpu_torch\b", "garlic_tpu", n.module)
    return ast.dump(node)


def _copied(path):
    """(name, source file, source line, node) of each top-level definition
    whose docstring says it is a copy."""
    out = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            m = _COPY.search(ast.get_docstring(node) or "")
            if m:
                out.append((node.name, m.group(1), int(m.group(2)), node))
    return out


_COPY_MODULES = [p for p in _port_sources() if _copied(p)]


@pytest.mark.parametrize("path", _COPY_MODULES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_copied_definitions_are_garlic_tpus(path):
    for name, rel, line, node in _copied(path):
        src = ast.parse(open(os.path.join(REPO, rel)).read())
        match = [n for n in src.body
                 if getattr(n, "name", None) == name and n.lineno == line]
        assert match, f"{name}: no definition at {rel}:{line}"
        assert _strip(node) == _strip(match[0]), f"{name} differs from " \
            f"{rel}:{line}"


_COPY_LINES = re.compile(rf"^# Copy of {_SOURCE}:(\d+)-(\d+)\.$", re.M)


def _copied_lines(path):
    """(source file, first line, last line, the statements) of each block
    of top-level statements after a comment that says it copies those
    lines: as many statements as the source's top level has there."""
    text = open(path).read()
    body = ast.parse(text).body
    out = []
    for m in _COPY_LINES.finditer(text):
        at = text.count("\n", 0, m.start()) + 1
        rel, a, b = m.group(1), int(m.group(2)), int(m.group(3))
        src = ast.parse(open(os.path.join(REPO, rel)).read()).body
        n = sum(a <= s.lineno <= b for s in src)
        out.append((rel, a, b, [s for s in body if s.lineno > at][:n]))
    return out


@pytest.mark.parametrize("path", [p for p in _port_sources()
                                  if _copied_lines(p)],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_copied_statements_are_their_sources(path):
    """Module-level statements copied as a block (bench_torch.py's
    constants) are their source's statements on those lines."""
    for rel, a, b, mine in _copied_lines(path):
        src = ast.parse(open(os.path.join(REPO, rel)).read()).body
        theirs = [s for s in src if a <= s.lineno <= b]
        assert theirs, f"no statement at {rel}:{a}-{b}"
        assert [ast.dump(s) for s in mine] == \
            [ast.dump(s) for s in theirs], f"differs from {rel}:{a}-{b}"


@pytest.mark.parametrize("rel,copies,adapted", [
    ("bench_torch.py", ("log", "total_windows", "ensure_panel",
                        "oracle_baseline"),
     ("run_ours", "kernel_throughput", "start_warmup_thread", "main")),
    ("bench_scaling_torch.py", (), ("main",)),
], ids=["bench_torch", "bench_scaling_torch"])
def test_bench_scripts_name_their_sources(rel, copies, adapted):
    """The port's benchmark scripts: bench.py's definitions that they copy
    (held to their code by test_copied_definitions_are_garlic_tpus) and
    those adapted from bench.py or bench_scaling.py, each naming the
    source definition of the same name; bench_torch.py's constants are
    held by test_copied_statements_are_their_sources."""
    path = os.path.join(REPO, rel)
    assert {n for n, _, _, _ in _copied(path)} == set(copies)
    named = {n: _source_defs(src)[line] for n, src, line in _adapted(path)}
    assert named == {n: n for n in adapted}
    if rel == "bench_torch.py":
        names = {t.id for _, _, _, stmts in _copied_lines(path)
                 for s in stmts for t in s.targets}
        assert names == {"REPO", "CACHE", "ORACLE", "NIND", "NLOCI",
                         "WINSIZE", "FLAGS"}


def test_copies_cover_the_host_modules():
    """Every whole-module copy the port carries is named, so a module that
    stops being a copy is noticed."""
    rels = {os.path.relpath(p, PORT) for p in _COPY_MODULES}
    for rel in ("cli.py", "centromeres.py", "logger.py", "core/digest.py",
                "core/fmt.py", "core/pbar.py", "core/types.py", "io/tfam.py",
                "io/freqfile.py", "io/filters.py", "io/kdefile.py",
                "io/rawlod.py", "io/tgls.py", "io/tped.py",
                "io/panelcache.py", "io/genmap.py", "ops/cutoff.py",
                "ops/density.py", "ops/wiggle.py", "ops/brent.py",
                "ops/kde.py", "ops/gmm.py", "ops/device_win.py", "ops/ld.py",
                "ops/wlod.py", "ops/convert.py", "api.py",
                "pipeline.py", "parallel/mesh.py", "parallel/engine.py",
                "tools/vcf2tped.py", "tools/count_features_in_roh.py"):
        assert rel in rels, rel


_ADAPTED = re.compile(rf"Adapted from\s+{_SOURCE}:(\d+)")


def _adapted(path):
    """(name, source file, source line) of each top-level definition whose
    docstring says it is adapted from garlic_tpu or its benchmark
    scripts."""
    out = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            m = _ADAPTED.search(" ".join(
                (ast.get_docstring(node) or "").split()))
            if m:
                out.append((node.name, m.group(1), int(m.group(2))))
    return out


def _source_defs(rel):
    src = ast.parse(open(os.path.join(REPO, rel)).read())
    return {n.lineno: n.name for n in src.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("path", [p for p in _port_sources() if _adapted(p)],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_adapted_definitions_name_a_source_definition(path):
    """An adapted definition (its code differs on purpose) names the line
    of a top-level definition of garlic_tpu or its benchmark scripts."""
    for name, rel, line in _adapted(path):
        assert line in _source_defs(rel), \
            f"{name}: no definition at {rel}:{line}"


@pytest.mark.parametrize("rel,names,adapted", [
    ("ops/device_win.py", ("is_device_win", "LazyWin", "is_lazy_win"), ()),
    ("ops/convert.py", ("win_to_samples",), ()),
    ("api.py", ("ROHResult",), ("load_panel", "call_roh")),
    ("pipeline.py", (), ("_resolve_mesh", "_owned_row_patrol",
                         "_exact_thinned_samples_sharded",
                         "_wpair_band", "_exact_thinned_wsamples")),
    ("parallel/mesh.py", ("factor_devices",), ("make_mesh",)),
    ("parallel/engine.py", ("check_halo_fits", "full_window_missing"),
     ("lod_windows_sharded", "gauss_transform_sharded", "fit_gmm_sharded",
      "ld_band_sharded", "wlod_windows_sharded",
      "allele_freq_counts_sharded", "allele_freq_sharded")),
    ("parallel/multihost.py", (),
     ("initialize_distributed", "initialize_from_env",
      "host_individual_range", "dp_layout_aligned")),
], ids=["device_win", "convert", "api", "pipeline", "parallel_mesh",
        "parallel_engine", "parallel_multihost"])
def test_streaming_and_api_definitions_are_held_to_their_sources(
        rel, names, adapted):
    """The definitions of the streaming, API and mesh slices: the copies
    are held to their code by test_copied_definitions_are_garlic_tpus,
    the adapted ones to a garlic_tpu definition of the same name."""
    path = os.path.join(PORT, rel)
    copies = {n for n, _, _, _ in _copied(path)}
    assert set(names) <= copies, set(names) - copies
    for name, src, line in _adapted(path):
        if name in adapted:
            assert _source_defs(src)[line] == name
    assert set(adapted) <= {n for n, _, _ in _adapted(path)}


# ---------------------------------------------------------------------------
# The CLI and the output version
# ---------------------------------------------------------------------------

def _specs(mod):
    return [(s.name, s.kind, s.default, s.help) for s in mod._flag_specs()]


@pytest.mark.parametrize("argv", [
    ["--tped", "a.tped", "--tfam", "a.tfam", "--winsize", "50"],
    ["--winsize-multi", "30", "40", "--auto-winsize", "--error", "0.01",
     "--size-bounds", "1", "2", "--tpu-engine", "exact"],
    ["--bogus"],
], ids=["plain", "lists", "unknown"])
def test_cli_flag_table_parses_like_garlic_tpu(argv):
    assert _specs(cli) == _specs(gt_cli)
    assert OUTPUT_COMPAT_VERSION == GT_VERSION
    got = want = None
    try:
        got = cli.parse_command_line(argv).values
    except cli.CLIError as e:
        got = ("error", str(e))
    try:
        want = gt_cli.parse_command_line(argv).values
    except gt_cli.CLIError as e:
        want = ("error", str(e))
    assert got == want


# ---------------------------------------------------------------------------
# Native entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    wd = tmp_path_factory.mktemp("host")
    panel = make_panel(nind=11, nloci_per_chr=(1500, 901), seed=3)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    write_tgls(panel, str(wd / "GL.tgls.gz"), gl_type="GL")
    return wd, panel


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif hasattr(a, "raw"):
        assert a.raw == b.raw
    else:
        assert a == b


def _windows(seed, I=7, L=700):
    rng = np.random.default_rng(seed)
    geno = rng.integers(0, 3, (I, L)).astype(np.int8)
    geno[rng.random((I, L)) < 0.05] = -9
    table = np.zeros((4, L))
    table[:3] = rng.normal(size=(3, L))
    miss = (rng.random(L) < 0.02).astype(np.uint8)
    return geno, table, miss


def _parse_tped(mod, wd, phased=False):
    """Unphased: 2-bit codes straight from the parser; phased: int8
    genotypes and the first-copy bits."""
    if mod is native:
        return mod.parse_tped_native(str(wd / "p.tped.gz"), "0",
                                     want_fc=phased)
    return mod.parse_tped_native(str(wd / "p.tped.gz"), "0", want_fc=phased,
                                 want_packed=not phased)


def _freq_roundtrip(mod, wd):
    chrom = _parse_tped(native, wd)[0]
    path = str(wd / f"f_{mod.__name__}.freq.gz")
    mod.write_freq_chrom_native(path, False, chrom["chrom"], chrom["names"],
                                chrom["positions"], chrom["alleles"],
                                chrom["freq"])
    with gzip.open(path, "rb") as f:
        text = f.read()
    back = mod.read_freq_native(path, chrom["names"].raw, chrom["alleles"],
                                chrom["freq"].size)
    return text, back


def _coverage(seed):
    rng = np.random.default_rng(seed)
    win = rng.normal(1.0, 1.0, (6, 900))
    win[:, -29:] = -9999.0
    return win


def _assemble(mod, seed):
    win = _coverage(seed)
    packed = native.covered_pack_native(win, 30, 1.0, 8.0)
    pos = np.cumsum(np.random.default_rng(seed).integers(100, 5000, 900))
    br = np.zeros(900, np.uint8)
    br[::211] = 1
    return mod.assemble_runs_native(packed, br, pos, pos * 1e-6, 8.0, False)


NATIVE = {
    "parse_tped": _parse_tped,
    "parse_tped_phased": lambda mod, wd: _parse_tped(mod, wd, phased=True),
    "parse_tgls_codes": lambda mod, wd: mod.parse_tgls_native(
        str(wd / "GQ.tgls.gz"), 11, [1500, 901]),
    "parse_tgls_vals": lambda mod, wd: mod.parse_tgls_native(
        str(wd / "GL.tgls.gz"), 11, [1500, 901]),
    "lod_windows_exact": lambda mod, wd: mod.lod_windows_exact_native(
        np.random.default_rng(1).normal(size=(5, 400)),
        _windows(1)[2][:400], 40),
    "lod_windows_exact_tbl": lambda mod, wd: mod.lod_windows_exact_tbl_native(
        *_windows(2), 40),
    "lod_windows_exact_thin": lambda mod, wd: (
        mod.lod_windows_exact_thin_native(*_windows(3), 40, 40)),
    "assemble_runs": lambda mod, wd: _assemble(mod, 4),
    "covered_pack": lambda mod, wd: mod.covered_pack_native(
        _coverage(5), 30, 1.0, 8.0),
    "hash128": lambda mod, wd: mod.hash128_native(
        np.random.default_rng(6).integers(0, 255, 100003, dtype=np.uint8)),
    "gsl_sd": lambda mod, wd: mod.gsl_sd_native(
        np.sort(np.random.default_rng(7).normal(3.0, 2.0, 20001))),
    "freq_roundtrip": _freq_roundtrip,
    "pack_unpack_2bit": lambda mod, wd: mod.unpack_2bit_native(
        mod.pack_2bit_padded_native(_windows(8)[0], 7, 704), 700),
    "filter_pack_2bit": lambda mod, wd: mod.filter_pack_2bit_native(
        native.pack_2bit_padded_native(_windows(9)[0], 7, 704), 700,
        np.random.default_rng(9).random(700) < 0.7),
}


@pytest.mark.parametrize("name", list(NATIVE))
def test_native_entry_point_matches_garlic_tpu(files, name):
    wd, _ = files
    native.library()  # raises BuildError when g++ cannot build it
    got = NATIVE[name](native, wd)
    want = NATIVE[name](gt_native, wd)
    assert got is not None
    _same(got, want)


def test_native_library_builds_under_build_dir():
    native.library()
    path = native.build.loaded_path
    assert path in [native.library_path(f) for f in native.build.FLAGS]
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "garlic_tpu_torch")


# ---------------------------------------------------------------------------
# Host numerics: the GMM, the KDE, the cutoff search
# ---------------------------------------------------------------------------

def _mixture(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(2.2e5, 5e4, 900),
                           rng.normal(8.5e5, 1.8e5, 600),
                           rng.normal(2.6e6, 6e5, 300)]).clip(1e4, None)


def _gmm_init(x, k=3):
    var, mean = float(np.var(x, ddof=1)), float(np.mean(x))
    return (np.full(k, 1.0 / k),
            np.array([mean * (n + 1) / (k + 1) for n in range(k)]),
            np.array([var * (n + 1) / k for n in range(k)]))


def _pool(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(-3, 1.0, 7000),
                           rng.normal(2, 0.7, 3001)])


HOST = {
    "fit_gmm": (lambda m, x: m.fit_gmm(x, 3, *_gmm_init(x)), _mixture),
    "gmm_sufficient_stats": (lambda m, x: m.gmm_sufficient_stats(
        x, *_gmm_init(x)), _mixture),
    "kde_grid": (lambda m, x: m._kde_grid(x), _pool),
    "gauss_transform_host": (lambda m, x: (
        m.gauss_transform_host if m is kde
        else lambda s, t, h: m.gauss_transform(s, t, h, device=False))(
            x, gt_kde._kde_grid(x)[1], gt_kde.nrd0(x)), _pool),
    "compute_kde_host": (lambda m, x: m.compute_kde(x), _pool),
}


@pytest.mark.parametrize("name", list(HOST))
@pytest.mark.parametrize("seed", [11, 12])
def test_host_numerics_equal_garlic_tpu(name, seed):
    fn, data = HOST[name]
    x = data(seed)
    port_mod = gmm if "gmm" in name else kde
    gt_mod = gt_gmm if "gmm" in name else gt_kde
    got, want = fn(port_mod, x), fn(gt_mod, x)
    if hasattr(got, "__dataclass_fields__"):
        got, want = vars(got), vars(want)
    _same(got, want)


def _density(seed):
    kr = gt_kde.compute_kde(_pool(seed))
    return kr.x, kr.y


@pytest.mark.parametrize("fn", ["get_min_btw_modes", "cutoff_tie_probe",
                                "get_min_btw_modes_indices"])
@pytest.mark.parametrize("seed", [21, 22, 23, 24, 25, 26])
def test_cutoff_search_equals_garlic_tpu(fn, seed):
    x, y = _density(seed)
    got = getattr(cutoff, fn)(x, y, 40)
    assert got == getattr(gt_cutoff, fn)(x, y, 40)

