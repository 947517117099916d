"""End-to-end parity of the port (garlic_tpu_torch) with garlic_tpu on the
pinned-cutoff slice, the port's JAX independence, and its refusals.

The port runs on the CPU here (device="cpu": the kernels' plain
versions); garlic_tpu runs its fast engine through the Pallas kernels in
interpret mode (GARLIC_TPU_FUSED_INTERPRET, as tests/test_device_win.py
does) and its exact engine.  .roh.bed is byte-identical, .log identical
after its first line, .freq.gz content-identical."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, write_tgls,  # noqa: E402
                  write_tped)

from garlic_tpu_torch.ops import cuda_lod  # noqa: E402
from garlic_tpu_torch.pipeline import run_main as port_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINNED = ["--winsize", "40", "--error", "0.001", "--kde-subsample", "0",
          "--lod-cutoff", "1.3", "--size-bounds", "300000", "800000"]


@pytest.fixture(scope="module")
def panel_dir(tmp_path_factory):
    """The panel of test_device_win.py:193 plus a centromere file that
    cuts both chromosomes."""
    wd = tmp_path_factory.mktemp("port_panel")
    panel = make_panel(nind=35, nloci_per_chr=(5000, 4000), seed=17,
                       big_gap_every=700)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    p1, p2 = panel.positions
    with open(wd / "centro.txt", "w") as f:
        f.write(f"1 {int(p1[2000])} {int(p1[2100])}\n"
                f"2 {int(p2[3000])} {int(p2[3050])}\n")
    return str(wd)


def jax_main(argv, prog):
    # imported here: the gpu tests collect where JAX is absent
    from garlic_tpu.pipeline import run_main
    return run_main(argv, prog=prog)


def _run(main, wd, args, **kw):
    old = os.getcwd()
    os.chdir(wd)
    try:
        return main(args, prog="garlic", **kw)
    finally:
        os.chdir(old)


def _base(wd):
    return ["--tped", f"{wd}/p.tped.gz", "--tfam", f"{wd}/p.tfam",
            "--centromere", f"{wd}/centro.txt"] + PINNED


def _same_outputs(wd, out, ref):
    assert read_text(f"{wd}/{out}.roh.bed") == read_text(f"{wd}/{ref}.roh.bed")
    assert read_text(f"{wd}/{out}.freq.gz") == read_text(f"{wd}/{ref}.freq.gz")
    assert diff_logs(read_text(f"{wd}/{ref}.log"),
                     read_text(f"{wd}/{out}.log"), ref, out) == []


def test_pinned_run_matches_garlic_tpu(panel_dir, monkeypatch):
    wd, base = panel_dir, _base(panel_dir)
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "jx"]) == 0
    monkeypatch.setenv("GARLIC_TPU_FUSED_INTERPRET", "1")
    assert _run(jax_main, wd, base + ["--tpu-engine", "fast",
                                      "--out", "jf"]) == 0
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "pf"], device="cpu") == 0
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", "px"]) == 0
    bed = read_text(f"{wd}/jx.roh.bed")
    assert bed.count("\nchr") >= 5  # the panel has ROH to call
    for out in ("pf", "px"):
        _same_outputs(wd, out, "jx")
        _same_outputs(wd, out, "jf")


def test_panel_cache_cold_and_warm_match(panel_dir):
    """The port writes the sidecar itself (io/panelcache.py) and reads
    garlic_tpu's format: cold, warm, and garlic_tpu on the port's
    sidecar all give the same BED."""
    wd = panel_dir
    src = f"{wd}/p.tped.gz"
    pc = f"{wd}/pc.tped.gz"
    with open(src, "rb") as f, open(pc, "wb") as g:
        g.write(f.read())
    base = ["--tped", pc, "--tfam", f"{wd}/p.tfam", "--centromere",
            f"{wd}/centro.txt", "--tpu-panel-cache"] + PINNED
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "cold"], device="cpu") == 0
    assert os.path.exists(pc + ".gtpc")
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "warm"], device="cpu") == 0
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "jwarm"]) == 0
    for out in ("cold", "warm"):
        _same_outputs(wd, out, "jwarm")


def test_user_freq_file_and_resample_match_garlic_tpu(panel_dir):
    """--freq-file (frequencies from a file) and --resample (seeded)
    take the same load path as garlic_tpu's."""
    wd = panel_dir
    base = _base(wd)
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "fsrc"]) == 0
    for extra, tag in ((["--freq-file", f"{wd}/fsrc.freq.gz"], "ff"),
                       (["--resample", "40", "--tpu-seed", "3"], "rs")):
        assert _run(jax_main, wd, base + extra + [
            "--tpu-engine", "exact", "--out", f"j{tag}"]) == 0
        assert _run(port_main, wd, base + extra + [
            "--tpu-engine", "fast", "--out", f"p{tag}"], device="cpu") == 0
        assert read_text(f"{wd}/p{tag}.roh.bed") == \
            read_text(f"{wd}/j{tag}.roh.bed")
        assert diff_logs(read_text(f"{wd}/j{tag}.log"),
                         read_text(f"{wd}/p{tag}.log"), f"j{tag}",
                         f"p{tag}") == []


def _raw(wd, out):
    vals = []
    for c in ("chr1", "chr2"):
        text = read_text(f"{wd}/{out}.POP1.{c}.raw.lod.windows.gz")
        vals.append(np.array(text.replace("NA", "nan").split(), dtype=float))
    return np.concatenate(vals)


def test_raw_lod_matches_garlic_tpu(panel_dir):
    """--raw-lod takes the split path (K1 + the torch coverage program).
    Raw values: f32 against f64 (and XLA's f32), printed with %g's six
    significant digits, hence atol 1e-4 plus rtol 1e-5."""
    wd, base = panel_dir, _base(panel_dir) + ["--raw-lod"]
    assert _run(jax_main, wd, base + ["--tpu-engine", "exact",
                                      "--out", "rjx"]) == 0
    assert _run(jax_main, wd, base + ["--tpu-engine", "fast",
                                      "--out", "rjf"]) == 0
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "rpf"], device="cpu") == 0
    got = _raw(wd, "rpf")
    for ref in ("rjx", "rjf"):
        assert read_text(f"{wd}/rpf.roh.bed") == \
            read_text(f"{wd}/{ref}.roh.bed")
        want = _raw(wd, ref)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        live = ~np.isnan(want)
        np.testing.assert_allclose(got[live], want[live], atol=1e-4,
                                   rtol=1e-5)


def test_port_runs_with_jax_blocked(tmp_path):
    """The port imports and runs with every import of `jax`, `jaxlib` and
    the JAX package `garlic_tpu` refused (garlic_tpu_torch is a top-level
    name of its own: only an exact first dotted component is refused),
    fast with device="cpu" and exact, with and without a --tgls error file
    (the port's own reader and .gtlc sidecar), and on an automatic cutoff
    and bounds run (the KDE, the GMM and the pool cache) on a panel whose
    GMM fits.  No garlic_tpu module is loaded at the end."""
    panel = make_panel(nind=12, nloci_per_chr=(900, 700), seed=5)
    write_tped(panel, str(tmp_path / "t.tped.gz"), str(tmp_path / "t.tfam"))
    write_tgls(panel, str(tmp_path / "t.tgls.gz"), gl_type="GQ")
    panel = make_panel(nind=30, nloci_per_chr=(4000, 3000), seed=23)
    write_tped(panel, str(tmp_path / "a.tped.gz"), str(tmp_path / "a.tfam"))
    script = (
        "import sys\n"
        "class B:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'garlic_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, B())\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from garlic_tpu_torch.pipeline import run_main\n"
        "base = ['--tped', 't.tped.gz', '--tfam', 't.tfam', '--build',\n"
        "        'hg18', '--winsize', '30', '--error', '0.001',\n"
        "        '--lod-cutoff', '1.0', '--size-bounds', '100000',\n"
        "        '--tpu-panel-cache']\n"
        "tgls = ['--tgls', 't.tgls.gz', '--gl-type', 'GQ']\n"
        "for eng in ('fast', 'exact'):\n"
        "    for extra, out in (([], eng), (tgls, 'gl_' + eng)):\n"
        "        rc = run_main(base + extra + ['--tpu-engine', eng,\n"
        "                                      '--out', out], device='cpu')\n"
        "        assert rc == 0, (out, rc)\n"
        "auto = ['--tped', 'a.tped.gz', '--tfam', 'a.tfam', '--build',\n"
        "        'hg18', '--winsize', '30', '--error', '0.001',\n"
        "        '--kde-subsample', '0', '--tpu-panel-cache']\n"
        "for out, eng in (('auto_cold', 'fast'), ('auto_warm', 'fast'),\n"
        "                 ('auto_exact', 'exact')):\n"
        "    rc = run_main(auto + ['--tpu-engine', eng, '--out', out],\n"
        "                  device='cpu')\n"
        "    assert rc == 0, (out, rc)\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib', 'garlic_tpu')]\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    r = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
    assert (tmp_path / "fast.roh.bed").read_text() == \
        (tmp_path / "exact.roh.bed").read_text()
    assert (tmp_path / "gl_fast.roh.bed").read_text() == \
        (tmp_path / "gl_exact.roh.bed").read_text()
    assert (tmp_path / "t.tgls.gz.gtlc").exists()
    for out in ("auto_cold", "auto_warm"):
        assert (tmp_path / f"{out}.roh.bed").read_text() == \
            (tmp_path / "auto_exact.roh.bed").read_text()
    assert "Selected LOD score cutoff:" in \
        (tmp_path / "auto_cold.log").read_text()


def test_fast_engine_without_cuda_exits_nonzero(panel_dir, monkeypatch,
                                                capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = _run(port_main, panel_dir, _base(panel_dir) + [
        "--tpu-engine", "fast", "--out", "nocuda"])
    assert rc == 1
    assert "--tpu-engine fast needs a CUDA device" in capsys.readouterr().err
    assert not os.path.exists(f"{panel_dir}/nocuda.log")


@pytest.mark.parametrize("surface", ["cli", "api"])
def test_failed_native_build_ends_the_run(panel_dir, monkeypatch, capsys,
                                          surface):
    """The native host library is required, as the kernels' library is.
    With flags g++ refuses, and no library loaded yet, g++ really runs
    and fails: a CLI run exits 1 with one stderr line, an ERROR naming
    g++ and build/garlic_tpu_torch/, before it writes any output, and
    api.load_panel raises the build error with g++'s stderr."""
    from garlic_tpu_torch import api, native
    monkeypatch.setattr(native.build, "FLAGS", (["--no-such-g++-flag"],))
    monkeypatch.setattr(native.build, "_lib", None)
    if surface == "cli":
        rc = _run(port_main, panel_dir, _base(panel_dir) + [
            "--tpu-engine", "exact", "--out", "nonative"])
        assert rc == 1
        err = capsys.readouterr().err.strip().splitlines()
        assert len(err) == 1, err
        assert err[0].startswith("ERROR:") and "g++" in err[0]
        assert os.path.join("build", "garlic_tpu_torch") + "/" in err[0]
        assert not os.path.exists(f"{panel_dir}/nonative.log")
    else:
        with pytest.raises(native.BuildError,
                           match="(?s)g\\+\\+.*--no-such-g\\+\\+-flag"):
            api.load_panel(f"{panel_dir}/p.tped.gz", f"{panel_dir}/p.tfam")


def test_auto_engine_without_cuda_runs_exact(panel_dir, monkeypatch,
                                             capsys):
    """The default --tpu-engine auto means the fast engine: without a
    CUDA device it no longer runs the exact engine by itself but exits 1
    with one stderr line that names --tpu-engine exact, which the same
    run then takes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _run(port_main, panel_dir, _base(panel_dir) + [
        "--out", "auto"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1
    assert "--tpu-engine exact" in err[0] and "--tpu-engine auto" in err[0]
    assert not os.path.exists(f"{panel_dir}/auto.log")
    assert _run(port_main, panel_dir, _base(panel_dir) + [
        "--tpu-engine", "exact", "--out", "auto"]) == 0


# --weighted, --cm and --phased run now: tests/test_torch_wlod.py holds
# them to garlic_tpu's runs, with a real map and TGLS file.  The last
# configuration this test saw refused, a --tpu-mesh over several
# devices, runs too (tests/test_torch_mesh.py holds every configuration
# to garlic_tpu's mesh runs): here 2x1 over two CPU devices gives the
# outputs of one device and of garlic_tpu's 2x1 mesh.
@pytest.mark.parametrize("extra,names", [
    (["--tpu-mesh", "2x1"], "--tpu-mesh"),
])
def test_unported_configuration_exits_1(panel_dir, capsys, extra, names):
    wd, base = panel_dir, _base(panel_dir) + ["--tpu-engine", "fast"]
    assert _run(port_main, wd, base + ["--out", "dev1"], device="cpu") == 0
    before = dict(cuda_lod.LAUNCHES)
    assert _run(port_main, wd, base + extra + ["--out", "m21"],
                device=["cpu", "cpu"]) == 0
    assert "not yet ported" not in capsys.readouterr().err, names
    assert cuda_lod.LAUNCHES == before  # CPU tensors: plain versions
    assert _run(jax_main, wd, base + extra + ["--out", "jm21"]) == 0
    _same_outputs(wd, "m21", "dev1")
    _same_outputs(wd, "m21", "jm21")


def test_multihost_env_is_refused_and_streaming_runs(panel_dir,
                                                     monkeypatch, capsys):
    # multi-process runs are ported (tests/test_torch_multihost.py); an
    # incomplete set of the variables exits 1 with one ERROR line at
    # once, never waiting on a process group that cannot form
    monkeypatch.setenv("GARLIC_TPU_NUM_PROCS", "2")
    assert _run(port_main, panel_dir, _base(panel_dir) + [
        "--out", "mh"], device="cpu") == 1
    err = capsys.readouterr().err
    assert err.startswith("ERROR: ") and "GARLIC_TPU_COORD" in err
    assert len(err.strip().splitlines()) == 1
    monkeypatch.delenv("GARLIC_TPU_NUM_PROCS")
    # split-path window matrices above half the device budget stream one
    # chromosome at a time, as the JAX package's do (tests/
    # test_torch_stream.py holds them to garlic_tpu's runs)
    monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", "1000")
    assert _run(port_main, panel_dir, _base(panel_dir) + [
        "--raw-lod", "--tpu-engine", "fast", "--out", "st"],
        device="cpu") == 0
    assert "streaming per chromosome" in capsys.readouterr().err
    # and so does the fused path, on K2
    assert _run(port_main, panel_dir, _base(panel_dir) + [
        "--tpu-engine", "fast", "--out", "st2"], device="cpu") == 0
    assert read_text(f"{panel_dir}/st2.roh.bed") == \
        read_text(f"{panel_dir}/st.roh.bed")


# as in garlic_tpu/pipeline.py:382-393: --freq-only returns before the
# mesh is resolved, the exact engine ignores it, `auto` over one device
# (the port on the CPU counts one) is single-device, and a malformed spec
# exits -1 with the ERROR line in .error
@pytest.mark.parametrize("tag,extra,rc", [
    ("auto", ["--tpu-mesh", "auto", "--tpu-engine", "fast"], 0),
    ("exact_2x1", ["--tpu-mesh", "2x1", "--tpu-engine", "exact"], 0),
    ("freq_only_2x1", ["--tpu-mesh", "2x1", "--freq-only"], 0),
    ("malformed", ["--tpu-mesh", "4x", "--tpu-engine", "fast"], -1),
])
def test_mesh_spec_matches_garlic_tpu(panel_dir, monkeypatch, tag, extra,
                                      rc):
    wd = panel_dir
    monkeypatch.setenv("GARLIC_TPU_FUSED_INTERPRET", "1")
    assert _run(jax_main, wd, _base(wd) + extra + ["--out", f"mj{tag}"]) == rc
    assert _run(port_main, wd, _base(wd) + extra + ["--out", f"mp{tag}"],
                device="cpu") == rc
    assert read_text(f"{wd}/mp{tag}.error") == read_text(f"{wd}/mj{tag}.error")
    if rc == 0 and "--freq-only" not in extra:
        _same_outputs(wd, f"mp{tag}", f"mj{tag}")
    else:
        assert diff_logs(read_text(f"{wd}/mj{tag}.log"),
                         read_text(f"{wd}/mp{tag}.log"), f"mj{tag}",
                         f"mp{tag}") == []
        assert not os.path.exists(f"{wd}/mp{tag}.roh.bed")
    if "--freq-only" in extra:
        assert read_text(f"{wd}/mp{tag}.freq.gz") == \
            read_text(f"{wd}/mj{tag}.freq.gz")
    if rc == -1:
        assert "ERROR: bad --tpu-mesh spec '4x'" in \
            read_text(f"{wd}/mp{tag}.error")


def test_mesh_larger_than_the_devices_exits_minus_1(panel_dir, capsys):
    """make_mesh's refusal (garlic_tpu/parallel/mesh.py:56-57): on the CPU
    the port counts one device."""
    rc = _run(port_main, panel_dir, _base(panel_dir) + [
        "--tpu-mesh", "2x1", "--tpu-engine", "fast", "--out", "big"],
        device="cpu")
    assert rc == -1
    assert "ERROR: mesh 2x1 exceeds 1 devices" in capsys.readouterr().err
    assert "ERROR: mesh 2x1 exceeds 1 devices" in \
        read_text(f"{panel_dir}/big.error")


@pytest.mark.gpu
def test_pinned_run_on_card_matches_exact(panel_dir):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    wd, base = panel_dir, _base(panel_dir)
    before = cuda_lod.LAUNCHES["covered"]
    assert _run(port_main, wd, base + ["--tpu-engine", "fast",
                                       "--out", "gpu"]) == 0
    assert cuda_lod.LAUNCHES["covered"] == before + 2
    assert _run(port_main, wd, base + ["--tpu-engine", "exact",
                                       "--out", "gpux"]) == 0
    _same_outputs(wd, "gpu", "gpux")


# ---------------------------------------------------------------------------
# The 2-bit codes' column compaction on the device (cuda_lod.packed_device)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mono_dir(tmp_path_factory):
    """A panel with monomorphic loci on both chromosomes (the first and
    last locus, a run, scattered ones) and its warm sidecar: its filtered
    chromosomes' compaction is deferred on every warm load."""
    wd = tmp_path_factory.mktemp("mono_panel")
    panel = make_panel(nind=35, nloci_per_chr=(5000, 4000), seed=29,
                       big_gap_every=700)
    rng = np.random.default_rng(5)
    for g in panel.genotypes:
        L = g.shape[1]
        cols = np.r_[0, L - 1, 1200:1209, rng.choice(L, L // 50)]
        g[:, cols] = 2
    write_tped(panel, str(wd / "m.tped.gz"), str(wd / "m.tfam"))
    assert _run(port_main, str(wd), _mono_args(str(wd), PINNED) + [
        "--tpu-engine", "fast", "--out", "cold"], device="cpu") == 0
    assert os.path.exists(f"{wd}/m.tped.gz.gtpc")
    return str(wd)


def _mono_args(wd, flags):
    return ["--tped", f"{wd}/m.tped.gz", "--tfam", f"{wd}/m.tfam",
            "--build", "hg18", "--tpu-panel-cache"] + flags


def _tie_flags(wd):
    """PINNED with the cutoff on an exact f64 window of chromosome 1 (its
    median live window): inside the tie band, so the patrol flips its
    row (the multi-process test's _tie_cutoff)."""
    from garlic_tpu_torch.centromeres import Centromere
    from garlic_tpu_torch.io import filters, tped
    from garlic_tpu_torch.logger import RunLog
    from garlic_tpu_torch.ops import lod
    ds, _ = tped.load_tped(f"{wd}/m.tped.gz")
    ds.chroms, _ = filters.filter_monomorphic(ds.chroms)
    w = lod.calc_lod_windows(ds.chroms[0], Centromere("hg18", "none", "none",
                                                      RunLog()),
                             40, 0.001, 200000, False)
    live = w[(w != -9999) & (w > 0)]
    flags = list(PINNED)
    flags[flags.index("--lod-cutoff") + 1] = repr(
        float(np.sort(live)[live.size // 2]))
    return flags


def _profiled(wd, args, out):
    """A fast warm call under --tpu-profile: its [profile] counters."""
    import contextlib
    import io
    import json
    import re
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = _run(port_main, wd, args + ["--tpu-engine", "fast",
                                         "--tpu-profile", "--out", out],
                  device="cpu")
    assert rc == 0, err.getvalue()
    (c,) = [json.loads(m) for m in re.findall(
        r"^\[profile\] counters (\{.*\})$", err.getvalue(), flags=re.M)]
    return c


# pinned: Phase I compacts on the device; tie: the patrol flips a row and
# decodes the suspects and that row from the parent payload; auto: the
# automatic cutoff's pool (20 rows, pooled again every call) compacts on
# the device, and Phase III's K2 compacts there again; auto-replay: the
# pool cache replays the whole panel's pool, so Phase III's K2 compacts
# on the device
@pytest.mark.parametrize("case,pack", [
    ("pinned", {"device": 2, "host": 0}),
    ("tie", {"device": 2, "host": 0}),
    ("auto", {"device": 4, "host": 0}),
    ("auto-replay", {"device": 2, "host": 0}),
])
def test_device_compaction_gives_the_host_routes_bed(mono_dir, monkeypatch,
                                                     case, pack):
    """A warm sidecar call whose chromosomes' compaction is deferred: the
    route the call takes is the counters' (pack.device, one a chromosome
    on the 1x1 mesh and again for the automatic pool's; pack.host, one a
    fired compaction), and its BED is
    the host route's (the compaction forced onto the host) and the exact
    engine's, byte for byte."""
    wd = mono_dir
    flags = {"pinned": PINNED, "tie": _tie_flags(wd),
             "auto": ["--winsize", "40", "--error", "0.001",
                      "--kde-subsample", "20", "--tpu-seed", "3",
                      "--size-bounds", "300000", "800000"],
             "auto-replay": ["--winsize", "40", "--error", "0.001",
                             "--kde-subsample", "0", "--size-bounds",
                             "300000", "800000"]}[case]
    args = _mono_args(wd, flags)
    if case == "auto-replay":  # the pool cache's first call pools
        _profiled(wd, args, f"{case}_prime")
    c = _profiled(wd, args, f"{case}_dev")
    assert c["pack"] == pack
    if case == "tie":
        assert c["patrol"]["flip_rows"] > 0
    if case == "auto-replay":
        assert c["pool"] == {"pooled": 0, "replayed": 1, "device": 0,
                             "host": 0}
    with monkeypatch.context() as m:
        m.setattr(cuda_lod, "deferred", lambda chrom: False)
        host = _profiled(wd, args, f"{case}_host")
    assert host["pack"] == {"device": 0, "host": 2}
    assert _run(port_main, wd, args + ["--tpu-engine", "exact",
                                       "--out", f"{case}_x"]) == 0
    bed = read_text(f"{wd}/{case}_x.roh.bed")
    assert bed.count("\nchr") >= 5
    for out in ("dev", "host"):
        assert read_text(f"{wd}/{case}_{out}.roh.bed") == bed
