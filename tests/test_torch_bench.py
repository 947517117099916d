"""The port's benchmark scripts, bench_torch.py and bench_scaling_torch.py,
against bench.py and bench_scaling.py, on the CPU.

bench_torch.py's copied constants and functions equal bench.py's (run
small by patching the module globals of both, as bench.py's own
functions read them); run_ours on the CPU (the kernels' plain versions)
writes garlic_tpu's BED byte for byte; main refuses to run without a
CUDA device and prints bench.py's JSON line.  bench_scaling_torch.py's
windows over ["cpu"] * n equal its one-device windows bit for bit, and
its lines carry bench_scaling.py's keys.

Tolerances:
- K1's plain windows (the kernel diagnostic's function) against
  garlic_tpu's lod_windows_fast_jax, and the port's sharded windows
  against garlic_tpu's make_sharded_lod_fn on conftest's 8-device CPU
  mesh: rtol 1e-5, atol 1e-4 (f32 sums in another order);
- everything else exact: BED bytes, TPED/TFAM text, JSON lines, the
  port's windows across meshes (bit for bit).

The gpu-marked tests run K1 on the card against its plain version and
the scaling harness's meshes on the card; garlic_tpu and JAX are
imported only inside the CPU-side tests.
"""

from __future__ import annotations

import ast
import gzip
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import bench
import bench_scaling_torch as bst
import bench_torch as bt
from garlic_tpu_torch.ops import cuda_lod
from garlic_tpu_torch.parallel.mesh import factor_devices, make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small bench panel (the verify skill's automatic-run panel size)
SMALL_NIND, SMALL_NLOCI = 40, (8000, 6000)
# the scaling harness's small chromosome: ragged over every mesh's axes
SCALE_I, SCALE_L = 13, 2001
RTOL, ATOL = 1e-5, 1e-4


def _small(monkeypatch, mod, cache):
    monkeypatch.setattr(mod, "NIND", SMALL_NIND)
    monkeypatch.setattr(mod, "NLOCI", SMALL_NLOCI)
    monkeypatch.setattr(mod, "CACHE", str(cache))


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    """(bench.py's cache, bench_torch.py's cache): each holds the small
    panel that its script's ensure_panel wrote."""
    dirs = []
    for mod, name in ((bench, "jax_cache"), (bt, "torch_cache")):
        cache = tmp_path_factory.mktemp(name)
        with pytest.MonkeyPatch.context() as mp:
            _small(mp, mod, cache)
            mod.ensure_panel()
        dirs.append(cache)
    return dirs


# ---------------------------------------------------------------------------
# bench_torch.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["NIND", "NLOCI", "WINSIZE", "FLAGS",
                                  "ORACLE", "CACHE"])
def test_constants_equal_benchs(name):
    assert getattr(bt, name) == getattr(bench, name)


@pytest.mark.parametrize("small", [False, True], ids=["default", "small"])
def test_total_windows_equals_benchs(small, monkeypatch, tmp_path):
    if small:
        for mod in (bench, bt):
            _small(monkeypatch, mod, tmp_path)
    want = 40 * (7941 + 5941) if small else 200 * 2 * 499_941
    assert bt.total_windows() == bench.total_windows() == want


def test_ensure_panel_writes_benchs_panel(panels):
    """Both scripts write the same panel under the same names, so they
    share one cache."""
    a, b = panels
    tag = f"{SMALL_NIND}x{sum(SMALL_NLOCI) // 1000}k"
    for name, read in ((f"bench_{tag}.tped.gz", gzip.open),
                       (f"bench_{tag}.tfam", open)):
        with read(a / name, "rb") as f, read(b / name, "rb") as g:
            assert f.read() == g.read(), name
    with pytest.MonkeyPatch.context() as mp:
        _small(mp, bt, b)
        assert bt.ensure_panel() == (str(b / f"bench_{tag}.tped.gz"),
                                     str(b / f"bench_{tag}.tfam"))


def _no_oracle(monkeypatch, tmp_path):
    for mod in (bench, bt):
        _small(monkeypatch, mod, tmp_path)
        monkeypatch.setattr(mod, "ORACLE", str(tmp_path / "no-oracle"))


def test_oracle_baseline_reads_the_shared_cache(monkeypatch, tmp_path):
    _no_oracle(monkeypatch, tmp_path)
    cache = tmp_path / f"oracle_baseline_{SMALL_NIND}x14k.json"
    cache.write_text(json.dumps({"windows_per_sec": 1234.5}))
    assert bt.oracle_baseline("p.tped.gz", "p.tfam") == \
        bench.oracle_baseline("p.tped.gz", "p.tfam") == 1234.5


def test_oracle_baseline_raises_without_binary_or_cache(monkeypatch,
                                                        tmp_path):
    _no_oracle(monkeypatch, tmp_path)
    for mod in (bench, bt):
        with pytest.raises(RuntimeError, match="no cached baseline"):
            mod.oracle_baseline("p.tped.gz", "p.tfam")


def test_run_ours_bed_equals_garlic_tpus(panels, monkeypatch):
    """run_ours on the CPU and bench.py's run_ours (garlic_tpu's fast
    engine, its Pallas kernels in interpret mode) on the same panel and
    arguments write the same BED bytes; each removes its BED, so the
    bytes are read as it does."""
    cache = panels[1]
    for mod in (bench, bt):
        _small(monkeypatch, mod, cache)
    monkeypatch.setenv("GARLIC_TPU_FUSED_INTERPRET", "1")
    beds, remove = {}, os.remove

    def keep(path):
        if str(path).endswith(".roh.bed"):
            with open(path, "rb") as f:
                beds[os.path.basename(path)] = f.read()
        remove(path)

    monkeypatch.setattr(os, "remove", keep)
    tped, tfam = bt.ensure_panel()
    before = dict(cuda_lod.LAUNCHES)
    assert bt.run_ours(tped, tfam, device="cpu") > 0
    assert cuda_lod.LAUNCHES == before  # CPU tensors: the plain versions
    assert bench.run_ours(tped, tfam) > 0
    assert beds["torch_bench.roh.bed"] == beds["ours_bench.roh.bed"]
    assert beds["torch_bench.roh.bed"].count(b"\nchr") >= 5


def test_run_ours_refuses_without_a_card(panels, monkeypatch):
    """The default device is the card: without one the run exits 1 and
    run_ours raises; it never runs on the CPU in the card's place."""
    _small(monkeypatch, bt, panels[1])
    with pytest.raises(RuntimeError, match="pipeline exited 1"):
        bt.run_ours(*bt.ensure_panel())


@pytest.mark.parametrize("written", [b"", None], ids=["empty", "absent"])
def test_run_ours_raises_without_a_bed(written, monkeypatch, tmp_path):
    def run_main(args, prog, device):
        if written is not None:
            (tmp_path / "torch_bench.roh.bed").write_bytes(written)
        return 0

    monkeypatch.setattr(bt, "CACHE", str(tmp_path))
    monkeypatch.setattr(bt, "run_main", run_main)
    with pytest.raises(RuntimeError, match="no BED output"):
        bt.run_ours("p.tped.gz", "p.tfam", device="cpu")


def test_main_without_cuda_prints_no_result(capsys):
    assert bt.main() == 1
    out, err = capsys.readouterr()
    assert out == ""
    assert "no CUDA device" in err


@pytest.mark.parametrize("script", ["bench_torch.py",
                                    "bench_scaling_torch.py"])
def test_script_without_cuda_exits_nonzero(script):
    r = subprocess.run([sys.executable, script], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def _started():
    th = threading.Thread(target=lambda: None)
    th.start()
    return th


@pytest.mark.parametrize("base", [None, 2_345_678.9],
                         ids=["no_baseline", "baseline"])
def test_json_line_equals_benchs(base, monkeypatch, capsys):
    """main's one stdout line, for the same run results and baseline, is
    bench.py's main's, key for key and digit for digit."""
    walls = [1.23456789e8, 4.4e8, 6.60123456e8, 5.5e8, 6.6e8, 3e8, 6.0e8]

    def oracle(tped, tfam):
        if base is None:
            raise RuntimeError("oracle binary unavailable")
        return base

    lines = []
    for mod in (bench, bt):
        runs = iter(walls)
        monkeypatch.setattr(mod, "ensure_panel", lambda: ("p", "f"))
        monkeypatch.setattr(mod, "oracle_baseline", oracle)
        monkeypatch.setattr(mod, "run_ours",
                            lambda *a, runs=runs, **k: next(runs))
        monkeypatch.setattr(mod, "kernel_throughput", lambda *a: 1.0)
    monkeypatch.setattr(bench, "start_warmup_thread", _started)
    monkeypatch.setattr(bt, "start_warmup_thread", lambda: (_started(), []))
    monkeypatch.setattr(bt, "card", lambda: "a card, 700.00 W")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 7)
    bench.main()
    lines.append(capsys.readouterr().out)
    assert bt.main() == 0
    out, err = capsys.readouterr()
    lines.append(out)
    assert lines[1] == lines[0]
    assert list(json.loads(lines[1])) == ["metric", "value", "unit",
                                          "vs_baseline"]
    assert "device-memory peak of the best run 7 bytes" in err
    assert "a card, 700.00 W" in err


def test_kernel_diagnostic_plain_equals_garlic_tpus(monkeypatch):
    """K1's plain version on kernel_throughput's inputs against
    lod_windows_fast_jax on bench.py's (:137-141), trimmed to the valid
    windows."""
    import jax.numpy as jnp

    from garlic_tpu.ops import lod as lod_ops
    monkeypatch.setattr(bt, "NIND", 12)
    monkeypatch.setattr(bt, "NLOCI", (3001, 2000))
    I, L, W = 12, 3001, bt.WINSIZE
    before = dict(cuda_lod.LAUNCHES)
    got = cuda_lod.lod_windows(*bt.kernel_inputs("cpu"), W).numpy()
    assert cuda_lod.LAUNCHES == before
    rng = np.random.default_rng(0)
    geno = rng.integers(0, 3, size=(I, L)).astype(np.int8)
    table = rng.standard_normal((4, L)).astype(np.float32)
    missing = np.zeros(L - W + 1, dtype=bool)
    want = np.asarray(lod_ops.lod_windows_fast_jax(
        jnp.asarray(geno), jnp.asarray(table), jnp.asarray(missing), W))
    assert got.shape == (I, L - W + 1)
    np.testing.assert_allclose(got, want[:, :L - W + 1], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# bench_scaling_torch.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chrom():
    return bst.make_chrom(SCALE_I, SCALE_L)


def _port_windows(chrom, devices):
    n_dp, n_sp = factor_devices(len(devices))
    mesh = make_mesh(n_dp, n_sp, devices)
    W = bst.WINSIZE
    parts = bst.shard_inputs(chrom, bst.no_centromere(chrom), mesh, W)
    return bst.stitch([sh for sh, _, _ in parts], bst.step(parts, W),
                      chrom.nind, chrom.nloci - W + 1)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_scaling_windows_equal_one_devices(chrom, n):
    one = _port_windows(chrom, ["cpu"])
    got = _port_windows(chrom, ["cpu"] * n)
    assert np.array_equal(got.view(np.uint32), one.view(np.uint32))


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_scaling_windows_match_garlic_tpus_sharded_step(chrom, n):
    """The port's windows over ["cpu"] * n against garlic_tpu's jitted
    shard_map step on n of conftest's CPU devices, set up as
    bench_scaling.py:56-66 does."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from garlic_tpu.parallel import (AXIS_DP, AXIS_SP, make_mesh as jmesh,
                                     pad_for_mesh)
    from garlic_tpu.parallel.engine import (full_window_missing,
                                            make_sharded_lod_fn)
    I, L, W = SCALE_I, SCALE_L, bst.WINSIZE
    n_dp, n_sp = factor_devices(n)
    mesh = jmesh(n_dp=n_dp, n_sp=n_sp)
    miss = full_window_missing(chrom.positions, W, bst.MAX_GAP,
                               *bst.NO_CENTROMERE)
    geno_p, miss_p, _ = pad_for_mesh(chrom.genotypes, miss, mesh)
    freq_p = np.zeros(geno_p.shape[1], np.float32)
    freq_p[:L] = chrom.freq
    gs = NamedSharding(mesh, P(AXIS_DP, AXIS_SP))
    ls = NamedSharding(mesh, P(AXIS_SP))
    fn = make_sharded_lod_fn(mesh, W, bst.ERROR)
    want = np.asarray(fn(jax.device_put(geno_p, gs),
                         jax.device_put(freq_p, ls),
                         jax.device_put(miss_p, ls)))[:I, :L - W + 1]
    got = _port_windows(chrom, ["cpu"] * n)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _bench_scaling_keys():
    """The keys of the JSON object bench_scaling.py prints, in order."""
    tree = ast.parse(open(os.path.join(REPO, "bench_scaling.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Constant) for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("bench_scaling.py prints no dict")


def test_scaling_lines_carry_bench_scalings_keys(monkeypatch, capsys):
    monkeypatch.setattr(bst, "NIND", SCALE_I)
    monkeypatch.setattr(bst, "NLOCI", SCALE_L)
    monkeypatch.setattr(bst, "REPS", 2)
    assert bst.main(["--cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    keys = _bench_scaling_keys()
    assert keys == ["devices", "mesh", "windows_per_sec", "speedup",
                    "efficiency"]
    assert [line["devices"] for line in lines] == [1, 2, 4, 8]
    for line in lines:
        assert list(line) == keys
        assert line["mesh"] == "%dx%d" % factor_devices(line["devices"])
        assert line["windows_per_sec"] > 0
    assert lines[0]["speedup"] == lines[0]["efficiency"] == 1.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_kernel_diagnostic_on_card_equals_plain():
    """K1 at the diagnostic's full shape (200 x 500,000, W=60) equals its
    plain version bit for bit on the same card tensors."""
    _card()
    inputs = bt.kernel_inputs("cuda")
    before = cuda_lod.LAUNCHES["lod_windows"]
    got = cuda_lod.lod_windows(*inputs, bt.WINSIZE)
    assert cuda_lod.LAUNCHES["lod_windows"] == before + 1
    want = cuda_lod.lod_windows_plain(*inputs, bt.WINSIZE)
    assert got.shape == (bt.NIND, bt.NLOCI[0] - bt.WINSIZE + 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_scaling_windows_equal_across_meshes_on_card():
    """bench_scaling_torch's full chromosome on meshes of 1, 2, 4 and 8
    devices of the card (cuda:0 repeated where there are fewer cards):
    every mesh's windows equal the one-device windows bit for bit, and
    the whole lod_windows_sharded call's equal the step's (measure)."""
    _card()
    c = bst.make_chrom(bst.NIND, bst.NLOCI)
    centro = bst.no_centromere(c)
    one = None
    for n in bst.MESH_SIZES:
        mesh = make_mesh(*factor_devices(n), bst.mesh_devices(n, False))
        _, win, _ = bst.measure(c, centro, mesh, reps=1)
        if one is None:
            one = win
        assert np.array_equal(win.view(np.uint32), one.view(np.uint32)), n
