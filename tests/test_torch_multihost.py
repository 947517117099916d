"""The port's multi-process runs (garlic_tpu_torch/parallel/multihost.py)
on the CPU: 2 (or 3) processes of `run_main(argv, device=["cpu"] * k)`
joined by a gloo process group on 127.0.0.1, as tests/test_multihost.py
runs garlic_tpu's two-process clusters.

Each case is held to garlic_tpu's single-process run on the same files
(its exact engine, in this process, as tests/util.run_ours runs it):
- .roh.bed byte for byte, on process 0 and on every .procN;
- .freq.gz equal, .log equal after line 1 (output names masked);
- .kde x byte for byte and y within 1e-5 * max y (the port's f32 device
  transform against garlic_tpu's f64 host one).
Where a case says so, the outputs are also held to the port's own
one-process run over the same mesh shape (a subprocess with the same
thread settings): the .kde file and the --raw-lod text byte for byte.
The float reductions' bits are checked directly by
test_ordered_reductions_match_one_process.

Every subprocess gets a timeout and every process of a cluster is
killed when one times out, so no case can hang the suite.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from util import (diff_logs, make_panel, read_text, run_ours,  # noqa: E402
                  write_tgls, write_tped)

import torch  # noqa: E402

from garlic_tpu_torch import runtime  # noqa: E402
from garlic_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from garlic_tpu_torch.parallel import multihost  # noqa: E402
from garlic_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds per process
Y_TOL = 1e-5
DRIVER = """\
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from garlic_tpu_torch.pipeline import run_main
sys.exit(run_main(sys.argv[2:], device=["cpu"] * int(sys.argv[1])))
"""
PINNED = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
          "--kde-subsample", "0", "--lod-cutoff", "1.0", "--size-bounds",
          "300000", "800000"]
AUTO = ["--build", "hg18", "--winsize", "50", "--error", "0.001",
        "--kde-subsample", "0"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _driver(wd: str) -> str:
    path = os.path.join(wd, "port_driver.py")
    with open(path, "w") as f:
        f.write(DRIVER.format(repo=REPO))
    return path


def _env(extra=None):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for v in multihost.ENV:
        env.pop(v, None)
    env.update(extra or {})
    return env


def _wait(procs, timeout=TIMEOUT):
    """(returncode, stdout, stderr) of each process; on a timeout every
    process is killed and the test fails."""
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            outs.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"a process ran past {timeout}s")
    return outs


def cluster(wd, argv, nproc=2, ndev=4, env=None, cwds=None, also=(),
            timeout=TIMEOUT, ok=True):
    """The port as an nproc-process run (each process ndev CPU devices,
    in wd or in cwds[rank]); also: (argv, ndev) of one-process runs
    started beside it.  Returns the cluster's [(rc, stdout, stderr)]."""
    driver, port = _driver(wd), _free_port()
    procs = []
    for rank in range(nproc):
        e = _env(env)
        e.update({"GARLIC_TPU_COORD": f"127.0.0.1:{port}",
                  "GARLIC_TPU_NUM_PROCS": str(nproc),
                  "GARLIC_TPU_PROC_ID": str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, driver, str(ndev)] + argv,
            cwd=wd if cwds is None else cwds[rank], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for a, k in also:
        procs.append(subprocess.Popen(
            [sys.executable, driver, str(k)] + a, cwd=wd, env=_env(env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = _wait(procs, timeout)
    if ok:
        for rc, _, err in outs:
            assert rc == 0, f"exit {rc}:\n{err[-3000:]}"
    return outs[:nproc]


def single(wd, argv, ndev, env=None):
    """The port as one process (no GARLIC_TPU_* variables)."""
    (rc, _, err), = _wait([subprocess.Popen(
        [sys.executable, _driver(wd), str(ndev)] + argv, cwd=wd,
        env=_env(env), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)])
    assert rc == 0, err[-3000:]
    return err


def garlic(wd, argv, out):
    """garlic_tpu's single-process exact run of argv (no --tpu-mesh)."""
    assert run_ours(wd, argv + ["--tpu-engine", "exact", "--out", out]) == 0


def _outs(out, nproc):
    return [out] + [f"{out}.proc{r}" for r in range(1, nproc)]


def same_as(wd, out, ref, nproc=2, kde=None, bed=True):
    """Every process's outputs of run `out` against run `ref`: BED bytes
    (bed: the run writes one), .freq.gz, .log after line 1; kde: the
    .kde file's winsize, x bytes and y within Y_TOL * max y."""
    for o in _outs(out, nproc):
        if bed:
            assert read_text(f"{wd}/{o}.roh.bed") == \
                read_text(f"{wd}/{ref}.roh.bed"), o
        assert read_text(f"{wd}/{o}.freq.gz") == \
            read_text(f"{wd}/{ref}.freq.gz"), o
        assert diff_logs(read_text(f"{wd}/{ref}.log"),
                         read_text(f"{wd}/{o}.log"), ref, o) == [], o
        if kde is not None:
            xa, ya = _kde(wd, f"{o}.{kde}SNPs.kde")
            xb, yb = _kde(wd, f"{ref}.{kde}SNPs.kde")
            assert xa == xb, o
            assert np.abs(ya - yb).max() <= Y_TOL * yb.max(), o


def _kde(wd, name):
    text = read_text(f"{wd}/{name}")
    return ([ln.split()[0] for ln in text.splitlines()],
            np.array([float(ln.split()[1]) for ln in text.splitlines()]))


def _load_stats(err):
    m = re.search(r"load-stats: rows=(\d+) geno_bytes=(\d+)", err)
    assert m, err[-2000:]
    return int(m.group(1)), int(m.group(2))


def _bed_rows(wd, out):
    return read_text(f"{wd}/{out}.roh.bed").count("\nchr")


@pytest.fixture(scope="module")
def panels(tmp_path_factory):
    """p: 24 x (3000, 2000), 5% missing, ROH planted at 1.5 times
    make_panel's rate (10 calls pinned), with a GQ TGLS file (pinned
    runs); a: 40 x (8000, 6000) (automatic runs, whose KDE and GMM need
    the larger panel)."""
    wd = tmp_path_factory.mktemp("port_multihost")
    p = make_panel(nind=24, nloci_per_chr=(3000, 2000), seed=61,
                   missing_rate=0.05, roh_rate=1.5)
    write_tped(p, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(p, str(wd / "p.gq.tgls.gz"), "GQ")
    a = make_panel(nind=40, nloci_per_chr=(8000, 6000), seed=67)
    write_tped(a, str(wd / "a.tped.gz"), str(wd / "a.tfam"))
    return str(wd)


def _files(name):
    return ["--tped", f"{name}.tped.gz", "--tfam", f"{name}.tfam"]


FAST = ["--tpu-engine", "fast"]


# ---------------------------------------------------------------------------
# parallel/multihost.py
# ---------------------------------------------------------------------------

def _mesh(n_dp, n_sp, counts, rank):
    """make_mesh over `counts` devices per process, seen from process
    `rank` (the counts given, so it makes no exchange): the cells laid
    process-major, another process's cells without a device."""
    mesh = make_mesh(n_dp, n_sp, ["cpu"] * counts[rank],
                     multihost.Group(rank, len(counts)), counts)
    placed = [r for r, c in enumerate(counts) for _ in range(c)]
    placed = placed[:n_dp * n_sp]
    assert mesh.owner.reshape(-1).tolist() == placed
    assert [d is not None for d in mesh.devices.reshape(-1)] == \
        [r == rank for r in placed]
    return mesh


@pytest.mark.parametrize("n_dp,n_sp,counts,aligned", [
    (2, 4, (4, 4), True), (4, 2, (4, 4), True), (8, 1, (4, 4), True),
    (3, 4, (4, 4, 4), True), (1, 2, (1, 1), False), (2, 2, (4, 4), False),
    (2, 1, (1, 1), True), (4, 2, (4, 2, 2), False), (1, 8, (4, 4), False)])
def test_host_individual_range_and_dp_layout_aligned(n_dp, n_sp, counts,
                                                     aligned):
    """dp_layout_aligned is garlic_tpu's condition (every process the
    same count d, d % sp == 0, dp % P == 0, dp * sp == d * P); on an
    aligned layout each process's range is its dp rows' slots, which
    is garlic_tpu/pipeline.py:419-429's range, and the ranges tile the
    panel in rank order."""
    P = len(counts)
    for nind in (24, 25, 7):
        ranges = []
        for rank in range(P):
            mesh = _mesh(n_dp, n_sp, counts, rank)
            assert multihost.dp_layout_aligned(mesh) == aligned
            ranges.append(multihost.host_individual_range(nind, mesh))
        if aligned:
            per = -(-nind // n_dp) * n_dp // P
            assert ranges == [(min(r * per, nind), min(r * per + per, nind))
                              for r in range(P)]


def test_incomplete_variables_fail_with_one_error_line(monkeypatch):
    for v in multihost.ENV:
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize_from_env().size == 1
    monkeypatch.setenv("GARLIC_TPU_NUM_PROCS", "2")
    with pytest.raises(ValueError, match=r"^ERROR: .*GARLIC_TPU_COORD"):
        multihost.initialize_from_env()
    monkeypatch.setenv("GARLIC_TPU_COORD", "127.0.0.1:1")
    monkeypatch.setenv("GARLIC_TPU_PROC_ID", "2")
    with pytest.raises(ValueError, match="^ERROR: .*not a process"):
        multihost.initialize_from_env()


# ---------------------------------------------------------------------------
# Processes that share a card split its budget (parallel/mesh.py)
# ---------------------------------------------------------------------------

class _Peers(multihost.Group):
    """Process 0 of a group whose other processes' survey rows are given
    (no process group): allgather answers with them."""

    def __init__(self, rows):
        super().__init__(0, len(rows) + 1)
        self.rows = rows

    def allgather(self, arr, tag):
        return np.stack([arr] + self.rows)


def _row(ndev, cards):
    """A survey row: the device count, then the cards' identities."""
    row = np.zeros(1 + mesh_mod.MAX_CARDS, dtype=np.int64)
    row[0] = ndev
    row[1:1 + len(cards)] = cards
    return row


@pytest.mark.parametrize("budget", [None, "1000"],
                         ids=["default", "override"])
@pytest.mark.parametrize("local,peers,sharers", [
    (["cpu"], [], 1),
    (["cpu"], [["same"]], 2),
    (["cpu"], [["other"]], 1),
    (["cpu", "cpu"], [["same"]], 2),
    (["cpu"], [["same", "other"], ["other"]], 2),
], ids=["one_process", "two_on_one_card", "two_on_two_cards",
        "repeated_device", "three_processes"])
def test_processes_sharing_a_card_split_its_budget(local, peers, sharers,
                                                   budget, monkeypatch):
    """hbm_budget is one card's bytes (GARLIC_TPU_HBM_BUDGET, or the CPU
    default); the survey counts, for each of this process's devices, the
    processes whose rows name its card ("same": this host's CPU), each
    once however often it lists the device, and the mesh's budget is
    the card's divided by that count: one process per card keeps the
    whole budget."""
    if budget is None:
        monkeypatch.delenv("GARLIC_TPU_HBM_BUDGET", raising=False)
    else:
        monkeypatch.setenv("GARLIC_TPU_HBM_BUDGET", budget)
    whole = float(budget or runtime.DEFAULT_HBM_BUDGET)
    assert runtime.hbm_budget("cpu") == whole
    here = mesh_mod.card_identity("cpu")
    ids = {"same": here, "other": here + 1 or 2}
    group = (_Peers([_row(len(p), [ids[c] for c in p]) for p in peers])
             if peers else multihost.Group())
    counts, shared = mesh_mod.survey_devices(local, group)
    assert counts == [len(local)] + [len(p) for p in peers]
    assert shared == {torch.device("cpu"): sharers}
    mesh = make_mesh(sum(counts), 1, local, group)  # the same survey
    assert mesh.sharers == shared
    assert mesh.budget("cpu") == whole / sharers


@pytest.mark.parametrize("spec", [None, "2x1"], ids=["own_1x1", "2x1"])
def test_two_processes_on_one_card_stream_within_their_share(panels, spec):
    """Two processes on the CPU (one card to the survey), with
    GARLIC_TPU_HBM_BUDGET three times what each process's Phase I holds:
    that fits half of the whole budget but not half of each process's
    share, so both processes stream (each on its own 1x1 mesh over the
    whole panel, or its rows of a 2x1 mesh), their --tpu-profile says
    1/2 of the card's budget, and every output equals the one-process
    run's with the same budget."""
    from garlic_tpu_torch import pipeline
    from garlic_tpu_torch.io import filters, tped
    wd = panels
    ds, _ = tped.load_tped(f"{wd}/p.tped.gz")
    chroms, _ = filters.filter_monomorphic(ds.chroms)
    held = []
    for rank in range(2):
        mesh = (make_mesh(1, 1, ["cpu"]) if spec is None else
                make_mesh(2, 1, ["cpu"], multihost.Group(rank, 2), [1, 1]))
        held += pipeline._device_holdings(chroms, 40, False, True,
                                          mesh).values()
    assert min(held) > 0.75 * max(held)
    env = {"GARLIC_TPU_HBM_BUDGET": str(3 * max(held))}
    argv = _files("p") + PINNED + FAST + ["--tpu-profile"]
    out = f"MH_share_{spec}"
    outs = cluster(wd, argv + ([] if spec is None else ["--tpu-mesh", spec])
                   + ["--out", out], ndev=1, env=env)
    for _, _, err in outs:
        assert "streaming per chromosome" in err
        assert "1/2 of the card's, shared by 2 processes" in err
    err1 = single(wd, argv + ["--out", out + "_one"], 1, env=env)
    assert "1/1 of the card's" in err1
    # alone, a process holds the whole panel: what each process held on
    # its own 1x1 mesh (resident), or both halves of the 2x1 (streamed)
    assert ("streaming" in err1) == (spec is not None)
    same_as(wd, out, out + "_one")


REDUCTIONS = """\
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(2)
from garlic_tpu_torch.parallel import engine, multihost
from garlic_tpu_torch.parallel.mesh import make_mesh
group = multihost.initialize_from_env()
mesh = make_mesh(2, 2, ["cpu"] * (4 // group.size), group)
rng = np.random.default_rng(3)
src = rng.normal(size=5003)
tgt = np.linspace(-4, 4, 512)
y = engine.gauss_transform_sharded(src, tgt, 0.3, mesh)
x = np.concatenate([rng.normal(1e5, 2e4, 700), rng.normal(5e5, 8e4, 500)])
res = engine.fit_gmm_sharded(x, 2, np.full(2, 0.5),
                             np.array([1e5, 4e5]), np.array([1e9, 1e10]),
                             mesh)
geno = rng.integers(-1, 3, size=(9, 301)).astype(np.int8)
geno[geno < 0] = -9
f = engine.allele_freq_sharded(geno, mesh)
np.savez(sys.argv[1] + f".{{group.rank}}.npz", y=y, w=res.weights,
         mu=res.means, var=res.variances, ll=res.loglikelihood,
         it=res.iterations, f=f)
group.close()
"""


def test_ordered_reductions_match_one_process(tmp_path):
    """The Phase-II transform, the Phase-IV EM and the allele-frequency
    counts over a 2x2 mesh: two processes of two devices give every
    process the one-process mesh's values bit for bit (each shard's
    partial gathered, then the same ordered add), and the frequencies
    equal numpy's exact counts divided once."""
    wd = str(tmp_path)
    script = os.path.join(wd, "red.py")
    with open(script, "w") as f:
        f.write(REDUCTIONS.format(repo=REPO))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, script, "one"], cwd=wd,
                              env=_env(), stderr=subprocess.PIPE, text=True)]
    for rank in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, script, "two"], cwd=wd, env=_env({
                "GARLIC_TPU_COORD": f"127.0.0.1:{port}",
                "GARLIC_TPU_NUM_PROCS": "2",
                "GARLIC_TPU_PROC_ID": str(rank)}),
            stderr=subprocess.PIPE, text=True))
    for rc, _, err in _wait(procs):
        assert rc == 0, err[-3000:]
    one = np.load(f"{wd}/one.0.npz")
    for rank in range(2):
        two = np.load(f"{wd}/two.{rank}.npz")
        for k in one.files:
            assert np.array_equal(one[k], two[k]), (rank, k)
    rng = np.random.default_rng(3)
    rng.normal(size=5003)
    rng.normal(1e5, 2e4, 700), rng.normal(5e5, 8e4, 500)
    geno = rng.integers(-1, 3, size=(9, 301)).astype(np.int8)
    geno[geno < 0] = -9
    obs = geno >= 0
    num, den = np.where(obs, geno, 0).sum(0), 2 * obs.sum(0)
    want = np.where(den > 0, num / np.maximum(den, 1), 0.0)
    assert np.array_equal(one["f"], want)


# ---------------------------------------------------------------------------
# Whole runs
# ---------------------------------------------------------------------------

def test_pinned_sharded_input_halves_rows_and_bytes(panels):
    """2x4 over two processes of four devices: each process parses and
    holds only its own 12 rows (GT_LOAD_STATS: rows and genotype bytes
    halve against a one-process run), and every process's outputs are
    garlic_tpu's."""
    wd = panels
    argv = _files("p") + PINNED + FAST
    stats = {"GT_LOAD_STATS": "1"}
    outs = cluster(wd, argv + ["--tpu-mesh", "2x4", "--out", "MH_pin"],
                   env=stats)
    err1 = single(wd, argv + ["--out", "MH_pin1"], 1, env=stats)
    garlic(wd, _files("p") + PINNED, "REF_pin")
    rows1, bytes1 = _load_stats(err1)
    assert rows1 == 24
    for rank, (_, _, err) in enumerate(outs):
        assert (f"sharded input: process {rank} holds individuals "
                f"[{12 * rank}, {12 * rank + 12}) of 24") in err
        rows, nbytes = _load_stats(err)
        assert rows == 12 and nbytes <= bytes1 // 2 + 1024
    assert _bed_rows(wd, "REF_pin") >= 5
    same_as(wd, "MH_pin", "REF_pin")
    same_as(wd, "MH_pin1", "REF_pin", nproc=1)


def test_auto_cutoff_and_bounds(panels):
    """The automatic cutoff (the exact sampler's rows gathered in rank
    order, the transform's partials added in shard order) and bounds
    (the EM's sums gathered each iteration): garlic_tpu's outputs, and
    the .kde file byte for byte the port's one-process 4x2 run's."""
    wd = panels
    argv = _files("a") + AUTO + FAST + ["--tpu-mesh", "4x2"]
    cluster(wd, argv + ["--out", "MH_auto"],
            also=[(argv + ["--out", "MH_auto1"], 8)])
    garlic(wd, _files("a") + AUTO, "REF_auto")
    same_as(wd, "MH_auto", "REF_auto", kde=50)
    for o in _outs("MH_auto", 2):
        assert read_text(f"{wd}/{o}.50SNPs.kde") == \
            read_text(f"{wd}/MH_auto1.50SNPs.kde")


def test_gq_tgls_sharded_input(panels):
    """GQ TGLS with per-process rows: each process reads its own rows of
    the likelihood file too; K4's plain version per owned shard."""
    wd = panels
    tg = ["--tgls", "p.gq.tgls.gz", "--gl-type", "GQ"]
    outs = cluster(wd, _files("p") + tg + PINNED + FAST
                   + ["--tpu-mesh", "2x4", "--out", "MH_gq"])
    garlic(wd, _files("p") + tg + PINNED, "REF_gq")
    assert "sharded input: process 0 holds individuals" in outs[0][2]
    same_as(wd, "MH_gq", "REF_gq")


def _tie_cutoff(wd):
    """A cutoff equal to one exact f64 window of chromosome 1 of panel p
    (its median): the window lies inside the tie band, its f64 value
    within the rolling drift bound of the cutoff, so the patrol flips its
    row and recomputes it (exact_cover)."""
    from garlic_tpu_torch.centromeres import Centromere
    from garlic_tpu_torch.io import filters, tped
    from garlic_tpu_torch.logger import RunLog
    from garlic_tpu_torch.ops import lod
    ds, _ = tped.load_tped(f"{wd}/p.tped.gz")
    ds.chroms, _ = filters.filter_monomorphic(ds.chroms)
    w = lod.calc_lod_windows(ds.chroms[0], Centromere("hg18", "none", "none",
                                                      RunLog()),
                             40, 0.001, 200000, False)
    live = w[(w != -9999) & (w > 0)]
    return repr(float(np.sort(live)[live.size // 2]))


def test_tie_patrol_repairs_each_processs_rows(panels):
    """A cutoff on an exact window value: the suspect row's flip is found
    by the process that holds it, its exact coverage recomputed there and
    gathered (_owned_row_patrol), so every process's BED is garlic_tpu's
    exact engine's."""
    wd = panels
    argv = _files("p") + ["--build", "hg18", "--winsize", "40", "--error",
                          "0.001", "--kde-subsample", "0", "--lod-cutoff",
                          _tie_cutoff(wd), "--size-bounds", "300000",
                          "800000"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "2x4", "--tpu-profile",
                                      "--out", "MH_tie"])
    flips = [json.loads(m)["patrol"]["flip_rows"] for _, _, err in outs
             for m in re.findall(r"^\[profile\] counters (\{.*\})$", err,
                                 flags=re.M)]
    assert len(flips) == 2 and max(flips) > 0
    garlic(wd, argv, "REF_tie")
    same_as(wd, "MH_tie", "REF_tie")


def test_resample_on_the_global_frequencies(panels):
    """--resample 40 with per-process rows: the binomials are drawn on
    the summed global frequencies, after the load, with the common seed:
    the .freq.gz and the BED are garlic_tpu's (whose one process draws
    them inside its load)."""
    wd = panels
    argv = _files("p") + PINNED + ["--resample", "40", "--tpu-seed", "9"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "2x4", "--out",
                                      "MH_res"])
    assert "sharded input: process 1 holds individuals" in outs[1][2]
    garlic(wd, argv, "REF_res")
    same_as(wd, "MH_res", "REF_res")


def test_warm_and_mixed_panel_cache(panels, tmp_path):
    """--tpu-panel-cache: a warm sidecar shared by both processes (rows
    sliced from it, its global frequencies used), and per-process working
    directories where only process 0's is warm: the flag gather sends
    both processes to process 0's global frequencies; outputs are
    garlic_tpu's either way, and no pool cache is written."""
    wds = []
    for rank in range(2):
        d = tmp_path / f"host{rank}"
        d.mkdir()
        for f in ("p.tped.gz", "p.tfam"):
            os.symlink(os.path.join(panels, f), d / f)
        wds.append(str(d))
    argv = _files("p") + PINNED + ["--tpu-panel-cache"]
    garlic(wds[0], _files("p") + PINNED, "REF_ref")
    single(wds[0], argv + FAST + ["--out", "MH_prime"], 1)
    assert os.path.exists(f"{wds[0]}/p.tped.gz.gtpc")
    outs = cluster(wds[0], argv + FAST + ["--tpu-mesh", "4x2", "--out",
                                          "MH_warm"])
    for _, _, err in outs:
        assert "Loaded panel cache" in err
    same_as(wds[0], "MH_warm", "REF_ref")
    outs = cluster(wds[0], argv + FAST + ["--tpu-mesh", "4x2", "--out",
                                          "MH_mixed"], cwds=wds)
    assert "Loaded panel cache" in outs[0][2]
    assert "Loaded panel cache" not in outs[1][2]
    assert read_text(f"{wds[0]}/MH_mixed.roh.bed") == \
        read_text(f"{wds[0]}/REF_ref.roh.bed")
    assert read_text(f"{wds[1]}/MH_mixed.proc1.roh.bed") == \
        read_text(f"{wds[0]}/REF_ref.roh.bed")
    assert not any(".p2pool." in f for d in wds for f in os.listdir(d))


def test_no_seed_processes_agree(panels):
    """Without --tpu-seed, process 0's seed is broadcast: both processes
    draw the same --kde-subsample individuals (the .log lines) and call
    the same ROH."""
    wd = panels
    cluster(wd, _files("a") + ["--build", "hg18", "--winsize", "50",
                               "--error", "0.001", "--kde-subsample", "20"]
            + FAST + ["--tpu-mesh", "4x2", "--out", "MH_ns"])
    assert read_text(f"{wd}/MH_ns.roh.bed") == \
        read_text(f"{wd}/MH_ns.proc1.roh.bed")
    pick = [ln for ln in read_text(f"{wd}/MH_ns.log").splitlines()
            if "Individuals used for KDE" in ln]
    assert pick and pick == [
        ln for ln in read_text(f"{wd}/MH_ns.proc1.log").splitlines()
        if "Individuals used for KDE" in ln]


def test_tiny_panel_does_not_shard(tmp_path):
    """Two individuals over a 4x2 mesh of two processes: process 0's
    share would be the whole panel, so no process shards its input."""
    wd = str(tmp_path)
    write_tped(make_panel(nind=2, nloci_per_chr=(2000,), seed=17),
               f"{wd}/t.tped.gz", f"{wd}/t.tfam")
    argv = _files("t") + ["--build", "hg18", "--winsize", "30", "--error",
                          "0.001", "--kde-subsample", "0", "--lod-cutoff",
                          "1.0", "--size-bounds", "300000", "800000"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "4x2", "--out", "MH_tiny"])
    for _, _, err in outs:
        assert "sharded input" not in err
    garlic(wd, argv, "REF_tiny")
    same_as(wd, "MH_tiny", "REF_tiny")


def test_replicated_1x2_raw_lod(panels):
    """1x2 over two processes of one device each is not dp-aligned: both
    processes load the whole panel, each launches its own sp cell, and
    the coverage program takes its left windows from the other process
    (the window halo gather).  --raw-lod gathers every cell's windows:
    the text equals the port's one-process 1x2 run's byte for byte."""
    wd = panels
    argv = _files("p") + PINNED + ["--raw-lod"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "1x2", "--out", "MH_r12"],
                   ndev=1, also=[(argv + FAST + ["--tpu-mesh", "1x2",
                                                 "--out", "MH_r12one"], 2)])
    for _, _, err in outs:
        assert "sharded input" not in err
    garlic(wd, argv, "REF_r12")
    same_as(wd, "MH_r12", "REF_r12")
    for o in _outs("MH_r12", 2):
        for c in ("chr1", "chr2"):
            assert read_text(f"{wd}/{o}.POP1.{c}.raw.lod.windows.gz") == \
                read_text(f"{wd}/MH_r12one.POP1.{c}.raw.lod.windows.gz")


def test_raw_lod_sharded_equals_one_process(panels):
    """--raw-lod with per-process rows: every process writes every row
    (the blocks gathered), byte for byte the port's one-process 2x4
    run's values; the BED is garlic_tpu's."""
    wd = panels
    argv = _files("p") + PINNED + ["--raw-lod"] + FAST + ["--tpu-mesh",
                                                          "2x4"]
    cluster(wd, argv + ["--out", "MH_rs"], also=[(argv + ["--out", "MH_rsone"],
                                                8)])
    garlic(wd, _files("p") + PINNED + ["--raw-lod"], "REF_rs")
    same_as(wd, "MH_rs", "REF_rs")
    for o in _outs("MH_rs", 2):
        for c in ("chr1", "chr2"):
            assert read_text(f"{wd}/{o}.POP1.{c}.raw.lod.windows.gz") == \
                read_text(f"{wd}/MH_rsone.POP1.{c}.raw.lod.windows.gz")


def test_three_processes(tmp_path):
    """25 individuals over 3x4 on three processes (rows 9/9/7): unequal
    shares through the frequency sums, the sampler's gather and the
    patrol; the automatic cutoff's .kde x and every process's BED are
    garlic_tpu's."""
    wd = str(tmp_path)
    write_tped(make_panel(nind=25, nloci_per_chr=(6000,), seed=37,
                          missing_rate=0.05),
               f"{wd}/t.tped.gz", f"{wd}/t.tfam")
    argv = _files("t") + ["--build", "hg18", "--winsize", "40", "--error",
                          "0.001", "--kde-subsample", "0", "--size-bounds",
                          "300000", "800000"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "3x4", "--out", "MH_m3"],
                   nproc=3)
    for rank, (_, _, err) in enumerate(outs):
        assert f"sharded input: process {rank}" in err
    assert "[18, 25) of 25" in outs[2][2]
    garlic(wd, argv, "REF_3")
    same_as(wd, "MH_m3", "REF_3", nproc=3, kde=40)


def test_auto_winsize_sharded(panels):
    """--auto-winsize over row-sharded input (8x1): the search's sampler
    takes the global --kde-subsample rows each process holds; the
    selected window size, the .log and the BED are garlic_tpu's."""
    wd = panels
    argv = _files("p") + ["--build", "hg18", "--auto-winsize", "--winsize",
                          "30", "--auto-winsize-step", "10", "--error",
                          "0.001", "--kde-subsample", "8", "--tpu-seed",
                          "11", "--size-bounds", "300000", "800000"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "8x1", "--out", "MH_aw"])
    assert "sharded input: process 1 holds individuals" in outs[1][2]
    garlic(wd, argv, "REF_aw")
    assert any(ln.startswith("Selected window size")
               for ln in read_text(f"{wd}/REF_aw.log").splitlines())
    same_as(wd, "MH_aw", "REF_aw")


def test_missing_tped_ends_every_process(panels, tmp_path):
    """A TPED missing everywhere: every process exits with garlic_tpu's
    code for the run; missing on process 1 only: process 1 fails its
    load and process 0, waiting in an exchange, fails too."""
    wd = panels
    argv = ["--tped", "nowhere.tped.gz", "--tfam", "p.tfam"] + PINNED
    want = run_ours(wd, argv + ["--tpu-engine", "exact", "--out", "REF_miss"])
    assert want != 0
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "2x4", "--out", "MH_miss"],
                   ok=False, timeout=60)
    assert [rc for rc, _, _ in outs] == [want, want]
    wds = [str(tmp_path / f"h{r}") for r in range(2)]
    for r, d in enumerate(wds):
        os.makedirs(d)
        os.symlink(os.path.join(wd, "p.tfam"), os.path.join(d, "p.tfam"))
    os.symlink(os.path.join(wd, "p.tped.gz"),
               os.path.join(wds[0], "p.tped.gz"))
    outs = cluster(wds[0], _files("p") + PINNED + FAST
                   + ["--tpu-mesh", "2x4", "--out", "MH_half"], cwds=wds,
                   ok=False, timeout=60)
    assert all(rc != 0 for rc, _, _ in outs)
