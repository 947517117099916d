"""A configuration's side inputs, its own reference and the kept
counters, on the CPU at tiny sizes:
  (a) the argv of each cell's calls and its reference's flags, as the
      timed path builds them, equal the lists the harness built before
      the side inputs existed (no cell's calls change);
  (b) the genetic-map writer's file reads back through the program's
      loader and places every generated locus;
  (c) a weighted configuration with a generated --map and a reference of
      its own runs through run_cell, the map reaching the program and
      the reference alike;
  (d) with the default reference it fails in set-up, before any call;
  (e) a traced call keeps its `[profile] counters` line."""

import json
import os
import time

import numpy as np
import pytest

from roh_bench import harness, panel, reference
from roh_bench.inputs import genetic_map
from roh_bench.metrics.counters import counter_mean
from roh_bench.tests import stub_reference
from roh_bench.tests.conftest import small_config

SEED = 2 ** 33 + 5  # --tpu-seed 9
WGS = ["--build", "hg19", "--winsize", "60", "--error", "0.001",
       "--lod-cutoff", "1.5", "--size-bounds", "500000", "1000000"]
EXAMPLE = ["--build", "hg18", "--winsize", "60", "--error", "0.001",
           "--nclust", "3", "--kde-subsample", "20"]
ENGINE = ["--tpu-engine", "fast", "--tpu-seed", "9"]
# each cell's flags after the files, its TPED's name and its panels, as
# the harness built them before the side inputs
CELLS = {
    "wgs-pinned-warm": ("kgp3-wgs", WGS + ["--tpu-panel-cache"] + ENGINE,
                        "tped", 1, 2),
    "example-auto-warm": ("garlic-example",
                          EXAMPLE + ["--tpu-panel-cache"] + ENGINE,
                          "tped.gz", 1, 2),
    "example-auto-cold": ("garlic-example", EXAMPLE + ENGINE, "tped.gz",
                          4, 1)}
MAP = {"flag": "--map", "writer": "genetic_map", "rate_cm_per_mb": 1.2,
       "points": 200}


def bench():
    with open(f"{harness.ROOT}/BENCHMARK.json") as f:
        return json.load(f)


def weighted_config(**kw) -> dict:
    cfg = small_config("kgp3-wgs", (6000, 4000), nind=24)
    cfg["flags"] = cfg["flags"] + ["--weighted"]
    cfg["inputs"] = [MAP]
    cfg.update(kw)
    return cfg


class Recorder:
    """Wraps Caller.__call__: each call's argv, exit code, stderr and
    .log (read before the window deletes it); fake=True answers every
    call at once without running the program."""

    def __init__(self, monkeypatch, fake=False):
        self.calls = []
        orig = harness.Caller.__call__

        def call(caller, argv, traced=False):
            if fake:
                time.sleep(0.01)
                rc, wall, err = 0, 0.01, ""
            else:
                rc, wall, err = orig(caller, argv, traced)
            out = argv[argv.index("--out") + 1]
            log = None
            if os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    log = f.read()
            self.calls.append((list(argv), rc, err, log))
            return rc, wall, err
        monkeypatch.setattr(harness.Caller, "__call__", call)


def workdir(monkeypatch) -> list:
    made = []
    orig = harness.tempfile.mkdtemp

    def mkdtemp(**kw):
        made.append(orig(**kw))
        return made[-1]
    monkeypatch.setattr(harness.tempfile, "mkdtemp", mkdtemp)
    return made


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_argv_as_before(monkeypatch, cell):
    name, flags, tped, npan, setup = CELLS[cell]
    rec = Recorder(monkeypatch, fake=True)
    work = workdir(monkeypatch)
    refs = []
    monkeypatch.setattr(reference, "call",
                        lambda pan, argv, dt=np.float64:
                        refs.append(list(argv)) or reference.Call(bed=[]))
    cfg = small_config(name, (2000, 1500, 1000)[:2 if npan == 1 else 3])
    harness.run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                     cfg=cfg, bench=bench())
    w = work[0]
    ntimed = len(rec.calls) - setup
    assert ntimed >= 5
    # set-up call k and window call k both take panel k % npan
    calls = [(k, f"setup{k}") for k in range(setup)] + [
        (k, f"c{k}") for k in range(ntimed)]
    want = [["--tped", f"{w}/panel{k % npan}.{tped}",
             "--tfam", f"{w}/panel{k % npan}.tfam", "--out", f"{w}/{out}"]
            + flags for k, out in calls]
    assert [a for a, *_ in rec.calls] == want
    assert refs == [flags] * npan


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_flags_pass_the_reference(cell):
    wl = harness.load("workloads", cell)
    cfg = harness.load("configs", wl["config"])
    flags = harness.call_flags(cfg, harness.load("traffic", wl["traffic"]),
                               SEED, harness.panel_inputs(None, cfg, "", 0))
    assert harness.reference_for(cfg) is reference
    assert reference.parse(flags).winsize == 60


@pytest.mark.parametrize("flag", [
    ["--weighted"], ["--phased"], ["--cm"], ["--map", "m.gz"],
    ["--tgls", "x.tgls"], ["--freq-file", "f.gz"], ["--auto-winsize"],
    ["--winsize-multi", "3"], ["--raw-lod"], ["--M", "7"],
    ["--tped-missing", "N"], ["--centromere", "c.txt"]])
def test_reference_refuses_what_it_does_not_implement(flag):
    with pytest.raises(ValueError, match=flag[0]):
        reference.parse(WGS + flag + ENGINE)


def test_reference_lets_engine_flags_pass():
    fl = reference.parse(WGS + ["--threads", "4", "--out", "x",
                                "--tpu-mesh", "1x1", "--tpu-profile"]
                         + ENGINE)
    assert fl.lod_cutoff == 1.5 and fl.seed == 9


def test_genetic_map_places_every_locus(tmp_path):
    from garlic_tpu_torch.centromeres import Centromere
    from garlic_tpu_torch.io import genmap
    cfg = small_config("kgp3-wgs", (40000, 30000))
    pan = panel.make_panel(cfg, 3)
    path = str(tmp_path / "panel0.genetic_map")
    genetic_map.write(pan, cfg, MAP, path)
    scaffolds = genmap.load_map_scaffold(path, Centromere(cfg["build"]))
    assert [s.chrom for s in scaffolds] == ["chr1", "chr2"]
    for s, pos, length in zip(scaffolds, pan.positions,
                              cfg["chrom_lengths"]):
        assert len(s.positions) == 200
        assert s.positions[0] == 1 and s.positions[-1] == length
        gpos, _ = genmap.interpolate_genetic_map(pos, s)
        assert np.all(np.diff(gpos) >= 0)
        np.testing.assert_allclose(gpos, 1.2 * pos / 1e6, rtol=1e-12)


def test_side_input_and_own_reference_through_run_cell(monkeypatch):
    rec = Recorder(monkeypatch)
    stub_reference.SEEN.clear()
    cfg = weighted_config(reference="tests.stub_reference")
    res = harness.run_cell("wgs-pinned-warm", SEED, 1.0, False, "cpu",
                           time.perf_counter(), cfg=cfg, bench=bench())
    assert rec.calls and all(rc == 0 for _, rc, _, _ in rec.calls)
    maps = {a[a.index("--map") + 1] for a, *_ in rec.calls}
    assert len(maps) == 1
    (path,) = maps
    assert path.endswith("/panel0.genetic_map")
    assert all(f"Map file: {path}\n" in log for *_, log in rec.calls)
    assert all("Weighted LOD: TRUE\n" in log for *_, log in rec.calls)
    (seen,) = stub_reference.SEEN
    assert seen[seen.index("--map") + 1] == path
    assert seen == rec.calls[0][0][6:]  # the program's flags, after --out
    assert res["correct"] and res["failed"] == 0, res["checks"]


def test_unjudgeable_config_fails_in_setup(monkeypatch):
    rec = Recorder(monkeypatch)
    with pytest.raises(ValueError, match="--weighted --map"):
        harness.run_cell("wgs-pinned-warm", SEED, 1.0, False, "cpu",
                         time.perf_counter(), cfg=weighted_config(),
                         bench=bench())
    assert rec.calls == []  # refused before the first set-up call


def test_traced_call_keeps_its_counters(monkeypatch):
    rec = Recorder(monkeypatch)
    windows = []
    orig = harness.Window

    def window(**kw):
        windows.append(orig(**kw))
        return windows[-1]
    monkeypatch.setattr(harness, "Window", window)
    harness.run_cell("wgs-pinned-warm", SEED, 1.0, True, "cpu",
                     time.perf_counter(),
                     cfg=small_config("kgp3-wgs", (20000, 15000)),
                     bench=bench())
    (w,) = windows
    timed = rec.calls[-len(w.calls):]
    for c, (_, _, err, _) in zip(w.calls, timed):
        lines = [ln for ln in err.splitlines()
                 if ln.startswith("[profile] counters ")]
        assert c.counters == json.loads(lines[-1][len("[profile] counters "):])
    assert counter_mean(w, "no.such") is None
    assert counter_mean(w, "launches") is None  # a group, not a number
    assert counter_mean(w, "sidecar.hit") == 1
    assert counter_mean(w, "h2d_bytes") == pytest.approx(
        np.mean([c.counters["h2d_bytes"] for c in w.calls]))
    assert w.flags == WGS + ["--tpu-panel-cache"] + ENGINE
