"""The port's multi-process weighted runs (--weighted, --phased, --cm,
the weighted --winsize-multi explore) on the CPU, held to garlic_tpu's
single-process exact runs as tests/test_torch_multihost.py holds the
unweighted ones (its helpers and tolerances; a file of its own so that
the two run on two workers).

Per-process rows reach the LD band through int32 pair counts summed
over the processes (parallel.engine.ld_band_sharded), the tie patrol
through the exact pair counts summed the same way
(pipeline._wpair_band) and each process's own suspect rows
(_owned_row_patrol), and Phase II through the exact weighted sampler's
rows gathered in rank order.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_multihost import (  # noqa: E402
    FAST, _files, _load_stats, _outs, cluster, garlic, same_as, single)
from util import (make_panel, read_text, write_map_scaffold,  # noqa: E402
                  write_tped)

WEIGHTED = ["--build", "hg18", "--map", "p.map.gz", "--weighted",
            "--winsize", "30", "--error", "0.002", "--kde-subsample", "0",
            "--size-bounds", "300000", "800000"]


@pytest.fixture(scope="module")
def wpanel(tmp_path_factory):
    """24 x (3000, 2000) with a genetic-map scaffold (the panel of
    tests/test_multihost.py's weighted cases)."""
    wd = tmp_path_factory.mktemp("port_multihost_weighted")
    p = make_panel(nind=24, nloci_per_chr=(3000, 2000), seed=71)
    write_tped(p, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_map_scaffold(p, str(wd / "p.map.gz"))
    return str(wd)


def test_weighted_sharded_auto_cutoff(wpanel):
    """--weighted over 4x2 on two processes, automatic cutoff: each
    process holds half the rows and half the genotype bytes, and the
    outputs are garlic_tpu's; the .kde file is the port's one-process
    4x2 run's byte for byte."""
    wd = wpanel
    argv = _files("p") + WEIGHTED
    stats = {"GT_LOAD_STATS": "1"}
    run = argv + FAST + ["--tpu-mesh", "4x2"]
    outs = cluster(wd, run + ["--out", "MH_w"], env=stats,
                   also=[(run + ["--out", "MH_w1"], 8)])
    err1 = single(wd, argv + FAST + ["--out", "MH_wdev"], 1, env=stats)
    garlic(wd, argv, "REF_w")
    rows1, bytes1 = _load_stats(err1)
    for rank, (_, _, err) in enumerate(outs):
        assert f"sharded input: process {rank} holds individuals" in err
        rows, nbytes = _load_stats(err)
        assert rows == rows1 // 2 and nbytes <= bytes1 // 2 + 1024
    assert read_text(f"{wd}/REF_w.roh.bed").count("\nchr") >= 5
    same_as(wd, "MH_w", "REF_w", kde=30)
    for o in _outs("MH_w", 2):
        assert read_text(f"{wd}/{o}.30SNPs.kde") == \
            read_text(f"{wd}/MH_w1.30SNPs.kde")


@pytest.mark.parametrize("name,extra,spec,ndev", [
    # a real --ld-subsample: global indices meet each process's rows
    ("phased", ["--phased", "--ld-subsample", "10", "--tpu-seed", "3",
                "--lod-cutoff", "0.1"], "4x2", 4),
    # sp across the processes: the pair band's right halo is made from
    # the summed counts on the process that needs it, and the coverage
    # program's left windows are gathered
    ("sp", ["--lod-cutoff", "0.1"], "1x2", 1),
])
def test_weighted_pinned(wpanel, name, extra, spec, ndev):
    wd = wpanel
    argv = _files("p") + WEIGHTED + extra
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", spec, "--out",
                                      f"MH_{name}"], ndev=ndev)
    assert ("sharded input" in outs[0][2]) == (spec != "1x2")
    garlic(wd, argv, f"REF_{name}")
    assert read_text(f"{wd}/REF_{name}.roh.bed").count("\nchr") >= 5
    same_as(wd, f"MH_{name}", f"REF_{name}")


def test_cm_sharded(wpanel):
    """--cm: the scaffold filter and the interpolation are per locus, so
    per-process rows compose; the cM BED is garlic_tpu's."""
    wd = wpanel
    argv = _files("p") + ["--build", "hg18", "--map", "p.map.gz", "--cm",
                          "--winsize", "40", "--error", "0.001",
                          "--kde-subsample", "0", "--lod-cutoff", "1.2",
                          "--size-bounds", "0.3", "0.8"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "4x2", "--out", "MH_cm"])
    for rank, (_, _, err) in enumerate(outs):
        assert f"sharded input: process {rank} holds individuals" in err
    garlic(wd, argv, "REF_cm")
    same_as(wd, "MH_cm", "REF_cm")


def test_weighted_explore_sharded(wpanel):
    """The weighted --winsize-multi explore over row-sharded input (8x1):
    each candidate's sampler pools the global --kde-subsample rows each
    process holds, in rank order; every .kde x column and the .log are
    garlic_tpu's."""
    wd = wpanel
    argv = _files("p") + ["--build", "hg18", "--map", "p.map.gz",
                          "--weighted", "--ld-subsample", "0",
                          "--winsize-multi", "25", "35", "--winsize", "25",
                          "--error", "0.002", "--kde-subsample", "8",
                          "--tpu-seed", "5"]
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "8x1", "--out", "MH_ex"])
    assert "sharded input: process 1 holds individuals" in outs[1][2]
    garlic(wd, argv, "REF_ex")
    for w in (25, 35):
        same_as(wd, "MH_ex", "REF_ex", kde=w, bed=False)


def test_three_process_weighted(tmp_path):
    """25 individuals over 3x4 on three processes (rows 9/9/7): the
    summed pair counts, the owned-row patrol and the rank-ordered
    weighted sampler with unequal shares; every process's outputs are
    garlic_tpu's."""
    wd = str(tmp_path)
    p = make_panel(nind=25, nloci_per_chr=(4000,), seed=41)
    write_tped(p, f"{wd}/p.tped.gz", f"{wd}/p.tfam")
    write_map_scaffold(p, f"{wd}/p.map.gz")
    argv = _files("p") + WEIGHTED
    outs = cluster(wd, argv + FAST + ["--tpu-mesh", "3x4", "--out", "MH_w3"],
                   nproc=3)
    assert "[18, 25) of 25" in outs[2][2]
    garlic(wd, argv, "REF_w3")
    same_as(wd, "MH_w3", "REF_w3", nproc=3, kde=30)
