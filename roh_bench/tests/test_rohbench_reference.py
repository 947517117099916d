"""The NumPy reference against the program's exact engine (the f64 host
engine, byte-identical to GARLIC v1.1.6a) at small sizes on the CPU:
the same BED lines, cutoff and size bounds, under each configuration's
flags."""

import contextlib
import io
import os

import numpy as np
import pytest

from roh_bench import compare, panel, reference
from roh_bench.tests.conftest import small_config


def exact_call(tmp_path, pan, flags):
    from garlic_tpu_torch.pipeline import run_main
    tped, tfam = panel.panel_files(pan, str(tmp_path), "p", True)
    out = os.path.join(str(tmp_path), "x")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = run_main(["--tped", tped, "--tfam", tfam, "--out", out,
                       "--tpu-engine", "exact"] + flags)
    assert rc == 0
    return out


@pytest.mark.parametrize("name,snps,seed", [
    ("garlic-example", (20000, 15000, 10000), 5),
    ("garlic-example", (20000, 15000, 10000), 2 ** 31 + 7),
    ("kgp3-wgs", (40000, 30000), 11)])
def test_reference_equals_exact_engine(tmp_path, name, snps, seed):
    cfg = small_config(name, snps)
    pan = panel.make_panel(cfg, seed)
    flags = cfg["flags"] + ["--tpu-seed", str(seed % 2147483647)]
    ref = reference.call(pan, flags)
    out = exact_call(tmp_path, pan, flags)
    with open(out + ".roh.bed") as f:
        assert f.read().splitlines() == ref.bed
    with open(out + ".log") as f:
        log = f.read()
    assert ref.nroh > 100
    if "--lod-cutoff" in flags:
        assert ref.cutoff is None and ref.bounds is None
    else:
        assert compare.cutoff_off(log, ref) == 0
        assert compare.bounds_off(log, ref) == 0
        assert f"KDE with {ref.kde_points} points." in log


def test_allele_coding_follows_the_first_allele_seen():
    g = np.array([[-9, 0, 1, 2], [0, 0, 2, -9], [2, 1, 2, -9]],
                 dtype=np.int8).T                      # [L=4, I=3]
    codes, freq = reference.coded(g)
    # locus 0: first seen is hom C (ind 1), so C is counted
    assert codes[0].tolist() == [-9, 2, 0] and freq[0] == 0.5
    assert codes[1].tolist() == [2, 2, 1] and freq[1] == 5 / 6
    # a heterozygote seen first counts allele A
    assert codes[2].tolist() == [1, 2, 2] and freq[2] == 5 / 6
    assert codes[3].tolist() == [2, -9, -9] and freq[3] == 1.0


def test_rolling_windows_keep_the_reference_order():
    rng = np.random.default_rng(3)
    t = rng.normal(size=(50, 2))
    miss = np.zeros(41, dtype=bool)
    miss[[5, 20, 21]] = True
    (w,) = reference.rolling_windows([t], [miss], 10)
    assert (w[miss] == reference.MISSING).all()
    acc = None
    for l in range(41):
        if miss[l]:
            acc = None
            continue
        if acc is None:
            acc = np.zeros(2)
            for k in range(10):
                acc = acc + t[l + k]
        else:
            acc = (acc - t[l - 1]) + t[l + 9]
        assert (w[l] == acc).all()
