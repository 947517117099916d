"""The port's companion tools (garlic_tpu_torch/tools/) against garlic_tpu's
(garlic_tpu/tools/) on the CPU, and the workflow that joins them: a VCF
through vcf2tped, the ROH calls, then count_features_in_roh.

Every input is made from a numpy seed.  Each case runs both packages'
tool on its own copy of the same files, in its own directory, and
compares the exit code, stderr and every file the tool leaves byte for
byte.  The whole chain compares garlic_tpu's exact engine, the port's
exact engine and the port's fast engine on the CPU (the kernels' plain
versions): the TPED, TFAM, BED and counts files are identical, and the
counts equal chip_smoke.py's plain numpy count.  Tolerances: none.
"""

from __future__ import annotations

import gzip
import os
import shutil
import sys

import numpy as np
import pytest

from garlic_tpu.tools import count_features_in_roh as gt_cfr
from garlic_tpu.tools import vcf2tped as gt_v2t
from garlic_tpu_torch.pipeline import run_main as port_main
from garlic_tpu_torch.tools import count_features_in_roh as cfr
from garlic_tpu_torch.tools import vcf2tped as v2t

sys.path.insert(0, os.path.dirname(__file__))
from util import make_panel, run_ours  # noqa: E402
from vcfutil import write_features, write_vcf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (its plain numpy count; needs no card)

BASES = np.array(list("ACGT"))


def _call(main, argv):
    """main(argv)'s exit code (a SystemExit's code included)."""
    try:
        return main(argv)
    except SystemExit as e:
        return e.code


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _both(tmp_path, monkeypatch, capsys, mains, inputs, argv):
    """Each main of `mains` (garlic_tpu's, the port's) run on argv in a
    directory of its own holding `inputs` (name -> bytes); returns
    [(exit code, stderr, the directory's files)] of each."""
    out = []
    for side, main in zip(("garlic_tpu", "port"), mains):
        d = tmp_path / side
        d.mkdir()
        for name, data in inputs.items():
            (d / name).write_bytes(data)
        monkeypatch.chdir(d)
        capsys.readouterr()
        rc = _call(main, argv)
        out.append((rc, capsys.readouterr().err, _files(d)))
    return out


# ---------------------------------------------------------------------------
# vcf2tped
# ---------------------------------------------------------------------------

def _vcf(seed, sep="/", missing=0.0, half=0.0, multi=0.0, fmt=False,
         nsites=40, nind=7):
    """A VCF text: nsites sites of nind samples, GT drawn from 0/1 with
    separator `sep`; missing / half / multi: the shares of ./., of one
    missing allele and of a code 2 allele; fmt: a GT:DP FORMAT."""
    rng = np.random.default_rng(seed)
    lines = ["##fileformat=VCFv4.1", "##source=test",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(nind))]
    pos = 1000 + np.cumsum(rng.integers(10, 500, nsites))
    for l in range(nsites):
        ref, alt = rng.choice(4, 2, replace=False)
        cells = []
        for _ in range(nind):
            a = [str(v) for v in rng.integers(0, 2, 2)]
            u = rng.random()
            if u < missing:
                a = [".", "."]
            elif u < missing + half:
                a[rng.integers(0, 2)] = "."
            elif u < missing + half + multi:
                a[rng.integers(0, 2)] = "2"
            s = sep if sep != "mixed" else "/|"[rng.integers(0, 2)]
            gt = a[0] + s + a[1]
            cells.append(f"{gt}:{rng.integers(1, 60)}" if fmt else gt)
        lines.append(f"22\t{pos[l]}\trs{l}\t{BASES[ref]}\t{BASES[alt]}\t."
                     f"\tPASS\t.\t{'GT:DP' if fmt else 'GT'}\t"
                     + "\t".join(cells))
    return ("\n".join(lines) + "\n").encode()


VCF2TPED_CASES = {
    "unphased": (dict(sep="/"), "a.vcf"),
    "phased": (dict(sep="|"), "a.vcf"),
    "mixed_separators": (dict(sep="mixed"), "a.vcf"),
    "missing_and_half_missing": (dict(missing=0.15, half=0.15), "a.vcf"),
    "multiallelic": (dict(multi=0.1), "a.vcf"),
    "format_subfields": (dict(fmt=True, missing=0.1), "a.vcf"),
    "gzip": (dict(sep="|", missing=0.1), "a.vcf.gz"),
    "bad_extension": (dict(), "a.txt"),
    "no_argument": (dict(), None),
}


@pytest.mark.parametrize("case", list(VCF2TPED_CASES))
def test_vcf2tped_matches_garlic_tpu(case, tmp_path, monkeypatch, capsys):
    kw, name = VCF2TPED_CASES[case]
    text = _vcf(seed=len(case), **kw)
    inputs = {}
    if name is not None:
        inputs[name] = gzip.compress(text) if name.endswith(".gz") else text
    argv = [] if name is None else [name]
    (rc, err, files), port = _both(tmp_path, monkeypatch, capsys,
                                   (gt_v2t.main, v2t.main), inputs, argv)
    assert port == (rc, err, files)
    if case in ("bad_extension", "no_argument"):
        assert rc == 1 and err and len(files) == len(inputs)
        return
    assert rc == 0 and err == ""
    tped = files[name.split(".")[0] + ".tped"].decode().splitlines()
    tfam = files[name.split(".")[0] + ".tfam"].decode().splitlines()
    assert tfam == [f"0\tS{i}\t0\t0\t0\t0" for i in range(7)]
    widths = {len(r.split("\t")) for r in tped}
    if case == "multiallelic":  # a code 2 emits nothing: short rows
        assert min(widths) < 4 + 14 == max(widths)
    else:
        assert widths == {4 + 14}


# ---------------------------------------------------------------------------
# count_features_in_roh
# ---------------------------------------------------------------------------

NIND, NSITES = 6, 60


def _cf_inputs(seed, chroms=(22,), kind="vcf", first_missing=False,
               neither=False):
    """Seeded genotype files (g.chr<c>.vcf or .tped + .tfam), a feature
    file over a third of each chromosome's sites (the functional allele
    REF or ALT), and a BED of a few intervals per individual and
    chromosome (classes A, B, C).  first_missing: some cells with a
    missing first allele; neither: some feature rows name two other
    bases (the VCF warns and skips the site)."""
    rng = np.random.default_rng(seed)
    inds = [f"I{i}" for i in range(NIND)]
    files, feats, bed = {}, [], {i: [] for i in inds}
    for c in chroms:
        pos = 5000 + np.cumsum(rng.integers(100, 2000, NSITES))
        ref = rng.integers(0, 4, NSITES)
        alt = (ref + rng.integers(1, 4, NSITES)) % 4
        hap = rng.integers(0, 2, (NSITES, NIND, 2))
        hom = rng.random((NSITES, NIND)) < 0.5  # more homozygotes
        hap[hom, 1] = hap[hom, 0]
        vcf = ["##fileformat=VCFv4.1",
               "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + "\t".join(inds)]
        tped = []
        for l in range(NSITES):
            cells, alle = [], []
            for i in range(NIND):
                a = [str(v) for v in hap[l, i]]
                if first_missing and rng.random() < 0.2:
                    a[0] = "."
                cells.append("|".join(a) + f":{rng.integers(1, 60)}")
                alle += ["0" if v == "." else BASES[(ref, alt)[int(v)][l]]
                         for v in a]
            vcf.append(f"{c}\t{pos[l]}\trs{c}_{l}\t{BASES[ref[l]]}\t"
                       f"{BASES[alt[l]]}\t.\tPASS\t.\tGT:DP\t"
                       + "\t".join(cells))
            tped.append(f"{c} rs{c}_{l} 0 {pos[l]} " + " ".join(alle))
        for l in np.sort(rng.choice(NSITES, NSITES // 3, replace=False)):
            fa, other = (alt[l], ref[l]) if rng.random() < 0.5 \
                else (ref[l], alt[l])
            if neither and rng.random() < 0.3:
                fa = other = ({0, 1, 2, 3} - {ref[l], alt[l]}).pop()
            feats.append(f"chr{c}:{pos[l]} {BASES[other]} {BASES[fa]} "
                         f"{('LOF', 'MIS', 'SYN')[rng.integers(0, 3)]}")
        for i in inds:
            edges = np.sort(rng.choice(pos[-1] - pos[0], 6, replace=False))
            for k in range(0, 6, 2):
                if rng.random() < 0.7:
                    bed[i].append(f"chr{c}\t{pos[0] + edges[k]}\t"
                                  f"{pos[0] + edges[k + 1]}\t"
                                  f"{'ABC'[rng.integers(0, 3)]}\t1\t.\t0\t0"
                                  "\t0,0,0")
        if kind == "vcf":
            files[f"g.chr{c}.vcf"] = "\n".join(vcf) + "\n"
        else:
            files[f"g.chr{c}.tped"] = "\n".join(tped) + "\n"
            files[f"g.chr{c}.tfam"] = "".join(f"P {i} 0 0 0 -9\n"
                                              for i in inds)
    files["features.txt"] = "\n".join(feats) + "\n"
    files["x.roh.bed"] = "".join(
        f'track name="Ind: {i} Pop:P ROH" description="Ind: {i} Pop:P ROH '
        f'from GARLIC v1.1.6a" visibility=2 itemRgb="On"\n'
        + "".join(r + "\n" for r in bed[i]) for i in inds)
    return {k: v.encode() for k, v in files.items()}


CF_CASES = {
    # name: (_cf_inputs kwargs, genotype file argument, <num chr>)
    "vcf": (dict(kind="vcf"), "g.chr22.vcf", "22"),
    "tped": (dict(kind="tped"), "g.chr22.tped", "22"),
    "two_chroms_vcf": (dict(kind="vcf", chroms=(22, 23)), "g.chr22.vcf",
                       "23"),
    "two_chroms_tped": (dict(kind="tped", chroms=(22, 23)), "g.chr22.tped",
                        "23"),
    "missing_first_allele_vcf": (dict(kind="vcf", first_missing=True),
                                 "g.chr22.vcf", "22"),
    "missing_first_allele_tped": (dict(kind="tped", first_missing=True),
                                  "g.chr22.tped", "22"),
    "neither_allele": (dict(kind="vcf", neither=True), "g.chr22.vcf", "22"),
    "bad_extension": (dict(kind="vcf"), "g.chr22.txt", "22"),
    "no_chr_in_name": (dict(kind="vcf"), "genotypes.vcf", "22"),
    "usage": (dict(kind="vcf"), None, None),
}


@pytest.mark.parametrize("case", list(CF_CASES))
def test_count_features_matches_garlic_tpu(case, tmp_path, monkeypatch,
                                           capsys):
    kw, gen, numchr = CF_CASES[case]
    inputs = _cf_inputs(seed=len(case), **kw)
    argv = (["features.txt", "x.roh.bed"] if gen is None else
            ["features.txt", "x.roh.bed", gen, numchr, "counts.txt"])
    (rc, err, files), port = _both(tmp_path, monkeypatch, capsys,
                                   (gt_cfr.main, cfr.main), inputs, argv)
    assert port == (rc, err, files)
    if case in ("bad_extension", "no_chr_in_name", "usage"):
        assert rc == 1 and "counts.txt" not in files
        assert ("ERROR" in err) == (case != "usage")
        return
    assert rc == 0
    rows = [r.split() for r in files["counts.txt"].decode().splitlines()]
    assert [r[0] for r in rows[1:]] == [f"I{i}" for i in range(NIND)]
    counts = np.array([[int(v) for v in r[1:]] for r in rows[1:]])
    assert counts.sum() > 0  # homozygous carriers were found
    warned = "are in the feature file, but chr22:" in err
    assert warned == (case == "neither_allele")
    if case.startswith("two_chroms"):
        assert "chr22\nchr23\n" in err


@pytest.mark.parametrize("intervals,query,want", [
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 150, "A"),
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 100, "A"),
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 200, "A"),
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 250, "0"),
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 400, "B"),
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 601, "0"),
    ([(100, 200, "A"), (300, 400, "B"), (500, 600, "C")], 99, "0"),
    ([(7, 7, "C")], 7, "C"),
    ([], 50, "0"),
], ids=["inside", "start", "end", "between", "second_end", "after_last",
        "before_first", "one_base", "empty"])
def test_hits_interval_matches_garlic_tpu(intervals, query, want):
    assert cfr.hits_interval(intervals, query) == want
    assert gt_cfr.hits_interval(intervals, query) == want


# ---------------------------------------------------------------------------
# The whole chain: VCF -> TPED -> ROH -> feature counts
# ---------------------------------------------------------------------------

# pinned: on one 40 x 10,000 chromosome the automatic cutoff's KDE is
# degenerate (negative cutoffs, a collapsed GMM) on both packages; the
# reference's default run goes through this chain on the card
# (chip_smoke.py phase 10, 200 x 100,000)
PINNED = ["--build", "hg18", "--winsize", "40", "--error", "0.001",
          "--kde-subsample", "0", "--lod-cutoff", "1.0", "--size-bounds",
          "300000", "800000"]


def test_vcf_to_roh_to_feature_counts(tmp_path, monkeypatch, capsys):
    """A seeded 40 x 10,000 chr22 panel (ROH planted at 1.5 times
    make_panel's rate) written as a phased .vcf.gz (one
    cell a multi-allelic code: a short TPED row) and 300 feature sites:
    garlic_tpu's tools and exact engine, the port's tools and exact
    engine, and the port's tools and fast engine on the CPU give the
    same TPED, TFAM, BED and counts (over the VCF and over the TPED);
    the VCF counts equal chip_smoke.py's plain numpy count."""
    panel = make_panel(nind=40, nloci_per_chr=(10_000,), chrom_names=["22"],
                       seed=23, roh_rate=1.5)
    src = tmp_path / "src"
    src.mkdir()
    vcf = "w.chr22.vcf.gz"
    alleles = write_vcf(panel, str(src / vcf), seed=5, multiallelic=1)
    geno = panel.genotypes[0].copy()
    geno[alleles[0][2][1], alleles[0][2][0]] = -9  # counted as no call
    sites = write_features(panel, alleles, str(src / "features.txt"), 300,
                           seed=6)
    chains = {"garlic_tpu": (gt_v2t, gt_cfr,
                             [("exact", lambda a: run_ours(".", a))]),
              "port": (v2t, cfr, [
                  ("exact", lambda a: port_main(a, prog="garlic")),
                  ("fast", lambda a: port_main(a, prog="garlic",
                                               device="cpu"))])}
    got = {}
    for side, (conv, count, engines) in chains.items():
        d = tmp_path / side
        shutil.copytree(src, d)
        monkeypatch.chdir(d)
        assert conv.main([vcf]) == 0
        got[side, "tped"] = (d / "w.chr22.tped").read_bytes()
        got[side, "tfam"] = (d / "w.chr22.tfam").read_bytes()
        for engine, run in engines:
            assert run(["--tped", "w.chr22.tped", "--tfam", "w.chr22.tfam"]
                       + PINNED + ["--tpu-engine", engine, "--out", engine]) \
                == 0
            got[side, engine] = (d / f"{engine}.roh.bed").read_bytes()
            for gen in (vcf, "w.chr22.tped"):
                out = f"{engine}.{gen.split('.')[-2]}.counts"
                assert count.main(["features.txt", f"{engine}.roh.bed", gen,
                                   "22", out]) == 0
                got[side, engine, gen] = (d / out).read_bytes()
    capsys.readouterr()
    assert got["port", "tped"] == got["garlic_tpu", "tped"]
    assert got["port", "tfam"] == got["garlic_tpu", "tfam"]
    widths = {len(r.split("\t")) for r in
              got["port", "tped"].decode().splitlines()}
    assert widths == {4 + 79, 4 + 80}  # the one short row
    bed = got["garlic_tpu", "exact"]
    assert got["port", "exact"] == bed and got["port", "fast"] == bed
    assert bed.count(b"\nchr22") >= 20
    for gen in (vcf, "w.chr22.tped"):
        want = got["garlic_tpu", "exact", gen]
        assert got["port", "exact", gen] == want
        assert got["port", "fast", gen] == want
    counts = got["port", "fast", vcf].decode()
    rows = [r.split() for r in counts.splitlines()[1:]]
    cols = counts.splitlines()[0].split()
    in_roh = sum(int(v) for r in rows for c, v in zip(cols, r[1:])
                 if not c.endswith("NONE"))
    assert in_roh > 0
    assert chip_smoke.numpy_counts(
        panel.ind_ids, geno, sites["22"],
        str(tmp_path / "port" / "fast.roh.bed"), "chr22") == counts
