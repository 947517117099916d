"""Phase II's exact f64 pool on the device (ops/exact_pool): the thinned
rolling LOD windows of the requested rows, one launch a pool, in place
of the host pass (pipeline._exact_thinned_samples).

On the CPU the route runs the plain version (exact_pool_plain); each
case is held bit for bit (np.array_equal on the f64 bits) to the host
pass over the same chromosome, rows, window size and step: rows as a
sorted subsample and as every row, step 1 and step W, missing windows at
the start, at the end, in runs and across a centromere, a chromosome
shorter than W, several chromosomes of different lengths in one launch,
and the codes deferred (the parent payload, compacted by the route) or
already filtered.  The plain version is also held to the native thinned
pass on its raw [rows, ceil(L/step)] output (MISSING and NaN in place),
with a table that holds -inf and +inf terms.  A run's counters say which
route it took: pool.device on an automatic 1x1 run, pool.host on a
2x1 mesh and on a TGLS run.  The kernel itself is compared with the
plain version on the card (the tests marked gpu, skipped here)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from util import make_panel, write_tgls, write_tped  # noqa: E402

from garlic_tpu_torch import pipeline  # noqa: E402
from garlic_tpu_torch.core.types import MISSING, ChromData  # noqa: E402
from garlic_tpu_torch.io import filters  # noqa: E402
from garlic_tpu_torch.native import \
    lod_windows_exact_thin_native  # noqa: E402
from garlic_tpu_torch.ops import cuda_lod, exact_pool, lod  # noqa: E402
from garlic_tpu_torch.pipeline import run_main as port_main  # noqa: E402

W = 30
MAX_GAP = 200_000
CPU = torch.device("cpu")


class Centro:
    """A centromere [start, end] on every chromosome (none: past them)."""

    def __init__(self, start=-2, end=-1):
        self._s, self._e = start, end

    def start(self, chrom):
        return self._s

    def end(self, chrom):
        return self._e


def _positions(Lp, case, rng):
    """Parent positions ~1 kb apart, with gaps over MAX_GAP (pair breaks)
    where the case wants missing windows; (positions, centromere)."""
    steps = rng.integers(500, 1500, Lp)
    breaks = {"none": [], "start": [5], "end": [Lp - 3],
              "runs": [200, 215, 240, 600, 601, 1100],
              "centromere": []}.get(case, [300, 700])
    steps[breaks] = MAX_GAP + 1000
    pos = 1_000_000 + np.cumsum(steps)
    centro = Centro()
    if case == "centromere":  # a window's first locus inside it, and
        # the pair across it
        centro = Centro(int(pos[Lp // 2]), int(pos[Lp // 2 + 40]) - 1)
        pos[Lp // 2 + 40:] += 3_000_000
    return pos.astype(np.int64), centro


def pool_chrom(I, L, seed, case="runs", codes="deferred", name="chr1"):
    """A chromosome of L kept loci out of a parent payload of I x ~1.02 L
    random 2-bit codes (code 3 among them) whose dropped loci are
    scattered and at both ends, and frequencies in [0.02, 0.98] with some
    0 and 1.  codes: "deferred" (the filter's compaction waits,
    cuda_lod.deferred), "filtered" (the host compaction has run) or
    "int8" (plain int8 genotypes).  Returns (chromosome, centromere)."""
    rng = np.random.default_rng(seed)
    Lp = L + L // 50 + 2
    keep = np.ones(Lp, dtype=bool)
    keep[[0, Lp - 1]] = False
    keep[rng.choice(np.arange(1, Lp - 1), Lp - L - 2, replace=False)] = False
    pos, centro = _positions(Lp, case, rng)
    q = rng.integers(0, 3, (I, 4 * ((Lp + 3) // 4)), dtype=np.uint8)
    q[rng.random(q.shape) < 0.01] = 3
    q[:, Lp:] = 3
    q = q.reshape(I, -1, 4)
    pb = q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)
    freq = np.clip(rng.beta(0.8, 0.8, Lp), 0.02, 0.98)
    freq[rng.choice(Lp, Lp // 40)] = rng.choice([0.0, 1.0], Lp // 40)
    c = ChromData(chrom=name, positions=pos, gpos=np.zeros(Lp),
                  locus_names=[""] * Lp, alleles=np.full(Lp, "A"),
                  genotypes=None, freq=freq, geno2b=pb, nind=I)
    fc = filters._apply(c, keep)
    assert cuda_lod.deferred(fc) and fc.nloci == L
    if codes == "filtered":
        assert fc.geno2b is not None and not cuda_lod.deferred(fc)
    elif codes == "int8":
        fc = ChromData(chrom=name, positions=fc.positions, gpos=fc.gpos,
                       locus_names=fc.locus_names, alleles=fc.alleles,
                       genotypes=np.array(fc.genotypes),
                       freq=fc.freq)
    return fc, centro


def _same_bits(a, b):
    """f64 arrays equal bit for bit, NaN in place (any NaN's payload)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb) and np.array_equal(
        a[~na].view(np.uint64), b[~nb].view(np.uint64)))


def _host(make, rows, step, error=0.001):
    """The host pass over fresh copies of the chromosomes (the first
    one's centromere for all)."""
    made = make()
    return [pipeline._exact_thinned_samples(
        [c], made[0][1], W, error, MAX_GAP, False, step, rows)
        for c, _ in made]


def _device(make, rows, step, error=0.001):
    """The device route (one launch for all the chromosomes) on the CPU.
    A deferred compaction is not fired: it stays deferred for Phase
    III."""
    made = make()
    chroms = [c for c, _ in made]
    deferred = [cuda_lod.deferred(c) for c in chroms]
    got = exact_pool.thinned_samples(chroms, made[0][1], W, error, MAX_GAP,
                                     step, [rows] * len(chroms), CPU)
    assert [cuda_lod.deferred(c) for c in chroms] == deferred
    return got


CASES = {
    "none": lambda codes: [pool_chrom(9, 1400, 1, "none", codes)],
    "start": lambda codes: [pool_chrom(9, 1400, 2, "start", codes)],
    "end": lambda codes: [pool_chrom(9, 1401, 3, "end", codes)],
    "runs": lambda codes: [pool_chrom(9, 1402, 4, "runs", codes)],
    "centromere": lambda codes: [pool_chrom(9, 1403, 5, "centromere",
                                            codes)],
    "short": lambda codes: [pool_chrom(9, W - 1, 6, "none", codes)],
    # one launch over chromosomes of different lengths (one under W),
    # the same centromere for all
    "several": lambda codes: [
        pool_chrom(9, 1400, 7, "runs", codes, "chr1"),
        pool_chrom(9, 905, 8, "two", codes, "chr2"),
        pool_chrom(9, W - 5, 9, "none", codes, "chr3"),
        pool_chrom(9, W, 10, "none", codes, "chr4")],
}


@pytest.mark.parametrize("codes", ["deferred", "filtered"])
@pytest.mark.parametrize("step", [1, W], ids=["step1", "stepW"])
@pytest.mark.parametrize("rows", [[1, 4, 5, 8], None],
                         ids=["subsample", "all"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_route_is_the_host_pass(case, rows, step, codes):
    """The route's samples of each chromosome equal the host pass's bit
    for bit, in its order (rows as given, row-major)."""
    make = lambda: CASES[case](codes)  # noqa: E731
    got = _device(make, rows, step)
    want = _host(make, rows, step)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and _same_bits(g, w)
    n = sum(w.size for w in want)
    assert n == 0 if case == "short" else n > 0


@pytest.mark.parametrize("codes", ["deferred", "int8"])
@pytest.mark.parametrize("rows", [[8, 0, 3], [2]], ids=["unsorted", "one"])
def test_device_route_takes_rows_in_their_order(rows, codes):
    """Rows in the order given (not sorted), one row, and int8 genotypes
    (packed on the host, then uploaded): the host pass's samples."""
    make = lambda: CASES["several"](codes)  # noqa: E731
    for g, w in zip(_device(make, rows, W), _host(make, rows, W)):
        assert _same_bits(g, w)


@pytest.mark.parametrize("step", [1, W], ids=["step1", "stepW"])
def test_device_route_filters_nan_windows(step):
    """error 0: heterozygous terms are -inf, so windows are -inf, and the
    rolling sums after them NaN; the NaN and MISSING windows are
    filtered out in the host pass's order."""
    make = lambda: CASES["several"]("deferred")  # noqa: E731
    got = _device(make, None, step, error=0.0)
    want = _host(make, None, step, error=0.0)
    for g, w in zip(got, want):
        assert _same_bits(g, w) and not np.isnan(g).any()
    assert np.isneginf(np.concatenate(got)).any()


def _raw_inputs(chroms, rows, error, table_fn=None):
    items, host = [], []
    for c, centro in chroms:
        r = np.asarray(rows if rows is not None else np.arange(c.nind))
        table = lod.lod_table(c.freq, error) if table_fn is None \
            else table_fn(c)
        nwin = max(c.nloci - W + 1, 0)
        miss = lod.window_missing_mask(c.positions, W, MAX_GAP,
                                       centro.start(c.chrom),
                                       centro.end(c.chrom)).astype(np.uint8)
        items.append((torch.from_numpy(np.ascontiguousarray(
            c.geno2b[:, :(c.nloci + 3) // 4])),
            torch.from_numpy(r.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(table[:3])),
            torch.from_numpy(miss)))
        host.append((c.genotypes[r], table,
                     miss if nwin > 0 else np.zeros(1, np.uint8)))
    return items, host


def _infinite_table(c):
    """lod_table's with -inf and +inf terms at a few loci of each row."""
    t = lod.lod_table(c.freq, 0.001).copy()
    rng = np.random.default_rng(c.nloci)
    for k in range(3):
        t[k, rng.choice(c.nloci, 3)] = -np.inf
        t[k, rng.choice(c.nloci, 2)] = np.inf
    return t


@pytest.mark.parametrize("table", ["lod", "infinite"])
@pytest.mark.parametrize("step", [1, 7, W], ids=["step1", "step7", "stepW"])
def test_plain_version_is_the_native_thin_pass(step, table):
    """exact_pool_plain's [rows, ceil(L/step)] blocks, chromosome-major,
    equal gt_lod_windows_exact_thin's output bit for bit: its MISSING
    columns and its NaN windows in place."""
    chroms = CASES["several"]("filtered")
    rows = [0, 2, 7]
    items, host = _raw_inputs(chroms, rows, 0.001,
                              None if table == "lod" else _infinite_table)
    got = exact_pool.exact_pool(items, W, step).numpy()
    want = np.concatenate([
        lod_windows_exact_thin_native(g, t, m, W, step).reshape(-1)
        for g, t, m in host])
    assert got.shape == want.shape and _same_bits(got, want)
    assert (want == MISSING).any()
    if table == "infinite":
        assert np.isnan(want).any() and np.isinf(want).any()


def test_wrapper_refuses_bad_inputs():
    (items,), _ = _raw_inputs([pool_chrom(3, 200, 11, "none", "filtered")],
                              None, 0.001)
    codes, rows, table, miss = items
    for bad, err in (((codes, rows.long(), table, miss), TypeError),
                     ((codes, rows[:0], table, miss), TypeError),
                     ((codes, rows, table.float(), miss), TypeError),
                     ((codes[:, :-1].contiguous(), rows, table, miss),
                      ValueError),
                     ((codes, rows, table, miss[:-1]), TypeError),
                     ((codes, rows, table.T.contiguous().T, miss),
                      ValueError)):
        with pytest.raises(err):
            exact_pool.exact_pool([bad], W, W)
    with pytest.raises(ValueError):
        exact_pool.exact_pool([items], W, 0)
    with pytest.raises(ValueError):
        exact_pool.exact_pool([], W, W)


# ---------------------------------------------------------------------------
# The route a run takes: its counters
# ---------------------------------------------------------------------------

NCHROM = 22


@pytest.fixture(scope="module")
def auto_dir(tmp_path_factory):
    """A panel of 22 short chromosomes and a GQ TGLS file."""
    wd = tmp_path_factory.mktemp("pool_auto")
    panel = make_panel(nind=30, nloci_per_chr=(900,) * NCHROM, seed=31)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    return str(wd)


def _counters(wd, args, out, device):
    err = io.StringIO()
    old = os.getcwd()
    os.chdir(wd)
    try:
        with contextlib.redirect_stderr(err):
            rc = port_main(["--tped", "p.tped.gz", "--tfam", "p.tfam",
                            "--build", "hg18", "--winsize", "40", "--error",
                            "0.001", "--kde-subsample", "20", "--tpu-seed",
                            "3", "--size-bounds", "300000", "800000",
                            "--tpu-engine", "fast", "--tpu-profile",
                            "--out", out] + args, prog="garlic",
                           device=device)
    finally:
        os.chdir(old)
    assert rc == 0, err.getvalue()
    (c,) = [json.loads(m) for m in re.findall(
        r"^\[profile\] counters (\{.*\})$", err.getvalue(), flags=re.M)]
    return c, err.getvalue()


def _kde_x(wd, out):
    with open(f"{wd}/{out}.40SNPs.kde") as f:
        return [line.split()[0] for line in f]


@pytest.mark.parametrize("route", ["1x1", "2x1", "tgls"])
def test_run_counts_the_route_it_pools_on(auto_dir, route):
    """An automatic 1x1 run pools every chromosome on the device in one
    launch (pool.device 22, pool.host 0; on the CPU the plain version,
    so no kernel launch), compacting the deferred codes on the device
    (22), and Phase III compacts them there again (pack.device 44,
    pack.host 0); a 2x1 mesh and a TGLS run pool them on the
    host (pool.host 22), firing the host compaction (pack.host 22).  The
    1x1 and 2x1 runs' .kde x columns are equal."""
    args, device = {"1x1": ([], "cpu"),
                    "2x1": (["--tpu-mesh", "2x1"], ["cpu", "cpu"]),
                    "tgls": (["--tgls", "GQ.tgls.gz", "--gl-type", "GQ"],
                             "cpu")}[route]
    before = cuda_lod.LAUNCHES["exact_pool"]
    c, err = _counters(auto_dir, args, route, device)
    assert cuda_lod.LAUNCHES["exact_pool"] == before
    dev = route == "1x1"
    assert c["pool"] == {"pooled": 1, "replayed": 0,
                         "device": NCHROM if dev else 0,
                         "host": 0 if dev else NCHROM}
    assert c["pack"] == {"device": 2 * NCHROM if dev else 0,
                         "host": 0 if dev else NCHROM}
    assert ("phase2-cutoff/pool/upload" in err) == dev
    if route == "2x1":
        if not os.path.exists(f"{auto_dir}/1x1.40SNPs.kde"):
            _counters(auto_dir, [], "1x1", "cpu")
        assert _kde_x(auto_dir, "2x1") == _kde_x(auto_dir, "1x1")


# ---------------------------------------------------------------------------
# The kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the example benchmark's chromosome 1 (roh_bench/configs/garlic-example
# .json: 45 individuals, 50,300 loci, --winsize 60, --kde-subsample 20,
# step W), and an all-rows pool of a WGS-width chromosome (kgp3-wgs's
# 108 individuals, ~800,000 loci)
@pytest.mark.gpu
@pytest.mark.parametrize("I,L,nrows,Wk,step", [
    (45, 50_300, 20, 60, 60), (108, 800_000, None, 60, 60),
    (9, 4_001, 5, 7, 1)], ids=["example_chr1", "wgs_all_rows", "small"])
def test_kernel_is_the_plain_version_on_card(cuda_device, I, L, nrows, Wk,
                                             step):
    """gt_exact_pool against exact_pool_plain (on the CPU) and the host
    pass, bit for bit with NaN in place, over the chromosome and two more
    of other lengths (one under W, missing runs) in one launch; the
    route's samples on the card equal the host pass's."""
    rng = np.random.default_rng(L)
    rows = None if nrows is None else np.sort(rng.choice(I, nrows, False))
    made = [pool_chrom(I, L, 12, "runs", "deferred")]
    if L < 100_000:  # the plain version pads every chain to the longest
        made += [pool_chrom(I, 3001, 13, "two", "deferred", "chr2"),
                 pool_chrom(I, Wk - 1, 14, "none", "deferred", "chr3")]
    centro = made[0][1]
    chroms = [c for c, _ in made]
    items = []
    for c in chroms:
        r = np.arange(I) if rows is None else rows
        miss = lod.window_missing_mask(c.positions, Wk, MAX_GAP,
                                       centro.start(c.chrom),
                                       centro.end(c.chrom))
        items.append((cuda_lod.packed_device(c, cuda_device),
                      torch.from_numpy(r.astype(np.int32)).to(cuda_device),
                      torch.from_numpy(np.ascontiguousarray(
                          lod.lod_table(c.freq, 0.001)[:3])).to(cuda_device),
                      torch.from_numpy(miss.astype(np.uint8)).to(
                          cuda_device)))
    before = cuda_lod.LAUNCHES["exact_pool"]
    got = exact_pool.exact_pool(items, Wk, step)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["exact_pool"] == before + 1
    plain = exact_pool.exact_pool_plain(
        [tuple(t.cpu() for t in it) for it in items], Wk, step)
    assert _same_bits(got.cpu().numpy(), plain.numpy())
    route = exact_pool.thinned_samples(chroms, centro, Wk, 0.001, MAX_GAP,
                                       step, [rows] * len(chroms),
                                       cuda_device)
    for c, part in zip(chroms, route):
        want = pipeline._exact_thinned_samples([c], centro, Wk, 0.001,
                                               MAX_GAP, False, step, rows)
        assert _same_bits(part, want)
