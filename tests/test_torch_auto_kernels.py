"""The automatic run's kernels K7 (the Gauss transform) and K8 (the
GMM-EM), csrc/kde_gmm.cu.

On the CPU the port takes their plain PyTorch versions
(ops/kde.gauss_sums_plain, ops/gmm._em_stats and fit_em's loop); those
are held here to garlic_tpu on the same seeded numpy inputs:
- the transform through gauss_transform_sharded on a 1x1 CPU mesh against
  garlic_tpu's gauss_transform(device=True) on JAX-CPU, rtol 1e-5 (f32
  sums in another order), and against the host f64 transform, rtol 5e-4,
  atol 1e-7 (tests/test_phase24.py:85);
- the EM through fit_gmm_sharded on a 1x1 and a 2x2 CPU mesh against
  garlic_tpu's fit_gmm_sharded on a JAX-CPU mesh of the same shape and
  against its host fit_gmm: the same iterations and convergence flag, the
  same %g-printed parameters, rtol 1e-10 (f64 sums in another order).
K7's plan (kde.k7_plan, kde.k7_buckets: the arithmetic the kernel does)
is held here to skip only terms whose f32 argument is at most -110, and
K7's summation order (a numpy model) to garlic_tpu's transforms.
The gpu-marked tests hold each kernel on the card to its plain version:
K7 within 1e-6 x max y, no farther from the host f64 transform and
closer to the f64 sums of the same f32 terms (the same terms, bit for
bit: only the summation differs), its bucketed order equal to a stable
sort and its plan to kde.k7_plan's, expf +0 from -104 down; K8's fit
mode with the plain loop's iterations, flag and %g lines, rtol 1e-10,
its stats mode within rtol 1e-12 of _em_stats, on both launch shapes
(one cluster, the grid), points resident and streamed, K = 3 and 9; two
launches of each bit-equal; one launch per stats-mode call.

garlic_tpu is imported inside the CPU-side tests only: the gpu tests run
where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from garlic_tpu_torch.core.fmt import g
from garlic_tpu_torch.ops import cuda_lod, gmm, kde
from garlic_tpu_torch.parallel import engine as port_engine
from garlic_tpu_torch.parallel.mesh import make_mesh


def _two_modes(n, seed):
    """n seeded draws of a two-mode density like the pooled LOD windows."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(-3.0, 1.0, n // 2),
                           rng.normal(2.0, 0.7, n - n // 2)])


def _transform_case(case):
    """(sources, targets, h) of each transform case: one source against a
    grid made from other data; a ragged last block (the block size is
    lowered to 1000 by the test); sources far outside the grid, whose
    terms underflow to 0 in f32; a bandwidth 1/200 of nrd0's."""
    from garlic_tpu_torch.ops.kde import _kde_grid
    if case == "n1":
        h, targets, _ = _kde_grid(_two_modes(500, 1))
        return np.array([0.37]), targets, h
    if case == "ragged":
        x = _two_modes(5003, 2)
        h, targets, _ = _kde_grid(x)
        return x, targets, h
    if case == "far":
        core = _two_modes(4000, 3)
        h, targets, _ = _kde_grid(core)
        return np.concatenate([core, [1e4, -2e4, 3.5e5, 1e7]]), targets, h
    x = _two_modes(3000, 4)  # tiny h
    h, targets, _ = _kde_grid(x)
    return x, targets, h / 200.0


@pytest.mark.parametrize("case", ["n1", "ragged", "far", "tiny_h"])
def test_gauss_sums_plain_matches_garlic_tpu(monkeypatch, case):
    from garlic_tpu.ops import kde as gt_kde
    monkeypatch.setattr(kde, "BLOCK", 1000)
    x, targets, h = _transform_case(case)
    n = x.size
    before = dict(cuda_lod.LAUNCHES)
    got = port_engine.gauss_transform_sharded(
        x, targets, h, make_mesh(1, 1, ["cpu"])) * (1.0 / n)
    assert cuda_lod.LAUNCHES == before  # CPU tensors: the plain version
    assert got.shape == (targets.size,) and np.all(np.isfinite(got))
    assert got.max() > 0
    # XLA on the CPU flushes f32 subnormal terms to 0 and torch keeps
    # them: each differs by less than the smallest normal f32, so y, the
    # mean of the terms, too (the n1 and tiny_h cases have such terms)
    np.testing.assert_allclose(
        got, gt_kde.gauss_transform(x, targets, h, device=True), rtol=1e-5,
        atol=float(np.finfo(np.float32).tiny))
    np.testing.assert_allclose(
        got, gt_kde.gauss_transform(x, targets, h, device=False),
        rtol=5e-4, atol=1e-7)


def _k7_order_model(x, targets, h, chunk):
    """K7's summation order in numpy (csrc/kde_gmm.cu): the f32 sources
    stable-sorted by bucket (kde.k7_buckets); tile tau's terms are those
    of its candidate range [S_lo, S_hi) of the bucketed array (the
    buckets kde.k7_plan gives it), cut at multiples of `chunk` into items
    and from each item's start into runs of 16; a target adds the terms
    of a run in order in f32 from 0, each run's sum to its item's f64 sum
    from 0 in order, its tile's item sums j = q mod 32 into 32 f64 sums
    from 0 in order, and those from 0 in order (numpy's f32 exp stands in
    for the card's expf)."""
    src = x.astype(np.float32)
    tgt = targets.astype(np.float32)
    nih2 = -np.float32(1.0 / (h * h))
    plan = kde.k7_plan(tgt, nih2)
    b = kde.k7_buckets(src, plan)
    srt = src[np.argsort(b, kind="stable")]
    start = np.searchsorted(np.sort(b), np.arange(plan.nc + 4))
    out = np.zeros(tgt.size)
    for tau, (blo, bhi) in enumerate(plan.ranges):
        t = tgt[tau * kde.K7_TILE:(tau + 1) * kde.K7_TILE]
        lo, hi = start[blo], start[bhi + 1]
        items = []
        for c0 in range(lo // chunk * chunk, hi, chunk):
            acc = np.zeros(t.size)
            for r0 in range(c0, min(c0 + chunk, hi), kde.K7_RUN):
                run = np.zeros(t.size, dtype=np.float32)
                for v in srt[max(r0, lo):min(r0 + kde.K7_RUN, c0 + chunk,
                                             hi)]:
                    d = v - t
                    run += np.exp(d * d * nih2)
                acc += run.astype(np.float64)
            items.append(acc)
        total = np.zeros(t.size)
        for q in range(32):
            part = np.zeros(t.size)
            for item in items[q::32]:
                part += item
            total += part
        out[tau * kde.K7_TILE:tau * kde.K7_TILE + t.size] = total
    return out


@pytest.mark.parametrize("chunk", [4, 252, kde.K7_CHUNK, 4096])
def test_k7_order_model_matches_garlic_tpu(chunk):
    """K7's order holds to garlic_tpu's f32 device transform as the plain
    version does (rtol 1e-5), at items of 4 and 252 sources (runs cut by
    the items), K7's 1024 and 4096; against the host f64 transform within
    rtol 5e-4, atol 1e-7.  The bandwidth is nrd0's / 20, so the tiles'
    candidate ranges skip most of the grid."""
    from garlic_tpu.ops import kde as gt_kde
    x = _two_modes(3001, 6)
    h, targets, _ = kde._kde_grid(x)
    h /= 20.0
    plan = kde.k7_plan(targets.astype(np.float32), -np.float32(1 / (h * h)))
    assert (plan.ranges[:, 1] - plan.ranges[:, 0]).max() < plan.nc / 2
    got = _k7_order_model(x, targets, h, chunk) * (1.0 / x.size)
    np.testing.assert_allclose(
        got, gt_kde.gauss_transform(x, targets, h, device=True), rtol=1e-5,
        atol=float(np.finfo(np.float32).tiny))
    np.testing.assert_allclose(
        got, gt_kde.gauss_transform(x, targets, h, device=False),
        rtol=5e-4, atol=1e-7)


def _plan_case(case):
    """(f32 sources, f32 targets, neg_inv_h2) of the transform cases, and
    "wide": nrd0's bandwidth x 100, whose candidate ranges cover the grid."""
    x, targets, h = _transform_case("ragged" if case == "wide" else case)
    if case == "wide":
        h *= 100.0
    return (x.astype(np.float32), targets.astype(np.float32),
            -np.float32(1.0 / (h * h)))


@pytest.mark.parametrize("case", ["n1", "ragged", "far", "tiny_h", "wide"])
def test_k7_plan_skips_only_zero_terms(case):
    """K7's plan (kde.k7_plan, kde.k7_buckets: the kernel's arithmetic)
    never skips a (source, target) pair whose f32 argument (x - t)^2 *
    neg_inv_h2 is above -110: each skipped term is exactly +0 (expf is +0
    from -104 down, checked on the card).  The wide bandwidth plans every
    tile dense; the others skip pairs."""
    src, tgt, nih2 = _plan_case(case)
    plan = kde.k7_plan(tgt, nih2)
    b = kde.k7_buckets(src, plan)
    assert b.min() >= 0 and b.max() <= plan.nc + 1  # no NaN source
    tile = np.arange(tgt.size) // kde.K7_TILE
    lo, hi = plan.ranges[tile, 0], plan.ranges[tile, 1]
    skipped = (b[:, None] < lo[None, :]) | (b[:, None] > hi[None, :])
    with np.errstate(over="ignore"):
        d = src[:, None] - tgt[None, :]
        arg = d * d * nih2
    assert arg.dtype == np.float32
    assert np.all(arg[skipped] <= -110.0)
    if case == "wide":
        assert (plan.ranges == [0, plan.nc + 1]).all() and not skipped.any()
    elif case != "n1":
        assert skipped.mean() > 0.2
    # the skipped pairs' terms are zero in f32, and every term kept that
    # is +0 lies outside the band the plan is built on (no term is lost)
    with np.errstate(under="ignore"):
        assert not np.exp(arg[skipped]).any()


def test_k7_plan_dense_when_degenerate():
    """One target, equal targets, a NaN target or a bandwidth that is not
    finite and > 0 plan every tile dense (every bucket but NaN's); NaN
    sources take the last bucket."""
    t = np.linspace(-3.0, 4.0, 512).astype(np.float32)
    for tgt, nih2 in ((t[:1], -1.0), (np.full(64, 2.0, np.float32), -1.0),
                      (t, 0.0), (t, np.inf), (t, np.nan), (t, 1.0)):
        plan = kde.k7_plan(tgt, nih2)
        assert (plan.ranges == [0, plan.nc + 1]).all()
    tn = t.copy()
    tn[40] = np.nan
    plan = kde.k7_plan(tn, -100.0)  # hw = 1.05: the tiles' ranges skip
    assert list(plan.ranges[1]) == [0, plan.nc + 1]
    assert list(plan.ranges[0]) != [0, plan.nc + 1]
    b = kde.k7_buckets(np.array([np.nan, -np.inf, np.inf, -3.0],
                                np.float32), kde.k7_plan(t, -1.0))
    assert list(b) == [plan.nc + 2, 0, plan.nc + 1, 1]


def test_gauss_sums_dispatches_cpu_tensors_to_the_plain_version():
    x, targets, h = _transform_case("ragged")
    src = torch.from_numpy(x.astype(np.float32))
    tgt = torch.from_numpy(targets.astype(np.float32))
    before = dict(cuda_lod.LAUNCHES)
    got = kde.gauss_sums(x, targets, h, "cpu")
    assert cuda_lod.LAUNCHES == before
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert torch.equal(got, kde.gauss_sums_plain(
        src, tgt, -np.float32(1.0 / (h * h))))


def test_gauss_sums_cuda_refuses_cpu_tensors():
    """K7's wrapper never computes on the CPU: there the dispatcher takes
    the plain version."""
    src = torch.zeros(4, dtype=torch.float32)
    with pytest.raises(ValueError):
        kde.gauss_sums_cuda(src, src, -1.0)


# ---------------------------------------------------------------------------
# The EM
# ---------------------------------------------------------------------------

def _mixture(n=5200, seed=404):
    """A trimodal ROH-length mixture (tests/test_phase24.py:243-247 at
    n = 5200), >= the 4096 gate of the device EM."""
    rng = np.random.default_rng(seed)
    a, b = n * 25 // 52, n * 18 // 52
    return np.concatenate([
        rng.normal(2.2e5, 5e4, a), rng.normal(8.5e5, 1.8e5, b),
        rng.normal(2.6e6, 6e5, n - a - b)]).clip(1e4, None)


def _init(x, k):
    """selectSizeClasses' initial parameters (ops/gmm.py)."""
    var, mean = float(np.var(x, ddof=1)), float(np.mean(x))
    return (np.full(k, 1.0 / k),
            np.array([mean * (i + 1) / (k + 1) for i in range(k)]),
            np.array([var * (i + 1) / k for i in range(k)]))


def _params(res):
    return (res.weights, res.means, res.variances)


def _same_fit(got, want, rtol=1e-10):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    for a, b in zip(_params(got), _params(want)):
        assert [g(float(v)) for v in a] == [g(float(v)) for v in b]
        np.testing.assert_allclose(a, b, rtol=rtol)
    assert got.loglikelihood == pytest.approx(want.loglikelihood, rel=1e-12)


# (K, N, max_iter): K = 1, 2, 3, 5 on the mixture, N = 4096 exactly, and
# a fit stopped by max_iter
EM_CASES = {"k1": (1, 5200, 1000), "k2": (2, 5200, 1000),
            "k3": (3, 5200, 1000), "k5": (5, 5200, 1000),
            "n4096": (3, 4096, 1000), "max_iter": (3, 5200, 5)}


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
@pytest.mark.parametrize("case", list(EM_CASES))
def test_fit_em_matches_garlic_tpu(case, dp, sp):
    import jax
    from garlic_tpu.ops import gmm as gt_gmm
    from garlic_tpu.parallel.engine import fit_gmm_sharded
    from garlic_tpu.parallel.mesh import make_mesh as gt_make_mesh
    k, n, max_iter = EM_CASES[case]
    x = _mixture(n, seed=404 + n)
    init = _init(x, k)
    before = dict(cuda_lod.LAUNCHES)
    got = port_engine.fit_gmm_sharded(
        x, k, *init, make_mesh(dp, sp, ["cpu"] * (dp * sp)),
        max_iter=max_iter)
    assert cuda_lod.LAUNCHES == before  # CPU tensors: the plain loop
    sharded = fit_gmm_sharded(
        x, k, *init, gt_make_mesh(n_dp=dp, n_sp=sp,
                                  devices=jax.devices()[:dp * sp]),
        max_iter=max_iter)
    host = gt_gmm.fit_gmm(x, k, *init, max_iter=max_iter)
    if case == "max_iter":
        assert got.iterations == max_iter and not got.converged
    for ref in (sharded, host):
        _same_fit(got, ref)


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_fit_em_collapse_raises_as_garlic_tpu(dp, sp):
    import jax
    from garlic_tpu.parallel.engine import fit_gmm_sharded
    from garlic_tpu.parallel.mesh import make_mesh as gt_make_mesh
    x = np.full(4096, 1000.0)  # zero variance (tests/test_phase24.py:191)
    init = _init(x, 3)
    with pytest.raises(FloatingPointError):
        port_engine.fit_gmm_sharded(x, 3, *init,
                                    make_mesh(dp, sp, ["cpu"] * (dp * sp)))
    with pytest.raises(FloatingPointError):
        fit_gmm_sharded(x, 3, *init, gt_make_mesh(
            n_dp=dp, n_sp=sp, devices=jax.devices()[:dp * sp]))


def test_em_stats_dispatches_cpu_tensors_to_the_plain_version():
    x = torch.from_numpy(_mixture(1000))
    w, mu, var = (torch.from_numpy(a) for a in _init(x.numpy(), 3))
    before = dict(cuda_lod.LAUNCHES)
    got = gmm.em_stats(x, w, mu, var)
    assert cuda_lod.LAUNCHES == before
    assert torch.equal(got, gmm._em_stats(x, w, mu, var))
    res = gmm.fit_em([x], 3, *_init(x.numpy(), 3), "cpu")
    _same_fit(res, gmm.fit_em_plain([x], 3, *_init(x.numpy(), 3), "cpu"),
              rtol=0)


# ---------------------------------------------------------------------------
# On the card (skipped without CUDA)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 1 << 18, (1 << 18) + 1, 3_328_600])
def test_gauss_sums_kernel_on_card(cuda_device, n):
    """K7 against its plain version on the same tensors: within 1e-6 x
    max y, no farther from the host f64 transform and closer to the f64
    sums of the same f32 terms, two launches bit-equal, one launch
    each."""
    x = _two_modes(n, seed=n) if n > 1 else np.array([0.37])
    h, targets, _ = kde._kde_grid(x if n > 1 else _two_modes(500, 1))
    src = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    tgt = torch.from_numpy(targets.astype(np.float32)).to(cuda_device)
    nih2 = -np.float32(1.0 / (h * h))
    before = cuda_lod.LAUNCHES["gauss_sums"]
    a = kde.gauss_sums_cuda(src, tgt, nih2)
    b = kde.gauss_sums_cuda(src, tgt, nih2)
    torch.cuda.synchronize()
    assert cuda_lod.LAUNCHES["gauss_sums"] == before + 2
    p = kde.gauss_sums_plain(src, tgt, nih2).cpu().numpy()
    a, b = a.cpu().numpy(), b.cpu().numpy()
    assert np.array_equal(a, b)
    assert np.abs(a - p).max() <= 1e-6 * p.max()
    host = kde.gauss_transform_host(x, targets, h) * n
    assert np.abs(a - host).max() <= np.abs(p - host).max()
    exact = np.zeros(targets.size)  # the f32 terms, added in f64
    for s in range(0, n, kde.BLOCK):
        d = src[s:s + kde.BLOCK, None] - tgt[None, :]
        d.square_().mul_(float(nih2)).exp_()
        exact += d.double().sum(dim=0).cpu().numpy()
    assert np.abs(a - exact).max() <= np.abs(p - exact).max()


@pytest.mark.gpu
def test_gauss_sums_kernel_terms_bit_equal(cuda_device):
    """K7's f32 terms are the plain version's bit for bit: each launch
    takes one run of 16 sources, one source at each of the run's places
    in turn and 15 so far off the grid that their terms are exactly 0 (the
    plan puts them in the over-range bucket), so both sums are that one
    term, exactly."""
    x = _two_modes(1000, seed=8)
    h, targets, _ = kde._kde_grid(x)
    tgt = torch.from_numpy(targets.astype(np.float32)).to(cuda_device)
    nih2 = -np.float32(1.0 / (h * h))
    for q, v in enumerate(x[::25].astype(np.float32)):
        run = np.full(16, 1e20, dtype=np.float32)
        run[q % 16] = v
        src = torch.from_numpy(run).to(cuda_device)
        assert torch.equal(kde.gauss_sums_cuda(src, tgt, nih2),
                           kde.gauss_sums_plain(src, tgt, nih2))


def _bench_pool(n, seed):
    """n seeded draws shaped like the bench auto run's pool: most windows
    near 0, a long negative tail (the grid spans about -105 to 23)."""
    rng = np.random.default_rng(seed)
    k = n // 50
    return np.concatenate([rng.normal(1.5, 2.0, n - 2 * k),
                           rng.uniform(-100.0, -5.0, k),
                           rng.uniform(5.0, 20.0, k)])


def _k7_cases():
    """(name, sources, targets, h): the transform cases, the wide
    bandwidth, and a pool of the bench run's size and shape."""
    for case in ("n1", "ragged", "far", "tiny_h", "wide"):
        x, targets, h = _transform_case("ragged" if case == "wide" else case)
        yield case, x, targets, h * (100.0 if case == "wide" else 1.0)
    x = _bench_pool(3_328_600, 9)
    h, targets, _ = kde._kde_grid(x)
    yield "bench", x, targets, h


@pytest.mark.gpu
def test_k7_bucketed_order_is_a_stable_sort(cuda_device):
    """K7's bucketed sources equal a stable sort by bucket (torch.sort,
    stable, over kde.k7_buckets: the test may sort, the kernel does not),
    and its plan (each tile's range, items, NaN count) is kde.k7_plan's."""
    for name, x, targets, h in _k7_cases():
        src32, tgt32 = x.astype(np.float32), targets.astype(np.float32)
        nih2 = -np.float32(1.0 / (h * h))
        src = torch.from_numpy(src32).to(cuda_device)
        tgt = torch.from_numpy(tgt32).to(cuda_device)
        _, srt, info = kde._gauss_launch(src, tgt, nih2)
        plan = kde.k7_plan(tgt32, nih2)
        b = torch.from_numpy(kde.k7_buckets(src32, plan))
        order = torch.sort(b, stable=True).indices.to(cuda_device)
        assert torch.equal(srt.view(torch.int32),
                           src[order].view(torch.int32)), name
        info = info.cpu().numpy()
        start = np.searchsorted(np.sort(b.numpy()), np.arange(plan.nc + 4))
        tiles = plan.ranges.shape[0]
        tinfo = info[kde.K7_INFO:kde.K7_INFO + 4 * tiles].reshape(tiles, 4)
        assert (tinfo[:, 0] == start[plan.ranges[:, 0]]).all(), name
        assert (tinfo[:, 1] == start[plan.ranges[:, 1] + 1]).all(), name
        cnt = np.where(tinfo[:, 1] > tinfo[:, 0],
                       (tinfo[:, 1] - 1) // kde.K7_CHUNK
                       - tinfo[:, 0] // kde.K7_CHUNK + 1, 0)
        assert (tinfo[:, 3] == cnt).all() and info[0] == cnt.sum(), name
        assert info[1] == 0 and info[2] == (name == "wide"), name


@pytest.mark.gpu
def test_gauss_sums_kernel_cases_on_card(cuda_device):
    """K7 on the transform cases, the wide bandwidth (dense) and a pool of
    the bench run's size and shape: within 1e-6 x max y of the plain
    version and closer than it to the f64 sums of the same f32 terms (the
    sums both orders approximate), two launches bit-equal; NaN everywhere
    when a source is NaN.  (The distance from the host f64 transform is
    mostly those terms' own f32 error, the same on both sides: the ragged
    case puts K7 1.03 x as far as the plain version on the card, so the
    1.01 bound stays where chip_smoke.py holds it, on the bench pool.)"""
    for name, x, targets, h in _k7_cases():
        src = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
        tgt = torch.from_numpy(targets.astype(np.float32)).to(cuda_device)
        nih2 = -np.float32(1.0 / (h * h))
        a = kde.gauss_sums_cuda(src, tgt, nih2).cpu().numpy()
        b = kde.gauss_sums_cuda(src, tgt, nih2).cpu().numpy()
        p = kde.gauss_sums_plain(src, tgt, nih2).cpu().numpy()
        assert np.array_equal(a, b), name
        assert np.abs(a - p).max() <= 1e-6 * p.max(), name
        exact = np.zeros(targets.size)
        for s in range(0, x.size, kde.BLOCK):
            d = src[s:s + kde.BLOCK, None] - tgt[None, :]
            d.square_().mul_(float(nih2)).exp_()
            exact += d.double().sum(dim=0).cpu().numpy()
        assert np.abs(a - exact).max() <= np.abs(p - exact).max(), name
    src[7] = float("nan")
    assert torch.isnan(kde.gauss_sums_cuda(src, tgt, nih2)).all()


@pytest.mark.gpu
def test_expf_underflows_to_zero_on_card(cuda_device):
    """K7's premise: expf of every f32 from -104 down to -inf is +0."""
    assert kde.expf_underflow(cuda_device) == 0
    assert kde.expf_underflow(cuda_device, -103.0) != 0


@pytest.mark.gpu
def test_gauss_transform_sharded_runs_k7_per_shard(cuda_device):
    """gauss_transform_sharded on a 2x2 mesh of the one card: one K7
    launch per shard, the result within 1e-6 x max of the 1x1 mesh's."""
    x = _two_modes(600_001, seed=5)
    h, targets, _ = kde._kde_grid(x)
    one = port_engine.gauss_transform_sharded(
        x, targets, h, make_mesh(1, 1, [cuda_device]))
    before = cuda_lod.LAUNCHES["gauss_sums"]
    four = port_engine.gauss_transform_sharded(
        x, targets, h, make_mesh(2, 2, [cuda_device] * 4))
    assert cuda_lod.LAUNCHES["gauss_sums"] == before + 4
    assert np.abs(four - one).max() <= 1e-6 * one.max()


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 5, 9])
@pytest.mark.parametrize("n", [4096, 5530, 100_000])
def test_em_kernel_on_card(cuda_device, n, k):
    """K8's fit mode against the plain loop on the card (the same
    iterations, flag and %g lines, rtol 1e-10), its stats mode against
    _em_stats (rtol 1e-12), two launches of each bit-equal."""
    x = _mixture(n, seed=n + k)
    init = _init(x, k)
    xt = torch.from_numpy(x).to(cuda_device)
    before = cuda_lod.LAUNCHES["gmm_em"]
    fit = gmm.fit_em([xt], k, *init, cuda_device)
    again = gmm.fit_em([xt], k, *init, cuda_device)
    assert cuda_lod.LAUNCHES["gmm_em"] == before + 2
    plain = gmm.fit_em_plain([xt], k, *init, cuda_device)
    _same_fit(fit, plain)
    for a, b in zip(_params(fit), _params(again)):
        assert np.array_equal(a, b)
    assert fit.loglikelihood == again.loglikelihood
    w, mu, var = (torch.from_numpy(a).to(cuda_device) for a in init)
    s1, s2 = gmm.em_stats(xt, w, mu, var), gmm.em_stats(xt, w, mu, var)
    assert torch.equal(s1, s2)
    np.testing.assert_allclose(s1.cpu().numpy(),
                               gmm._em_stats(xt, w, mu, var).cpu().numpy(),
                               rtol=1e-12)


# (path, N, K, max_iter, points resident): both launch shapes, the fused
# E-step (K <= 8) and the grouped one (K = 9), points resident in shared
# memory and streamed from device memory (N above what the cluster's, or
# the card's, shared memory holds)
EM_PATH_CASES = {
    "cluster-5530-k3": ("cluster", 5530, 3, 1000, True),
    "cluster-5530-k9": ("cluster", 5530, 9, 1000, True),
    "cluster-500k-k3": ("cluster", 500_000, 3, 60, False),
    "cluster-500k-k9": ("cluster", 500_000, 9, 60, False),
    "grid-5530-k3": ("grid", 5530, 3, 1000, True),
    "grid-100k-k9": ("grid", 100_000, 9, 1000, True),
    "grid-4m-k3": ("grid", 4_000_000, 3, 60, False),
    "grid-4m-k9": ("grid", 4_000_000, 9, 60, False)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(EM_PATH_CASES))
def test_em_kernel_paths_on_card(cuda_device, case):
    """Each of K8's launch shapes against the plain loop and _em_stats as
    test_em_kernel_on_card holds the automatic one; em_path reports the
    shape taken; the automatic choice is the cluster where every point
    runs at once in its 16 x 1024 threads with all its lanes (up to 4 a
    point: K rounded up to a power of two; one for K > 4)."""
    path, n, k, max_iter, resident = EM_PATH_CASES[case]
    assert gmm.em_path(cuda_device, n, k, path)[::2] == (path, resident)
    lanes = 1 << (k - 1).bit_length() if k <= 4 else 1
    assert gmm.em_path(cuda_device, n, k)[0] == (
        "cluster" if n * lanes <= 16 * 1024 else "grid")
    x = _mixture(n, seed=n + k)
    init = _init(x, k)
    xt = torch.from_numpy(x).to(cuda_device)
    w, mu, var = (torch.from_numpy(a).to(cuda_device) for a in init)
    outs = []
    for _ in range(2):
        out = torch.empty(3 * k + 4, dtype=torch.float64, device=cuda_device)
        gmm._em_launch(xt, w, mu, var, out, fit=True, n=n,
                       max_iter=max_iter, precision=1e-5, path=path)
        outs.append(out.cpu().numpy())
    assert np.array_equal(outs[0], outs[1])
    got = outs[0]
    fit = gmm._em_result(got[:k].copy(), got[k:2 * k].copy(),
                         got[2 * k:3 * k].copy(), float(got[3 * k]),
                         bool(got[3 * k + 2]), int(got[3 * k + 1]), k, n)
    _same_fit(fit, gmm.fit_em_plain([xt], k, *init, cuda_device,
                                    max_iter=max_iter))
    stats = []
    for _ in range(2):
        out = torch.empty(3 * k + 1, dtype=torch.float64, device=cuda_device)
        gmm._em_launch(xt, w, mu, var, out, fit=False, path=path)
        stats.append(out)
    assert torch.equal(stats[0], stats[1])
    np.testing.assert_allclose(stats[0].cpu().numpy(),
                               gmm._em_stats(xt, w, mu, var).cpu().numpy(),
                               rtol=1e-12)


@pytest.mark.gpu
def test_em_stats_one_launch_per_call(cuda_device):
    """Stats mode: one K8 launch per em_stats call on either shape."""
    for n in (1383, 5530, 100_000):
        x = torch.from_numpy(_mixture(n, seed=3)).to(cuda_device)
        w, mu, var = (torch.from_numpy(a).to(cuda_device)
                      for a in _init(x.cpu().numpy(), 3))
        before = cuda_lod.LAUNCHES["gmm_em"]
        for _ in range(3):
            gmm.em_stats(x, w, mu, var)
        assert cuda_lod.LAUNCHES["gmm_em"] == before + 3


@pytest.mark.gpu
def test_em_kernel_stops_at_max_iter_and_raises_on_collapse(cuda_device):
    x = _mixture(5530, seed=1)
    xt = torch.from_numpy(x).to(cuda_device)
    res = gmm.fit_em([xt], 3, *_init(x, 3), cuda_device, max_iter=5)
    assert res.iterations == 5 and not res.converged
    _same_fit(res, gmm.fit_em_plain([xt], 3, *_init(x, 3), cuda_device,
                                    max_iter=5))
    flat = torch.full((4096,), 1000.0, dtype=torch.float64,
                      device=cuda_device)
    with pytest.raises(FloatingPointError):
        gmm.fit_em([flat], 3, *_init(np.full(4096, 1000.0), 3), cuda_device)


@pytest.mark.gpu
def test_fit_gmm_sharded_mesh_runs_k8_stats_mode(cuda_device):
    """A 2x2 mesh of the one card: K8 in stats mode once per shard and
    iteration, the fit equal to the 1x1 mesh's (fit mode) within rtol
    1e-10 with the same iterations."""
    x = _mixture(5530, seed=2)
    init = _init(x, 3)
    one = port_engine.fit_gmm_sharded(x, 3, *init,
                                      make_mesh(1, 1, [cuda_device]))
    before = cuda_lod.LAUNCHES["gmm_em"]
    four = port_engine.fit_gmm_sharded(x, 3, *init,
                                       make_mesh(2, 2, [cuda_device] * 4))
    assert cuda_lod.LAUNCHES["gmm_em"] == before + 4 * four.iterations
    _same_fit(four, one)
