"""The port's programmatic API (garlic_tpu_torch.api) against garlic_tpu's
(garlic_tpu.api) on the same seeded panel.

The port's fast engine runs here with device="cpu" (the kernels' plain
versions); garlic_tpu's runs on JAX-CPU.

Tolerances:
- engine="exact": calls, lengths, cutoff, bounds and the KDE's x
  identical (the same f64 code);
- engine="fast", pinned: calls identical, on a cutoff that the test
  holds at least 1e-3 away from every window (the API has no tie patrol,
  so a window within f32 rounding of the cutoff may decide either way);
- engine="fast", automatic: the KDE's y within 1e-5 * max y (f32 window
  sums and transforms in another order) and the cutoff at the same grid
  index.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from garlic_tpu_torch import api

sys.path.insert(0, os.path.dirname(__file__))
from util import make_panel, write_tgls, write_tped  # noqa: E402

Y_TOL = 1e-5
BOUNDS = [300000.0, 800000.0]


@pytest.fixture(scope="module")
def api_dir(tmp_path_factory):
    """The verify recipe's panel (40 x (8000, 6000), seed 1: its KDE and
    GMM are not degenerate), with a GQ TGLS file."""
    wd = tmp_path_factory.mktemp("port_api")
    panel = make_panel(nind=40, nloci_per_chr=(8000, 6000), seed=1)
    write_tped(panel, str(wd / "p.tped.gz"), str(wd / "p.tfam"))
    write_tgls(panel, str(wd / "GQ.tgls.gz"), gl_type="GQ")
    return str(wd)


def _panels(wd, **kw):
    from garlic_tpu import api as gt_api
    args = (f"{wd}/p.tped.gz", f"{wd}/p.tfam")
    return (api.load_panel(*args, build="hg18", **kw),
            gt_api.load_panel(*args, build="hg18", **kw), gt_api)


def _gap_cutoff(ds, winsize=60, near=1.3):
    """A cutoff near `near` whose nearest exact window value lies more
    than 1e-3 away: the midpoint of the widest gap between the sorted
    live window values within 0.1 of `near`."""
    from garlic_tpu_torch.core.types import MISSING
    from garlic_tpu_torch.ops import lod
    vals = []
    for c in ds.chroms:
        w = lod.calc_lod_windows(c, ds._centro, winsize, 0.001, 200000)
        vals.append(w[(w != MISSING) & (np.abs(w - near) < 0.1)])
    v = np.sort(np.concatenate(vals))
    k = int(np.argmax(np.diff(v)))
    cut = float((v[k] + v[k + 1]) / 2)
    assert np.abs(np.concatenate(vals) - cut).min() > 1e-3
    return cut


def _same_result(got, want):
    assert got.to_rows() == want.to_rows()
    assert np.array_equal(got.lengths, want.lengths)
    assert got.cutoff == want.cutoff
    assert got.bounds == want.bounds
    assert got.winsize == want.winsize and got.chrom_names == want.chrom_names


@pytest.mark.parametrize("tgls", [None, "GQ.tgls.gz"], ids=["plain", "gq"])
def test_exact_pinned_matches_garlic_tpu(api_dir, tgls):
    kw = {} if tgls is None else {"tgls": f"{api_dir}/{tgls}",
                                  "gl_type": "GQ"}
    ds, gds, gt_api = _panels(api_dir, **kw)
    got = api.call_roh(ds, winsize=60, cutoff=1.3, bounds=BOUNDS)
    want = gt_api.call_roh(gds, winsize=60, cutoff=1.3, bounds=BOUNDS)
    assert len(got.to_rows()) >= 10 and got.kde is None
    _same_result(got, want)


def test_exact_automatic_matches_garlic_tpu(api_dir):
    ds, gds, gt_api = _panels(api_dir)
    got = api.call_roh(ds, winsize=60)
    want = gt_api.call_roh(gds, winsize=60)
    assert got.kde.size == 512 and len(got.bounds) == 2
    assert np.array_equal(got.kde.x, want.kde.x)
    assert np.array_equal(got.kde.y, want.kde.y)
    _same_result(got, want)


def test_fast_pinned_matches_garlic_tpu(api_dir):
    ds, gds, gt_api = _panels(api_dir)
    cut = _gap_cutoff(ds)
    got = api.call_roh(ds, winsize=60, cutoff=cut, bounds=BOUNDS,
                       engine="fast", device="cpu")
    want = gt_api.call_roh(gds, winsize=60, cutoff=cut, bounds=BOUNDS,
                           engine="fast")
    exact = api.call_roh(ds, winsize=60, cutoff=cut, bounds=BOUNDS)
    assert len(got.to_rows()) >= 10
    _same_result(got, want)
    _same_result(got, exact)


def test_fast_automatic_matches_garlic_tpu(api_dir):
    ds, gds, gt_api = _panels(api_dir)
    got = api.call_roh(ds, winsize=60, engine="fast", device="cpu")
    want = gt_api.call_roh(gds, winsize=60, engine="fast")
    y = want.kde.y
    assert np.abs(got.kde.y - y).max() <= Y_TOL * y.max()
    assert np.flatnonzero(got.kde.x == got.cutoff).tolist() == \
        np.flatnonzero(want.kde.x == want.cutoff).tolist()
    assert np.isfinite(got.cutoff) and got.bounds[0] < got.bounds[1]


def test_load_panel_cache_round_trip(api_dir):
    """panel_cache=True writes the port's sidecar, then reads it back; the
    calls are those of the uncached load."""
    import shutil
    wd = api_dir
    shutil.copy(f"{wd}/p.tped.gz", f"{wd}/pc.tped.gz")
    runs = []
    for _ in range(2):
        ds = api.load_panel(f"{wd}/pc.tped.gz", f"{wd}/p.tfam", build="hg18",
                            panel_cache=True)
        runs.append(api.call_roh(ds, winsize=60, cutoff=1.3, bounds=BOUNDS))
    assert os.path.exists(f"{wd}/pc.tped.gz.gtpc")
    ds = api.load_panel(f"{wd}/p.tped.gz", f"{wd}/p.tfam", build="hg18")
    plain = api.call_roh(ds, winsize=60, cutoff=1.3, bounds=BOUNDS)
    for r in runs:
        _same_result(r, plain)


def test_fast_engine_without_cuda_raises(api_dir, monkeypatch):
    ds, _, _ = _panels(api_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='engine="exact"'):
        api.call_roh(ds, winsize=60, cutoff=1.3, bounds=BOUNDS,
                     engine="fast")


def test_mesh_is_not_ported(api_dir):
    """The call this test once saw refused: call_roh(mesh=...) now shards
    K1 over the mesh (here two CPU devices) and gives the single-device
    calls (tests/test_torch_mesh.py holds it to garlic_tpu's mesh calls);
    an unknown engine still raises."""
    from garlic_tpu_torch.parallel.mesh import make_mesh
    ds, _, _ = _panels(api_dir)
    cut = _gap_cutoff(ds)
    got = api.call_roh(ds, winsize=60, cutoff=cut, bounds=BOUNDS,
                       engine="fast", mesh=make_mesh(2, 1, ["cpu", "cpu"]))
    assert len(got.to_rows()) >= 10
    _same_result(got, api.call_roh(ds, winsize=60, cutoff=cut, bounds=BOUNDS,
                                   engine="fast", device="cpu"))
    with pytest.raises(ValueError, match="unknown engine"):
        api.call_roh(ds, winsize=60, engine="auto")


@pytest.mark.gpu
def test_api_on_card(api_dir):
    """On the card: the pinned fast calls equal the exact engine's on a
    cutoff away from every window, and the automatic fast call picks a
    finite cutoff and two ordered bounds, with K1 run per chromosome."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from garlic_tpu_torch.ops import cuda_lod
    ds = api.load_panel(f"{api_dir}/p.tped.gz", f"{api_dir}/p.tfam",
                        build="hg18")
    cut = _gap_cutoff(ds)
    before = cuda_lod.LAUNCHES["lod_windows"]
    got = api.call_roh(ds, winsize=60, cutoff=cut, bounds=BOUNDS,
                       engine="fast")
    assert cuda_lod.LAUNCHES["lod_windows"] == before + 2
    _same_result(got, api.call_roh(ds, winsize=60, cutoff=cut,
                                   bounds=BOUNDS))
    auto = api.call_roh(ds, winsize=60, engine="fast")
    assert np.isfinite(auto.cutoff) and auto.bounds[0] < auto.bounds[1]
    exact = api.call_roh(ds, winsize=60)
    assert np.abs(auto.kde.y - exact.kde.y).max() <= Y_TOL * exact.kde.y.max()
