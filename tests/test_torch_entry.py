"""The port's entry points (garlic_tpu_torch/entry.py) on the CPU, and
entry()'s K2 launch on the card (gpu-marked).

entry() builds the inputs of the root __graft_entry__.py's entry() (the
same seeded draws) and runs K2 where garlic_tpu's runs its window scan:
K2's above plane must be garlic_tpu's windows >= the cutoff wherever a
window lies further than 1e-4 from it (f32 sums in another order), and
its covered plane the coverage count of that plane.  dryrun_multichip
drives every sharded phase over ["cpu"] * n and raises on any
disagreement (the fused and split coverage, the frequencies' range, the
KDE's and the EM's finiteness).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from garlic_tpu_torch import entry as port_entry
from garlic_tpu_torch.ops import cuda_lod


def test_entry_runs_k2_over_garlic_tpus_inputs():
    import importlib
    jax_entry = importlib.import_module("__graft_entry__").entry
    fn, args = port_entry.entry("cpu")
    before = dict(cuda_lod.LAUNCHES)
    cov, susw, above = fn(*args)
    assert cuda_lod.LAUNCHES == before  # CPU tensors: the plain version
    jfn, jargs = jax_entry()
    W, cut = 60, 1.5
    win = np.asarray(jfn(*jargs))[:, :4096 - W + 1]  # the window starts
    assert above.shape == win.shape and cov.shape == (64, 4096)
    far = np.abs(win - cut) > 1e-4
    assert far.mean() > 0.99
    np.testing.assert_array_equal(above.numpy().astype(bool)[far],
                                  (win >= cut)[far])
    counts = cuda_lod.window_counts(above.bool(), W).numpy()
    np.testing.assert_array_equal(cov.numpy().astype(bool),
                                  counts >= np.ceil(0.25 * W))
    assert not susw.numpy().any()  # no tie band


@pytest.mark.parametrize("n", [8, 4, 1])
def test_dryrun_multichip_on_cpu(n):
    before = dict(cuda_lod.LAUNCHES)
    port_entry.dryrun_multichip(n, ["cpu"] * 8)
    assert cuda_lod.LAUNCHES == before


def test_dryrun_needs_the_devices():
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        port_entry.dryrun_multichip(4, ["cpu"] * 2)


@pytest.mark.gpu
def test_entry_on_card_equals_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fn, args = port_entry.entry()
    before = cuda_lod.LAUNCHES["covered"]
    got = fn(*args)
    assert cuda_lod.LAUNCHES["covered"] == before + 1
    want = fn(*(a.cpu() for a in args))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    port_entry.dryrun_multichip(4, ["cuda:0"] * 4)
