"""The port against the JAX package over whole training runs, on the CPU:
a 30-epoch, 60-subject case of `scripts/convergence_ab_torch.py` per
trainer family (SGCN_GCN_CLUSTERLABEL runs in
`test_torch_port_convergence_cluster.py`). From the JAX init, loaded
into the port, on each package's own planted-signal cohort (bit-equal),
full batch, dropout 0: the first three epochs' losses agree to rtol
2e-4, the last to 0.05 (0.15 for the SNP family, still in steep descent
at 30 epochs, as `tests/test_convergence_ab.py` bounds it), both
packages learn, and the held-out predictions agree but for near-ties
(class margin below 0.1 in either package)."""
import os
import sys

import jax
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import convergence_ab_torch as ab  # noqa: E402

EPOCHS, SUBJECTS = 30, 60


@pytest.fixture(autouse=True, scope="module")
def fast_compiles():
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def assert_agrees(r):
    """Every bound of the harness, each with the run's summary."""
    summary = {k: v for k, v in r.items() if k != "losses"}
    assert r["learned_jax"] and r["learned_port"], summary
    assert r["early_rel"] <= ab.EARLY_RTOL, summary
    assert r["final_rel"] <= ab.final_rtol(r["family"], r["epochs"]), summary
    assert not r["disagreements"], summary
    assert all(t["margin_jax"] < ab.TIE_MARGIN or t["margin_port"]
               < ab.TIE_MARGIN for t in r["near_ties"]), summary
    assert r["ok"], summary


@pytest.mark.parametrize("family", ["fused", "gcn", "guide", "sgcn", "snps",
                                    "zoo"])
def test_port_converges_with_jax(family):
    assert_agrees(ab.run_convergence_ab(family, epochs=EPOCHS,
                                        subjects=SUBJECTS))
