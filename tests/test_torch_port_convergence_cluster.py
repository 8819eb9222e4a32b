"""SGCN_GCN_CLUSTERLABEL's cases of `scripts/convergence_ab_torch.py`
(the other families' are in `test_torch_port_convergence.py`).

At 30 epochs and 60 subjects one held-out subject of this family sits
where fp32 rounding alone moves its class margin by more than the
near-tie rule's 0.1, and the JAX package's fp32 run is the one that
parts from exact arithmetic (`--family cluster --epochs 30 --subjects 60
--exact`, XLA's optimisations off as here: subject 7's log p1 - log p0
reads -3.52 in the JAX package's float64 run, -4.51 in the port's,
-3.22 in the port's fp32 and +0.91 in the JAX package's fp32). So at
that size the port is held to the JAX package's float64 run, and to the
JAX package's fp32 run at the script's default, 300 epochs and 120
subjects, both under the same bounds."""
import pytest

from tests.test_torch_port_convergence import (EPOCHS, SUBJECTS, ab,
                                               assert_agrees, fast_compiles,
                                               one_thread)

# pytest takes the two autouse fixtures from this module's names
__all__ = ["fast_compiles", "one_thread"]


@pytest.mark.parametrize("family", ["cluster"])
def test_port_converges_with_jax_at_the_default_run(family):
    assert_agrees(ab.run_convergence_ab(family))


@pytest.mark.parametrize("family", ["cluster"])
def test_port_agrees_with_the_jax_float64_run(family):
    r = ab.run_convergence_ab(family, epochs=EPOCHS, subjects=SUBJECTS,
                              exact=True)
    witness = r["exact"]["port_against_witness"]
    assert witness["ok"], r["exact"]
