"""Port GO network (`iggcn_tpu_torch/models/go_network.py`) against the JAX
module on the same weights (carried across with `load_flax_variables`) and
the same numpy inputs, both encoder attention implementations, eval mode
with non-trivial BatchNorm running statistics. atol/rtol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.go_network import GeneOntologyNetwork as JaxGO
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.tools.convert import load_flax_variables


def _perturbed_stats(batch_stats, rng):
    """Random running statistics (var > 0), so the eval-mode BN is tested
    with more than its init values."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 2.0, a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.5, a.shape)).astype(np.float32),
        jax.device_get(batch_stats))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jtopo = jax_topology(np.random.default_rng(5))
    snps = rng.random((6, jtopo.num_snps)).astype(np.float32)
    jmod = JaxGO(topo=jtopo, dim_snps_atten=7)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(snps))
    params = jax.device_get(variables["params"])
    stats = _perturbed_stats(variables["batch_stats"], rng)
    return jtopo, snps, params, stats


def test_topology_copy_matches_jax(setup):
    jtopo = setup[0]
    topo = synthetic_topology(np.random.default_rng(5))
    np.testing.assert_array_equal(topo.adj_child_parent, jtopo.adj_child_parent)
    np.testing.assert_array_equal(topo.go_snps, jtopo.go_snps)
    assert topo.pool == jtopo.pool and topo.go_ids == jtopo.go_ids
    for a, b in zip(topo.encoder_masks(3) + topo.decoder_masks(3),
                    jtopo.encoder_masks(3) + jtopo.decoder_masks(3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("impl", ["dense", "edge"])
def test_eval_forward_matches_jax(setup, impl):
    jtopo, snps, params, stats = setup
    want = JaxGO(topo=jtopo, dim_snps_atten=7, attention_impl=impl).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(snps))
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)),
                                dim_snps_atten=7, attention_impl=impl)
    load_flax_variables(model, params, stats).eval()
    with torch.inference_mode():
        got = model(torch.tensor(snps))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_auto_picks_edge_at_batch_64(setup, monkeypatch):
    _, _, params, stats = setup
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)),
                                dim_snps_atten=7, attention_impl="auto")
    load_flax_variables(model, params, stats).eval()
    seen = []
    orig = model._attend
    monkeypatch.setattr(model, "_attend",
                        lambda jj, x, use_edge: seen.append(use_edge)
                        or orig(jj, x, use_edge))
    with torch.inference_mode():
        model(torch.rand(63, 54))
        model(torch.rand(64, 54))
    assert seen == [False, False, True, True]


def test_train_mode_is_refused(setup):
    # train mode with dropout draws only from an explicit generator
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)))
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(torch.rand(2, 54))
