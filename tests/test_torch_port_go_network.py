"""Port GO network (`iggcn_tpu_torch/models/go_network.py`) against the JAX
module on the same weights (carried across with `load_flax_variables`) and
the same numpy inputs, both encoder attention implementations, eval mode
with non-trivial BatchNorm running statistics. atol/rtol 1e-5; the edge
form at the batches that take it (64 and 96) also against the port's
dense form, its gradients against `jax.grad` (rtol 1e-4, atol 1e-6), its
bf16 serving at batch 256 against the JAX package's bf16 path (atol
2e-3), and its topology buffers kept out of the state_dict and bundles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.go_network import GeneOntologyNetwork as JaxGO
from iggcn_tpu.predict import batched_forward_snps as jax_forward_snps
from iggcn_tpu.tools.serve import save_bundle as jax_save_bundle
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.predict import batched_forward_snps
from iggcn_tpu_torch.tools.convert import (_leaves, load_flax_variables,
                                           to_flax_variables)
from iggcn_tpu_torch.tools.serve import save_bundle


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


def _port_model(params, stats, impl):
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)),
                                dim_snps_atten=7, attention_impl=impl)
    return load_flax_variables(model, params, stats).eval()


@pytest.mark.parametrize("batch", [64, 96])
def test_edge_form_at_its_batches_matches_jax(setup, batch):
    """'auto' takes the edge form from batch 64 on, in both packages: the
    port's one-hot aggregation against the JAX package's."""
    jtopo, _, params, stats = setup
    snps = np.random.default_rng(batch).random(
        (batch, jtopo.num_snps)).astype(np.float32)
    want = jax.jit(JaxGO(topo=jtopo, dim_snps_atten=7).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(snps))
    model = _port_model(params, stats, "auto")
    with torch.inference_mode():
        got = model(torch.tensor(snps))
        dense = _port_model(params, stats, "dense")(torch.tensor(snps))
    for g, d, w in zip(got, dense, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        # and the port's two forms agree
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_edge_form_gradients_match_jax_grad(setup):
    """Every parameter's gradient of sum(outputs x cotangents) through the
    edge form (eval mode, batch 64) against `jax.grad` of the same loss,
    rtol 1e-4 and atol 1e-6 per unit of the gradient's largest entry: a
    batch-norm scale's gradient sums 64 rows of terms up to ~10 and can
    cancel to ~1e-2, where the order of fp32 summation alone moves it by
    a few 1e-6."""
    jtopo, _, params, stats = setup
    rng = np.random.default_rng(11)
    snps = rng.random((64, jtopo.num_snps)).astype(np.float32)
    jmod = JaxGO(topo=jtopo, dim_snps_atten=7, attention_impl="edge")
    shapes = [o.shape for o in jax.eval_shape(lambda: jmod.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(snps)))]
    cots = [rng.normal(size=s).astype(np.float32) for s in shapes]

    def loss(p):
        outs = jmod.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(snps))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    want = {"/".join(k.key for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_leaves_with_path(
                jax.jit(jax.grad(loss))(params))}
    model = _port_model(params, stats, "edge")
    outs = model(torch.tensor(snps))
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    got = {}
    for path, t, transposed in _leaves(model):
        if path[0] == "params":
            g = (t.grad if t.grad is not None else torch.zeros_like(t))
            got["/".join(path[1:])] = g.numpy().T if transposed else g.numpy()
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=k)


def test_topology_buffers_stay_out_of_state_dict_and_bundles(setup, tmp_path):
    """The edge form's one-hots (`agg_i`, `pick_i`) are topology, not
    weights: the state_dict holds the parameters and the batch norms'
    running statistics only, and the exported bundle is the JAX package's
    own, array for array."""
    jtopo, _, params, stats = setup
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)),
                                dim_snps_atten=7, classifier=True)
    assert {f"agg_{i}" for i in range(model.n_l)} <= dict(
        model.named_buffers()).keys()
    weights = {n for n, _ in model.named_parameters()} | {
        n for n, _ in model.named_buffers() if "running_" in n}
    assert set(model.state_dict()) == weights
    variables = to_flax_variables(model)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_bundle(port_path, model)
    jax_save_bundle(jax_path, JaxGO(topo=jtopo, dim_snps_atten=7),
                    variables["params"], variables["batch_stats"])
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            if k != "__meta__":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bf16_serving_at_batch_256_matches_jax_bf16(setup):
    """The served bf16 forward takes the edge form at the serving batch;
    its sums stay fp32 (the JAX einsums' preferred_element_type), so the
    SNP-only bundle's probabilities agree with the JAX package's bf16 path
    within the port's bf16 serving atol."""
    jtopo, _, params, stats = setup
    topo = synthetic_topology(np.random.default_rng(5))
    model = GeneOntologyNetwork(topo, classifier=True,
                                generator=torch.Generator().manual_seed(3))
    model.eval()
    variables = to_flax_variables(model)
    snps = np.random.default_rng(7).random(
        (300, jtopo.num_snps)).astype(np.float32)
    want = jax_forward_snps(JaxGO(topo=jtopo), variables["params"],
                            variables["batch_stats"], snps, batch_size=256,
                            dtype=jnp.bfloat16)
    got = batched_forward_snps(model, snps, batch_size=256,
                               dtype=torch.bfloat16)
    np.testing.assert_allclose(got["prob"], want["prob"], rtol=0, atol=2e-3)
    decided = np.abs(want["prob"] - 0.5) > 1e-2
    np.testing.assert_array_equal(got["pred"][decided], want["pred"][decided])
