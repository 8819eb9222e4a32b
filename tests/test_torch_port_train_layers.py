"""Train mode of the port's layers and models against the JAX package, on
the same weights (`load_flax_variables`) and the same numpy inputs:
masked BatchNorm (batch statistics over the real rows, running-statistic
update with the unbiased variance, the all-padding guard; 1e-5), the GO
network and `FusedSGCN` train-mode forwards at dropout 0 with their
gradients against `jax.grad` and their updated running statistics, and
the share that dropout and node dropout zero.

Whole-model tolerance: rtol 1e-3 with atol 1e-3 x the tensor's largest
magnitude, on the real rows of a padded batch (the cotangents are 0 on
its padding rows, as the objective's weights are). Not 1e-5: train-mode
batch norm computes the variance as E[x^2] - E[x]^2 over five real rows
of large-mean features (the gene encodings), and that cancellation lifts
fp32 rounding: the port's own fp32 gradients depart from its float64
ones by up to 6e-4 of the magnitude (the decoder norm's scale), and JAX's
by as much. A float64 comparison does not settle it, since the JAX GO
network accumulates its einsums in float32 whatever the input dtype. The
fp32 path is pinned end to end at rtol 2e-4 by the trajectory test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.config import ModelConfig as JaxConfig
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models import nn_compat as jax_nn
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.models.go_network import GeneOntologyNetwork as JaxGO
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models import nn_compat
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.tools.convert import _leaves, load_flax_variables

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_RTOL = 1e-3
NO_DROPOUT = dict(dropout_lin=0.0, dropout_regr=0.0, dropout_go=0.0,
                  dropout_readout=0.0)
W = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)      # two padding rows


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small ops: torch's OpenMP pool costs more than it saves here."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL,
                               atol=MODEL_RTOL * scale, err_msg=what)


def _compare_train_pass(jmod, variables, inputs, model, shapes, w=W,
                        **kwargs):
    """One train-mode pass on both sides from the same weights: the outputs
    on the real rows, the gradients of sum(out * cot) with cot 0 on the
    padding rows, and the updated running statistics; `w` marks the real
    rows."""
    W = w
    rng = np.random.default_rng(3)
    cots = [(rng.normal(size=s) * W.reshape((-1,) + (1,) * (len(s) - 1))
             ).astype(np.float32) for s in shapes]

    def f(p):
        outs, mut = jmod.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            *map(jnp.asarray, inputs), train=True,
            sample_weight=jnp.asarray(W), mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)}, **kwargs)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, mut)

    (_, (want, mut)), grads = jax.device_get(jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"]))
    load_flax_variables(model, variables["params"],
                        variables["batch_stats"]).train()
    got = model(*map(torch.tensor, inputs), sample_weight=torch.tensor(W),
                **kwargs)
    sum((g * torch.tensor(c)).sum() for g, c in zip(got, cots)).backward()
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.detach().numpy()[W > 0], np.asarray(w)[W > 0], f"output {i}")
    want_grads = {"/".join(k.key for k in p): v for p, v in
                  jax.tree_util.tree_leaves_with_path(grads)}
    got_grads = {}
    for path, t, transposed in _leaves(model):
        if path[0] == "params":
            # a parameter the pass does not use (prob_bias outside the
            # masked pass) has no torch gradient and a zero JAX one
            g = (t.grad if t.grad is not None else torch.zeros_like(t)).numpy()
            got_grads["/".join(path[1:])] = g.T if transposed else g
        else:
            node = mut["batch_stats"]
            for key in path[1:]:
                node = node[key]
            _close(t.numpy(), node, "/".join(path))
    assert got_grads.keys() == want_grads.keys()
    for k, w in want_grads.items():
        _close(got_grads[k], w, k)


@pytest.mark.parametrize("shape", [(7, 5), (7, 5, 4)])
@pytest.mark.parametrize("masked", [True, False])
def test_batch_norm_train_mode_matches_jax(shape, masked):
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, shape).astype(np.float32)
    cot = rng.normal(size=shape).astype(np.float32)
    w = W if masked else None
    c = shape[1]
    mod = jax_nn.BatchNorm1d()
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         use_running_average=True)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    stats = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2, c).astype(np.float32)}

    def f(p, xx):
        y, mut = mod.apply({"params": p, "batch_stats": stats}, xx,
                           use_running_average=False,
                           weight=None if w is None else jnp.asarray(w),
                           mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    bn = nn_compat.BatchNorm1d(c)
    load_flax_variables(bn, params, stats).train()
    xt = torch.tensor(x, requires_grad=True)
    yt = bn(xt, None if w is None else torch.tensor(w))
    (yt * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(gp["scale"]),
                               **TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]),
                               **TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new_stats["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new_stats["var"]), **TOL)
    if masked:
        # the padding rows do not enter the statistics
        real = x[W > 0]
        axes = (0, 2) if x.ndim == 3 else (0,)
        n = real.size // c
        np.testing.assert_allclose(
            bn.running_var.numpy(),
            0.9 * stats["var"] + 0.1 * real.var(axis=axes) * n / (n - 1),
            **TOL)


def test_batch_norm_leaves_running_stats_on_an_all_padding_batch():
    bn = nn_compat.BatchNorm1d(5).train()
    with torch.no_grad():
        bn.running_mean.normal_()
    before = (bn.running_mean.clone(), bn.running_var.clone())
    bn(torch.randn(4, 5, 3), torch.zeros(4))
    torch.testing.assert_close(bn.running_mean, before[0], rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, before[1], rtol=0, atol=0)
    bn(torch.randn(4, 5, 3), torch.tensor([1.0, 0, 0, 0]))
    assert not torch.equal(bn.running_mean, before[0])


@pytest.fixture(scope="module")
def inputs():
    c = synthetic_cohort(np.random.default_rng(2), num_subjects=7)
    x, adj, snps = (a.astype(np.float32) for a in (c.x, c.adj, c.snps))
    x[W == 0] = adj[W == 0] = snps[W == 0] = 0.0    # padded as pad_to_batches
    return x, adj, snps


@pytest.mark.parametrize("impl", ["dense", "edge"])
def test_go_network_train_forward_and_grads_match_jax(inputs, impl):
    snps = inputs[2]
    jmod = JaxGO(topo=jax_topology(np.random.default_rng(5)), dim_snps_atten=7,
                 attention_impl=impl, dropout_gcn=0.0, dropout_readout=0.0)
    variables = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(snps)))
    shapes = [o.shape for o in jax.eval_shape(
        lambda: jmod.apply(variables, jnp.asarray(snps)))]
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)),
                                dim_snps_atten=7, attention_impl=impl,
                                dropout_gcn=0.0, dropout_readout=0.0)
    _compare_train_pass(jmod, variables, (snps,), model, shapes)


def test_go_network_edge_form_in_train_mode_at_batch_64_matches_jax():
    """'auto' at batch 64 takes the edge form, whose one-hot aggregation
    and gathers must give the JAX package's train-mode pass and gradients
    (60 real rows, 4 of padding)."""
    c = synthetic_cohort(np.random.default_rng(4), num_subjects=64)
    w = (np.arange(64) < 60).astype(np.float32)
    snps = c.snps.astype(np.float32) * w[:, None]
    jmod = JaxGO(topo=jax_topology(np.random.default_rng(5)), dim_snps_atten=7,
                 dropout_gcn=0.0, dropout_readout=0.0)
    variables = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(snps)))
    shapes = [o.shape for o in jax.eval_shape(
        lambda: jmod.apply(variables, jnp.asarray(snps)))]
    model = GeneOntologyNetwork(synthetic_topology(np.random.default_rng(5)),
                                dim_snps_atten=7, dropout_gcn=0.0,
                                dropout_readout=0.0)
    seen = []
    orig = model._attend
    model._attend = lambda jj, x, use_edge: seen.append(use_edge) or orig(
        jj, x, use_edge)
    _compare_train_pass(jmod, variables, (snps,), model, shapes, w=w)
    assert seen and all(seen)


@pytest.mark.parametrize("is_explain", [False, True])
def test_fused_train_forward_and_grads_match_jax(inputs, is_explain):
    small = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
                 **NO_DROPOUT)
    jmod = JaxFused(cfg=JaxConfig(**small),
                    topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmod.init)(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs)))
    shapes = [o.shape for o in jax.eval_shape(
        lambda: jmod.apply(variables, *map(jnp.asarray, inputs)))]
    model = FusedSGCN(ModelConfig(**small),
                      synthetic_topology(np.random.default_rng(0)))
    _compare_train_pass(jmod, variables, inputs, model, shapes,
                        is_explain=is_explain)


def test_dropout_zeroes_the_expected_share_and_rescales():
    g = torch.Generator().manual_seed(0)
    x = torch.full((400, 500), 2.0)
    y = nn_compat.dropout(x, 0.3, g)
    assert abs(float((y == 0).float().mean()) - 0.3) < 0.01
    assert torch.all((y == 0) | (y == 2.0 / 0.7))
    h = torch.full((64, 300, 4), 3.0)
    z = nn_compat.node_dropout(h, 0.4, g)
    rows_zero = (z == 0).all(dim=2)
    assert torch.all(rows_zero | (z == 3.0 / 0.6).all(dim=2))
    assert abs(float(rows_zero.float().mean()) - 0.4) < 0.01
    state = g.get_state()
    assert nn_compat.dropout(x, 0.0, g) is x
    assert nn_compat.node_dropout(h, 0.0, None) is h
    assert torch.equal(g.get_state(), state)      # rate 0 draws nothing
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        nn_compat.dropout(x, 0.5, None)
