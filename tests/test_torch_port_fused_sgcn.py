"""Port flagship model (`iggcn_tpu_torch/models/fused_sgcn.py`) and weight
conversion (`tools/convert.py`) against the JAX `FusedSGCN`: the same flax
variables, the same numpy batch, all six `FusedOutputs` fields in plain and
explain mode, at small widths. rtol/atol 1e-5 (`our_reg` rtol 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.config import ModelConfig as JaxConfig
from iggcn_tpu.data.adni import synthetic_cohort
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.tools.convert import load_flax_variables, to_flax_variables

SMALL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8)


@pytest.fixture(scope="module")
def batch():
    c = synthetic_cohort(np.random.default_rng(1), num_subjects=6)
    return tuple(a.astype(np.float32) for a in (c.x, c.adj, c.snps))


def _jax_variables(cfg, batch, seed=0):
    model = JaxFused(cfg=cfg, topo=jax_topology(np.random.default_rng(0)))
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    *map(jnp.asarray, batch))
    # random running statistics, so eval-mode BN is exercised
    rng = np.random.default_rng(seed + 7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 2.0, a.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.3, a.shape)).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    return model, jax.device_get(variables["params"]), stats


def _port(cfg_kwargs, params, stats):
    model = FusedSGCN(ModelConfig(**cfg_kwargs),
                      synthetic_topology(np.random.default_rng(0)))
    return load_flax_variables(model, params, stats).eval()


def _compare(jmodel, params, stats, port, batch, is_explain):
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        *map(jnp.asarray, batch), is_explain=is_explain)
    with torch.inference_mode():
        got = port(*map(torch.tensor, batch), is_explain=is_explain)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-4 if name == "our_reg"
                                   else 1e-5, atol=1e-5, err_msg=name)


VARIANTS = {
    "default": {},
    "graph_pool": {"graph_pool": True},
    "model4eachregr": {"model4eachregr": True},
    "image_only": {"is_image_only": True},
    "snps_only": {"is_snps_only": True},
    "concat_fusion": {"is_cross_atten": False},
    "no_prob4regr": {"is_use_prob4regr": False},
    "three_layers_edge": {"num_layers": 3, "go_attention_impl": "edge"},
}


@pytest.fixture(scope="module")
def initialised(batch):
    """Per-variant JAX init, shared by the plain and the explain case."""
    cache = {}

    def get(variant):
        if variant not in cache:
            kwargs = {**SMALL, **VARIANTS[variant]}
            jmodel, params, stats = _jax_variables(JaxConfig(**kwargs), batch)
            cache[variant] = (jmodel, params, stats,
                              _port(kwargs, params, stats))
        return cache[variant]
    return get


@pytest.mark.parametrize("is_explain", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_outputs_match_jax(batch, initialised, variant, is_explain):
    _compare(*initialised(variant), batch, is_explain)


def test_raw_x_feeds_prob4regr(batch):
    """The regression input uses raw_x (the unmasked features) when given."""
    jmodel, params, stats = _jax_variables(JaxConfig(**SMALL), batch)
    port = _port(SMALL, params, stats)
    x, adj, snps = batch
    raw = x + 1.0
    want = jmodel.apply({"params": params, "batch_stats": stats},
                        *map(jnp.asarray, batch), raw_x=jnp.asarray(raw))
    with torch.inference_mode():
        got = port(*map(torch.tensor, batch), raw_x=torch.tensor(raw))
    np.testing.assert_allclose(got.our_reg.numpy(), np.asarray(want.our_reg),
                               rtol=1e-4, atol=1e-5)


def test_flax_round_trip_and_strict_keys(batch):
    _, params, stats = _jax_variables(JaxConfig(**SMALL), batch)
    port = _port(SMALL, params, stats)
    back = to_flax_variables(port)
    want = jax.tree_util.tree_leaves_with_path({"params": params,
                                               "batch_stats": stats})
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)

    fresh = FusedSGCN(ModelConfig(**SMALL),
                      synthetic_topology(np.random.default_rng(0)))
    missing = {**params}
    missing.pop("prob")
    with pytest.raises(KeyError, match="prob"):
        load_flax_variables(fresh, missing, stats)
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_variables(fresh, {**params, "stray": np.zeros(2)}, stats)
    bad = {**params, "conv_w_0": np.zeros((3, 9), np.float32)}
    with pytest.raises(ValueError, match="conv_w_0"):
        load_flax_variables(fresh, bad, stats)


def test_config_fields_and_defaults_match_jax():
    assert ([f.name for f in dataclasses.fields(ModelConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JaxConfig())


@pytest.mark.parametrize("use_pallas_gcn", [False, True])
def test_imaging_stack_always_goes_through_fused_gcn_stack(batch, monkeypatch,
                                                           use_pallas_gcn):
    """The stack runs through `fused_gcn_stack` whatever `use_pallas_gcn`
    says: the device, not the flag, picks the kernel. P reaches it in the
    transposed layout `gcn_propagation_matrix` returns, with no copy."""
    import iggcn_tpu_torch.models.fused_sgcn as fused_module
    from iggcn_tpu_torch.ops.gcn_stack import _prop_transposed

    calls = []
    real = fused_module.fused_gcn_stack
    monkeypatch.setattr(fused_module, "fused_gcn_stack",
                        lambda *a: calls.append(_prop_transposed(a[0])) or real(*a))
    model = FusedSGCN(ModelConfig(**SMALL, use_pallas_gcn=use_pallas_gcn),
                      synthetic_topology(np.random.default_rng(0))).eval()
    with torch.inference_mode():
        model(*map(torch.tensor, batch))
        model(*map(torch.tensor, batch), is_explain=True)
    assert calls == [True, True]


def test_gat_and_train_mode_are_refused():
    topo = synthetic_topology(np.random.default_rng(0))
    # use_gat builds the dense GAT stack (held against JAX in
    # test_torch_port_families.py): GAT leaves in place of the GCN ones
    names = {n for n, _ in FusedSGCN(ModelConfig(**SMALL, use_gat=True),
                                     topo).named_parameters()}
    assert {"gat_w_0", "gat_att_src_1", "gat_b_1"} <= names
    assert not any(n.startswith("conv_") for n in names)
    # train mode with dropout draws only from an explicit generator
    model = FusedSGCN(ModelConfig(**SMALL), topo)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model(torch.zeros(2, 90, 3), torch.zeros(2, 90, 90),
              torch.zeros(2, 54))
