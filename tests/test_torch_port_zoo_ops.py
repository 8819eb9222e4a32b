"""The port's zoo pooling ops and zoo data builders against the JAX package
on the same NumPy inputs, on the CPU:

  * every function of `ops/pool.py` (and `models/nested.py:
    subgraph_mean_pool`) on variable-size masked batches (graphs of 7, 5,
    3 and 1 valid nodes): float outputs within atol 1e-5, masks and
    selections equal. `topk_pool` and `sort_pool` also on inputs with
    exact ties (duplicated rows; a relu's zeros in the last channel) so
    that the stable ranking is held, `sort_pool` with N < k and N > k,
    `diff_pool` with and without `sample_weight`;
  * `greedy_matching`, `data/tu.py` (`read_tu_dir` on the TUTEST fixture,
    `synthetic_tu_dataset`, the degree features), `data/statistics.py`
    and `data/nested.py:create_nested_dataset` for every `node_label`,
    `use_rd`, `use_return_prob` and `max_nodes_per_hop`, on TUTEST and on
    the synthetic TU benchmark: bit-equal."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.data import nested as jax_nested
from iggcn_tpu.data import statistics as jax_stats
from iggcn_tpu.data import tu as jax_tu
from iggcn_tpu.models.nested import subgraph_mean_pool as jax_sub_pool
from iggcn_tpu.ops import pool as jax_pool
from iggcn_tpu_torch.data import nested, statistics, tu
from iggcn_tpu_torch.models.nested import subgraph_mean_pool
from iggcn_tpu_torch.ops import pool

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
B, N, F = 4, 7, 5
SIZES = (7, 5, 3, 1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed=0, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, F)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.asarray(SIZES)[:, None]
    adj = (rng.random((B, N, N)) < 0.4).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1)) * mask[:, :, None] \
        * mask[:, None, :]
    if ties:
        x[:, 1] = x[:, 0]                    # equal scores, equal keys
        x[:, 4] = x[:, 2]
        x[..., -1] = np.maximum(x[..., -1], 0.0)   # a relu's exact zeros
        x[:, 3, -1] = 0.0
    return x, adj, mask


def _case(name):
    """(jax fn, port fn, numpy args) of one case."""
    x, adj, mask = _batch(ties=name.endswith("ties"))
    rng = np.random.default_rng(1)
    w_self, w_nb = (rng.normal(size=(F, 3)).astype(np.float32)
                    for _ in range(2))
    bias = rng.normal(size=3).astype(np.float32)
    base = name.replace("_ties", "")
    if base in ("mean_pool", "max_pool", "add_pool"):
        return getattr(jax_pool, base), getattr(pool, base), (x, mask)
    if base == "neighbor_mean":
        return jax_pool.neighbor_mean, pool.neighbor_mean, (x, adj)
    if base == "sage_conv":
        return (jax_pool.sage_conv, pool.sage_conv,
                (x, adj, w_self, w_nb, bias))
    if base == "gin_conv_aggregate":
        eps = np.float32(0.3)
        return (jax_pool.gin_conv_aggregate, pool.gin_conv_aggregate,
                (x, adj, eps))
    if base == "topk_pool":
        w = rng.normal(size=F).astype(np.float32)
        return (lambda *a: jax_pool.topk_pool(*a, ratio=0.6),
                lambda *a: pool.topk_pool(*a, ratio=0.6), (x, adj, mask, w))
    if base.startswith("sort_pool"):
        k = 10 if base.endswith("short") else 4
        return (lambda a, m: jax_pool.sort_pool(a, m, k),
                lambda a, m: pool.sort_pool(a, m, k), (x, mask))
    if base == "set2set":
        h = F
        params = [rng.uniform(-0.4, 0.4, size=s).astype(np.float32)
                  for s in ((4 * h, 2 * h), (4 * h, h), (4 * h,), (4 * h,))]
        return (lambda a, m, *p: jax_pool.set2set(
                    a, m, jax_pool.Set2SetParams(*p)),
                lambda a, m, *p: pool.set2set(a, m, pool.Set2SetParams(*p)),
                (x, mask, *params))
    if base == "global_attention_pool":
        gate = rng.normal(size=(B, N, 1)).astype(np.float32)
        return (jax_pool.global_attention_pool, pool.global_attention_pool,
                (x, mask, gate))
    if base.startswith("diff_pool"):
        s_logits = rng.normal(size=(B, N, 3)).astype(np.float32)
        args = (x, adj, s_logits, mask)
        if base.endswith("weighted"):
            args = args + (np.array([1, 1, 0, 1], np.float32),)
        return jax_pool.diff_pool, pool.diff_pool, args
    if base == "cluster_max_pool":
        assign = np.stack([jax_pool.greedy_matching(a) for a in adj])
        return (lambda *a: jax_pool.cluster_max_pool(*a, N),
                lambda *a: pool.cluster_max_pool(*a, N),
                (x, adj, mask, assign))
    if base == "subgraph_mean_pool":
        assign = rng.integers(0, 3, size=(B, N))
        return (lambda *a: jax_sub_pool(*a, 3),
                lambda *a: subgraph_mean_pool(*a, 3), (x, assign, mask))
    raise ValueError(name)


CASES = ["mean_pool", "max_pool", "add_pool", "neighbor_mean", "sage_conv",
         "gin_conv_aggregate", "topk_pool", "topk_pool_ties", "sort_pool",
         "sort_pool_ties", "sort_pool_short", "sort_pool_short_ties",
         "set2set", "global_attention_pool", "diff_pool",
         "diff_pool_weighted", "cluster_max_pool", "subgraph_mean_pool"]


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", CASES)
def test_pool_op_matches_jax(name):
    jax_fn, port_fn, args = _case(name)
    want = _outputs(jax_fn(*(jnp.asarray(a) for a in args)))
    got = _outputs(port_fn(*(torch.as_tensor(a) for a in args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_ties_select_the_lower_index():
    """With duplicated rows the stable ranking keeps the first copy."""
    x, adj, mask = _batch(ties=True)
    w = np.ones(F, np.float32)
    res = pool.topk_pool(*(torch.as_tensor(a) for a in (x, adj, mask, w)),
                         ratio=0.6)
    keep = res.mask.numpy()
    for b in range(B):
        if keep[b, 1] and not keep[b, 0]:
            pytest.fail(f"graph {b}: kept the later of two equal scores")
    order = pool.sort_pool(torch.as_tensor(x), torch.as_tensor(mask), N)
    np.testing.assert_array_equal(order[0, :, -1].numpy(),
                                  -np.sort(-np.where(mask[0], x[0, :, -1],
                                                     0.0)))


def _assert_same_dataset(got, want):
    fields = [f for f in vars(want) if not f.startswith("_")]
    assert sorted(vars(got)) == sorted(vars(want))
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f


def test_tu_builders_are_bit_equal():
    _assert_same_dataset(tu.read_tu_dir(FIXTURES, "TUTEST"),
                         jax_tu.read_tu_dir(FIXTURES, "TUTEST"))
    for seed, kw in ((1000, {}), (3, dict(num_graphs=20, n_min=3, n_max=9,
                                          num_classes=3, feat_dim=4))):
        got = tu.synthetic_tu_dataset(np.random.default_rng(seed), **kw)
        want = jax_tu.synthetic_tu_dataset(np.random.default_rng(seed), **kw)
        _assert_same_dataset(got, want)
        assert statistics.dataset_statistics(got, "s") == \
            jax_stats.dataset_statistics(want, "s")
    adjs = [a[:n, :n] for a, n in zip(want.adj, want.mask.sum(1))]
    for g, w in zip(tu.normalized_degree_features(adjs),
                    jax_tu.normalized_degree_features(adjs)):
        np.testing.assert_array_equal(g, w)
    for a in adjs:
        np.testing.assert_array_equal(pool.greedy_matching(a),
                                      jax_pool.greedy_matching(a))
    with pytest.raises(FileNotFoundError):
        tu.read_tu_dir(FIXTURES, "NONE")


@pytest.fixture(scope="module")
def sources():
    return {"TUTEST": tu.read_tu_dir(FIXTURES, "TUTEST"),
            "SYNTH": tu.synthetic_tu_dataset(np.random.default_rng(1000))}


@pytest.mark.parametrize("data, kw", [
    ("TUTEST", dict(h=1)),
    ("TUTEST", dict(h=2, node_label="drnl", use_rd=True)),
    ("SYNTH", dict(h=2)),
    ("SYNTH", dict(h=2, node_label="spd")),
    ("SYNTH", dict(h=2, node_label="spd2", use_rd=True)),
    ("SYNTH", dict(h=3, node_label="spd3")),
    ("SYNTH", dict(h=1, use_return_prob=True, return_prob_steps=4)),
    ("SYNTH", dict(h=2, max_nodes_per_hop=2, seed=7)),
], ids=["tutest-hop", "tutest-drnl-rd", "synth-hop", "synth-spd",
        "synth-spd2-rd", "synth-spd3", "synth-rp", "synth-max-per-hop"])
def test_nested_dataset_is_bit_equal(sources, data, kw):
    ds = sources[data]
    got = nested.create_nested_dataset(ds, **kw)
    want = jax_nested.create_nested_dataset(
        jax_tu.GraphDataset(**{f: getattr(ds, f) for f in (
            "x", "adj", "mask", "y", "assign", "num_classes")}), **kw)
    _assert_same_dataset(got, want)
