"""Port ops (`iggcn_tpu_torch/ops/{gcn,attention,masking}.py`) against their
JAX counterparts on the same numpy inputs, fp32 on the CPU, atol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.ops import attention as jattn
from iggcn_tpu.ops import gcn as jgcn
from iggcn_tpu.ops import masking as jmask
from iggcn_tpu_torch.ops import attention as tattn
from iggcn_tpu_torch.ops import gcn as tgcn
from iggcn_tpu_torch.ops import masking as tmask

ATOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(port, ref, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _adjacency(rng, b=3, n=12):
    """Non-negative sparse adjacency with some nonzero diagonals, some zero
    diagonals, and one isolated node (no edges, zero diagonal) per sample."""
    adj = rng.random((b, n, n)).astype(np.float32)
    adj[adj < 0.6] = 0.0
    diag = np.arange(n)
    adj[:, diag, diag] = np.where(rng.random((b, n)) < 0.5,
                                  rng.random((b, n)) + 0.5, 0.0)
    adj[:, 3, :] = 0.0
    adj[:, :, 3] = 0.0
    return adj


@pytest.mark.parametrize("improved", [False, True])
@pytest.mark.parametrize("add_self_loops", [True, False])
def test_propagation_matrix_matches_jax(add_self_loops, improved):
    adj = _adjacency(np.random.default_rng(0))
    ref = jgcn.gcn_propagation_matrix(jnp.asarray(adj),
                                      add_self_loops=add_self_loops,
                                      improved=improved)
    port = tgcn.gcn_propagation_matrix(_t(adj), add_self_loops=add_self_loops,
                                       improved=improved)
    _close(port, ref)
    if not add_self_loops:
        # the isolated node's row and column are exactly zero (inf -> 0)
        assert float(port[:, 3].abs().sum()) == 0.0


def test_gcn_conv_matches_jax():
    rng = np.random.default_rng(1)
    adj = _adjacency(rng)
    x = rng.normal(size=(3, 12, 4)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    prop = np.asarray(jgcn.gcn_propagation_matrix(jnp.asarray(adj)))
    ref = jgcn.gcn_conv(jnp.asarray(x), jnp.asarray(prop), jnp.asarray(w),
                        jnp.asarray(b))
    _close(tgcn.gcn_conv(_t(x), _t(prop), _t(w), _t(b)), ref)


def test_cross_attention_matches_jax():
    rng = np.random.default_rng(2)
    e, heads = 8, 2
    params = [rng.normal(0, 0.3, s).astype(np.float32)
              for s in ((3 * e, e), (3 * e,), (e, e), (e,))]
    q = rng.normal(size=(3, 10, e)).astype(np.float32)
    kv = rng.normal(size=(3, 6, e)).astype(np.float32)
    ref_out, ref_w = jattn.multihead_cross_attention(
        jattn.MHAParams(*map(jnp.asarray, params)), jnp.asarray(q),
        jnp.asarray(kv), jnp.asarray(kv), heads)
    out, w = tattn.multihead_cross_attention(
        tattn.MHAParams(*map(_t, params)), _t(q), _t(kv), _t(kv), heads)
    _close(out, ref_out)
    _close(w, ref_w)
    assert w.shape == (3, 10, 6)


def test_masked_row_normalize_matches_jax():
    rng = np.random.default_rng(3)
    scores = np.exp(np.tanh(rng.normal(size=(2, 7, 7)))).astype(np.float32)
    mask = rng.random((7, 7)) < 0.4
    mask[2] = False                      # an all-masked row stays zero
    ref = jattn.masked_row_normalize(jnp.asarray(scores), jnp.asarray(mask))
    port = tattn.masked_row_normalize(_t(scores), _t(mask))
    _close(port, ref)
    assert float(port[:, 2].abs().sum()) == 0.0


@pytest.mark.parametrize("with_snps", [True, False])
def test_importance_masks_match_jax(with_snps):
    rng = np.random.default_rng(4)
    b, n, d, s = 3, 12, 3, 9
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    adj = _adjacency(rng, b, n)
    prob = rng.normal(size=(n, d)).astype(np.float32)
    prob_bias = rng.normal(size=(2 * d, 1)).astype(np.float32)
    snps = rng.random((b, s)).astype(np.float32) if with_snps else None
    snps_prob = rng.normal(size=(1, s)).astype(np.float32)
    ref = jmask.importance_masks(
        jnp.asarray(x), jnp.asarray(adj), jnp.asarray(prob),
        jnp.asarray(prob_bias),
        None if snps is None else jnp.asarray(snps), jnp.asarray(snps_prob))
    port = tmask.importance_masks(
        _t(x), _t(adj), _t(prob), _t(prob_bias),
        None if snps is None else _t(snps), _t(snps_prob))
    for name in ("x_masked", "adj_masked", "edge_prob"):
        _close(getattr(port, name), getattr(ref, name))
    if with_snps:
        _close(port.snps_masked, ref.snps_masked)
    else:
        assert port.snps_masked is None and ref.snps_masked is None
