"""Port loss terms (`iggcn_tpu_torch/train/losses.py`) against the JAX
package's, on the same numpy inputs from a seed, with and without the
padding weight: values and the gradients with respect to every float
input, rtol/atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.config import SparsityWeights as JaxSW
from iggcn_tpu.train import losses as jl
from iggcn_tpu_torch.config import SparsityWeights
from iggcn_tpu_torch.train import losses as pl

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)
W = np.array([1, 1, 1, 1, 0, 0], np.float32)
X = RNG.normal(size=(6, 5, 3)).astype(np.float32)
ADJ = np.where(RNG.random((6, 5, 5)) < 0.5, RNG.random((6, 5, 5)), 0
               ).astype(np.float32)
PROB = RNG.normal(size=(5, 3)).astype(np.float32)
PROB_BIAS = RNG.normal(size=(6, 1)).astype(np.float32)
SNPS_PROB = RNG.normal(size=(1, 7)).astype(np.float32)
Z = RNG.normal(size=(6, 4)).astype(np.float32)
WIDE = RNG.normal(size=(6, 9)).astype(np.float32)
TSNE = RNG.normal(size=(6, 3)).astype(np.float32)
LOGP = np.log(RNG.dirichlet(np.ones(3), 6)).astype(np.float32)
LABELS = np.array([0, 2, 1, 1, 0, 2], np.int32)
REG = RNG.normal(size=(6, 3)).astype(np.float32)
TARGET = RNG.normal(size=(6, 3)).astype(np.float32)
MEMBER = np.array([1, 0, 1, 1, 0, 0], np.float32)
SW = dict(lamda_x_l1=0.2, lamda_e_l1=0.3, lamda_x_ent=0.4, lamda_e_ent=0.5)


def _both(jfn, pfn, floats):
    """Value of jfn(*jnp arrays) / pfn(*torch tensors) and their gradients
    with respect to every array of `floats`."""
    val, grads = jax.value_and_grad(jfn, argnums=tuple(range(len(floats))))(
        *map(jnp.asarray, floats))
    ts = [torch.tensor(a, requires_grad=True) for a in floats]
    got = pfn(*ts)
    got.backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(val), **TOL)
    for t, g in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def _w(w, lib):
    return None if w is None else (jnp.asarray(w) if lib == "jax"
                                   else torch.tensor(w))


@pytest.mark.parametrize("w", [None, W])
def test_sparsity_loss(w):
    _both(lambda p, pb, sp, x: jl.sparsity_loss(
              p, pb, sp, x, jnp.asarray(ADJ), JaxSW(**SW),
              sample_weight=_w(w, "jax")),
          lambda p, pb, sp, x: pl.sparsity_loss(
              p, pb, sp, x, torch.tensor(ADJ), SparsityWeights(**SW),
              sample_weight=_w(w, "torch")),
          [PROB, PROB_BIAS, SNPS_PROB, X])


@pytest.mark.parametrize("w", [None, W])
def test_sgcn_sparsity_loss(w):
    """The image family's penalty: no SNP term, node L1 over N not N * D."""
    _both(lambda p, pb, x: jl.sgcn_sparsity_loss(
              p, pb, x, jnp.asarray(ADJ), JaxSW(**SW),
              sample_weight=_w(w, "jax")),
          lambda p, pb, x: pl.sgcn_sparsity_loss(
              p, pb, x, torch.tensor(ADJ), SparsityWeights(**SW),
              sample_weight=_w(w, "torch")),
          [PROB, PROB_BIAS, X])


@pytest.mark.parametrize("member", [None, W, MEMBER, np.zeros(6, np.float32)])
def test_consistency_loss_and_rbf_kernel(member):
    _both(lambda z, t: jl.consistency_loss(
              z, jl.rbf_kernel(t, t, 0.3),
              None if member is None else jnp.asarray(member)),
          lambda z, t: pl.consistency_loss(
              z, pl.rbf_kernel(t, t, 0.3),
              None if member is None else torch.tensor(member)),
          [Z, TSNE])


@pytest.mark.parametrize("w", [None, W])
@pytest.mark.parametrize("wide", [False, True])
def test_orthogonal_loss(w, wide):
    _both(lambda z: jl.orthogonal_loss(z, _w(w, "jax")),
          lambda z: pl.orthogonal_loss(z, _w(w, "torch")),
          [WIDE if wide else Z])


@pytest.mark.parametrize("w", [None, W])
def test_nll_mse_recon_and_weighted_mean(w):
    _both(lambda lp: jl.nll_loss(lp, jnp.asarray(LABELS), _w(w, "jax")),
          lambda lp: pl.nll_loss(lp, torch.tensor(LABELS), _w(w, "torch")),
          [LOGP])
    _both(lambda r, t: jl.mse_loss(r, t, _w(w, "jax")),
          lambda r, t: pl.mse_loss(r, t, _w(w, "torch")), [REG, TARGET])
    _both(lambda r, t: jl.recon_sum(r, t, _w(w, "jax")),
          lambda r, t: pl.recon_sum(r, t, _w(w, "torch")), [REG, TARGET])
    _both(lambda x: jl.weighted_mean(x, _w(w, "jax")),
          lambda x: pl.weighted_mean(x, _w(w, "torch")), [X])


def test_mse_loss_refuses_broadcasting_shapes():
    with pytest.raises(ValueError, match="shape mismatch"):
        pl.mse_loss(torch.zeros(4, 3), torch.zeros(4, 1))
