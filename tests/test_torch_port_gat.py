"""Port dense GAT layer (`iggcn_tpu_torch/ops/gat.py`) against
`iggcn_tpu.ops.gat.gat_conv` on the same numpy inputs, fp32 on the CPU,
atol 1e-6: nonzero and zero diagonals (the self-loops are replaced by the
mean incoming weight), an isolated node, an incoming-only node; and its
gradients, which the SGCN_GAT trajectory then exercises end to end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.ops import gat as jgat
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.ops import gat as tgat
from iggcn_tpu_torch.tools import serve


def _inputs(seed, b=3, n=12, fin=5, fout=4):
    rng = np.random.default_rng(seed)
    adj = rng.random((b, n, n)).astype(np.float32)
    adj[adj < 0.6] = 0.0
    diag = np.arange(n)
    adj[:, diag, diag] = np.where(rng.random((b, n)) < 0.5,
                                  rng.random((b, n)) + 0.5, 0.0)
    adj[:, 3, :] = 0.0          # node 3 isolated
    adj[:, :, 3] = 0.0
    adj[:, :, 5] = 0.0          # node 5: outgoing edges only
    x = rng.normal(size=(b, n, fin)).astype(np.float32)
    params = [rng.normal(0, 0.5, s).astype(np.float32) for s in
              ((fin, fout), (fout,), (fout,), (1, fout), (fout,), (fout,))]
    return x, adj, params


@pytest.mark.parametrize("slope", [0.2, 0.01])
def test_gat_conv_matches_jax(slope):
    x, adj, params = _inputs(0)
    want = jgat.gat_conv(jnp.asarray(x), jnp.asarray(adj),
                         jgat.GATParams(*map(jnp.asarray, params)), slope)
    got = tgat.gat_conv(torch.tensor(x), torch.tensor(adj),
                        tgat.GATParams(*map(torch.tensor, params)), slope)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_self_loop_fill_is_the_mean_incoming_weight():
    _, adj, _ = _inputs(1)
    eye = np.eye(adj.shape[1], dtype=bool)
    mask_off = (adj != 0) & ~eye
    w_off = np.where(mask_off, adj, 0.0)
    got = tgat._self_loop_fill(torch.tensor(w_off), torch.tensor(mask_off))
    want = jgat._self_loop_fill(jnp.asarray(w_off), jnp.asarray(mask_off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[0, 5]) == 0.0 and float(got[0, 3]) == 0.0


def test_gat_conv_gradients_match_jax():
    x, adj, params = _inputs(2)
    cot = np.random.default_rng(3).normal(size=(3, 12, 4)).astype(np.float32)

    def jloss(x_, adj_, *ps):
        return jnp.sum(jgat.gat_conv(x_, adj_, jgat.GATParams(*ps)) * cot)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(8))))(
        jnp.asarray(x), jnp.asarray(adj), *map(jnp.asarray, params))
    leaves = [torch.tensor(a, requires_grad=True) for a in [x, adj, *params]]
    (tgat.gat_conv(leaves[0], leaves[1], tgat.GATParams(*leaves[2:]))
     * torch.tensor(cot)).sum().backward()
    for name, t, w in zip(["x", "adj", *tgat.GATParams._fields], leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_gat_bundle_serves(tmp_path):
    """A `use_gat` flagship bundle loads in the serving tool and gives the
    model's own outputs."""
    cfg = ModelConfig(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
                      use_gat=True)
    model = FusedSGCN(cfg, synthetic_topology(np.random.default_rng(0)),
                      generator=torch.Generator().manual_seed(1)).eval()
    path = str(tmp_path / "gat.npz")
    serve.save_bundle(path, model)
    loaded = serve.load_bundle(path, device="cpu")
    assert loaded.cfg.use_gat
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(3, 90, 3)).astype(np.float32))
    adj = torch.tensor(np.abs(rng.normal(size=(3, 90, 90))).astype(np.float32))
    snps = torch.tensor(rng.random((3, 54)).astype(np.float32))
    with torch.no_grad():
        want, got = model(x, adj, snps), loaded(x, adj, snps)
    for name in want._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name))
