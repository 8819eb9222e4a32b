"""Port GCN stack (`iggcn_tpu_torch/ops/gcn_stack.py`) against the JAX
reference and the Pallas kernel run in interpret mode, as
tests/test_pallas_gcn.py runs it. On the CPU `fused_gcn_stack` takes the
plain version; the CUDA kernel itself is held against it by chip_smoke.py
on the card. Forward at 1e-5, gradients at 1e-4 (fp32, different
summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.ops.pallas_gcn import fused_gcn_stack as jax_fused
from iggcn_tpu.ops.pallas_gcn import gcn_stack_reference as jax_reference
from iggcn_tpu_torch.ops.gcn_stack import (fused_gcn_stack,
                                           gcn_stack_reference)


def _inputs(b, n, f0, widths, seed=0):
    rng = np.random.default_rng(seed)
    prop = rng.normal(0, 0.1, (b, n, n)).astype(np.float32)
    x = rng.normal(size=(b, n, f0)).astype(np.float32)
    dims = [f0] + list(widths)
    ws = [rng.normal(0, 0.3, (dims[i], dims[i + 1])).astype(np.float32)
          for i in range(len(widths))]
    bs = [rng.normal(0, 0.1, (h,)).astype(np.float32) for h in widths]
    return prop, x, ws, bs


def _torch(prop, x, ws, bs, grad=False):
    def t(a):
        return torch.tensor(a, requires_grad=grad)
    return t(prop), t(x), [t(w) for w in ws], [t(b) for b in bs]


def _jax(prop, x, ws, bs):
    return (jnp.asarray(prop), jnp.asarray(x), tuple(map(jnp.asarray, ws)),
            tuple(map(jnp.asarray, bs)))


@pytest.mark.parametrize("n,f0,widths", [(90, 3, (16, 16)),
                                         (90, 3, (5, 5, 5, 5)),
                                         (27, 1, (10, 10, 10))])
def test_forward_matches_jax_reference_and_pallas(n, f0, widths):
    arrays = _inputs(4, n, f0, widths)
    ref = np.asarray(jax_reference(*_jax(*arrays)))
    pallas = np.asarray(jax_fused(*_jax(*arrays), True))
    plain = gcn_stack_reference(*_torch(*arrays)).numpy()
    fused = fused_gcn_stack(*_torch(*arrays)).numpy()
    assert fused.shape == (4, n, sum(widths))
    for port in (plain, fused):
        np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port, pallas, rtol=1e-5, atol=1e-5)


def test_gradients_match_jax():
    arrays = _inputs(4, 90, 3, (16, 16), seed=1)

    def loss_jax(prop, x, ws, bs):
        return jnp.sum(jax_fused(prop, x, ws, bs, True) ** 2)

    want = jax.tree_util.tree_leaves(
        jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*_jax(*arrays)))
    for fn in (fused_gcn_stack, gcn_stack_reference):
        prop, x, ws, bs = _torch(*arrays, grad=True)
        (fn(prop, x, ws, bs) ** 2).sum().backward()
        got = [prop.grad, x.grad, *[w.grad for w in ws],
               *[b.grad for b in bs]]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-4, atol=1e-4)


def test_backward_skips_inputs_without_grad():
    """Only the weights need gradients (the serving-time prop/x are data):
    the recompute backward returns None for the rest."""
    prop, x, ws, bs = _torch(*_inputs(2, 20, 3, (4, 4), seed=2))
    for w in ws:
        w.requires_grad_(True)
    fused_gcn_stack(prop, x, ws, bs).sum().backward()
    assert prop.grad is None and x.grad is None
    assert all(w.grad is not None for w in ws)
    assert all(b.grad is None for b in bs)


def test_cpu_path_does_not_count_launches():
    before = fused_gcn_stack.launches
    fused_gcn_stack(*_torch(*_inputs(2, 10, 3, (4,))))
    assert fused_gcn_stack.launches == before


def test_unsupported_device_raises():
    prop, x, ws, bs = _torch(*_inputs(1, 6, 2, (3,)))
    meta = [t.to("meta") for t in (prop, x)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_gcn_stack(*meta, [w.to("meta") for w in ws],
                        [b.to("meta") for b in bs])
