"""Port GCN stack (`iggcn_tpu_torch/ops/gcn_stack.py`) against the JAX
reference and the Pallas kernel run in interpret mode, as
tests/test_pallas_gcn.py runs it. On the CPU `fused_gcn_stack` takes the
plain version; the CUDA kernel itself is held against it by chip_smoke.py
on the card. Forward at 1e-5, gradients at 1e-4 (fp32, different
summation order). The kernel's launch plan and input checks are pure
Python and are tested here at every shape of the model family."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.ops.pallas_gcn import fused_gcn_stack as jax_fused
from iggcn_tpu.ops.pallas_gcn import gcn_stack_reference as jax_reference
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.ops.gcn_stack import (SMEM_PER_BLOCK, _check_inputs,
                                           fused_gcn_stack,
                                           gcn_stack_reference, plan_launch)

# (N, F0, L, H) of both search grids (main.py:_combos): the default 90-ROI
# grid and the --isMultiFusion 270-ROI one
GRID_SHAPES = ([(90, 3, L, H) for L, H in
                zip([2, 3, 2, 3, 4], [16, 16, 10, 10, 5])]
               + [(270, 1, L, H) for L, H in
                  zip([3, 2, 4, 2, 3], [2, 3, 3, 5, 10])])


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


@pytest.mark.parametrize("n,f0,layers,hidden", GRID_SHAPES)
def test_plan_keeps_p_resident_within_shared_memory(n, f0, layers, hidden):
    dims = (f0,) + (hidden,) * layers
    for b in (1, 7, 32, 256):
        plan = plan_launch(b, n, dims)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        # every CTA owns >= 1 column of P; together they hold all N
        assert (plan.cluster - 1) * plan.rows < n <= plan.cluster * plan.rows
        assert plan.rows % 8 == 0 and plan.ps in (n, n + 1)
        assert plan.kpad >= plan.rows and plan.kpad % (4 * plan.ksplit) == 0
        # P's band (kpad columns of stride ps, + 8 floats of slack), the
        # partial sums (clusters only), hW, h^T, the weights and biases,
        # all zero-padded, then the JK output rows: in order, 16-byte aligned
        part = plan.n8 * plan.hs if plan.cluster > 1 else 0
        ends = [plan.kpad * plan.ps + 8, plan.off_part + part,
                plan.off_hw + plan.kpad * plan.hws,
                plan.off_h + plan.hs * plan.hts]
        starts = [plan.off_part, plan.off_hw, plan.off_h, plan.off_w[0]]
        for i, (fin, fp) in enumerate(zip(dims[:-1], plan.fout_p)):
            ends += [plan.off_w[i] + -(-fin // 4) * 4 * fp, plan.off_b[i] + fp]
            starts += [plan.off_b[i], (plan.off_w + (plan.off_o,))[i + 1]]
        ends.append(plan.off_o + plan.rows * layers * hidden)
        assert plan.hts >= plan.kpad + 2
        assert plan.hws >= plan.hs and plan.hts % 2 == 0
        starts.append(plan.smem_bytes // 4)
        assert ends == starts
        assert all(o % 4 == 0 for o in (*starts, plan.hs, plan.hws, *plan.fout_p))
        tiles = (plan.n8 // 8) * (max(plan.fout_p) // 4) * plan.ksplit
        assert tiles <= plan.threads <= 512 and plan.threads % 32 == 0
        if n == 270:   # 291 KB of P: spread over a cluster
            assert 2 <= plan.cluster <= 8
        else:
            assert plan.cluster == 1


def test_plan_refuses_what_the_kernel_cannot_hold():
    with pytest.raises(ValueError, match="cannot hold"):
        plan_launch(256, 90, (3, 4096))
    with pytest.raises(ValueError, match="cannot hold"):
        plan_launch(256, 700, (1, 4, 4))    # 1.96 MB of P: > 8 CTAs' worth
    with pytest.raises(ValueError, match="layers"):
        plan_launch(256, 90, (3,) + (16,) * 9)
    with pytest.raises(ValueError, match="width >= 1"):
        plan_launch(256, 90, (3, 0))


# shapes outside the search grids that plan_launch sends down the kernel's
# other branches; chip_smoke.py checks the kernel on the card at each
@pytest.mark.parametrize("n,dims,cluster,ksplit", [
    (90, (3, 64, 64), 1, 1), (270, (1, 3, 3), 2, 4), (400, (1, 10, 10), 4, 1),
    (500, (1, 10, 10), 8, 1), (600, (1, 4, 4), 8, 2)])
def test_plan_reaches_every_cluster_and_k_split(n, dims, cluster, ksplit):
    plan = plan_launch(7, n, dims)
    assert (plan.cluster, plan.ksplit) == (cluster, ksplit)
    assert plan.smem_bytes <= SMEM_PER_BLOCK and plan.threads <= 512


def test_check_inputs_takes_both_prop_layouts_and_no_other():
    prop, x, ws, bs = _torch(*_inputs(3, 12, 3, (4, 4)))
    made = gcn_propagation_matrix(torch.rand(3, 12, 12))
    assert made.stride() == (144, 1, 12)
    assert _check_inputs(prop, x, ws, bs) == ([3, 4, 4], False)
    assert _check_inputs(made, x, ws, bs) == ([3, 4, 4], True)
    assert _check_inputs(made.contiguous(), x, ws, bs)[1] is False
    single = gcn_propagation_matrix(torch.rand(1, 12, 12))
    assert _check_inputs(single, x[:1], ws, bs)[1] is True
    batch_major = torch.rand(12, 3, 12).permute(1, 0, 2)   # (12, 36, 1)
    every_other = torch.rand(3, 12, 24)[:, :, ::2]         # (288, 24, 2)
    for bad in (batch_major, every_other):
        with pytest.raises(ValueError, match="strides"):
            _check_inputs(bad, x, ws, bs)
    with pytest.raises(ValueError, match="contiguous"):
        _check_inputs(prop, x.mT.contiguous().mT, ws, bs)


@pytest.mark.parametrize("n,f0,widths", [(90, 3, (16, 16)),
                                         (27, 1, (10, 10, 10))])
def test_forward_same_for_both_prop_layouts(n, f0, widths):
    """The propagation matrix as gcn_propagation_matrix returns it
    (transposed in memory, isolated nodes included) and its row-major copy
    give the same stack, equal to the JAX reference."""
    rng = np.random.default_rng(3)
    adj = np.abs(rng.normal(size=(4, n, n))).astype(np.float32)
    adj[:, :3, :] = 0.0    # nodes 0-2 isolated: zero rows and columns of P
    adj[:, :, :3] = 0.0
    made = gcn_propagation_matrix(torch.from_numpy(adj), add_self_loops=False)
    assert not made.is_contiguous() and float(made[:, :3].abs().sum()) == 0.0
    _, x, ws, bs = _inputs(4, n, f0, widths, seed=4)
    want = np.asarray(jax_reference(*_jax(made.numpy(), x, ws, bs)))
    _, xt, wt, bt = _torch(adj, x, ws, bs)
    for prop in (made, made.contiguous()):
        got = fused_gcn_stack(prop, xt, wt, bt).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_c_plan_mirrors_the_kernel_struct():
    """`_CPlan` is passed by pointer as csrc/gcn_stack.cu's StackPlan: the
    same int fields, in the same order, with the same array lengths."""
    import pathlib
    import re

    from iggcn_tpu_torch.ops.gcn_stack import MAX_LAYERS, _CPlan
    src = (pathlib.Path(__file__).parents[1] / "iggcn_tpu_torch" / "csrc"
           / "gcn_stack.cu").read_text()
    body = re.search(r"struct StackPlan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"^\s*int ([^;]+);", body, re.M):
        for name in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(.+)\])?\s*", name)
            sizes = {None: None, "kMaxLayers": MAX_LAYERS,
                     "kMaxLayers + 1": MAX_LAYERS + 1}
            fields.append((m.group(1), sizes[m.group(2)]))
    ours = [(name, getattr(ctype, "_length_", None))
            for name, ctype in _CPlan._fields_]
    assert fields == ours
