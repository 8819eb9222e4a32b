"""The port's GCN-stack backward (`iggcn_tpu_torch/ops/gcn_stack.py`) against
the JAX package's custom VJP (`iggcn_tpu/ops/pallas_gcn.py:fused_gcn_stack`,
the Pallas forward in interpret mode, as tests/test_pallas_gcn.py runs it).

`gcn_stack_backward_reference` is the plain version of the backward kernel
(`csrc/gcn_stack_backward.cu`, which runs only on the card and is held
against it there by chip_smoke.py); the kernel's launch plan
(`plan_backward`) and its C struct are pure Python and are tested here.
Gradients at rtol 1e-4 / atol 1e-4 (fp32, another summation order), as
tests/test_torch_port_gcn_stack.py."""
import itertools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.ops.pallas_gcn import fused_gcn_stack as jax_fused
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.ops.gcn_stack import (MAX_LAYERS, SMEM_PER_BLOCK,
                                           STATIC_SMEM, StreamedPlan,
                                           _CBackwardPlan,
                                           fused_gcn_stack,
                                           gcn_stack_backward_reference,
                                           gcn_stack_reference,
                                           gcn_stack_reference_grouped,
                                           plan_backward, plan_launch)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, n, f0, widths, seed=0, sets=0):
    """P, x, weights and biases (in `sets` weight sets where > 0) and an
    output gradient, from a numpy seed."""
    rng = np.random.default_rng(seed)
    lead = (sets,) if sets else ()
    dims = [f0, *widths]
    prop = rng.normal(0, 0.2, (b, n, n)).astype(np.float32)
    x = rng.normal(size=(b, n, f0)).astype(np.float32)
    ws = [rng.normal(0, 0.5, lead + (dims[i], dims[i + 1])).astype(np.float32)
          for i in range(len(widths))]
    bs = [rng.normal(0, 0.1, lead + (h,)).astype(np.float32) for h in widths]
    cot = rng.normal(size=(b, n, sum(widths))).astype(np.float32)
    return prop, x, ws, bs, cot


def _torch(prop, x, ws, bs, cot):
    return (torch.tensor(prop), torch.tensor(x), [torch.tensor(w) for w in ws],
            [torch.tensor(v) for v in bs], torch.tensor(cot))


def _flat(dprop, dx, dws, dbs):
    return [dprop, dx, *dws, *dbs]


def _autograd(fn, prop, x, ws, bs, cot):
    """Gradients of sum(fn(prop, x, ws, bs) * cot) through torch autograd."""
    leaves = [t.clone().requires_grad_(True) for t in (prop, x, *ws, *bs)]
    layers = len(ws)
    out = fn(leaves[0], leaves[1], leaves[2:2 + layers], leaves[2 + layers:])
    return list(torch.autograd.grad(out, leaves, cot))


def _jax_vjp(prop, x, ws, bs, cot):
    """The JAX package's VJP of `fused_gcn_stack` (Pallas forward in
    interpret mode, its custom `_bwd`)."""
    _, vjp = jax.vjp(lambda p, xx, w, b: jax_fused(p, xx, w, b, True),
                     jnp.asarray(prop), jnp.asarray(x),
                     tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    dprop, dx, dws, dbs = vjp(jnp.asarray(cot))
    return [np.asarray(t) for t in (dprop, dx, *dws, *dbs)]


@pytest.mark.parametrize("widths", [(6, 5), (4, 6, 3), (3, 5, 4, 6)])
def test_plain_backward_matches_jax_vjp_and_autograd(widths):
    arrays = _inputs(3, 14, 3, widths, seed=len(widths))
    got = _flat(*gcn_stack_backward_reference(*_torch(*arrays)))
    want_jax = _jax_vjp(*arrays)
    want_torch = _autograd(gcn_stack_reference, *_torch(*arrays))
    assert len(got) == len(want_jax) == len(want_torch) == 2 + 2 * len(widths)
    for g, wj, wt in zip(got, want_jax, want_torch):
        assert g.shape == wj.shape == wt.shape
        np.testing.assert_allclose(g.numpy(), wj, **TOL)
        torch.testing.assert_close(g, wt, **TOL)


def test_grouped_plain_backward_is_per_set_shared_weight_calls():
    """The grouped form's backward: each set's samples give that set's
    shared-weight backward, and the weight gradients are summed per set."""
    sets, b = 3, 2
    prop, x, ws, bs, cot = _torch(*_inputs(sets * b, 12, 2, (5, 4, 3), seed=5,
                                           sets=sets))
    dprop, dx, dws, dbs = gcn_stack_backward_reference(prop, x, ws, bs, cot)
    assert [tuple(t.shape) for t in dws] == [tuple(w.shape) for w in ws]
    assert [tuple(t.shape) for t in dbs] == [tuple(v.shape) for v in bs]
    for k in range(sets):
        rows = slice(k * b, (k + 1) * b)
        one = gcn_stack_backward_reference(prop[rows], x[rows],
                                           [w[k] for w in ws],
                                           [v[k] for v in bs], cot[rows])
        torch.testing.assert_close(dprop[rows], one[0], **TOL)
        torch.testing.assert_close(dx[rows], one[1], **TOL)
        for got, want in zip([t[k] for t in dws + dbs], one[2] + one[3]):
            torch.testing.assert_close(got, want, **TOL)
    auto = _autograd(gcn_stack_reference_grouped, prop, x, ws, bs, cot)
    for got, want in zip(_flat(dprop, dx, dws, dbs), auto):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("needs", list(itertools.product((False, True),
                                                         repeat=3)))
def test_every_needs_subset(needs):
    """(prop, x, weights and biases): a gradient not asked for is None, one
    asked for is the full call's."""
    args = _torch(*_inputs(2, 10, 3, (4, 5), seed=6))
    full = gcn_stack_backward_reference(*args)
    got = gcn_stack_backward_reference(*args, needs=needs)
    for part, need in zip((0, 1), needs[:2]):
        if need:
            torch.testing.assert_close(got[part], full[part], rtol=0, atol=0)
        else:
            assert got[part] is None
    if needs[2]:
        for g, f in zip(got[2] + got[3], full[2] + full[3]):
            torch.testing.assert_close(g, f, rtol=0, atol=0)
    else:
        assert got[2] is None and got[3] is None


def test_relu_tie_at_zero_gives_zero_gradient_in_both_packages():
    """Nodes 0-2 isolated and zero biases: z = 0 exactly on their rows in
    every layer, where relu's gradient is 0 (strict mask) in JAX and in
    the port, so dP's rows 0-2 are exactly 0."""
    prop, x, ws, bs, cot = _inputs(2, 12, 3, (4, 4), seed=7)
    adj = np.abs(prop)
    adj[:, :3, :] = 0.0
    adj[:, :, :3] = 0.0
    made = gcn_propagation_matrix(torch.tensor(adj), add_self_loops=False)
    prop = made.contiguous().numpy()
    bs = [np.zeros_like(v) for v in bs]
    args = _torch(prop, x, ws, bs, cot)
    plain = _flat(*gcn_stack_backward_reference(*args))
    jax_grads = _jax_vjp(prop, x, ws, bs, cot)
    fused = _autograd(fused_gcn_stack, made, *args[1:])
    assert not plain[0][:, :3].any() and not jax_grads[0][:, :3].any()
    assert not fused[0][:, :3].any()
    for g, wj, wf in zip(plain, jax_grads, fused):
        np.testing.assert_allclose(g.numpy(), wj, **TOL)
        torch.testing.assert_close(wf, g, **TOL)


@pytest.mark.parametrize("sets", [0, 2])
def test_cpu_fused_backward_is_autograd_of_the_reference_bit_for_bit(sets):
    """On CPU tensors the backward stays autograd of the plain version: the
    same bits as differentiating `gcn_stack_reference` (grouped:
    `gcn_stack_reference_grouped`) directly, and no kernel launch."""
    before = (fused_gcn_stack.launches, fused_gcn_stack.launches_backward)
    args = _torch(*_inputs(4, 11, 3, (5, 4), seed=8, sets=sets))
    reference = gcn_stack_reference_grouped if sets else gcn_stack_reference
    got = _autograd(fused_gcn_stack, *args)
    want = _autograd(reference, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (fused_gcn_stack.launches,
            fused_gcn_stack.launches_backward) == before


def test_cpu_fused_backward_skips_inputs_without_grad():
    prop, x, ws, bs, cot = _torch(*_inputs(2, 9, 3, (4, 3), seed=9))
    ws = [w.requires_grad_(True) for w in ws]
    out = fused_gcn_stack(prop, x, ws, bs)
    grads = torch.autograd.grad(out, ws, cot)
    want = gcn_stack_backward_reference(prop, x, ws, bs, cot,
                                        needs=(False, False, True))
    for g, w in zip(grads, want[2]):
        torch.testing.assert_close(g, w, **TOL)


# (N, F0, widths) of both search grids (main.py:_combos), and the shapes
# beyond them at which the forward's plan takes cluster 1, 2, 4 and 8
GRID = ([(90, 3, (h,) * n) for n, h in zip([2, 3, 2, 3, 4],
                                           [16, 16, 10, 10, 5])]
        + [(270, 1, (h,) * n) for n, h in zip([3, 2, 4, 2, 3],
                                              [2, 3, 3, 5, 10])])
BRANCHES = [(90, 3, (64, 64)), (270, 1, (3, 3)), (400, 1, (10, 10)),
            (500, 1, (10, 10)), (600, 1, (4, 4))]


def _layout_holds(plan, n, dims):
    """The backward plan's shared-memory regions in order, 16-byte aligned,
    each as large as the kernel reads, within a CTA's shared memory."""
    layers = len(dims) - 1
    assert plan.fout_p == tuple(-(-d // 4) * 4 for d in dims[1:])
    assert plan.tot_p == sum(plan.fout_p) and plan.hmax == max(plan.fout_p)
    assert plan.dz_off == tuple(sum(plan.fout_p[:i]) for i in range(layers))
    h_rows = plan.h_off[-1] + -(-dims[-2] // 4) * 4
    n8 = -(-n // 8) * 8
    # the band (+ slack), dz^T (which also holds the cluster's partials),
    # a^T, h^T, da, then each layer's weights and biases
    assert plan.off_dz == plan.rows * plan.ps + 8
    assert plan.hmax * n8 <= plan.tot_p * plan.dts
    assert plan.off_at == plan.off_dz + plan.tot_p * plan.dts
    assert plan.off_ht == plan.off_at + plan.tot_p * plan.ats
    assert plan.off_da == plan.off_ht + h_rows * plan.ats
    ends = [plan.off_da + plan.rows * plan.das]
    for i, (fin, fp) in enumerate(zip(dims[:-1], plan.fout_p)):
        assert plan.off_w[i] == ends[-1]
        assert plan.off_b[i] == plan.off_w[i] + -(-fin // 4) * 4 * fp
        ends.append(plan.off_b[i] + fp)
    assert 4 * ends[-1] == plan.smem_bytes <= SMEM_PER_BLOCK - STATIC_SMEM
    assert all(v % 4 == 0 for v in (plan.off_dz, plan.off_at, plan.off_ht,
                                    plan.off_da, plan.dts, plan.ats,
                                    plan.das, *plan.off_w, *plan.off_b))
    assert plan.dts >= n8 and plan.ats >= plan.rows and plan.das >= plan.hmax
    assert plan.ps % 2 == 0 and plan.ps >= n and plan.rows % 8 == 0
    assert (plan.cluster - 1) * plan.rows < n <= plan.cluster * plan.rows
    sizes = [fin * fout + fout for fin, fout in zip(dims[:-1], dims[1:])]
    assert plan.wsz == sum(sizes)
    assert plan.ws_off == tuple(sum(sizes[:i]) for i in range(layers))


@pytest.mark.parametrize("n,f0,widths", GRID + BRANCHES)
def test_plan_backward_takes_the_forwards_cluster_at_every_model_shape(
        n, f0, widths):
    dims = (f0, *widths)
    for b in (1, 7, 32, 256):
        plan = plan_backward(b, n, dims)
        assert plan.cluster == plan_launch(b, n, dims).cluster
        _layout_holds(plan, n, dims)


def test_plan_backward_exists_wherever_plan_launch_does():
    """Over N up to 320 (the model's 90 and 270 ROIs and beyond) and the
    search grids' widths (up to 16, 1-4 layers): wherever the forward has
    a plan, the backward has one, within a CTA's shared memory."""
    checked = 0
    for n in range(1, 321, 7):
        for f0, layers, hidden in itertools.product((1, 3), (1, 2, 3, 4),
                                                    (1, 2, 5, 10, 16)):
            dims = (f0,) + (hidden,) * layers
            try:
                plan_launch(7, n, dims)
            except ValueError:
                continue
            _layout_holds(plan_backward(7, n, dims), n, dims)
            checked += 1
    assert checked > 1500


def test_plan_backward_refuses_what_it_cannot_hold():
    """What the resident backward cannot hold goes to the streamed form
    (its plan, not an error); only a grid past the launch limits raises."""
    for dims, n in (((3, 256, 256), 90), ((1, 4, 4), 700),
                    ((3,) + (16,) * (MAX_LAYERS + 1), 90)):
        plan = plan_backward(32, n, dims)
        assert isinstance(plan, StreamedPlan) and plan.backward
    with pytest.raises(ValueError, match="CTAs"):
        plan_backward(2 ** 31, 90, (3, 16, 16))


def test_c_backward_plan_mirrors_the_kernel_struct():
    """`_CBackwardPlan` is passed by pointer as csrc/gcn_stack_backward.cu's
    BackwardPlan: the same int fields, in the same order, with the same
    array lengths."""
    src = (pathlib.Path(__file__).parents[1] / "iggcn_tpu_torch" / "csrc"
           / "gcn_stack_backward.cu").read_text()
    body = re.search(r"struct BackwardPlan \{(.*?)\};", src, re.S).group(1)
    sizes = {None: None, "kMaxLayers": MAX_LAYERS,
             "kMaxLayers + 1": MAX_LAYERS + 1}
    fields = []
    for decl in re.findall(r"^\s*int ([^;]+);", body, re.M):
        for name in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(.+)\])?\s*", name)
            fields.append((m.group(1), sizes[m.group(2)]))
    ours = [(name, getattr(ctype, "_length_", None))
            for name, ctype in _CBackwardPlan._fields_]
    assert fields == ours
