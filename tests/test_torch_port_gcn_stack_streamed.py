"""The GCN stack's streamed form (`csrc/gcn_stack_streamed.cu`, planned by
`StreamedPlan`, its launches listed by `ops/gcn_stack.py:_layer_products`
and `_backward_products`) on the CPU: the form runs only on the card,
where chip_smoke.py holds it against the plain versions.

  (a) `plan_launch` (fp32, bf16 and the grouped form's batches) and
      `plan_backward` give a plan for every N, depth and width swept;
  (b) wherever the resident designs hold a shape, they keep it, with the
      plan unchanged field for field (a digest of every plan over the
      search grids, the timed shapes and a sweep of N x L x H, taken from
      the tree before the streamed form);
  (c) a NumPy replay of the product the kernel runs, launch by launch
      (the tile and K split `choose_tile` gives it, K in chunks of 32,
      each chunk cut among the K split's groups, each group's sum taken
      in order and the groups' sums added in group order, values past an
      operand's edge read as 0, the ones row, the four epilogues and the
      fused a_{l+1} = h_{l+1} W_{l+1}; the copy widths and staging checked
      against the addresses), over the launches the wrapper lists, on
      scratch and outputs filled with NaN, held against
      `gcn_stack_reference`, `gcn_stack_reference_grouped` and
      `gcn_stack_backward_reference`; the tile and copy-width choosers at
      the shapes the card times;
  (d) the wrappers `_launch` and `_launch_backward` driven on CPU tensors
      through a fake library that replays what it is given: the launch
      list, the scratch sizes, the count and the error path;
  (e) the port against the JAX package at streamed shapes: the stack at
      9 layers, at N=90 with three layers of 128 and at N=620 with two of
      16 against the Pallas kernel in interpret mode (forward and VJP, on
      the CPU path and through the replayed streamed form), the flagship
      at `--layers 3 --hiddens 128` against the JAX model on transferred
      weights (loss and gradients), and `GCNFlat` at N=620.

Tolerances: the replay and the CPU path against the plain versions and
JAX, forward rtol 1e-5 with atol 1e-5 of the output's largest magnitude,
gradients 1e-4 of theirs (fp32 in another summation order, K up to 620);
the models as `tests/test_torch_port_train_layers.py` holds them (rtol
1e-3 with atol 1e-3 of the magnitude: train-mode batch norm)."""
import ctypes
import hashlib
import itertools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.config import ModelConfig as JaxConfig
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models import baselines as jax_baselines
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.ops.pallas_gcn import fused_gcn_stack as jax_fused
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.baselines import GCNFlat
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.tools.convert import _leaves, load_flax_variables
from tests import test_torch_port_train_layers as train_layers

CHUNK = gcn_stack.STREAM_CHUNK
# the search grids' (N, F0, widths) (main.py:combos)
GRID = ([(90, 3, (h,) * n) for n, h in zip([2, 3, 2, 3, 4],
                                            [16, 16, 10, 10, 5])]
        + [(270, 1, (h,) * n) for n, h in zip([3, 2, 4, 2, 3],
                                               [2, 3, 3, 5, 10])])
# sha1 of every plan over `_resident_sweep`, from the tree before the
# streamed form ("raise" where it had none; a streamed plan reads so too)
RESIDENT_DIGEST = "191fdfcef9debb4abbdd29957f777ef57db37a44"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _inputs(b, n, f0, widths, seed=0, sets=0, transposed=True):
    """P (a normalised top-k adjacency, in `gcn_propagation_matrix`'s
    transposed layout or row-major), x, weights and biases (in `sets`
    weight sets where > 0) and an output gradient, from a numpy seed."""
    rng = np.random.default_rng(seed)
    adj = np.abs(rng.normal(size=(b, n, n))).astype(np.float32)
    kth = np.partition(adj, max(n - 8, 0), axis=1)[:, max(n - 8, 0)][:, None]
    adj[adj < kth] = 0.0
    prop = gcn_propagation_matrix(torch.from_numpy(adj))
    if not transposed:
        prop = prop.contiguous()
    lead = (sets,) if sets else ()
    dims = [f0, *widths]
    ws = [torch.from_numpy(rng.normal(0, (2 / (dims[i] + dims[i + 1])) ** 0.5,
                                      lead + (dims[i], dims[i + 1]))
                           .astype(np.float32)) for i in range(len(widths))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, lead + (h,)).astype(np.float32))
          for h in widths]
    x = torch.from_numpy(rng.normal(size=(b, n, f0)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, n, sum(widths)))
                         .astype(np.float32))
    return prop, x, ws, bs, g


# ---- (a) a plan for every shape ------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 28, 90, 126, 270, 620, 1000, 5748])
def test_every_shape_gets_a_plan(n):
    for layers, width in itertools.product(range(1, 13),
                                           (1, 5, 16, 32, 64, 128, 256)):
        dims = (3,) + (width,) * layers
        plans = [gcn_stack.plan_launch(32, n, dims),
                 gcn_stack.plan_launch(32, n, dims, elem_bytes=2),
                 gcn_stack.plan_launch(5 * 32, n, dims),      # grouped
                 gcn_stack.plan_backward(32, n, dims),
                 gcn_stack.plan_backward(5 * 32, n, dims)]
        for plan in plans:
            if isinstance(plan, gcn_stack.StreamedPlan):
                assert plan.smem_bytes <= gcn_stack.STREAM_MAX_SMEM
                assert plan.a_floats == n * width * layers
                assert 1 <= plan.tiles and 160 * plan.tiles < 2 ** 31
        if layers > gcn_stack.MAX_LAYERS:
            assert all(isinstance(p, gcn_stack.StreamedPlan) for p in plans)


def test_only_invalid_shapes_and_grids_raise():
    with pytest.raises(ValueError, match="width >= 1"):
        gcn_stack.plan_launch(32, 90, (3, 0))
    with pytest.raises(ValueError, match="N >= 1"):
        gcn_stack.plan_backward(32, 0, (3, 16))
    with pytest.raises(ValueError, match="at least one layer"):
        gcn_stack.plan_launch(32, 90, (3,))
    with pytest.raises(ValueError, match="CTAs"):
        gcn_stack.plan_launch(2 ** 27, 5748, (3, 16))      # 90 CTAs each
    with pytest.raises(ValueError, match="at least one layer"):
        gcn_stack._check_inputs(*_inputs(1, 4, 3, (2,))[:2], [], [])


# ---- (b) the resident plans stay ------------------------------------------

def _resident_sweep():
    shapes = [(b, n, (f0, *w)) for b in (1, 7, 32, 160, 256, 480)
              for n, f0, w in GRID]
    for n, layers, width in itertools.product(
            (1, 8, 28, 90, 126, 270, 620, 1000), range(1, 9),
            (1, 5, 16, 32, 64, 128)):
        shapes.append((32, n, (3,) + (width,) * layers))
    return shapes


def _tag(fn):
    try:
        plan = fn()
    except ValueError:
        return "raise"
    return "raise" if isinstance(plan, gcn_stack.StreamedPlan) else repr(plan)


def test_resident_plans_are_unchanged_field_for_field():
    """Over both search grids at every batch the routes give (serving,
    training, the grouped 5 x 32 and 15 x 32, which covers PERF.md's timed
    shapes) and N x L x H: the same resident plan as before, in each of
    the forward's two forms and the backward, and the streamed one exactly
    where there was none."""
    rows = []
    for b, n, dims in _resident_sweep():
        rows += [_tag(lambda: gcn_stack.plan_launch(b, n, dims)),
                 _tag(lambda: gcn_stack.plan_launch(b, n, dims, 2)),
                 _tag(lambda: gcn_stack.plan_backward(b, n, dims))]
    assert len(rows) == 1332 and sum(r != "raise" for r in rows) == 935
    assert hashlib.sha1("\n".join(rows).encode()).hexdigest() \
        == RESIDENT_DIGEST


@pytest.mark.parametrize("b,n,dims,forward,backward", [
    (256, 90, (3, 16, 16), gcn_stack.LaunchPlan, gcn_stack.BackwardPlan),
    (32, 270, (1, 10, 10, 10), gcn_stack.LaunchPlan, gcn_stack.BackwardPlan),
    (32, 90, (3, 128, 128), gcn_stack.LaunchPlan, gcn_stack.StreamedPlan),
    (32, 90, (3, 128, 128, 128), gcn_stack.StreamedPlan,
     gcn_stack.StreamedPlan),
    (32, 270, (1, 32, 32, 32), gcn_stack.LaunchPlan, gcn_stack.StreamedPlan),
    (32, 270, (1, 64), gcn_stack.StreamedPlan, gcn_stack.BackwardPlan),
    (32, 620, (3, 32, 32, 32), gcn_stack.StreamedPlan,
     gcn_stack.StreamedPlan),
    (32, 90, (3,) + (16,) * 9, gcn_stack.StreamedPlan,
     gcn_stack.StreamedPlan)])
def test_forward_and_backward_choose_apart(b, n, dims, forward, backward):
    fwd, bwd = gcn_stack.plan_launch(b, n, dims), gcn_stack.plan_backward(
        b, n, dims)
    assert type(fwd) is forward and type(bwd) is backward
    if (n, dims) == (90, (3, 128, 128)):
        assert fwd.cluster == 4          # the forward stays on 4 CTAs
    if isinstance(bwd, gcn_stack.StreamedPlan):
        assert bwd.backward and bwd.wsz == sum(
            fin * fout + fout for fin, fout in zip(dims[:-1], dims[1:]))


# ---- (c) the replay ------------------------------------------------------

def _ceil(v, m):
    return -(-v // m) * m


def _view(ptr, extent, typ):
    """`extent` values at address `ptr` as float32 (bf16 widened: a
    copy), else a writable view."""
    if typ == gcn_stack.BF16:
        raw = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint16)), (extent,))
        return (raw.astype(np.uint32) << 16).view(np.float32)
    return np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctypes.c_float)), (extent,))


def _index(batch, div, bs, rows, s0, cols, s1):
    return ((np.arange(batch) // div * bs)[:, None, None]
            + (np.arange(rows) * s0)[None, :, None]
            + (np.arange(cols) * s1)[None, None, :])


def _read(ptr, typ, idx):
    return _view(ptr, int(idx.max()) + 1, typ)[idx]


def _write(ptr, idx, values):
    _view(ptr, int(idx.max()) + 1, gcn_stack.F32)[idx] = values


def _copies_fit(ptr, typ, vec, contiguous, other, batch_stride):
    """What the kernel's `copies_fit` asks of a copy of `vec` floats."""
    return vec == 1 or (vec in (2, 4) and typ == gcn_stack.F32
                        and contiguous == 1 and ptr % (4 * vec) == 0
                        and other % vec == 0 and batch_stride % vec == 0)


def replay_product(p, batch):
    """One launch of `gcn_stack_streamed_product` for `batch` samples, as
    its CTAs compute it: A and B staged chunk by chunk into BM x CHUNK and
    CHUNK x BN tiles of its `tile`, a value outside the operand staged as
    0 (the ones row as 1 up to K); each chunk's K cut into `ksplit` equal
    parts, one per group of warps, each group summing its parts chunk
    after chunk in order and the groups' sums added in group order; then
    the epilogue on C's values only, and where `w2` is set a_{l+1} =
    relu(z) W2, summed over the n columns in order. Asserts what the
    kernel's launch check asserts (the copies' alignment, the split, the
    shared memory, a fused tile covering the width)."""
    bm, bn = gcn_stack.STREAM_TILES[p.tile]
    ks = p.ksplit
    assert ks in gcn_stack.STREAM_KSPLITS
    assert bm * bn // 16 * ks <= gcn_stack.STREAM_MAX_THREADS
    assert gcn_stack.streamed_smem(
        p.tile, ks, bool(p.a_k), bool(p.b_k),
        (p.n, p.n2) if p.w2 else None) <= gcn_stack.STREAM_MAX_SMEM
    assert _copies_fit(p.a, p.a_type, p.a_vec,
                       *((p.a_s1, p.a_s0) if p.a_k else (p.a_s0, p.a_s1)),
                       p.a_bs)
    assert _copies_fit(p.b, p.b_type, p.b_vec,
                       *((p.b_s0, p.b_s1) if p.b_k else (p.b_s1, p.b_s0)),
                       p.b_bs)
    mp, np_, kp = _ceil(p.m, bm), _ceil(p.n, bn), _ceil(p.k, CHUNK)
    a = np.zeros((batch, mp, kp), np.float32)
    if p.a_rows:
        a[:, :p.a_rows, :p.k] = _read(p.a, p.a_type, _index(
            batch, p.a_div, p.a_bs, p.a_rows, p.a_s0, p.k, p.a_s1))
    if p.ones:
        a[:, p.a_rows, :p.k] = 1.0
    b = np.zeros((batch, kp, np_), np.float32)
    b[:, :p.k, :p.n] = _read(p.b, p.b_type, _index(
        batch, p.b_div, p.b_bs, p.k, p.b_s0, p.n, p.b_s1))
    parts = np.zeros((ks, batch, mp, np_), np.float32)
    sub = CHUNK // ks
    for chunk in range(kp // CHUNK):
        for g in range(ks):
            for k in range(chunk * CHUNK + g * sub,
                           chunk * CHUNK + (g + 1) * sub):
                parts[g] += a[:, :, k, None] * b[:, None, k, :]
    acc = parts[0]
    for g in range(1, ks):
        acc = acc + parts[g]
    v = acc[:, :p.m, :p.n]
    c_idx = _index(batch, 1, p.c_bs, p.m, p.c_s0, p.n, p.c_s1)
    if p.epi == gcn_stack.EPI_STORE:
        _write(p.c, c_idx, v)
    elif p.epi == gcn_stack.EPI_RELU:
        bias = _read(p.bias, p.bias_type,
                     _index(batch, p.bias_div, p.bias_bs, 1, 0, p.n, 1))
        z = v + bias
        h = np.where(z > 0, z, np.float32(0))
        _write(p.c, c_idx, h)
        if p.d:
            g = _read(p.g, gcn_stack.F32,
                      _index(batch, 1, p.g_bs, p.m, p.g_s0, p.n, 1))
            _write(p.d, _index(batch, 1, p.d_bs, p.m, p.d_s0, p.n, 1),
                   g * (z > 0))
        if p.w2:
            assert p.n <= bn and _copies_fit(p.w2, p.w2_type, p.w2_vec, 1,
                                             p.n2, p.w2_bs)
            w2 = _read(p.w2, p.w2_type, _index(batch, p.w2_div, p.w2_bs, p.n,
                                               p.n2, p.n2, 1))
            out = np.zeros((batch, p.m, p.n2), np.float32)
            for k in range(p.n):
                out += h[:, :, k, None] * w2[:, None, k, :]
            _write(p.c2, _index(batch, 1, p.c2_bs, p.m, p.c2_s0, p.n2, 1),
                   out)
    elif p.epi == gcn_stack.EPI_DA:
        rows = p.a_rows
        _write(p.c, c_idx[:, :rows], v[:, :rows])
        if p.ones:
            _write(p.d, _index(batch, 1, p.d_bs, 1, 0, p.n, 1), v[:, rows:])
    else:
        assert p.epi == gcn_stack.EPI_GRAD_MASK
        idx = _index(batch, 1, p.g_bs, p.m, p.g_s0, p.n, 1)
        g = _read(p.g, gcn_stack.F32, idx)
        h = _read(p.mask, gcn_stack.F32,
                  _index(batch, 1, p.mask_bs, p.m, p.mask_s0, p.n, 1))
        _write(p.c, c_idx, (g + v) * (h > 0))


class FakeStreamed:
    """The streamed form's library, replayed in NumPy on CPU memory: each
    call's products (as dicts) and arguments are recorded."""

    def __init__(self, code=0):
        self.code, self.calls = code, []

    def gcn_stack_streamed(self, steps, count, batch, ws, wgrad, slots, wsz,
                           sets, device, stream):
        self.calls.append(dict(
            steps=[{name: getattr(p, name) for name, _ in p._fields_}
                   for p in steps[:count]],
            batch=batch, slots=slots, wsz=wsz, sets=sets))
        if self.code:
            return self.code
        for p in steps[:count]:
            replay_product(p, batch)
        if ws is not None:
            slots_v = _view(ws, batch * wsz, gcn_stack.F32).reshape(
                sets, slots, wsz)
            out = np.zeros((sets, wsz), np.float32)
            for q in range(slots):          # the slots of a set, in order
                out += slots_v[:, q]
            _view(wgrad, sets * wsz, gcn_stack.F32)[:] = out.reshape(-1)
        return 0

    def gcn_stack_streamed_error_string(self, code):
        return b"fake failure"


@pytest.fixture
def fake(monkeypatch):
    """`gcn_stack`'s streamed library replaced by `FakeStreamed`, the CUDA
    stream and device stubbed, and every scratch and output buffer the
    wrapper allocates filled with NaN (its shapes recorded)."""
    lib = FakeStreamed()
    shapes = []

    def nan_scratch(shape, device):
        shapes.append(tuple(shape))
        return torch.full(shape, float("nan"), device=device)

    monkeypatch.setattr(gcn_stack, "_streamed_lib", lib)
    monkeypatch.setattr(gcn_stack, "_scratch", nan_scratch)
    monkeypatch.setattr(gcn_stack, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(gcn_stack.fused_gcn_stack, "launches_streamed", 0)
    lib.shapes = shapes
    return lib


def _streamed_forward(prop, x, ws, bs):
    out = gcn_stack._launch(prop, x, ws, bs)
    assert not torch.isnan(out).any()
    return out


def _streamed_backward(prop, x, ws, bs, g, needs=(True, True, True)):
    return gcn_stack._launch_backward(prop, x, ws, bs, g, needs)


def _reference_for(ws):
    return (gcn_stack.gcn_stack_reference_grouped if ws[0].dim() == 3
            else gcn_stack.gcn_stack_reference)


def _held(got, want, rel=1e-4):
    for gg, w in zip(got, want):
        if w is None:
            assert gg is None
            continue
        if isinstance(w, list):
            _held(gg, w, rel)
            continue
        assert not torch.isnan(gg).any()
        _close(gg.numpy(), w.numpy(), rel)


# (B, N, F0, widths, weight sets): chunk and tile edges (N = 17, 65, widths
# 66 and 7), one tile exactly (N = 64), depth past MAX_LAYERS, the grouped
# form; each streamed in the forward and the backward by the choice below
REPLAY_SHAPES = [(3, 17, 3, (5, 7), 0), (2, 65, 2, (66, 9), 0),
                 (2, 64, 1, (4, 4, 4), 0), (2, 12, 3, (6,) * 9, 0),
                 (6, 33, 3, (8, 5), 3), (4, 40, 2, (7,) * 10, 2)]


@pytest.fixture
def streamed_everywhere(monkeypatch):
    """Every plan streamed, so that small shapes take the streamed form."""
    monkeypatch.setattr(gcn_stack, "plan_launch",
                        lambda b, n, dims, elem_bytes=4, sms=0:
                        gcn_stack.streamed_plan(n, dims, elem_bytes))
    monkeypatch.setattr(gcn_stack, "plan_backward",
                        lambda b, n, dims: gcn_stack.streamed_plan(
                            n, dims, backward=True))


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("b,n,f0,widths,sets", REPLAY_SHAPES)
def test_replayed_forward_gives_the_plain_version(fake, streamed_everywhere,
                                                  b, n, f0, widths, sets,
                                                  transposed):
    prop, x, ws, bs, _ = _inputs(b, n, f0, widths, sets=sets,
                                 transposed=transposed)
    _close(_streamed_forward(prop, x, ws, bs),
           _reference_for(ws)(prop, x, ws, bs), 1e-5)


@pytest.mark.parametrize("transposed", [True, False])
@pytest.mark.parametrize("b,n,f0,widths,sets", REPLAY_SHAPES)
def test_replayed_backward_gives_the_plain_version(fake, streamed_everywhere,
                                                   b, n, f0, widths, sets,
                                                   transposed):
    prop, x, ws, bs, g = _inputs(b, n, f0, widths, sets=sets,
                                 transposed=transposed)
    got = _streamed_backward(prop, x, ws, bs, g)
    _held(got, gcn_stack.gcn_stack_backward_reference(prop, x, ws, bs, g))


@pytest.mark.parametrize("needs", [(False, True, True), (False, False, True),
                                   (True, False, False), (True, True, False),
                                   (False, True, False)])
def test_replayed_backward_takes_every_needs_subset(fake, streamed_everywhere,
                                                   needs):
    prop, x, ws, bs, g = _inputs(3, 20, 3, (6, 5, 4))
    got = _streamed_backward(prop, x, ws, bs, g, needs)
    want = gcn_stack.gcn_stack_backward_reference(prop, x, ws, bs, g, needs)
    _held(got, want)


def test_replayed_backward_with_a_broadcast_weight_and_relu_ties(
        fake, streamed_everywhere):
    """One weight set broadcast to every fold (stride 0), and isolated
    nodes with zero biases, so z is exactly 0 there (the mask takes 0)."""
    prop, x, ws, bs, g = _inputs(6, 21, 3, (5, 6), sets=3)
    ws[0] = ws[0][:1].expand(3, *ws[0].shape[1:])
    bs = [torch.zeros_like(v) for v in bs]
    prop = prop.clone()
    prop[:, :4, :] = 0.0
    got = _streamed_backward(prop, x, ws, bs, g)
    want = gcn_stack.gcn_stack_backward_reference(prop, x, ws, bs, g)
    _held(got, want)


def test_replayed_bf16_forward_gives_the_plain_version_on_the_upcasts(
        fake, streamed_everywhere):
    prop, x, ws, bs, _ = _inputs(3, 70, 3, (66, 8))
    cast = [t.bfloat16() for t in (prop, x)]
    wb, bb = [w.bfloat16() for w in ws], [v.bfloat16() for v in bs]
    got = _streamed_forward(*cast, wb, bb)
    want = gcn_stack.gcn_stack_reference(
        cast[0].float(), cast[1].float(), [w.float() for w in wb],
        [v.float() for v in bb])
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)
    steps = fake.calls[-1]["steps"]
    # a_0 = x W_0, then z_0 with a_1 = h_1 W_1 (bf16 W_1) in its epilogue,
    # then z_1
    assert [(s["a_type"], s["b_type"], s["w2_type"] if s["w2"] else None)
            for s in steps] == [
        (gcn_stack.BF16, gcn_stack.BF16, None),
        (gcn_stack.BF16, gcn_stack.F32, gcn_stack.BF16),
        (gcn_stack.BF16, gcn_stack.F32, None)]


# ---- (d) the wrapper through a fake library -------------------------------

def test_forward_wrapper_lists_two_launches_a_layer(fake):
    """At N=90 with three layers of 128 (the forward cannot hold it): one
    call of the library, L + 1 products over the batch (a_0 = x W_0, then
    relu(P a_l + b_l) into the JK output, whose epilogue computes a_{l+1}
    = h_{l+1} W_{l+1} but in the last layer), as the plan lists them, one
    scratch of every layer's a, one count."""
    prop, x, ws, bs, _ = _inputs(2, 90, 3, (128, 128, 128))
    out = _streamed_forward(prop, x, ws, bs)
    _close(out, gcn_stack.gcn_stack_reference(prop, x, ws, bs), 1e-5)
    assert gcn_stack.fused_gcn_stack.launches_streamed == 1
    (call,) = fake.calls
    assert call["batch"] == 2 and call["slots"] == 0
    assert fake.shapes == [(2, 90 * 384)]
    steps = call["steps"]
    assert [s["epi"] for s in steps] == [gcn_stack.EPI_STORE] + [
        gcn_stack.EPI_RELU] * 3
    assert [bool(s["w2"]) for s in steps] == [False, True, True, False]
    assert [s["n2"] for s in steps[1:3]] == [128, 128]
    plan = gcn_stack.plan_launch(2, 90, (3, 128, 128, 128))
    assert plan.fused == (True, True)
    assert [(s["m"], s["n"], s["k"]) for s in steps] == list(plan.launches)
    z0 = steps[1]
    # P as gcn_propagation_matrix lays it out: P[i, j] at i + j * N
    assert (z0["m"], z0["n"], z0["k"]) == (90, 128, 90)
    assert (z0["a_s0"], z0["a_s1"], z0["a_bs"]) == (1, 90, 90 * 90)
    # the 32 x 128 tile covers the width; 6 CTAs, so K is split
    assert gcn_stack.STREAM_TILES[z0["tile"]] == (32, 128)
    assert z0["ksplit"] == 2 and not z0["a_k"] and z0["a_vec"] == 2


def test_backward_wrapper_lists_the_vjp_chain(fake):
    """The backward at the same shape: the recompute (L + 1, as the
    forward), per layer from the last da (+ db in the ones row), dW into
    the sample's slot and e (dz of the layer below; dx at layer 0), dP
    once over the concatenated dz and a; then the per-set sum of B slots;
    scratch h, a, dz (N x sum H) and da (N x max H) and the outputs."""
    prop, x, ws, bs, g = _inputs(2, 90, 3, (128, 128, 128))
    got = _streamed_backward(prop, x, ws, bs, g)
    _held(got, gcn_stack.gcn_stack_backward_reference(prop, x, ws, bs, g))
    assert gcn_stack.fused_gcn_stack.launches_streamed == 1
    (call,) = fake.calls
    plan = gcn_stack.plan_backward(2, 90, (3, 128, 128, 128))
    assert (call["batch"], call["slots"], call["sets"], call["wsz"]) == (
        2, 2, 1, plan.wsz)
    assert fake.shapes == [(2, 90, 90), (2 * plan.wsz,), (1, plan.wsz),
                           (2, 90 * 384), (2, 90 * 384), (2, 90 * 384),
                           (2, 90 * 128)]
    S, R, D, G = (gcn_stack.EPI_STORE, gcn_stack.EPI_RELU, gcn_stack.EPI_DA,
                  gcn_stack.EPI_GRAD_MASK)
    steps = call["steps"]
    assert [s["epi"] for s in steps] == (
        [S, R, R, R] + [D, S, G, D, S, G, D, S, S] + [S])
    assert [(s["m"], s["n"], s["k"]) for s in steps] == list(plan.launches)
    assert steps[3]["d"] and not steps[1]["d"]              # dz_{L-1}
    da = steps[4]
    assert (da["m"], da["a_rows"], da["ones"]) == (91, 90, 1)
    # P^T in gcn_propagation_matrix's layout: K contiguous, 8-byte copies
    assert da["a_k"] and da["a_vec"] == 2
    dp = steps[-1]
    assert (dp["m"], dp["n"], dp["k"], dp["c_s0"], dp["c_s1"]) == (
        90, 90, 384, 1, 90)
    assert dp["a_k"] and dp["b_k"]          # dz and a^T: both along K


def test_grouped_wrapper_reads_weight_set_s_over_group(fake):
    prop, x, ws, bs, g = _inputs(6, 90, 3, (128, 128, 128), sets=3)
    _close(_streamed_forward(prop, x, ws, bs),
           gcn_stack.gcn_stack_reference_grouped(prop, x, ws, bs), 1e-5)
    a0 = fake.calls[0]["steps"][0]
    assert (a0["b_div"], a0["b_bs"]) == (2, 3 * 128)
    got = _streamed_backward(prop, x, ws, bs, g)
    _held(got, gcn_stack.gcn_stack_backward_reference(prop, x, ws, bs, g))
    assert (fake.calls[1]["slots"], fake.calls[1]["sets"]) == (2, 3)
    assert gcn_stack.fused_gcn_stack.launches_streamed == 2


def test_a_failed_launch_raises(fake):
    fake.code = 700
    prop, x, ws, bs, g = _inputs(1, 90, 3, (128, 128, 128))
    with pytest.raises(RuntimeError, match="streamed kernel launch failed"):
        gcn_stack._launch(prop, x, ws, bs)
    with pytest.raises(RuntimeError, match="streamed kernel launch failed"):
        _streamed_backward(prop, x, ws, bs, g)
    assert gcn_stack.fused_gcn_stack.launches_streamed == 0


def test_c_product_mirrors_the_kernel_struct():
    """`_CProduct` is csrc/gcn_stack_streamed.cu's Product field for field:
    the pointers, then the strides, then the ints, in the same order."""
    src = (pathlib.Path(__file__).parents[1] / "iggcn_tpu_torch" / "csrc"
           / gcn_stack.STREAMED_SOURCE).read_text()
    body = re.sub(r"//[^\n]*", "", re.search(
        r"struct Product \{(.*?)\};", src, re.S).group(1))
    fields = []
    for kind, names in re.findall(
            r"(const void\*|const float\*|float\*|long long|int)\s+([^;]+);",
            body):
        ctype = {"long long": ctypes.c_longlong, "int": ctypes.c_int}.get(
            kind, ctypes.c_void_p)
        fields += [(name.strip(), ctype) for name in names.split(",")]
    assert fields == list(gcn_stack._CProduct._fields_)
    tiles = gcn_stack.STREAM_TILES
    for name in ("kStore = 0", "kRelu = 1", "kDa = 2", "kGradMask = 3",
                 f"kChunk = {CHUNK};",
                 f"kStages = {gcn_stack.STREAM_STAGES};",
                 f"kPad = {gcn_stack.STREAM_PAD};",
                 f"kMaxThreads = {gcn_stack.STREAM_MAX_THREADS};",
                 f"kTiles = {len(tiles)};",
                 "kTileM[kTiles] = {" + ", ".join(str(m) for m, _ in tiles)
                 + "};",
                 "kTileN[kTiles] = {" + ", ".join(str(n) for _, n in tiles)
                 + "};",
                 f"kMaxSmemBytes = {gcn_stack.STREAM_MAX_SMEM // 1024} "
                 "* 1024;"):
        assert name in src


# the shapes the card times (chip_smoke.py's STREAMED_TIMED, B=32): the
# flagship at --layers 3 --hiddens 128 and the zoo's GCN at 620 nodes at
# three of its search grid's points
TIMED = [(32, 90, 3, (128, 128, 128)), (32, 620, 3, (32, 32, 32)),
         (32, 620, 3, (16, 16, 16)), (32, 620, 3, (10, 10))]


@pytest.mark.parametrize("width,idle", [(16, 0.25), (32, 0.25), (128, 0.25),
                                        (10, 0.375)])
def test_tiles_fit_the_layer_widths(width, idle):
    """A product of a layer's width takes a tile whose idle columns are a
    quarter of it at most (3/8 at width 10, in a tile of 16), at N=90 and
    620 and batches from 1 to 256."""
    for m, batch in itertools.product((90, 620), (1, 32, 256)):
        tile, _ = gcn_stack.choose_tile(m, width, batch)
        bn = gcn_stack.STREAM_TILES[tile][1]
        assert width <= bn and (bn - width) / bn <= idle


@pytest.mark.parametrize("b,n,f0,widths", TIMED)
def test_every_timed_product_fills_the_card_or_splits_k(b, n, f0, widths):
    """Every launch of the forward and the backward at the timed shapes
    has two CTAs per SM of an H100 (264) or splits K over groups of
    warps, within the thread and shared-memory limits."""
    dims = (f0, *widths)
    for plan in (gcn_stack.streamed_plan(n, dims),
                 gcn_stack.streamed_plan(n, dims, backward=True)):
        assert plan.smem_bytes <= gcn_stack.STREAM_MAX_SMEM
        for m, c, _ in plan.launches:
            tile, ks = gcn_stack.choose_tile(m, c, b)
            bm, bn = gcn_stack.STREAM_TILES[tile]
            ctas = -(-m // bm) * -(-c // bn) * b
            assert ctas >= gcn_stack.STREAM_MIN_CTAS or ks > 1
            assert bm * bn // 16 * ks <= gcn_stack.STREAM_MAX_THREADS
            assert ctas <= b * plan.tiles


@pytest.mark.parametrize("what,addr,elem,contiguous,other,batch,vec", [
    ("P at N=620: rows of 2,480 bytes", 0, 4, 1, 620, 620 * 620, 4),
    ("P at N=90: rows of 360 bytes", 0, 4, 1, 90, 90 * 90, 2),
    ("P at N=270: rows of 1,080 bytes", 0, 4, 1, 270, 270 * 270, 2),
    ("x at F0=3: rows of 12 bytes", 0, 4, 1, 3, 620 * 3, 1),
    ("JK slice of (10, 10) at 40 bytes", 40, 4, 1, 20, 620 * 20, 2),
    ("a misaligned base", 4, 4, 1, 620, 620 * 620, 1),
    ("a stride of 2 along the staged dimension", 0, 4, 2, 620, 0, 1),
    ("bf16: plain loads", 0, 2, 1, 620, 620 * 620, 1)])
def test_copy_widths_follow_the_alignment(what, addr, elem, contiguous, other,
                                          batch, vec):
    assert gcn_stack.copy_vec(addr, elem, contiguous, other, batch) == vec


@pytest.mark.parametrize("n,f0,widths,checks", [
    (620, 3, (10, 10), {("z0", "a_vec"): 4, ("a0", "a_vec"): 1,
                        ("z1", "b_vec"): 2}),
    (90, 3, (128, 128, 128), {("z0", "a_vec"): 2, ("a0", "a_vec"): 1,
                              ("z1", "b_vec"): 4}),
    (270, 1, (64,), {("z0", "a_vec"): 2, ("z0", "b_vec"): 4})])
def test_listed_copies_take_the_widest_aligned_vector(fake, n, f0, widths,
                                                      checks):
    """Through the wrapper, on the tensors the port allocates: P's copies
    are 16 bytes at N=620 and 8 at N=90 and 270, x's at F0=3 4 bytes, the
    (10, 10) stack's second JK slice (40 bytes in) 8 bytes."""
    prop, x, ws, bs, _ = _inputs(1, n, f0, widths)
    _streamed_forward(prop, x, ws, bs)
    names = {}
    for p in fake.calls[-1]["steps"]:
        kind = "z" if p["epi"] == gcn_stack.EPI_RELU else "a"
        names[f"{kind}{sum(k.startswith(kind) for k in names)}"] = p
    for (name, field), vec in checks.items():
        assert names[name][field] == vec, (name, field)


# ---- (e) the port against JAX at streamed shapes -------------------------

def _jax_vjp(prop, x, ws, bs, g):
    args = (jnp.asarray(prop.numpy()), jnp.asarray(x.numpy()),
            tuple(jnp.asarray(w.numpy()) for w in ws),
            tuple(jnp.asarray(v.numpy()) for v in bs))
    out, vjp = jax.vjp(lambda *a: jax_fused(*a, True), *args)
    dp, dx, dws, dbs = vjp(jnp.asarray(g.numpy()))
    return (np.asarray(out),
            [np.asarray(dp), np.asarray(dx), [np.asarray(d) for d in dws],
             [np.asarray(d) for d in dbs]])


def _cpu_path(prop, x, ws, bs, g):
    leaves = [t.clone().requires_grad_(True) for t in (prop, x, *ws, *bs)]
    out = gcn_stack.fused_gcn_stack(leaves[0], leaves[1],
                                    leaves[2:2 + len(ws)],
                                    leaves[2 + len(ws):])
    grads = torch.autograd.grad(out, leaves, g)
    layers = len(ws)
    return out.detach(), [grads[0], grads[1], list(grads[2:2 + layers]),
                          list(grads[2 + layers:])]


def _held_np(got, want, rel):
    for gg, w in zip(got, want):
        if isinstance(w, list):
            _held_np(gg, w, rel)
        else:
            _close(gg.numpy(), w, rel)


@pytest.mark.parametrize("b,n,f0,widths", [(2, 20, 3, (8,) * 9),
                                           (2, 90, 3, (128, 128, 128)),
                                           (2, 620, 3, (16, 16))])
def test_stack_matches_jax_at_streamed_shapes(fake, b, n, f0, widths):
    prop, x, ws, bs, g = _inputs(b, n, f0, widths, seed=4)
    assert isinstance(gcn_stack.plan_backward(b, n, (f0, *widths)),
                      gcn_stack.StreamedPlan)
    want_out, want_grads = _jax_vjp(prop, x, ws, bs, g)
    out, grads = _cpu_path(prop, x, ws, bs, g)          # the CPU path
    _close(out.numpy(), want_out, 1e-5)
    _held_np(grads, want_grads, 1e-4)
    streamed_out = _streamed_forward(prop, x, ws, bs)   # the replayed kernel
    _close(streamed_out.numpy(), want_out, 1e-5)
    dprop, dx, dws, dbs = _streamed_backward(prop, x, ws, bs, g)
    _held_np([dprop, dx, dws, dbs], want_grads, 1e-4)
    assert gcn_stack.fused_gcn_stack.launches_streamed == 2


def test_flagship_at_three_layers_of_128_matches_jax():
    """`--layers 3 --hiddens 128` (N=90: both stack kernels stream on the
    card), train mode at dropout 0, on the batch
    `tests/test_torch_port_train_layers.py` uses (7 rows, 2 of them
    padding: with fewer real rows the GO network's train-mode batch norms
    depart further in fp32 on both sides): outputs, the gradients of every
    parameter and the batch statistics against `jax.grad` of the JAX
    model on the same weights."""
    c = synthetic_cohort(np.random.default_rng(2), num_subjects=7)
    inputs = tuple(a.astype(np.float32) for a in (c.x, c.adj, c.snps))
    for a in inputs:
        a[train_layers.W == 0] = 0.0      # padded as pad_to_batches
    cfg = dict(num_layers=3, hidden=128, hidden_linear=16, l_dim=8,
               **train_layers.NO_DROPOUT)
    jmod = JaxFused(cfg=JaxConfig(**cfg),
                    topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmod.init)(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs)))
    shapes = [o.shape for o in jax.eval_shape(
        lambda: jmod.apply(variables, *map(jnp.asarray, inputs)))]
    model = FusedSGCN(ModelConfig(**cfg),
                      synthetic_topology(np.random.default_rng(0)))
    assert isinstance(gcn_stack.plan_launch(7, 90, (3, 128, 128, 128)),
                      gcn_stack.StreamedPlan)
    train_layers._compare_train_pass(jmod, variables, inputs, model, shapes)


def test_gcn_flat_at_620_nodes_matches_jax():
    """The zoo's `GCN` over graphs padded to 620 nodes (PROTEINS' largest),
    three layers of 32: eval log-probabilities and the gradients of every
    parameter against the JAX module on the same weights."""
    rng = np.random.default_rng(6)
    b, n, f0 = 2, 620, 3
    x = rng.normal(size=(b, n, f0)).astype(np.float32)
    adj = (rng.random((b, n, n)) < 0.01).astype(np.float32)
    adj = np.maximum(adj, adj.transpose(0, 2, 1))
    adj[1, 500:] = adj[1, :, 500:] = 0.0        # a smaller, padded graph
    jmod = jax_baselines.GCNFlat(num_layers=3, hidden=32, hidden_linear=16,
                                 dropout_lin=0.0)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                      jnp.asarray(adj)))["params"]
    cot = rng.normal(size=(b, 2)).astype(np.float32)

    def loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(adj))
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    model = GCNFlat(f0, n, num_layers=3, hidden=32, hidden_linear=16,
                    dropout_lin=0.0)
    load_flax_variables(model, params).eval()
    assert isinstance(gcn_stack.plan_launch(b, n, (3, 32, 32, 32)),
                      gcn_stack.StreamedPlan)
    got = model(torch.from_numpy(x), torch.from_numpy(adj))
    _close(got.detach().numpy(), np.asarray(want), 1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    want_grads = {"/".join(k.key for k in path): np.asarray(v) for path, v in
                  jax.tree_util.tree_leaves_with_path(jgrads)}
    for path, t, transposed in _leaves(model):
        g = t.grad.numpy()
        _close(g.T if transposed else g, want_grads["/".join(path[1:])], 1e-4)
