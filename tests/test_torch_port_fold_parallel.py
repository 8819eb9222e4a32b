"""The port's fold-parallel training (`iggcn_tpu_torch/train/fold_parallel.py`,
the batched steps of `train/steps.py`, the grouped form of
`ops/gcn_stack.py`) on the CPU.

* The grouped plain stack equals the per-fold loop exactly, and
  `torch.func.vmap` of `fused_gcn_stack` over a fold axis equals per-fold
  calls and their autograd, in one call of the grouped form with P kept
  in the transposed layout `gcn_propagation_matrix` returns; `_CPlan`
  mirrors the kernel's `StackPlan`, the grouped fields included.
* Every fused family trains fold-parallel as it trains one fold after the
  other, fold by fold, with dropout on (each fold draws its uniforms from
  its own generator): 3 folds x 2 epochs over 49 subjects at batch 8,
  where two folds' train sets take one batch fewer than the third's, so
  the cross-fold equalisation makes all-padding batches in every epoch,
  and the learning rate decays every epoch on each fold's own schedule.
  Per-epoch train/val/test loss sums within rtol 2e-4, the selected epoch
  equal, and the selected epoch's test predictions equal except for ties:
  a subject whose two best class log-probabilities are within `TIE`
  (1e-4) of each other in the sequential run's eval is a decision fp32
  rounding makes (the batched and the per-fold products sum in other
  orders), as `tests/test_torch_port_zoo_cv.py` states it. SGCN_Ori
  trains at lr 1e-4: its relu -> batch-norm head is chaotic in fp32 (see
  `tests/test_torch_port_families.py`): a bias whose gradient cancels to
  rounding takes an Adam step of +-lr on one side and not the other, and
  at lr 1e-3 one such step already parts the folds' losses by 1 %.
* An all-padding batch is a complete no-op for its fold; the resume rule
  of a fold-parallel run (a partial set of saved folds is retrained
  whole; a complete set, from either kind of run, is restored).
* The port's flagship fold-parallel CV equals the JAX package's
  (`cross_validation` with `fold_parallel=True`) on transferred weights at
  dropout 0, 3 folds x 2 epochs: per-epoch losses rtol 2e-4, the same
  best epochs and score matrix.
"""
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iggcn_tpu.config import LossWeights as JaxLW
from iggcn_tpu.config import ModelConfig as JaxMC
from iggcn_tpu.config import TrainConfig as JaxTC
from iggcn_tpu.data.adni import synthetic_cohort as jax_cohort
from iggcn_tpu.data.go_graph import synthetic_topology as jax_topology
from iggcn_tpu.models.fused_sgcn import FusedSGCN as JaxFused
from iggcn_tpu.train.cv import cross_validation as jax_cv
from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.batching import cohort_batch_arrays
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.data.splits import k_fold
from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.train import fold_parallel, steps
from iggcn_tpu_torch.train.cv import (cross_validation, init_fold_model,
                                      prepare_fold, to_device)
from iggcn_tpu_torch.train.fold_loop import run_fold

TIE = 1e-4
# case -> (model kind, ModelConfig fields); dropout at the families' rates
FAMILIES = {
    "SGCN_GCN_IMGSNP": ("sgcn_imgsnp", {}),
    "GCN_IMGSNP": ("gcn_imgsnp", {}),
    "GUIDE_IMGSNP": ("guide_imgsnp", {}),
    "SGCN_GCN_CLUSTERLABEL": ("clusterlabel", {}),
    "SGCN_GCN": ("sgcn_image", {}),
    "SGCN_GAT": ("sgcn_image", {"use_gat": True}),
    "SGCN_Ori": ("sgcn_ori", {}),
}
SMALL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
             num_classes=2)
LOSS = dict(disease=1.0, regr=1.0, prob=0.5, reco=1.5e-6, simi=0.1, orth=0.1)
# GUIDE reads prob as its SNP reconstruction weight (as in the families
# test): at 0.5 the summed SNP error dominates every other term
GUIDE_LOSS = dict(disease=1.0, regr=1.0, prob=1e-4, reco=1e-3, simi=0.1,
                  orth=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _stack_inputs(f, b, n, f0, widths, seed=0):
    rng = np.random.default_rng(seed)
    adj = torch.from_numpy(np.abs(rng.normal(size=(f, b, n, n))).astype(
        np.float32))
    x = torch.from_numpy(rng.normal(size=(f, b, n, f0)).astype(np.float32))
    dims = [f0] + list(widths)
    ws = [torch.from_numpy(rng.normal(0, 0.3, (f, dims[i], dims[i + 1]))
                           .astype(np.float32)) for i in range(len(widths))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, (f, h)).astype(np.float32))
          for h in widths]
    return adj, x, ws, bs


@pytest.mark.parametrize("n,f0,widths", [(90, 3, (16, 16)),
                                         (27, 1, (10, 10, 10))])
def test_grouped_reference_equals_the_per_fold_loop(n, f0, widths):
    adj, x, ws, bs = _stack_inputs(4, 5, n, f0, widths)
    prop = gcn_propagation_matrix(adj)
    got = gcn_stack.gcn_stack_reference_grouped(
        prop.reshape(20, n, n), x.reshape(20, n, f0), ws, bs)
    want = torch.cat([gcn_stack.gcn_stack_reference(
        prop[g], x[g], [w[g] for w in ws], [v[g] for v in bs])
        for g in range(4)])
    assert torch.equal(got, want)
    # the wrapper's CPU path of the grouped form is the same function
    assert torch.equal(gcn_stack.fused_gcn_stack(
        prop.reshape(20, n, n), x.reshape(20, n, f0), ws, bs), want)


def test_vmap_of_the_stack_is_one_grouped_call(monkeypatch):
    adj, x, ws, bs = _stack_inputs(3, 4, 90, 3, (16, 16), seed=1)
    calls = []
    grouped = gcn_stack.gcn_stack_reference_grouped

    def spy(prop, *args):
        calls.append((tuple(prop.shape), gcn_stack._prop_transposed(prop)))
        return grouped(prop, *args)

    monkeypatch.setattr(gcn_stack, "gcn_stack_reference_grouped", spy)

    def per_fold(a, xx, w0, w1, b0, b1):
        return gcn_stack.fused_gcn_stack(gcn_propagation_matrix(a), xx,
                                         [w0, w1], [b0, b1])

    leaves = [t.clone().requires_grad_(True) for t in (adj, x, *ws, *bs)]
    out = torch.func.vmap(per_fold)(*leaves)
    # one grouped call for the three folds, P still the transposed view
    assert calls == [((12, 90, 90), True)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (adj, x, *ws, *bs)]
    want = torch.stack([gcn_stack.gcn_stack_reference(
        gcn_propagation_matrix(ref_leaves[0][f]), ref_leaves[1][f],
        [w[f] for w in ref_leaves[2:4]], [v[f] for v in ref_leaves[4:]])
        for f in range(3)])
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    cot = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, cot)
    exp = torch.autograd.grad(want, ref_leaves, cot)
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=1e-6, atol=1e-6)
    # weights without the fold axis broadcast to every fold
    shared = torch.func.vmap(per_fold, in_dims=(0, 0, None, None, None, None))(
        adj, x, ws[0][0], ws[1][0], bs[0][0], bs[1][0])
    torch.testing.assert_close(shared, torch.stack([
        gcn_stack.gcn_stack_reference(gcn_propagation_matrix(adj[f]), x[f],
                                      [ws[0][0], ws[1][0]],
                                      [bs[0][0], bs[1][0]])
        for f in range(3)]), rtol=0, atol=0)


def test_grouped_inputs_are_checked():
    adj, x, ws, bs = _stack_inputs(2, 3, 12, 3, (4, 4))
    prop = gcn_propagation_matrix(adj).reshape(6, 12, 12)
    xs = x.reshape(6, 12, 3)
    assert gcn_stack._check_inputs(prop, xs, ws, bs) == ([3, 4, 4], True)
    assert gcn_stack._weight_sets(ws) == 2
    broadcast = [w[0].expand(2, *w.shape[1:]) for w in ws]   # stride 0
    assert gcn_stack._check_inputs(prop, xs, broadcast, bs)[0] == [3, 4, 4]
    with pytest.raises(ValueError, match="do not split into 4"):
        gcn_stack._check_inputs(prop, xs, [w.repeat(2, 1, 1) for w in ws],
                                [v.repeat(2, 1) for v in bs])
    with pytest.raises(ValueError, match="do not chain"):
        gcn_stack._check_inputs(prop, xs, ws, [v[0] for v in bs])
    with pytest.raises(ValueError, match="within each weight set"):
        gcn_stack._check_inputs(prop, xs, [w.mT.contiguous().mT
                                           for w in ws[:1]] + ws[1:], bs)


def test_c_plan_carries_the_grouped_fields_in_the_kernel_order():
    """`_CPlan` is csrc/gcn_stack.cu's StackPlan field for field: `group`
    after `copy_bulk`, the per-layer `w_stride` and `b_stride` last."""
    src = (pathlib.Path(__file__).parents[1] / "iggcn_tpu_torch" / "csrc"
           / "gcn_stack.cu").read_text()
    body = re.search(r"struct StackPlan \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.findall(r"^\s*int ([^;]+);", body, re.M):
        for name in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)(?:\[(.+)\])?\s*", name)
            fields.append((m.group(1), {None: None,
                                        "kMaxLayers": gcn_stack.MAX_LAYERS,
                                        "kMaxLayers + 1":
                                            gcn_stack.MAX_LAYERS + 1}
                           [m.group(2)]))
    ours = [(name, getattr(ctype, "_length_", None))
            for name, ctype in gcn_stack._CPlan._fields_]
    assert fields == ours
    names = [n for n, _ in ours]
    assert names.index("group") == names.index("copy_bulk") + 1
    assert names[-2:] == ["w_stride", "b_stride"]
    plan = gcn_stack.plan_launch(10, 90, (3, 16, 16))
    c = gcn_stack._c_plan(plan, 90, (3, 16, 16), True, True, 5,
                          (48, 256) + (0,) * 6, (16, 16) + (0,) * 6)
    assert (c.group, list(c.w_stride)[:3], list(c.b_stride)[:3]) == (
        5, [48, 256, 0], [16, 16, 0])


@pytest.fixture(scope="module")
def data():
    return (synthetic_cohort(np.random.default_rng(1), num_subjects=49,
                             num_classes=2),
            synthetic_topology(np.random.default_rng(0)))


def _family(case):
    kind, extra = FAMILIES[case]
    mcfg = ModelConfig(**SMALL, **extra)
    loss = GUIDE_LOSS if kind == "guide_imgsnp" else LOSS
    tcfg = TrainConfig(epochs=2, batch_size=8, folds=3, seed=1,
                       lr=1e-4 if kind == "sgcn_ori" else 1e-3,
                       lr_decay_step_size=1, loss=LossWeights(**loss))
    return kind, mcfg, tcfg


def _folds(cohort, tcfg):
    full = cohort_batch_arrays(cohort)
    return [prepare_fold(cohort, full, split, f, tcfg, -1)
            for f, split in enumerate(k_fold(cohort.y, tcfg.folds,
                                             tcfg.seed))]


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_fold_parallel_equals_sequential_fold_by_fold(data, case):
    cohort, topo = data
    kind, mcfg, tcfg = _family(case)
    ps = _folds(cohort, tcfg)
    spe = [p["train_data"]["y"].shape[0] // tcfg.batch_size for p in ps]
    assert len(set(spe)) > 1        # the equalisation pads whole batches
    cpu = torch.device("cpu")
    inits = [init_fold_model(mcfg, topo, tcfg.seed, f, cpu, kind=kind)
             for f in range(len(ps))]
    per_epoch, best, _ = fold_parallel.run_folds_parallel(
        [m for m, _ in inits], [g for _, g in inits],
        [p["train_data"] for p in ps], [p["val_data"] for p in ps],
        [p["test_data"] for p in ps], [p["perms"] for p in ps], spe, mcfg,
        tcfg, kind)
    for f, p in enumerate(ps):
        model, gen = init_fold_model(mcfg, topo, tcfg.seed, f, cpu, kind=kind)
        want, want_best, _ = run_fold(
            steps.TrainState(model, tcfg, spe[f], kind),
            to_device(p["train_data"], cpu), to_device(p["val_data"], cpu),
            to_device(p["test_data"], cpu), p["perms"], mcfg, tcfg, gen)
        got = per_epoch[f]
        for key in ("train_loss_sum", "val_loss_sum", "test_loss_sum"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                       err_msg=f"{case} fold {f} {key}")
        assert np.isclose(best[f]["val_loss_sum"], want_best["val_loss_sum"],
                          rtol=2e-4)
        chosen = int(np.argmin(want["val_loss_sum"]))
        assert int(np.argmin(got["val_loss_sum"])) == chosen
        lp = np.sort(want_best["test"]["log_probs"], axis=1)
        decided = lp[:, -1] - lp[:, -2] > TIE
        np.testing.assert_array_equal(best[f]["test"]["pred"][decided],
                                      want_best["test"]["pred"][decided])
        for k, v in want_best["state"].items():
            assert best[f]["state"][k].shape == v.shape


def test_an_all_padding_batch_is_a_no_op(data):
    cohort, topo = data
    kind, mcfg, tcfg = _family("SGCN_GCN_IMGSNP")
    ps = _folds(cohort, tcfg)
    cpu = torch.device("cpu")
    models = [init_fold_model(mcfg, topo, tcfg.seed, f, cpu, kind=kind)[0]
              for f in range(3)]
    state = steps.StackedState(models, tcfg, [2, 2, 3], kind, steps=[4, 4, 6])
    batch = {k: torch.as_tensor(np.stack([p["train_data"][k][:8]
                                          for p in ps]))
             for k in ps[0]["train_data"]}
    batch["w"][1] = 0.0               # fold 1: only padding rows
    before = {name: {k: v.detach().clone() for k, v in tensors.items()}
              for name, tensors in (("params", state.params),
                                    ("buffers", state.buffers),
                                    ("exp_avg", state.exp_avg),
                                    ("exp_avg_sq", state.exp_avg_sq))}
    gens = [torch.Generator().manual_seed(f) for f in range(3)]
    shapes = steps.record_noise_shapes(state, batch, mcfg, tcfg)
    assert shapes                     # dropout on: the forward draws
    g1 = gens[1].get_state()
    noise = steps.draw_fold_noise(shapes, [gens[0], None, gens[2]], cpu)
    assert torch.equal(gens[1].get_state(), g1)
    out = steps.batched_train_step(state, batch, mcfg, tcfg, noise,
                                   np.array([True, False, True]))
    assert float(out[1]) == 0.0
    assert state.steps.tolist() == [5, 4, 7]
    for name, tensors in (("params", state.params), ("buffers", state.buffers),
                          ("exp_avg", state.exp_avg),
                          ("exp_avg_sq", state.exp_avg_sq)):
        moved = 0
        for k, v in tensors.items():
            assert torch.equal(v[1], before[name][k][1]), (name, k)
            moved += int(not torch.equal(v[0], before[name][k][0]))
        assert moved > 0, name


def _run(cohort, topo, tcfg, res_dir, mcfg, **kw):
    lines = []
    cross_validation(cohort, topo, mcfg, tcfg, res_dir=str(res_dir),
                     result_file_name="r", logger=lines.append,
                     device="cpu", **kw)
    return lines


def test_resume_rule(data, tmp_path, capsys):
    cohort, topo = data
    kind, mcfg, tcfg = _family("SGCN_GCN")
    fp = dataclasses.replace(tcfg, fold_parallel=True)
    first = _run(cohort, topo, fp, tmp_path, mcfg, model_kind=kind)
    records = sorted(tmp_path.glob("fold_result_*"))
    assert len(records) == 3
    records[1].unlink()
    capsys.readouterr()
    again = _run(cohort, topo, fp, tmp_path, mcfg, model_kind=kind,
                 resume=True)
    out = capsys.readouterr().out
    assert ("[resume] fold_parallel trains all folds in one program; 2/3 "
            "saved folds is not a complete set — retraining everything (drop "
            "--fold_parallel to resume fold-by-fold)") in out
    assert "restored" not in out and again == first
    # a complete set resumes under either kind of run, the other's too
    seq = _run(cohort, topo, tcfg, tmp_path, mcfg, model_kind=kind,
               resume=True)
    assert sum("restored" in line for line in seq) == 3
    other = tmp_path / "seq"
    _run(cohort, topo, tcfg, other, mcfg, model_kind=kind)
    restored = _run(cohort, topo, fp, other, mcfg, model_kind=kind,
                    resume=True)
    assert sum("restored" in line for line in restored) == 3


LINE = re.compile(r"Fold: (\d+), epoch:(\d+), train_loss: ([-\d.naninf]+), "
                  r"val_loss: ([-\d.naninf]+), test_loss: ([-\d.naninf]+)")
JAX_MODEL = dict(num_layers=2, hidden=8, hidden_linear=16, l_dim=8,
                 num_classes=2, dropout_lin=0.0, dropout_regr=0.0,
                 dropout_go=0.0, dropout_readout=0.0)
JAX_TRAIN = dict(epochs=2, batch_size=8, folds=3, lr=3e-3, weight_decay=1e-2,
                 lr_decay_step_size=1, fold_parallel=True)


def test_flagship_fold_parallel_cv_matches_jax(tmp_path):
    jmodel = JaxFused(cfg=JaxMC(**JAX_MODEL),
                      topo=jax_topology(np.random.default_rng(0)))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((8, 90, 3)), jnp.zeros((8, 90, 90)),
        jnp.zeros((8, 54))))
    warm = (variables["params"], variables["batch_stats"], "shared")
    runs = {}
    for side, cv, cohort, topo, mcfg, tcfg, kw in (
            ("jax", jax_cv, jax_cohort, jax_topology, JaxMC(**JAX_MODEL),
             JaxTC(**JAX_TRAIN, loss=JaxLW(**LOSS)), {}),
            ("port", cross_validation, synthetic_cohort, synthetic_topology,
             ModelConfig(**JAX_MODEL),
             TrainConfig(**JAX_TRAIN, loss=LossWeights(**LOSS)),
             {"device": "cpu"})):
        lines = []
        result = cv(cohort(np.random.default_rng(1), num_subjects=49),
                    topo(np.random.default_rng(0)), mcfg, tcfg,
                    res_dir=str(tmp_path / side), result_file_name="r",
                    logger=lines.append, warm_start=warm, **kw)
        epochs = {(int(m[1]), int(m[2])): tuple(map(float, m.group(3, 4, 5)))
                  for m in map(LINE.match, lines) if m}
        runs[side] = (result, epochs)
    (want, want_ep), (got, got_ep) = runs["jax"], runs["port"]
    assert got_ep.keys() == want_ep.keys() and len(want_ep) == 6
    for key, w in want_ep.items():
        np.testing.assert_allclose(got_ep[key], w, rtol=2e-4, err_msg=str(key))
    for fold in range(3):
        assert (min((1, 2), key=lambda e: got_ep[fold, e][1])
                == min((1, 2), key=lambda e: want_ep[fold, e][1]))
    np.testing.assert_allclose(got.score_result, want.score_result, atol=1e-6)
    np.testing.assert_allclose(got.mean_test_loss, want.mean_test_loss,
                               rtol=2e-4)
