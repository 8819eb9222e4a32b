"""Named plausible misimplementations of the PyTorch port, for the port's
test-sensitivity audit (`scripts/mutation_audit_torch.py`).

Each entry re-introduces, as a runtime patch of `iggcn_tpu_torch.*`, a
semantic drift of the kind a porter writes: the counterparts of
`tests/mutations.py`'s entries for which the port has code (all but its
two mesh mutations, which drift XLA's sharding specs: the port's mesh
has none), two on the GCN stack's side, one that brings atomics back
into the GO network's edge attention, and two that drop a reduction of
the port's data axis (the gradient all-reduce, `BatchNorm1d`'s
statistics). `TARGETS` pins each to the port test that must turn red
under it. The mesh tests' spawned ranks apply the mutation named in the
environment too (`tests/torch_mesh_ranks.py`).

Load this module as a pytest plugin with `scripts/` on `sys.path`:

    IGGCN_TORCH_MUTATION=<name> python -m pytest -p torch_mutations <target>

`pytest_configure` applies the named mutation before any test module is
imported; an unknown name stops pytest with a usage error. A patch
replaces the module attribute and every binding of the same object that
an already imported `iggcn_tpu_torch` module holds (`from ... import`),
so it takes effect whatever the import order.
"""
from __future__ import annotations

import __future__
import inspect
import os
import sys
import textwrap

import numpy as np

ENV = "IGGCN_TORCH_MUTATION"


def _replace(module, name: str, new) -> None:
    """Set `module.name` to `new`, and every other reference to the old
    object in the port's loaded modules."""
    old = getattr(module, name)
    setattr(module, name, new)
    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("iggcn_tpu_torch"):
            for attr, value in list(vars(mod).items()):
                if value is old:
                    setattr(mod, attr, new)


def _rewrite(module, name: str, old: str, new: str) -> None:
    """Redefine `module.name` from its own source with the one occurrence
    of `old` replaced by `new` (the drift written into the code itself)."""
    fn = getattr(module, name)
    src = textwrap.dedent(inspect.getsource(fn))
    if src.count(old) != 1:
        raise RuntimeError(f"{module.__name__}.{name}: expected one "
                           f"{old!r} in its source, found {src.count(old)}")
    space = dict(vars(module))
    code = compile(src.replace(old, new), inspect.getsourcefile(fn), "exec",
                   flags=__future__.annotations.compiler_flag,
                   dont_inherit=True)
    exec(code, space)
    _replace(module, name, space[name])


def _steplr_off_by_one():
    """Decay the learning rate one epoch early (the reference decays after
    epoch % step_size == 0)."""
    from iggcn_tpu_torch.train import steps
    orig = steps.lr_at_step

    def mutated(tcfg, step, steps_per_epoch):
        return orig(tcfg, step + steps_per_epoch, steps_per_epoch)

    _replace(steps, "lr_at_step", mutated)


def _bn_biased_running_var():
    """Store the biased batch variance in running_var (no Bessel
    correction)."""
    from iggcn_tpu_torch.models import nn_compat
    _replace(nn_compat, "unbiased_var_factor", lambda n_red: 1.0)


def _adam_decoupled_decay():
    """AdamW's decoupled weight decay instead of torch.optim.Adam's coupled
    L2 (the decay added to the gradient before the moments)."""
    import torch

    from iggcn_tpu_torch.train import steps

    def mutated(model, tcfg):
        return torch.optim.AdamW(model.parameters(), lr=tcfg.lr,
                                 weight_decay=tcfg.weight_decay)

    _replace(steps, "make_optimizer", mutated)


def _gcn_no_self_loops():
    """Leave the self-loops out of the GCN normalisation."""
    from iggcn_tpu_torch.ops import gcn
    orig = gcn.gcn_propagation_matrix

    def mutated(adj, *, add_self_loops=True, **kw):
        del add_self_loops
        return orig(adj, add_self_loops=False, **kw)

    _replace(gcn, "gcn_propagation_matrix", mutated)


def _sparsity_entropy_dropped():
    """Keep only the L1 half of the sparsity penalty, not its binary
    entropy."""
    import torch

    from iggcn_tpu_torch.train import losses
    _replace(losses, "_binary_entropy",
             lambda p, eps=1e-6: torch.zeros_like(p))


def _consistency_unnormalized():
    """Drop the 1/n^2 of the similarity-consistency term."""
    from iggcn_tpu_torch.train import losses
    orig = losses.consistency_loss

    def mutated(s, weight_matrix, member=None):
        n = s.shape[0]
        return orig(s, weight_matrix, member) * (n * n)

    _replace(losses, "consistency_loss", mutated)


def _fold_padding_gate_removed():
    """Drop the fold-parallel step's gate: a fold whose batch is all
    cross-fold padding steps Adam (its param-only penalties move it) and
    advances its step count."""
    from iggcn_tpu_torch.train import steps
    orig = steps.batched_train_step

    def mutated(state, batch, mcfg, tcfg, noise, has_real):
        return orig(state, batch, mcfg, tcfg, noise,
                    np.ones_like(np.asarray(has_real), dtype=bool))

    _replace(steps, "batched_train_step", mutated)


def _fold_perms_pad_from_zero():
    """Pad the stacked epoch permutations with 0..pad instead of the new
    padding rows' indices: padded slots re-sample real subjects."""
    from iggcn_tpu_torch.train import fold_parallel

    def mutated(perms, target):
        e, s = perms.shape
        if s == target:
            return perms
        extra = np.broadcast_to(np.arange(0, target - s, dtype=perms.dtype),
                                (e, target - s))
        return np.concatenate([perms, extra], axis=1)

    _replace(fold_parallel, "extend_perms", mutated)


def _gat_leaky_slope_dropped():
    """Score GAT attention logits with relu instead of
    leaky_relu(0.2)."""
    from iggcn_tpu_torch.ops import gat
    orig = gat.gat_conv

    def mutated(x, adj, p, negative_slope=0.2):
        return orig(x, adj, p, negative_slope=0.0)

    _replace(gat, "gat_conv", mutated)


def _gat_self_loop_fill_one():
    """GAT self-loops of weight 1 instead of PyG's fill_value='mean'."""
    import torch

    from iggcn_tpu_torch.ops import gat
    _replace(gat, "_self_loop_fill",
             lambda w_off, mask_off: torch.ones_like(w_off.sum(dim=1)))


def _gin_mlp_variant_swapped():
    """Give GIN (train_eps=True) GIN0's MLP."""
    from iggcn_tpu_torch.models import baselines
    baselines._GINMLPLateBN = baselines._GINMLP


def _impute_fit_on_all_splits():
    """Fit the KNN imputer on train, val and test together (leakage; the
    reference fits on the train fold only)."""
    from iggcn_tpu_torch.data import impute
    from iggcn_tpu_torch.data.adni import CLINICAL_SELECT_INDEX

    def mutated(demographics_splits, scaler4score, clinical_score_index=-1,
                k=3):
        imputer = impute.KNNImputer(n_neighbors=k)
        imputer.fit(np.vstack(demographics_splits))
        scaled = [scaler4score.transform(imputer.transform(d))
                  for d in demographics_splits]
        sel = (CLINICAL_SELECT_INDEX if clinical_score_index == -1
               else np.array([clinical_score_index]))
        return [s[:, sel].astype(np.float32) for s in scaled]

    _replace(impute, "knn_impute_scores", mutated)


def _kfold_val_is_next():
    """Take the next test fold as the validation fold, not the previous
    one."""
    from iggcn_tpu_torch.data import splits
    orig = splits.k_fold

    def mutated(y, folds, seed):
        tests = [te for _, te, _ in orig(y, folds, seed)]
        out = []
        for i in range(folds):
            val = tests[(i + 1) % folds]
            mask = np.ones(len(y), dtype=bool)
            mask[tests[i]] = False
            mask[val] = False
            out.append((np.nonzero(mask)[0], tests[i], val))
        return out

    _replace(splits, "k_fold", mutated)


def _padding_weights_ignored():
    """Average the data losses over every row, padding rows (w = 0)
    included."""
    from iggcn_tpu_torch.train import losses

    def mutated(values, sample_weight=None):
        del sample_weight
        return values.mean()

    _replace(losses, "weighted_mean", mutated)


def _ppr_row_normalized():
    """Random-walk normalisation D^-1 A in the PPR matrix instead of the
    symmetric D^-1/2 A D^-1/2."""
    from iggcn_tpu_torch.data import diffusion

    def mutated(adj, alpha=0.05):
        n = adj.shape[0]
        h = adj / adj.sum(axis=1, keepdims=True)
        return alpha * np.linalg.inv(np.eye(n) - (1 - alpha) * h)

    _replace(diffusion, "get_ppr_matrix", mutated)


def _topk_per_row():
    """Keep the top-k of each row (then row-normalise) instead of each
    column."""
    from iggcn_tpu_torch.data import diffusion
    orig = diffusion.get_top_k_matrix

    def mutated(a, k=5):
        return np.ascontiguousarray(orig(np.ascontiguousarray(a.T), k).T)

    _replace(diffusion, "get_top_k_matrix", mutated)


def _stack_backward_relu_tie():
    """The stack's plain backward passes gradient where z = 0 (relu's
    mask >= 0, where the JAX VJP's is strict)."""
    from iggcn_tpu_torch.ops import gcn_stack
    _rewrite(gcn_stack, "gcn_stack_backward_reference", "(zs[layer] > 0)",
             "(zs[layer] >= 0)")


def _stack_plan_tile():
    """The resident kernel's plan takes the K split that gives two warps
    of tiles, not four."""
    from iggcn_tpu_torch.ops import gcn_stack
    _rewrite(gcn_stack, "_plan_for", "tiles * k >= 128", "tiles * k >= 64")
    gcn_stack._choose_plan.cache_clear()


def _go_index_add():
    """Aggregate the GO encoder's edge attention with `index_add_` over
    the edge list and gather by index (the port's form before it took the
    JAX package's one-hot products): the same values, but on CUDA the
    sums are float atomics in launch order, so runs do not repeat."""
    import torch
    from iggcn_tpu_torch.models import go_network
    from iggcn_tpu_torch.models.nn_compat import promoted
    orig = go_network.GeneOntologyNetwork._attend

    def mutated(self, jj, x_in, use_edge):
        if not use_edge:
            return orig(self, jj, x_in, use_edge)
        w_att = getattr(self, f"w_att_in_{jj}")
        f = x_in.shape[-1]
        x_in, w_att = promoted(x_in, w_att)
        u = x_in @ w_att[:f, 0]
        v = x_in @ w_att[f:, 0]
        rows = getattr(self, f"agg_{jj}").argmax(dim=0)
        cols = getattr(self, f"pick_{jj}").argmax(dim=0)
        scores_e = torch.exp(torch.tanh(u[:, rows] + v[:, cols]))
        rowsum = torch.zeros_like(u).index_add_(1, rows, scores_e)
        msg = (scores_e / rowsum[:, rows])[..., None] * x_in[:, cols, :]
        return torch.zeros_like(x_in).index_add_(1, rows, msg)

    go_network.GeneOntologyNetwork._attend = mutated


def _mesh_grad_allreduce_dropped():
    """Skip the gradient all-reduce over the data axis: each position
    steps Adam on its own rows' share of the gradient, so the data
    replicas of a fold drift apart and none trains on the whole batch."""
    from iggcn_tpu_torch.parallel import mesh

    def mutated(params, shard):
        del params, shard

    _replace(mesh, "all_reduce_grads", mutated)


def _mesh_bn_sync_dropped():
    """Normalise each position's rows with its own rows' batch statistics
    (the batch norm's sums not summed over the data axis)."""
    import types

    from iggcn_tpu_torch.models import nn_compat
    from iggcn_tpu_torch.parallel import mesh
    local = types.SimpleNamespace(**vars(mesh))
    local.all_reduce_sum = (lambda *tensors, shard=None: tensors[0]
                            if len(tensors) == 1 else tensors)
    nn_compat.mesh = local


MUTATIONS = {
    "steplr_off_by_one": _steplr_off_by_one,
    "bn_biased_running_var": _bn_biased_running_var,
    "adam_decoupled_decay": _adam_decoupled_decay,
    "gcn_no_self_loops": _gcn_no_self_loops,
    "sparsity_entropy_dropped": _sparsity_entropy_dropped,
    "consistency_unnormalized": _consistency_unnormalized,
    "fold_padding_gate_removed": _fold_padding_gate_removed,
    "fold_perms_pad_from_zero": _fold_perms_pad_from_zero,
    "gat_leaky_slope_dropped": _gat_leaky_slope_dropped,
    "gat_self_loop_fill_one": _gat_self_loop_fill_one,
    "gin_mlp_variant_swapped": _gin_mlp_variant_swapped,
    "impute_fit_on_all_splits": _impute_fit_on_all_splits,
    "kfold_val_is_next": _kfold_val_is_next,
    "padding_weights_ignored": _padding_weights_ignored,
    "ppr_row_normalized": _ppr_row_normalized,
    "topk_per_row": _topk_per_row,
    "stack_backward_relu_tie": _stack_backward_relu_tie,
    "stack_plan_tile": _stack_plan_tile,
    "go_index_add": _go_index_add,
    "mesh_grad_allreduce_dropped": _mesh_grad_allreduce_dropped,
    "mesh_bn_sync_dropped": _mesh_bn_sync_dropped,
}


# the port test pinned to catch each mutation (file::test)
_T = "tests/test_torch_port_"
TARGETS = {
    "steplr_off_by_one":
        _T + "trajectory.py::test_six_steps_match_make_train_step",
    "bn_biased_running_var":
        _T + "trajectory.py::test_six_steps_match_make_train_step",
    "adam_decoupled_decay":
        _T + "trajectory.py::test_six_steps_match_make_train_step",
    "gcn_no_self_loops": _T + "ops.py::test_propagation_matrix_matches_jax",
    "sparsity_entropy_dropped": _T + "losses.py::test_sparsity_loss",
    "consistency_unnormalized":
        _T + "losses.py::test_consistency_loss_and_rbf_kernel",
    "fold_padding_gate_removed":
        _T + "fold_parallel.py::test_an_all_padding_batch_is_a_no_op",
    "fold_perms_pad_from_zero":
        _T + "fold_parallel.py::test_fold_parallel_equals_sequential_fold_by"
        "_fold",
    "gat_leaky_slope_dropped": _T + "gat.py::test_gat_conv_matches_jax",
    "gat_self_loop_fill_one":
        _T + "gat.py::test_self_loop_fill_is_the_mean_incoming_weight",
    "gin_mlp_variant_swapped":
        _T + "zoo_models.py::test_forward_repr_and_weights_match_jax",
    "impute_fit_on_all_splits":
        _T + "data.py::test_knn_imputation_is_bit_equal",
    "kfold_val_is_next": _T + "data.py::test_k_fold_is_bit_equal",
    "padding_weights_ignored":
        _T + "losses.py::test_nll_mse_recon_and_weighted_mean",
    "ppr_row_normalized": _T + "data.py::test_numpy_diffusion_is_bit_equal",
    "topk_per_row": _T + "data.py::test_numpy_diffusion_is_bit_equal",
    "stack_backward_relu_tie":
        _T + "gcn_stack_backward.py::test_relu_tie_at_zero_gives_zero_"
        "gradient_in_both_packages",
    "stack_plan_tile": _T + "gcn_stack_streamed.py::test_resident_plans_are"
        "_unchanged_field_for_field",
    "go_index_add": _T + "determinism.py::test_fused_train_step_has_no_"
        "atomics[SGCN_GCN_IMGSNP-64]",
    "mesh_grad_allreduce_dropped":
        _T + "mesh.py::test_dp_step_equals_the_single_step[4]",
    "mesh_bn_sync_dropped":
        _T + "mesh.py::test_data_axis_piece_equals_the_unsharded_batch"
        "[bn2-7-2]",
}


def apply_mutation(name: str) -> None:
    if name not in MUTATIONS:
        raise KeyError(f"unknown {ENV} {name!r}; known: {sorted(MUTATIONS)}")
    MUTATIONS[name]()


def pytest_configure(config):
    name = os.environ.get(ENV)
    if name:
        import pytest
        try:
            apply_mutation(name)
        except KeyError as e:
            raise pytest.UsageError(str(e)) from None
