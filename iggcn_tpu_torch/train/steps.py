"""Train and eval steps of the fused model families (port of
`iggcn_tpu/train/steps.py`).

Each family has its objective, looked up by model kind in `OBJECTIVES`
(the keys of the JAX package's table): the flagship's 7-term
`fused_objective`, `gcn_fusion_objective` (GCN_IMGSNP, one forward),
`sgcn_image_objective` (SGCN_GCN, SGCN_GAT, SGCN_Ori), `guide_objective`
and `clusterlabel_objective`. The two-pass objectives run the reference's
plain pass and then its importance-masked pass (`is_explain=True`) on one
module in train mode, so the batch norms' running statistics move in that
order; the JAX package runs them sequentially or, for the flagship,
rebuilds that order from one vmapped pass (`_dual_pass`). The optimiser
is `torch.optim.Adam` with coupled L2
(`weight_decay`, as `adam_transform` chains it), and the learning rate is
set into the param group before every step from the count of completed
steps: StepLR per epoch, as `lr_at_step`.

Batches are dicts of tensors on one device: x (B,N,D), adj (B,N,N),
snps (B,S), y (B,), clini (B,R), clust_y (B,), tsne (B,F) and the 0/1 row
weight w (B,). Padded rows have w = 0 and every reduction is weighted by
w.

The fold-batched steps (`batched_train_step`, `batched_eval_step`) run
the same objectives for F folds at once, as the JAX package's vmapped
fold program does: `torch.func.vmap` over `functional_call` of the
fold-stacked params and batch statistics (`StackedState`), one backward
of the summed (F,) losses, then Adam with coupled L2 written out over
the stacked tensors, with each fold's own step count and learning rate
(from its own real steps per epoch). Dropout draws each fold's uniforms
from that fold's generator beforehand (`draw_fold_noise`), in the order
the sequential forward would, so a fold trains as it would alone. The
padding gate: a fold whose batch has no real rows (only cross-fold
equalisation makes such batches) keeps its params, batch statistics,
Adam moments and step count, as `iggcn_tpu/train/steps.py`'s
`gate_padding` does.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
from iggcn_tpu_torch.models.nn_compat import NoiseSource, ShapeRecorder
from iggcn_tpu_torch.parallel import mesh
from iggcn_tpu_torch.train import losses

Batch = Dict[str, torch.Tensor]
# per-sample outputs an eval step returns when the family's model has them
EVAL_FIELDS = ("our_reg", "out_lin", "linear_outf", "log_probs_cluster")


def lr_at_step(tcfg: TrainConfig, step: int, steps_per_epoch: int) -> float:
    """StepLR: lr * factor every `lr_decay_step_size` completed epochs;
    `step` counts completed optimiser steps, so the first step of epoch
    step_size + 1 is already decayed."""
    if tcfg.lr_decay_step_size <= 0:
        return tcfg.lr
    epoch = step // max(steps_per_epoch, 1)
    return tcfg.lr * tcfg.lr_decay_factor ** (epoch // tcfg.lr_decay_step_size)


def make_optimizer(model: nn.Module, tcfg: TrainConfig) -> torch.optim.Adam:
    """Adam with coupled L2 decay (the decay is added to the gradient before
    the moments, as torch's `weight_decay` and the JAX package's
    `add_decayed_weights` + `scale_by_adam` do). The LR is set per step."""
    return torch.optim.Adam(model.parameters(), lr=tcfg.lr,
                            weight_decay=tcfg.weight_decay)


def fused_objective(model: nn.Module, batch: Batch, mcfg: ModelConfig,
                    tcfg: TrainConfig, *, train: bool,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The 7-term objective on one batch, plain pass then masked pass.
    `train` puts the model in train mode (batch statistics, dropout from
    `generator`) or eval mode (running statistics, no dropout). Returns
    (loss, aux) with aux holding both passes' outputs and each term."""
    lw, sw = tcfg.loss, tcfg.sparsity
    w = batch["w"]
    x, adj, snps = batch["x"], batch["adj"], batch["snps"]
    out = _forward(model, batch, train, generator)
    out_prob = _forward(model, batch, train, generator, is_explain=True)

    y = batch["y"]
    if lw.disease == 0:     # the reference's `if lambda_loss[0] == 0` guard
        loss_ce = loss_mi = 0.0
    else:
        loss_ce = lw.disease * losses.nll_loss(out.log_probs, y, w)
        loss_mi = lw.disease * losses.nll_loss(out_prob.log_probs, y, w)

    clini = batch["clini"]
    loss_reg = lw.regr * (losses.mse_loss(out.our_reg, clini, w)
                          + losses.mse_loss(out_prob.our_reg, clini, w)) / 2
    loss_prob = lw.prob * losses.sparsity_loss(
        model.prob, model.prob_bias, model.snps_prob, x, adj, sw,
        sample_weight=w)
    recon = lw.reco * (losses.recon_sum(out.snps_hat, snps, w)
                       + losses.recon_sum(out_prob.snps_hat, snps, w)) / 2

    cluster = lw.simi * (_consistency(out.out_z, batch, mcfg, tcfg)
                         + _consistency(out_prob.out_z, batch, mcfg, tcfg)) / 2
    orth = lw.orth * losses.orthogonal_loss(out.out_z, w)

    total = (sw.lamda_ce * loss_ce + sw.lamda_mi * loss_mi + loss_reg
             + loss_prob + recon + cluster + orth)
    aux = {"out": out, "out_prob": out_prob,
           "loss_terms": {"ce": loss_ce, "mi": loss_mi, "reg": loss_reg,
                          "prob": loss_prob, "recon": recon,
                          "cluster": cluster, "orth": orth}}
    return total, aux


def _forward(model: nn.Module, batch: Batch, train: bool,
             generator: Optional[torch.Generator], **kwargs):
    """One forward of a fused-family model on a batch, in train mode
    (batch statistics over the real rows, dropout from `generator`) or
    eval mode."""
    model.train(train)
    return model(batch["x"], batch["adj"], batch["snps"],
                 sample_weight=batch["w"] if train else None,
                 generator=generator, **kwargs)


def _consistency(out_z: torch.Tensor, batch: Batch, mcfg: ModelConfig,
                 tcfg: TrainConfig) -> torch.Tensor:
    """Unweighted subject-similarity consistency of one pass's embedding:
    soft RBF similarity of the t-SNE features, or with
    `is_soft_similarity=False` the sum over the hard clusters `clust_y` of
    the consistency among each cluster's members."""
    # the pairwise similarity spans the whole batch, when sharded too
    out_z, tsne, w, clust_y = mesh.gather_columns(
        out_z, batch["tsne"], batch["w"], batch["clust_y"])
    if mcfg.is_soft_similarity:
        sim = losses.rbf_kernel(tsne, tsne, mcfg.rbf_gamma)
        return losses.consistency_loss(out_z, sim, w)
    ones = torch.ones((w.shape[0], w.shape[0]), device=w.device)
    total = 0.0
    for c in range(tcfg.num_cluster):
        total = total + losses.consistency_loss(
            out_z, ones, w * (clust_y == c))
    return total


def gcn_fusion_objective(model: nn.Module, batch: Batch, mcfg: ModelConfig,
                         tcfg: TrainConfig, *, train: bool,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """GCN_IMGSNP: one forward, no importance terms; CE + regression MSE +
    SNP reconstruction + consistency + orthogonality, where a zero disease
    weight also zeroes the orthogonality term, as in the reference."""
    lw, sw = tcfg.loss, tcfg.sparsity
    w = batch["w"]
    out = _forward(model, batch, train, generator)
    loss_reg = lw.regr * losses.mse_loss(out.our_reg, batch["clini"], w)
    recon = lw.reco * losses.recon_sum(out.snps_hat, batch["snps"], w)
    cluster = lw.simi * _consistency(out.out_z, batch, mcfg, tcfg)
    if lw.disease == 0:
        loss_ce = orth = 0.0
    else:
        loss_ce = lw.disease * losses.nll_loss(out.log_probs, batch["y"], w)
        orth = lw.orth * losses.orthogonal_loss(out.out_z, w)
    total = sw.lamda_ce * loss_ce + loss_reg + recon + cluster + orth
    return total, {"out": out, "out_prob": out}


class ImageOutputs(NamedTuple):
    log_probs: torch.Tensor     # (B, num_classes)


def sgcn_image_objective(model: nn.Module, batch: Batch, mcfg: ModelConfig,
                         tcfg: TrainConfig, *, train: bool,
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The image-only families (SGCN_GCN, SGCN_GAT, SGCN_Ori): CE of the
    plain pass + the family's sparsity penalty + CE of the masked pass.
    The SNPs and clinical scores are not read."""
    sw = tcfg.sparsity
    w = batch["w"]
    x, adj = batch["x"], batch["adj"]
    model.train(train)
    kwargs = dict(sample_weight=w if train else None, generator=generator)
    lp = model(x, adj, **kwargs)
    lp_m = model(x, adj, is_explain=True, **kwargs)
    loss_prob = losses.sgcn_sparsity_loss(model.prob, model.prob_bias, x, adj,
                                          sw, sample_weight=w)
    total = (sw.lamda_ce * losses.nll_loss(lp, batch["y"], w) + loss_prob
             + sw.lamda_mi * losses.nll_loss(lp_m, batch["y"], w))
    return total, {"out": ImageOutputs(lp), "out_prob": ImageOutputs(lp_m)}


def guide_objective(model: nn.Module, batch: Batch, mcfg: ModelConfig,
                    tcfg: TrainConfig, *, train: bool,
                    generator: Optional[torch.Generator] = None,
                    prob_ref: float = 0.001, eps: float = 1e-10
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """GUIDE_IMGSNP. The loss weights map as in the reference: disease ->
    CE, regr -> regression MSE, prob -> SNP reconstruction, reco -> image
    reconstruction, simi -> the Bernoulli KL of the keep probabilities
    from `prob_ref`."""
    lw, sw = tcfg.loss, tcfg.sparsity
    w = batch["w"]
    out = _forward(model, batch, train, generator,
                   temperature=tcfg.temperature)
    loss_reg = lw.regr * losses.mse_loss(out.our_reg, batch["clini"], w)
    recon = lw.prob * losses.recon_sum(out.snps_hat, batch["snps"], w)
    recon_img = lw.reco * losses.recon_sum(out.surrogate_img,
                                           out.surrogate_recon, w)
    rho_hat, rho = out.imp_prob, prob_ref
    s1 = (rho_hat * (torch.log(rho_hat + eps) - math.log(rho + eps))).mean()
    s2 = ((1 - rho_hat) * (torch.log(1 - rho_hat + eps)
                           - math.log(1 - rho + eps))).mean() + s1
    loss_ce = (0.0 if lw.disease == 0 else
               lw.disease * losses.nll_loss(out.log_probs, batch["y"], w))
    total = (sw.lamda_ce * loss_ce + loss_reg + recon + recon_img
             + lw.simi * s2)
    return total, {"out": out, "out_prob": out}


def clusterlabel_objective(model: nn.Module, batch: Batch, mcfg: ModelConfig,
                           tcfg: TrainConfig, *, train: bool,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """SGCN_GCN_CLUSTERLABEL: disease and cluster CE of the plain and the
    masked pass (averaged when `is_predict_cluster`), the sparsity penalty
    and the SNP reconstruction (weight `loss.reco`). The reference computes
    a consistency term and never adds it, so it is left out."""
    lw, sw = tcfg.loss, tcfg.sparsity
    w = batch["w"]
    y, cy = batch["y"], batch["clust_y"]
    out = _forward(model, batch, train, generator)
    out_prob = _forward(model, batch, train, generator, is_explain=True)
    ce = losses.nll_loss(out.log_probs, y, w)
    mi = losses.nll_loss(out_prob.log_probs, y, w)
    loss_prob = losses.sparsity_loss(
        model.prob, model.prob_bias, model.snps_prob, batch["x"],
        batch["adj"], sw, sample_weight=w)
    recon = lw.reco * (losses.recon_sum(out.snps_hat, batch["snps"], w)
                       + losses.recon_sum(out_prob.snps_hat, batch["snps"], w)
                       ) / 2
    if mcfg.is_predict_cluster:
        ce_c = losses.nll_loss(out.log_probs_cluster, cy, w)
        mi_c = losses.nll_loss(out_prob.log_probs_cluster, cy, w)
        total = (sw.lamda_ce * (ce + ce_c) / 2 + sw.lamda_mi * (mi + mi_c) / 2
                 + loss_prob + recon)
    else:
        total = sw.lamda_ce * ce + sw.lamda_mi * mi + loss_prob + recon
    return total, {"out": out, "out_prob": out_prob}


# model kind -> objective; `train/cv.py:MODEL_FAMILIES` lists the same kinds
OBJECTIVES = {
    "sgcn_imgsnp": fused_objective,
    "gcn_imgsnp": gcn_fusion_objective,
    "guide_imgsnp": guide_objective,
    "clusterlabel": clusterlabel_objective,
    "sgcn_image": sgcn_image_objective,
    "sgcn_ori": sgcn_image_objective,
}


class TrainState:
    """A fold's model, its optimiser, the count of completed steps and the
    model kind whose objective the steps take from `OBJECTIVES`.
    `steps_per_epoch` (the fold's train batches) drives the StepLR."""

    def __init__(self, model: nn.Module, tcfg: TrainConfig,
                 steps_per_epoch: int, kind: str = "sgcn_imgsnp"):
        if kind not in OBJECTIVES:
            raise ValueError(f"unknown model kind {kind!r}; one of "
                             f"{sorted(OBJECTIVES)}")
        self.model = model
        self.optimizer = make_optimizer(model, tcfg)
        self.step = 0
        self.steps_per_epoch = steps_per_epoch
        self.kind = kind


def train_step(state: TrainState, batch: Batch, mcfg: ModelConfig,
               tcfg: TrainConfig, generator: Optional[torch.Generator]
               ) -> torch.Tensor:
    """One optimiser step on one padded batch. Returns loss * sum(w) (the
    reference's loss bookkeeping) as a detached device scalar: nothing
    waits for the device here. Under a sharded batch
    (`parallel.mesh.sharded`) `batch` is this position's rows, the loss
    is the whole batch's, this position backpropagates its share of it
    and the gradients are summed over the data axis before Adam (whose
    coupled L2 then counts once)."""
    lr = lr_at_step(tcfg, state.step, state.steps_per_epoch)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss, _ = OBJECTIVES[state.kind](state.model, batch, mcfg, tcfg,
                                     train=True, generator=generator)
    mesh.backward(loss, state.model.parameters())
    state.optimizer.step()
    state.step += 1
    return loss.detach() * mesh.all_reduce_sum(batch["w"].sum())


@torch.no_grad()
def eval_step(model: nn.Module, batch: Batch, mcfg: ModelConfig,
              tcfg: TrainConfig, kind: str = "sgcn_imgsnp"
              ) -> Dict[str, torch.Tensor]:
    """Loss (all terms, eval mode) and the plain pass's per-sample outputs
    of one batch: log_probs, pred and those of `EVAL_FIELDS` the family's
    model has."""
    return _eval_outputs(
        OBJECTIVES[kind](model, batch, mcfg, tcfg, train=False), batch)


def _eval_outputs(objective_out, batch: Batch) -> Dict[str, torch.Tensor]:
    """What an eval step returns from its objective's (loss, aux)."""
    loss, aux = objective_out
    out = aux["out"]
    result = {"loss_sum": loss * mesh.all_reduce_sum(batch["w"].sum()),
              "log_probs": out.log_probs,
              "pred": out.log_probs.argmax(dim=-1)}
    result.update({f: getattr(out, f) for f in EVAL_FIELDS
                   if getattr(out, f, None) is not None})
    return result


# Adam's constants, torch.optim.Adam's defaults (make_optimizer keeps them)
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


class StackedState:
    """F folds' train states stacked on a leading fold axis: the params
    (leaf tensors that take gradients), the persistent buffers (the batch
    norms' running statistics), Adam's two moments, and per fold the
    count of completed steps and the real steps per epoch (host ints).
    `model` is the module `functional_call` runs with those tensors in
    place of its own; its non-persistent buffers (the GO topology) are
    shared by every fold."""

    def __init__(self, models: Sequence[nn.Module], tcfg: TrainConfig,
                 steps_per_epoch: Sequence[int], kind: str,
                 steps: Optional[Sequence[int]] = None):
        if kind not in OBJECTIVES:
            raise ValueError(f"unknown model kind {kind!r}; one of "
                             f"{sorted(OBJECTIVES)}")
        self.model = models[0]
        self.kind = kind
        self.weight_decay = tcfg.weight_decay
        names = dict(self.model.named_parameters())
        persistent = [k for k in self.model.state_dict() if k not in names]
        with torch.no_grad():
            self.params = {k: torch.stack([dict(m.named_parameters())[k]
                                           .detach() for m in models])
                           .requires_grad_(True) for k in names}
            self.buffers = {k: torch.stack([m.state_dict()[k]
                                            for m in models]).clone()
                            for k in persistent}
        self.exp_avg = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v)
                           for k, v in self.params.items()}
        self.steps = np.asarray(steps if steps is not None
                                else [0] * len(models), np.int64)
        self.steps_per_epoch = np.asarray(steps_per_epoch, np.int64)

    @property
    def folds(self) -> int:
        return len(self.steps)

    def fold_tensors(self) -> Dict[str, torch.Tensor]:
        """The stacked params and buffers, under their state_dict names."""
        return {**self.params, **self.buffers}

    def fold_state_dict(self, f: int) -> Dict[str, torch.Tensor]:
        """Fold f's `state_dict()` (views into the stacked tensors)."""
        out = {k: v[f].detach() for k, v in self.params.items()}
        out.update({k: v[f] for k, v in self.buffers.items()})
        return out


class _Objective(nn.Module):
    """The family's objective as a module around the fold model, so that
    `functional_call` swaps every tensor the objective reads (the
    forward's and the sparsity penalties' params alike)."""

    def __init__(self, model: nn.Module, mcfg: ModelConfig,
                 tcfg: TrainConfig, kind: str):
        super().__init__()
        self.model, self.mcfg, self.tcfg, self.kind = model, mcfg, tcfg, kind

    def forward(self, batch, train: bool, noise):
        return OBJECTIVES[self.kind](self.model, batch, self.mcfg, self.tcfg,
                                     train=train, generator=noise)


def _drawn_shapes(model: nn.Module, kind: str, batch: Batch,
                  mcfg: ModelConfig, tcfg: TrainConfig
                  ) -> List[Tuple[int, ...]]:
    """The shapes of the uniforms one train-mode objective of `model` on
    `batch` draws, in order: one forward of a CPU copy of the model
    (nothing runs on the card, no state moves)."""
    cpu = torch.device("cpu")
    model = copy.deepcopy(model).to(cpu)
    recorder = ShapeRecorder()
    with torch.no_grad():
        OBJECTIVES[kind](model, {k: v.to(cpu) for k, v in batch.items()},
                         mcfg, tcfg, train=True, generator=recorder)
    return recorder.shapes


def record_noise_shapes(state: StackedState, batch: Batch, mcfg: ModelConfig,
                        tcfg: TrainConfig) -> List[Tuple[int, ...]]:
    """The shapes of the uniforms one batched train step draws per fold,
    in order, at this (F, B, ...) batch's shape (fold 0's forward)."""
    return _drawn_shapes(state.model, state.kind,
                         {k: v[0] for k, v in batch.items()}, mcfg, tcfg)


def step_noise_shapes(state: TrainState, batch: Batch, mcfg: ModelConfig,
                      tcfg: TrainConfig) -> List[Tuple[int, ...]]:
    """The shapes of the uniforms one `train_step` of `state` on `batch`
    draws, in order."""
    return _drawn_shapes(state.model, state.kind, batch, mcfg, tcfg)


def draw_noise(shapes: Sequence[Tuple[int, ...]],
               generator: Optional[torch.Generator], device: torch.device
               ) -> Optional[NoiseSource]:
    """The uniforms of `shapes` drawn from `generator` in order (what a
    forward drawing from it would draw), or None where there are none."""
    if not shapes:
        return None
    return NoiseSource([torch.rand(shape, generator=generator, device=device)
                        for shape in shapes])


def draw_fold_noise(shapes: Sequence[Tuple[int, ...]],
                    generators: Sequence[Optional[torch.Generator]],
                    device: torch.device) -> Optional[List[torch.Tensor]]:
    """Each fold's uniforms for one train step, drawn from its own
    generator in the forward's order and stacked per site: (F, *shape).
    A fold whose generator is None (its batch is all padding, so the
    sequential run takes no such step) draws nothing and gets zeros."""
    if not shapes:
        return None
    per_fold = [[torch.rand(shape, generator=g, device=device)
                 if g is not None else torch.zeros(shape, device=device)
                 for shape in shapes] for g in generators]
    return [torch.stack(site) for site in zip(*per_fold)]


def _vmapped(state: StackedState, mcfg: ModelConfig, tcfg: TrainConfig,
             train: bool, fn):
    """The per-fold function that torch.func.vmap maps over the stacked
    params, buffers, batch and noise: `fn(objective's (loss, aux), batch)`
    of one fold."""
    objective = _Objective(state.model, mcfg, tcfg, state.kind)

    def one_fold(params, buffers, batch, noise):
        source = NoiseSource(noise) if noise is not None else None
        out = torch.func.functional_call(
            objective, ({f"model.{k}": v for k, v in params.items()},
                        {f"model.{k}": v for k, v in buffers.items()}),
            (batch, train, source), strict=False)
        if source is not None and not source.done():
            raise ValueError("the forward drew fewer noise tensors than "
                             "were recorded for it")
        return fn(out, batch)
    return one_fold


def _adam_update(state: StackedState, lrs: np.ndarray) -> None:
    """One step of Adam with coupled L2 over the stacked params, in
    torch.optim.Adam's arithmetic, at each fold's own learning rate and
    step count (`state.steps` + 1)."""
    b1, b2 = ADAM_BETAS
    f = state.folds
    t = state.steps + 1
    ref = next(iter(state.params.values()))
    step_size = torch.as_tensor(lrs / (1 - b1 ** t), dtype=torch.float32,
                                device=ref.device)
    bc2_sqrt = torch.as_tensor(np.sqrt(1 - b2 ** t), dtype=torch.float32,
                               device=ref.device)
    with torch.no_grad():
        for k, p in state.params.items():
            if p.grad is None:      # a param the objective never reads
                continue
            shape = (f,) + (1,) * (p.dim() - 1)
            grad = p.grad
            if state.weight_decay != 0:
                grad = grad.add(p, alpha=state.weight_decay)
            m, v = state.exp_avg[k], state.exp_avg_sq[k]
            m.lerp_(grad, 1 - b1)
            v.mul_(b2).addcmul_(grad, grad, value=1 - b2)
            denom = (v.sqrt() / bc2_sqrt.reshape(shape)).add_(ADAM_EPS)
            p.sub_(step_size.reshape(shape) * m / denom)


def batched_train_step(state: StackedState, batch: Batch, mcfg: ModelConfig,
                       tcfg: TrainConfig, noise: Optional[List[torch.Tensor]],
                       has_real: np.ndarray) -> torch.Tensor:
    """One optimiser step of every fold on its (F, B, ...) batch, with the
    padding gate for the folds where `has_real` is False (from the whole
    batch's weights). Returns each fold's loss * sum(w) as a detached (F,)
    device tensor. Under a sharded batch, as `train_step`: `batch` and
    `noise` are this position's rows, the reductions inside the vmapped
    objective read the whole batch, and the gradients are summed over the
    data axis before `_adam_update`."""
    lrs = np.asarray([lr_at_step(tcfg, int(s), int(spe)) for s, spe in
                      zip(state.steps, state.steps_per_epoch)], np.float64)
    gate = not bool(np.all(has_real))
    if gate:
        kept = {name: {k: v.detach().clone() for k, v in tensors.items()}
                for name, tensors in (("params", state.params),
                                      ("buffers", state.buffers),
                                      ("exp_avg", state.exp_avg),
                                      ("exp_avg_sq", state.exp_avg_sq))}
    for p in state.params.values():
        p.grad = None
    fold_fn = _vmapped(state, mcfg, tcfg, True, lambda out, _: out[0])
    in_dims = (0, 0, 0, 0 if noise is not None else None)
    loss = torch.func.vmap(fold_fn, in_dims=in_dims)(
        state.params, state.buffers, batch, noise)
    mesh.backward(loss.sum(), state.params.values())
    _adam_update(state, lrs)
    if gate:
        real = torch.as_tensor(has_real, device=loss.device)
        with torch.no_grad():
            for name, tensors in (("params", state.params),
                                  ("buffers", state.buffers),
                                  ("exp_avg", state.exp_avg),
                                  ("exp_avg_sq", state.exp_avg_sq)):
                for k, v in tensors.items():
                    mask = real.reshape((-1,) + (1,) * (v.dim() - 1))
                    v.copy_(torch.where(mask, v, kept[name][k]))
    state.steps += np.asarray(has_real, np.int64)
    return loss.detach() * mesh.all_reduce_sum(batch["w"].sum(dim=1))


@torch.no_grad()
def batched_eval_step(state: StackedState, batch: Batch, mcfg: ModelConfig,
                      tcfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """`eval_step` of every fold on its (F, B, ...) batch: the same keys,
    each with the fold axis in front."""
    fold_fn = _vmapped(state, mcfg, tcfg, False, _eval_outputs)
    return torch.func.vmap(fold_fn, in_dims=(0, 0, 0, None))(
        state.params, state.buffers, batch, None)
