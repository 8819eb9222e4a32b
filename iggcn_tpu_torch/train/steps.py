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
w. The padding gate of the JAX package's fold-parallel mode (all-padding
batches) is not ported: a sequential epoch pads within its last batch
only, so every batch has real rows.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
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
    w = batch["w"]
    if mcfg.is_soft_similarity:
        sim = losses.rbf_kernel(batch["tsne"], batch["tsne"], mcfg.rbf_gamma)
        return losses.consistency_loss(out_z, sim, w)
    ones = torch.ones((w.shape[0], w.shape[0]), device=w.device)
    total = 0.0
    for c in range(tcfg.num_cluster):
        total = total + losses.consistency_loss(
            out_z, ones, w * (batch["clust_y"] == c))
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
    waits for the device here."""
    lr = lr_at_step(tcfg, state.step, state.steps_per_epoch)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.zero_grad(set_to_none=True)
    loss, _ = OBJECTIVES[state.kind](state.model, batch, mcfg, tcfg,
                                     train=True, generator=generator)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach() * batch["w"].sum()


@torch.no_grad()
def eval_step(model: nn.Module, batch: Batch, mcfg: ModelConfig,
              tcfg: TrainConfig, kind: str = "sgcn_imgsnp"
              ) -> Dict[str, torch.Tensor]:
    """Loss (all terms, eval mode) and the plain pass's per-sample outputs
    of one batch: log_probs, pred and those of `EVAL_FIELDS` the family's
    model has."""
    loss, aux = OBJECTIVES[kind](model, batch, mcfg, tcfg, train=False)
    out = aux["out"]
    result = {"loss_sum": loss * batch["w"].sum(),
              "log_probs": out.log_probs,
              "pred": out.log_probs.argmax(dim=-1)}
    result.update({f: getattr(out, f) for f in EVAL_FIELDS
                   if getattr(out, f, None) is not None})
    return result
