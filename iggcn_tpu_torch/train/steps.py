"""Train and eval steps of the flagship model (port of
`iggcn_tpu/train/steps.py`).

A step runs the two forwards of the reference, the plain pass and then the
importance-masked pass (`is_explain=True`), on one module in train mode,
so the batch norms' running statistics move in that order; the JAX
package runs them sequentially or rebuilds that order from one vmapped
pass (`_dual_pass`). The objective is the 7-term sum of the JAX package's
`fused_objective`. The optimiser is `torch.optim.Adam` with coupled L2
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

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
from iggcn_tpu_torch.train import losses

Batch = Dict[str, torch.Tensor]
EVAL_FIELDS = ("our_reg", "out_lin", "linear_outf")


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
    model.train(train)
    kwargs = dict(sample_weight=w if train else None, generator=generator)
    out = model(x, adj, snps, **kwargs)
    out_prob = model(x, adj, snps, is_explain=True, **kwargs)

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

    if mcfg.is_soft_similarity:
        sim = losses.rbf_kernel(batch["tsne"], batch["tsne"], mcfg.rbf_gamma)
        cluster = lw.simi * (losses.consistency_loss(out.out_z, sim, w)
                             + losses.consistency_loss(out_prob.out_z, sim, w)
                             ) / 2
    else:
        ones = torch.ones((y.shape[0], y.shape[0]), device=w.device)
        cluster = 0.0
        for c in range(tcfg.num_cluster):
            member = w * (batch["clust_y"] == c)
            cluster = cluster + lw.simi * (
                losses.consistency_loss(out.out_z, ones, member)
                + losses.consistency_loss(out_prob.out_z, ones, member)) / 2

    orth = lw.orth * losses.orthogonal_loss(out.out_z, w)

    total = (sw.lamda_ce * loss_ce + sw.lamda_mi * loss_mi + loss_reg
             + loss_prob + recon + cluster + orth)
    aux = {"out": out, "out_prob": out_prob,
           "loss_terms": {"ce": loss_ce, "mi": loss_mi, "reg": loss_reg,
                          "prob": loss_prob, "recon": recon,
                          "cluster": cluster, "orth": orth}}
    return total, aux


class TrainState:
    """A fold's model, its optimiser and the count of completed steps.
    `steps_per_epoch` (the fold's train batches) drives the StepLR."""

    def __init__(self, model: nn.Module, tcfg: TrainConfig,
                 steps_per_epoch: int):
        self.model = model
        self.optimizer = make_optimizer(model, tcfg)
        self.step = 0
        self.steps_per_epoch = steps_per_epoch


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
    loss, _ = fused_objective(state.model, batch, mcfg, tcfg, train=True,
                              generator=generator)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach() * batch["w"].sum()


@torch.no_grad()
def eval_step(model: nn.Module, batch: Batch, mcfg: ModelConfig,
              tcfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """Loss (all terms, both passes, eval mode) and the plain pass's
    per-sample outputs of one batch."""
    loss, aux = fused_objective(model, batch, mcfg, tcfg, train=False)
    out = aux["out"]
    result = {"loss_sum": loss * batch["w"].sum(),
              "log_probs": out.log_probs,
              "pred": out.log_probs.argmax(dim=-1)}
    result.update({f: getattr(out, f) for f in EVAL_FIELDS})
    return result
