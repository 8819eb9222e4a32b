"""Generic graph-classification CV trainer of the baseline zoo (port of
`iggcn_tpu/train/generic_cv.py`).

The objective is the NLL over the padded batch with zero-weight padding
rows; with `aux_loss` DiffPool's link and entropy losses are added (the
reference discards them, so the CLI leaves it off). `takes_weight` gives
the model the row weight, so that batch-norm statistics and DiffPool's
losses leave the padding rows out. Batch-norm running statistics move in
train steps only. The optimiser is coupled-L2 Adam at the learning rate
StepLR gives each epoch, set from the host.

`cross_validation_generic` runs stratified k-fold CV. With a validation
split every fold evaluates its val fold each epoch and reports the test
accuracy at its lowest-val-loss epoch; without one (`no_val`) the val
fold joins the train split, every epoch resamples it class-balanced, and
the result is the epoch of the highest fold-mean accuracy. Everything
drawn in NumPy is the JAX package's: the splits, the per-fold
`default_rng(seed * 31 + fold)` with its epoch permutations or balanced
draws, the epoch padding. Each fold's weights are drawn on the CPU from
`torch.Generator().manual_seed(seed + fold)` (or replaced by a warm
start) and trained on `device`. With `record_dir` each fold writes the
JAX package's atomic record (same name, keys and `meta`), and `resume`
restores the folds whose record matches, whichever package wrote it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from iggcn_tpu_torch.data.sampler import (imbalanced_sample_indices,
                                          pad_epoch_indices)
from iggcn_tpu_torch.data.splits import k_fold
from iggcn_tpu_torch.data.tu import GraphDataset
from iggcn_tpu_torch.tools.convert import load_flax_variables
from iggcn_tpu_torch.train.cv import load_fold_records, write_fold_record
from iggcn_tpu_torch.train.losses import nll_loss
from iggcn_tpu_torch.train.records import config_fingerprint
from iggcn_tpu_torch.train.snps_trainer import steplr_host
from iggcn_tpu_torch.utils.platform import resolve_device

Batch = Dict[str, torch.Tensor]
# dataset arrays a batch carries (z and rd when a nested dataset has them)
BATCH_KEYS = ("x", "adj", "mask", "assign", "y", "z", "rd")


@dataclasses.dataclass
class GenericCVResult:
    best_acc: float
    best_acc_std: float
    accs: np.ndarray       # (folds, epochs)
    mean_loss: float


def model_forward(model: torch.nn.Module, batch: Batch, train: bool,
                  generator: Optional[torch.Generator], *, needs_mask: bool,
                  needs_assign: bool, adj_only: bool,
                  takes_weight: bool = False):
    """One forward of a zoo model on a batch with the JAX trainer's
    argument wiring: (adj) for `adj_only`, (x, adj, mask[, assign]) for
    `needs_mask`, else (x, adj); the row weight with `takes_weight`; the
    nested labels when the batch has them."""
    model.train(train)
    kwargs = {"generator": generator}
    if takes_weight:
        kwargs["sample_weight"] = batch["w"]
    for k in ("z", "rd"):
        if k in batch:
            kwargs[k] = batch[k]
    if adj_only:
        args = (batch["adj"],)
    elif needs_mask:
        args = (batch["x"], batch["adj"], batch["mask"])
        if needs_assign:
            args = args + (batch["assign"],)
    else:
        args = (batch["x"], batch["adj"])
    return model(*args, **kwargs)


def build_generic_steps(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer, *,
                        needs_mask: bool, needs_assign: bool, adj_only: bool,
                        aux_loss: bool, takes_weight: bool):
    """(train_step, eval_batch) of the generic trainer, the counterparts of
    the JAX package's `build_generic_steps`.

    train_step(batch, generator, lr_t) sets the learning rate, takes one
    Adam step on the NLL (+ DiffPool's losses with `aux_loss`) and returns
    the loss as a detached device scalar. eval_batch(batch) returns
    (loss * sum(w), correct count) as device scalars, in eval mode."""
    wiring = dict(needs_mask=needs_mask, needs_assign=needs_assign,
                  adj_only=adj_only, takes_weight=takes_weight)

    def train_step(batch: Batch, generator: Optional[torch.Generator],
                   lr_t: float) -> torch.Tensor:
        for group in optimizer.param_groups:
            group["lr"] = lr_t
        optimizer.zero_grad(set_to_none=True)
        out = model_forward(model, batch, True, generator, **wiring)
        # DiffPool always returns (logp, link, ent); aux_loss decides
        # whether the link and entropy terms enter the objective
        logp = out[0] if isinstance(out, tuple) else out
        loss = nll_loss(logp, batch["y"], batch["w"])
        if aux_loss:
            loss = loss + out[1] + out[2]
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_batch(batch: Batch):
        out = model_forward(model, batch, False, None, **wiring)
        logp = out[0] if isinstance(out, tuple) else out
        w = batch["w"]
        loss = nll_loss(logp, batch["y"], w)
        correct = ((logp.argmax(dim=-1) == batch["y"]).to(w.dtype) * w).sum()
        return loss * w.sum(), correct

    return train_step, eval_batch


def make_generic_optimizer(model: torch.nn.Module, weight_decay: float = 0.0
                           ) -> torch.optim.Adam:
    """Coupled-L2 Adam (the JAX trainers' `adam_transform`); the learning
    rate is set before every step."""
    return torch.optim.Adam(model.parameters(), lr=1e-3,
                            weight_decay=weight_decay)


def init_generic_model(model: torch.nn.Module, seed: int, fold: int,
                       device: torch.device, warm_start=None):
    """(model, dropout generator) of one fold: an untrained copy of `model`
    (`fresh`) drawn on the CPU from a generator seeded by seed + fold, so
    that it is the same on every device; `warm_start` = (params,
    batch_stats) flax trees replace the drawn weights. The dropout stream
    is seeded from that generator and lives on `device`."""
    g = torch.Generator().manual_seed(seed + fold)
    fold_model = model.fresh(generator=g, device=device)
    if warm_start is not None:
        load_flax_variables(fold_model, warm_start[0], warm_start[1])
    drop_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    return fold_model, torch.Generator(device=device).manual_seed(drop_seed)


def cross_validation_generic(dataset: GraphDataset, model, *,
                             folds: int = 5, epochs: int = 50,
                             batch_size: int = 32, lr: float = 1e-3,
                             lr_decay_factor: float = 0.5,
                             lr_decay_step_size: int = 50,
                             weight_decay: float = 0.0, seed: int = 1000,
                             no_val: bool = False,
                             needs_mask: bool = True,
                             needs_assign: bool = False,
                             adj_only: bool = False,
                             aux_loss: bool = False,
                             takes_weight: bool = False,
                             record_dir: Optional[str] = None,
                             record_tag: str = "",
                             resume: bool = False,
                             verbose: bool = False,
                             warm_start=None,
                             device: str | torch.device | None = None
                             ) -> GenericCVResult:
    """k-fold CV of a zoo model over a dense padded `GraphDataset` on
    `device` (default: the card). `model` is a zoo model whose untrained
    copies (`fresh`) train the folds. `record_dir` + `resume`: each
    finished fold writes `fold_result_generic_<tag>_fold_<k>.npz`, and a
    resumed run restores the folds whose record matches this run's
    identity (the epochs, folds, seed, batch, `no_val` and a fingerprint of
    the model's class and flax fields and the objective's wiring);
    `record_tag` names the model and configuration (the CLI's
    `<model>_layers<L>_hidden<H>_h<h>`). `warm_start` = (params,
    batch_stats) starts every fold from those weights; it is not part of
    the record's identity."""
    dev = resolve_device(device)
    y_all = dataset.y
    keys = [k for k in BATCH_KEYS if getattr(dataset, k, None) is not None]
    splits = k_fold(y_all, folds, seed)
    b = batch_size
    wiring = dict(needs_mask=needs_mask, needs_assign=needs_assign,
                  adj_only=adj_only, aux_loss=aux_loss,
                  takes_weight=takes_weight)
    accs = np.zeros((folds, epochs))
    val_losses = np.full((folds, epochs), np.inf)
    losses: List[float] = []

    def record_path(fold: int) -> str:
        return os.path.join(
            record_dir, f"fold_result_generic_{record_tag}_fold_{fold}.npz")

    want_meta = np.asarray(
        [epochs, folds, seed, batch_size, int(no_val),
         config_fingerprint(
             model_cls=type(model).__name__,
             model_fields=repr(model), lr=lr,
             lr_decay_factor=lr_decay_factor,
             lr_decay_step_size=lr_decay_step_size,
             weight_decay=weight_decay, **wiring)], np.int64)
    done_folds = {}
    if resume and record_dir is not None:
        done_folds = load_fold_records(
            [record_path(f) for f in range(folds)], want_meta)

    # the dataset on the device once; batches are gathered there
    data = {k: torch.from_numpy(np.ascontiguousarray(
        getattr(dataset, k))).to(dev) for k in keys}

    def gather(idx: np.ndarray) -> Batch:
        sel = torch.from_numpy(idx).to(dev)
        return {k: v[sel] for k, v in data.items()}

    def eval_set(idx: np.ndarray) -> List[Batch]:
        """`idx` in batches of b, the last padded with zero rows of weight
        0 (the JAX trainer pads its eval arrays with zeros)."""
        n_real = len(idx)
        total = -(-n_real // b) * b
        arrays = gather(idx)
        w = torch.zeros(total, device=dev)
        w[:n_real] = 1.0
        padded = {k: torch.cat([v, v.new_zeros((total - n_real,)
                                               + v.shape[1:])])
                  for k, v in arrays.items()}
        padded["w"] = w
        return [{k: v[i:i + b] for k, v in padded.items()}
                for i in range(0, total, b)]

    for fold, (train_idx, test_idx, val_idx) in enumerate(splits):
        if fold in done_folds:
            d = done_folds[fold]
            accs[fold] = d["accs"]
            val_losses[fold] = d["val_losses"]
            losses.extend(d["losses"].tolist())
            print(f"[resume] fold {fold} restored from "
                  f"{record_path(fold)} (training skipped)")
            continue
        if no_val:
            train_idx = np.concatenate([train_idx, val_idx])
        fold_model, generator = init_generic_model(model, seed, fold, dev,
                                                   warm_start)
        optimizer = make_generic_optimizer(fold_model, weight_decay)
        train_step, eval_batch = build_generic_steps(fold_model, optimizer,
                                                     **wiring)
        host_rng = np.random.default_rng(seed * 31 + fold)
        te = eval_set(test_idx)
        va = None if no_val else eval_set(val_idx)

        def run_eval(batches: List[Batch], n_real: int):
            sums = torch.stack([torch.stack(eval_batch(batch))
                                for batch in batches]).double().cpu().numpy()
            return float(sums[:, 0].sum()) / n_real, \
                float(sums[:, 1].sum()) / n_real

        for epoch in range(epochs):
            if no_val:
                idx = train_idx[imbalanced_sample_indices(y_all[train_idx],
                                                          host_rng)]
            else:
                idx = host_rng.permutation(train_idx)
            lr_t = steplr_host(lr, lr_decay_factor, lr_decay_step_size,
                               epoch)
            idx, w_epoch = pad_epoch_indices(idx, b)
            epoch_data = gather(idx)
            epoch_data["w"] = torch.from_numpy(w_epoch).to(dev)
            for i in range(0, len(idx), b):
                train_step({k: v[i:i + b] for k, v in epoch_data.items()},
                           generator, lr_t)
            te_loss, te_acc = run_eval(te, len(test_idx))
            accs[fold, epoch] = te_acc
            losses.append(te_loss)
            if va is not None:
                val_losses[fold, epoch], _ = run_eval(va, len(val_idx))
            if verbose:
                print(f"fold {fold} epoch {epoch}: "
                      f"acc {accs[fold, epoch]:.3f}")

        if record_dir is not None:
            write_fold_record(record_path(fold), accs=accs[fold],
                              val_losses=val_losses[fold],
                              losses=np.asarray(losses[-epochs:], np.float64),
                              meta=want_meta)

    if no_val:
        # the epoch of the highest fold-mean accuracy
        acc_mean = accs.mean(axis=0)
        arg = int(acc_mean.argmax())
        best = float(acc_mean[arg])
        std = float(accs[:, arg].std(ddof=1) if folds > 1 else 0.0)
    else:
        # per fold, the test accuracy at its lowest-val-loss epoch
        argmin = val_losses.argmin(axis=1)
        picked = accs[np.arange(folds), argmin]
        best = float(picked.mean())
        std = float(picked.std(ddof=1) if folds > 1 else 0.0)
    return GenericCVResult(best_acc=best, best_acc_std=std, accs=accs,
                           mean_loss=float(np.mean(losses)))
