"""SNP-only classifiers' trainer (port of `iggcn_tpu/train/snps_trainer.py`):
the GO network with its classifier head (`Gene_ontology_network`) or the
plain MLP (`MLP_Model`), binary, on a SNP matrix alone.

The objective is BCE(sum) of the head's probability over the real rows
plus lambda0 times the summed squared SNP reconstruction error (lambda0 =
0 for the MLP, which has no decoder). A GO train step runs the encoder
and then the classifier as two calls with independent dropout draws from
one generator, both moving the batch norms' running statistics over the
real rows. The optimiser is coupled-L2 Adam (no decay here) with the
learning rate StepLR(50, 0.7) per epoch.

`cross_validation_snps` runs stratified k-fold with the val fold merged
into train, each fold's model from `init_snps_model` (seeded by seed +
fold; a test replaces it to start both packages from one set of weights)
and its epochs' class-balanced resampling from
`np.random.default_rng(seed * 77 + fold)`, then scores the padded test
split every epoch: [acc, auc, f1, sen, spe], the mean test loss, and with
`bundle_dir` a serving bundle of each fold's best-accuracy epoch. With
`record_dir` each fold writes an atomic record that `resume` restores, as
the JAX trainer's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.data.sampler import (imbalanced_sample_indices,
                                          pad_epoch_indices)
from iggcn_tpu_torch.data.splits import k_fold
from iggcn_tpu_torch.models.baselines import MLPModel
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.tools.convert import to_flax_variables
from iggcn_tpu_torch.tools.serve import save_bundle
from iggcn_tpu_torch.train import metrics
from iggcn_tpu_torch.train.cv import load_fold_records, write_fold_record
from iggcn_tpu_torch.train.records import config_fingerprint
from iggcn_tpu_torch.utils.platform import resolve_device

MODEL_KINDS = ("go", "mlp")


def steplr_host(lr: float, factor: float, step_size: int,
                epoch: int) -> float:
    """StepLR: lr * factor ** (epoch // step_size), epoch 0-indexed."""
    if step_size <= 0:
        return lr
    return lr * factor ** (epoch // step_size)


def snps_forward(model: torch.nn.Module, x: torch.Tensor, w: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_hat, y_hat (B, 1)) of either kind, train mode per
    `model.training`: the GO network encodes and then classifies its latent
    (two calls, two independent dropout draws); the MLP's x_hat is x."""
    if isinstance(model, GeneOntologyNetwork):
        latent, x_hat, _ = model(x, sample_weight=w, generator=generator)
        return x_hat, model.classify(latent, x, sample_weight=w,
                                     generator=generator)
    return x, model(x, generator=generator)


def snps_loss(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, lambda0: float,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BCE(sum over real rows) + lambda0 * sum-MSE reconstruction, y_hat)."""
    x_hat, y_hat = snps_forward(model, x, w, generator)
    p = y_hat[:, 0]
    bce = -(y * torch.log(torch.clamp(p, 1e-7, 1.0))
            + (1 - y) * torch.log(torch.clamp(1 - p, 1e-7, 1.0)))
    recon = lambda0 * torch.sum(torch.square(x_hat - x) * w[:, None])
    return torch.sum(bce * w) + recon, y_hat


def make_snps_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """Coupled-L2 Adam without decay (the JAX trainer's `adam_transform()`);
    its learning rate is set before every step."""
    return torch.optim.Adam(model.parameters(), lr=1e-3)


def snps_train_step(model: torch.nn.Module, optimizer: torch.optim.Adam,
                    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    lr_t: float, lambda0: float,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """One optimiser step at learning rate `lr_t` (the counterpart of
    `build_snps_steps`' train step); returns the loss as a detached device
    scalar."""
    model.train()
    for group in optimizer.param_groups:
        group["lr"] = lr_t
    optimizer.zero_grad(set_to_none=True)
    loss, _ = snps_loss(model, x, y, w, lambda0, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def snps_eval_batch(model: torch.nn.Module, x: torch.Tensor, y: torch.Tensor,
                    w: torch.Tensor, lambda0: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, prob (B,)) of one batch in eval mode."""
    model.eval()
    loss, y_hat = snps_loss(model, x, y, w, lambda0)
    return loss, y_hat[:, 0]


def init_snps_model(kind: str, topo: GoTopology, num_snps: int, seed: int,
                    fold: int, device: torch.device, *, l_dim: int = 32,
                    n_l: int = 2, f_dim: Sequence[int] = (5, 5)):
    """(model, dropout generator) of one fold: weights drawn on the CPU from
    a generator seeded by seed + fold, the dropout stream seeded from it on
    `device`."""
    g = torch.Generator().manual_seed(seed + fold)
    if kind == "mlp":
        model = MLPModel(num_snps, generator=g, device=device)
    else:
        model = GeneOntologyNetwork(topo, in_f_dim=2, n_l=n_l, f_dim=f_dim,
                                    l_dim=l_dim, classifier=True,
                                    generator=g, device=device)
    drop_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    return model, torch.Generator(device=device).manual_seed(drop_seed)


@dataclasses.dataclass
class SnpsCVResult:
    accs: np.ndarray            # (folds, epochs)
    best_acc: float
    mean_loss: float
    score_result: np.ndarray    # (folds, epochs, 5): acc/auc/f1/sen/spe
    best_acc_std: float = 0.0   # std across folds at the best mean epoch


def cross_validation_snps(snps: np.ndarray, labels: np.ndarray,
                          topo: GoTopology, *, folds: int = 5,
                          epochs: int = 100, batch_size: int = 32,
                          lr: float = 1e-3, lambda0: float = 1e-5,
                          seed: int = 1000, l_dim: int = 32,
                          n_l: int = 2, f_dim=(5, 5),
                          model_kind: str = "go",
                          result_path: Optional[str] = None,
                          bundle_dir: Optional[str] = None,
                          record_dir: Optional[str] = None,
                          resume: bool = False,
                          verbose: bool = False,
                          device: str | torch.device | None = None
                          ) -> SnpsCVResult:
    """Binary SNP classification on `device` (default: the card) with the
    GO network and its head (`model_kind='go'`) or the MLP ('mlp': BCE
    only). `result_path` gets the (folds, epochs, 5) score matrix;
    `bundle_dir` a bundle per fold at the fold's best-accuracy epoch;
    `record_dir` + `resume` the fold records
    `fold_result_snps_{kind}_fold_{k}.npz`."""
    if model_kind not in MODEL_KINDS:
        raise ValueError(f"model_kind must be one of {MODEL_KINDS}; got "
                         f"{model_kind!r}")
    dev = resolve_device(device)
    labels = np.asarray(labels, np.float32).reshape(-1)
    snps = np.asarray(snps, np.float32)
    if model_kind == "mlp":
        lambda0 = 0.0
    splits = k_fold(labels.astype(int), folds, seed)
    accs = np.zeros((folds, epochs))
    score_result = np.zeros((folds, epochs, 5))
    losses = []

    def record_path(fold: int) -> str:
        return os.path.join(
            record_dir, f"fold_result_snps_{model_kind}_fold_{fold}.npz")

    want_meta = np.asarray(
        [epochs, folds, seed, batch_size,
         config_fingerprint(lr=lr, lambda0=lambda0, l_dim=l_dim, n_l=n_l,
                            f_dim=tuple(f_dim))], np.int64)
    done_folds = {}
    if resume and record_dir is not None:
        done_folds = load_fold_records(
            [record_path(f) for f in range(folds)], want_meta)
        for f in list(done_folds):
            if str(done_folds[f]["model_kind"]) != model_kind:
                print(f"[resume] {record_path(f)} was written by a "
                      f"different config; retraining fold {f}")
                del done_folds[f]

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for fold, (train_idx, test_idx, val_idx) in enumerate(splits):
        if fold in done_folds:
            d = done_folds[fold]
            score_result[fold] = d["score_result_epoch"]
            accs[fold] = d["score_result_epoch"][:, 0]
            losses.extend(d["losses"].tolist())
            print(f"[resume] fold {fold} restored from {record_path(fold)} "
                  "(training skipped)")
            continue
        train_idx = np.concatenate([train_idx, val_idx])
        model, generator = init_snps_model(
            model_kind, topo, snps.shape[1], seed, fold, dev, l_dim=l_dim,
            n_l=n_l, f_dim=f_dim)
        optimizer = make_snps_optimizer(model)
        host_rng = np.random.default_rng(seed * 77 + fold)
        best_fold = (-1.0, None)   # (acc, state_dict copy)
        x_tr = to_dev(snps[train_idx])
        y_tr = to_dev(labels[train_idx])
        y_tr_host = labels[train_idx]
        y_te = labels[test_idx]
        n_te = len(test_idx)
        pad_te = -(-n_te // batch_size) * batch_size - n_te
        x_te = to_dev(np.pad(snps[test_idx], ((0, pad_te), (0, 0))))
        y_te_p = to_dev(np.pad(y_te, (0, pad_te)))
        w_te = to_dev(np.concatenate([np.ones(n_te), np.zeros(pad_te)])
                      .astype(np.float32))

        for epoch in range(epochs):
            idx = imbalanced_sample_indices(y_tr_host, host_rng)
            lr_t = steplr_host(lr, 0.7, 50, epoch)
            idx, w_ep = pad_epoch_indices(idx, batch_size)
            idx_d, w_d = to_dev(idx), to_dev(w_ep)
            for i in range(len(idx) // batch_size):
                s = slice(i * batch_size, (i + 1) * batch_size)
                snps_train_step(model, optimizer, x_tr[idx_d[s]],
                                y_tr[idx_d[s]], w_d[s], lr_t, lambda0,
                                generator)
            tot, probs = [], []
            for i in range(x_te.shape[0] // batch_size):
                s = slice(i * batch_size, (i + 1) * batch_size)
                loss, p = snps_eval_batch(model, x_te[s], y_te_p[s], w_te[s],
                                          lambda0)
                tot.append(loss)
                probs.append(p)
            tot_loss = float(torch.stack(tot).sum())
            prob = torch.cat(probs)[:n_te].cpu().numpy()
            pred = (prob > 0.5).astype(np.int64)
            cm = metrics.classification_metrics(y_te.astype(np.int64), pred,
                                                prob, 2)
            accs[fold, epoch] = cm["acc"]
            score_result[fold, epoch] = [cm["acc"], cm["auc"], cm["f1"],
                                         cm["sen"], cm["spe"]]
            losses.append(tot_loss / n_te)
            if bundle_dir is not None and cm["acc"] > best_fold[0]:
                # a device copy; it moves to the host once, at fold end
                best_fold = (cm["acc"], {k: v.clone() for k, v in
                                         model.state_dict().items()})
            if verbose:
                print(f"fold {fold} epoch {epoch}: acc {cm['acc']:.3f}, "
                      f"auc {cm['auc']:.3f}, f1 {cm['f1']:.3f}, "
                      f"sen {cm['sen']:.3f}, spe {cm['spe']:.3f}")

        if bundle_dir is not None and best_fold[1] is not None:
            best = to_flax_variables(model, {k: v.cpu() for k, v in
                                             best_fold[1].items()})
            save_bundle(os.path.join(
                bundle_dir, f"serving_bundle_snps_{model_kind}_fold_{fold}"
                            ".npz"), model, best["params"],
                best["batch_stats"])
        if record_dir is not None:
            write_fold_record(
                record_path(fold), score_result_epoch=score_result[fold],
                losses=np.asarray(losses[-epochs:], np.float64),
                model_kind=np.asarray(model_kind), meta=want_meta)

    if result_path is not None:
        np.save(result_path, score_result)
    acc_mean = accs.mean(axis=0)
    argmax = int(acc_mean.argmax())
    std = float(accs[:, argmax].std(ddof=1)) if folds > 1 else 0.0
    return SnpsCVResult(accs=accs, best_acc=float(acc_mean[argmax]),
                        mean_loss=float(np.mean(losses)),
                        score_result=score_result, best_acc_std=std)
