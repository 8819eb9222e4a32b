"""All CV folds as one batched program (port of
`iggcn_tpu/train/fold_parallel.py`).

The JAX package vmaps its single-fold scan over a leading fold axis and
shards that axis over a device mesh. The port runs the same program on one
card: the folds' data, params, batch statistics and Adam moments are
stacked on a fold axis and every train step and eval batch is one
`torch.func.vmap` call over it (`steps.batched_train_step`,
`steps.batched_eval_step`), so the flagship's GCN-stack kernel runs once
per pass for all folds, each with its own weights. There is no mesh and
no data axis (`fold_mesh` is not ported): the card host has one GPU.

Fold data shapes are equalised by padding each fold's padded-batch arrays
to the largest fold with zero-weight rows (`pad_fold_data`) and extending
its epoch permutations over the new rows (`extend_perms`). A batch of
only such rows is a no-op for its fold (the padding gate of
`batched_train_step`), each fold's learning rate follows its own real
steps per epoch, and each fold draws its dropout from its own generator,
so every fold trains as `fold_loop.run_fold` trains it alone.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
from iggcn_tpu_torch.train.steps import (StackedState, batched_eval_step,
                                         batched_train_step, draw_fold_noise,
                                         record_noise_shapes)

HostData = Dict[str, np.ndarray]


def pad_fold_data(datas: Sequence[HostData]) -> List[HostData]:
    """Pad every fold's arrays (leading axis) to the max across folds with
    zeros; the `w` column keeps marking the real rows."""
    target = max(d["y"].shape[0] for d in datas)
    out = []
    for d in datas:
        cur = d["y"].shape[0]
        if cur == target:
            out.append(d)
            continue
        padded = {}
        for k, v in d.items():
            pad = [(0, target - cur)] + [(0, 0)] * (v.ndim - 1)
            padded[k] = np.pad(v, pad)
        out.append(padded)
    return out


def extend_perms(perms: np.ndarray, target: int) -> np.ndarray:
    """Extend (E, S_f) epoch permutations to (E, target) by appending the
    identity over the new padding rows."""
    e, s = perms.shape
    if s == target:
        return perms
    extra = np.broadcast_to(np.arange(s, target, dtype=perms.dtype),
                            (e, target - s))
    return np.concatenate([perms, extra], axis=1)


def stack_data(datas: Sequence[HostData], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """Equal-shape host dicts as (F, ...) tensors on `device`."""
    return {k: torch.as_tensor(np.stack([d[k] for d in datas]), device=device)
            for k in datas[0]}


def _batches(data: Dict[str, torch.Tensor], batch_size: int):
    n = data["w"].shape[1]
    return [{k: v[:, i:i + batch_size] for k, v in data.items()}
            for i in range(0, n, batch_size)]


def _eval_set(state: StackedState, data: Dict[str, torch.Tensor],
              mcfg: ModelConfig, tcfg: TrainConfig) -> Dict[str, np.ndarray]:
    """`fold_loop.eval_set` of every fold: per-row outputs (F, T, ...),
    `loss_sum` (F,); copied to the host."""
    outs = [batched_eval_step(state, b, mcfg, tcfg)
            for b in _batches(data, tcfg.batch_size)]
    flat = {k: torch.cat([o[k] for o in outs], dim=1).cpu().numpy()
            for k in outs[0] if k != "loss_sum"}
    flat["loss_sum"] = torch.stack([o["loss_sum"] for o in outs]
                                   ).sum(dim=0).cpu().numpy()
    return flat


def run_folds_parallel(models: Sequence[torch.nn.Module],
                       generators: Sequence[torch.Generator],
                       train_datas: Sequence[HostData],
                       val_datas: Optional[Sequence[HostData]],
                       test_datas: Sequence[HostData],
                       perms_list: Sequence[np.ndarray],
                       steps_per_epoch: Sequence[int], mcfg: ModelConfig,
                       tcfg: TrainConfig, kind: str
                       ) -> Tuple[List[Dict], List[Dict], float]:
    """Train F folds at once for `perms_list[f].shape[0]` epochs.

    Each fold's host data are its padded splits (`cv.prepare_fold`),
    `perms_list[f]` its epoch permutations and `steps_per_epoch[f]` its
    own train batches (its learning-rate schedule); shapes are equalised
    here. `val_datas=None` tracks the best epoch on the test loss.
    Returns (per_epoch, best, seconds): per fold, what
    `fold_loop.run_fold` returns for it (outputs trimmed to the fold's own
    padded test rows; `best["state"]` a host state_dict), with `models[f]`
    left holding fold f's final weights; and the run's wall time.
    """
    t0 = time.perf_counter()
    f_count = len(models)
    device = next(models[0].parameters()).device
    own_test = [d["y"].shape[0] for d in test_datas]
    trains = pad_fold_data(train_datas)
    tests = pad_fold_data(test_datas)
    vals = pad_fold_data(val_datas) if val_datas is not None else None
    target = trains[0]["y"].shape[0]
    perms = np.stack([extend_perms(p, target) for p in perms_list])
    state = StackedState(models, tcfg, steps_per_epoch, kind)
    train = stack_data(trains, device)
    test = stack_data(tests, device)
    val = stack_data(vals, device) if vals is not None else None
    w_host = np.stack([d["w"] for d in trains])
    b = tcfg.batch_size
    fold_index = torch.arange(f_count, device=device)[:, None]
    shapes = None
    records: List[List[Dict]] = [[] for _ in range(f_count)]
    best_val = np.full(f_count, np.inf)
    best_test: List[Optional[Dict]] = [None] * f_count
    best_state: Optional[Dict[str, torch.Tensor]] = None
    for e in range(perms.shape[1]):
        perm = torch.as_tensor(perms[:, e], device=device).long()
        shuffled = {k: v[fold_index, perm] for k, v in train.items()}
        w_shuf = np.take_along_axis(w_host, perms[:, e].astype(np.int64),
                                    axis=1)
        sums = []
        for i, batch in enumerate(_batches(shuffled, b)):
            has_real = w_shuf[:, i * b:(i + 1) * b].sum(axis=1) > 0
            if shapes is None:
                shapes = record_noise_shapes(state, batch, mcfg, tcfg)
            noise = draw_fold_noise(
                shapes, [g if real else None
                         for g, real in zip(generators, has_real)], device)
            sums.append(batched_train_step(state, batch, mcfg, tcfg, noise,
                                           has_real))
        train_sum = torch.stack(sums).sum(dim=0).cpu().numpy()
        test_out = _eval_set(state, test, mcfg, tcfg)
        val_sum = (_eval_set(state, val, mcfg, tcfg)["loss_sum"]
                   if val is not None else test_out["loss_sum"])
        improved = np.asarray([best_test[f] is None or val_sum[f] < best_val[f]
                               for f in range(f_count)])
        for f in range(f_count):
            rows = {k: v[f, :own_test[f]] for k, v in test_out.items()
                    if k != "loss_sum"}
            records[f].append({"train_loss_sum": float(train_sum[f]),
                               "val_loss_sum": float(val_sum[f]),
                               "test_loss_sum": float(test_out["loss_sum"][f]),
                               **rows})
            if improved[f]:
                best_val[f] = val_sum[f]
                best_test[f] = {**rows,
                                "loss_sum": float(test_out["loss_sum"][f])}
        # each fold's best weights, kept on the card: one select per tensor
        current = {k: v.detach() for k, v in state.fold_tensors().items()}
        if best_state is None:
            best_state = {k: v.clone() for k, v in current.items()}
        elif improved.any():
            mask = torch.as_tensor(improved, device=device)
            for k, v in current.items():
                best_state[k] = torch.where(
                    mask.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                    best_state[k])
    for f, model in enumerate(models):
        model.load_state_dict(state.fold_state_dict(f))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    per_epoch, best = [], []
    for f in range(f_count):
        per_epoch.append({k: np.stack([np.asarray(r[k]) for r in records[f]])
                          for k in records[f][0]})
        best.append({"test": best_test[f], "val_loss_sum": float(best_val[f]),
                     "state": {k: v[f].cpu() for k, v in best_state.items()}})
    return per_epoch, best, seconds
