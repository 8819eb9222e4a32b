"""One CV fold as a Python epoch loop (the port's counterpart of
`iggcn_tpu/train/fold_scan.py`'s `make_epoch_fns` / `make_fold_runner`).

Each epoch shuffles the padded train set with the fold's pre-drawn
permutation, takes one step per batch, then evaluates the test set and,
with a validation split, the val set. The best epoch (strictly lower val
loss sum, or test loss sum without val) keeps its test outputs.
The JAX package runs the same loop as one `lax.scan` per fold; it seeds
its best copy with an evaluation before the first epoch, which the first
epoch's finite loss always replaces, so this loop skips that evaluation
and takes epoch 1 as its first best (the JAX package's per-epoch debug
path does the same).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
from iggcn_tpu_torch.train.steps import TrainState, eval_step, train_step

Data = Dict[str, torch.Tensor]


def fold_perms(seed: int, epochs: int, fold: int, n_train: int,
               total_padded: int) -> np.ndarray:
    """(epochs, total_padded) int32 epoch permutations of the fold's padded
    train set, identity over the pad rows: one NumPy stream per fold,
    bit-equal to the JAX package's `cv._fold_perms`."""
    shuffler = np.random.default_rng(seed * 1000 + fold)
    return np.stack([
        np.concatenate([shuffler.permutation(n_train),
                        np.arange(n_train, total_padded)])
        for _ in range(epochs)]).astype(np.int32)


def batches(data: Data, batch_size: int) -> List[Data]:
    """Consecutive (B, ...) slices of a padded split."""
    n = data["w"].shape[0]
    return [{k: v[i:i + batch_size] for k, v in data.items()}
            for i in range(0, n, batch_size)]


def train_epoch(state: TrainState, data: Data, perm: torch.Tensor,
                mcfg: ModelConfig, tcfg: TrainConfig,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """One epoch over `data` shuffled by `perm`; returns the sum of
    loss * sum(w) over its steps as a device scalar."""
    shuffled = {k: v.index_select(0, perm) for k, v in data.items()}
    sums = [train_step(state, batch, mcfg, tcfg, generator)
            for batch in batches(shuffled, tcfg.batch_size)]
    return torch.stack(sums).sum()


def eval_set(model: torch.nn.Module, data: Data, mcfg: ModelConfig,
             tcfg: TrainConfig) -> Dict[str, np.ndarray]:
    """Eval every batch of a padded split: per-row outputs concatenated
    (padding rows included), `loss_sum` summed. Copies to the host."""
    outs = [eval_step(model, batch, mcfg, tcfg)
            for batch in batches(data, tcfg.batch_size)]
    flat = {k: torch.cat([o[k] for o in outs]).cpu().numpy()
            for k in outs[0] if k != "loss_sum"}
    flat["loss_sum"] = float(torch.stack([o["loss_sum"] for o in outs]).sum())
    return flat


def run_fold(state: TrainState, train_data: Data, val_data: Optional[Data],
             test_data: Data, perms: np.ndarray, mcfg: ModelConfig,
             tcfg: TrainConfig, generator: Optional[torch.Generator],
             on_epoch: Optional[Callable[[int, Dict], None]] = None
             ) -> Tuple[Dict[str, np.ndarray], Dict, TrainState]:
    """Train one fold for `len(perms)` epochs.

    `val_data=None` tracks the best epoch on the test loss (no-val mode).
    `on_epoch(epoch, record)` sees each epoch's record as it ends.
    Returns (per_epoch, best, state): per_epoch stacks each epoch's
    train/val/test loss sums and test outputs over the epochs; best holds
    the best epoch's test outputs and `val_loss_sum`.
    """
    device = train_data["w"].device
    records: List[Dict] = []
    best: Optional[Dict] = None
    for epoch, perm in enumerate(perms, start=1):
        train_sum = train_epoch(state, train_data,
                                torch.as_tensor(perm, device=device).long(),
                                mcfg, tcfg, generator)
        test_out = eval_set(state.model, test_data, mcfg, tcfg)
        val_sum = (eval_set(state.model, val_data, mcfg, tcfg)["loss_sum"]
                   if val_data is not None else test_out["loss_sum"])
        record = {"train_loss_sum": float(train_sum), "val_loss_sum": val_sum,
                  "test_loss_sum": test_out["loss_sum"],
                  **{k: v for k, v in test_out.items() if k != "loss_sum"}}
        records.append(record)
        if on_epoch is not None:
            on_epoch(epoch, record)
        if best is None or val_sum < best["val_loss_sum"]:
            best = {"test": test_out, "val_loss_sum": val_sum}
    per_epoch = {k: np.stack([np.asarray(r[k]) for r in records])
                 for k in records[0]}
    return per_epoch, best, state
