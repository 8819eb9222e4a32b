"""All CV folds as one batched program (port of
`iggcn_tpu/train/fold_parallel.py`).

The JAX package vmaps its single-fold scan over a leading fold axis and
shards that axis over a device mesh. The port runs the same program: the
folds' data, params, batch statistics and Adam moments are stacked on a
fold axis and every train step and eval batch is one `torch.func.vmap`
call over it (`steps.batched_train_step`, `steps.batched_eval_step`), so
the flagship's GCN-stack kernel runs once per pass for all folds, each
with its own weights. On a (fold, data) mesh of more than one device
(`parallel.mesh.fold_mesh`, one process per position) each position runs
that program for its row's folds on its slice of every train and eval
batch; a batch whose rows the data axis does not divide stays whole on
every position, as `stacked_data_specs` leaves such arrays replicated.
The data replicas of a fold hold the same parameters, bit for bit, after
every step, and the results are gathered in fold order.

Fold data shapes are equalised by padding each fold's padded-batch arrays
to the largest fold with zero-weight rows (`pad_fold_data`) and extending
its epoch permutations over the new rows (`extend_perms`). A batch of
only such rows is a no-op for its fold (the padding gate of
`batched_train_step`), each fold's learning rate follows its own real
steps per epoch, and each fold draws its dropout from its own generator,
so every fold trains as `fold_loop.run_fold` trains it alone.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
from iggcn_tpu_torch.parallel import mesh as meshlib
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


def _shard(axis: Optional[meshlib.DataAxis], rows: int
           ) -> Optional[meshlib.Shard]:
    """This position's shard of a batch of `rows`, or None where the batch
    stays whole (no data axis, or one that does not divide the rows)."""
    if axis is None or rows % axis.size:
        return None
    lo, hi = axis.bounds(rows)
    return meshlib.Shard(axis, lo, hi, rows)


def _rows(tensors, shard: Optional[meshlib.Shard]):
    """The shard's rows (axis 1, after the fold axis) of a batch dict or a
    list of noise draws made for the whole batch."""
    if shard is None or tensors is None:
        return tensors
    n = shard.hi - shard.lo
    if isinstance(tensors, dict):
        return {k: v.narrow(1, shard.lo, n) for k, v in tensors.items()}
    for i, u in enumerate(tensors):
        if u.shape[1] != shard.total:
            raise ValueError(f"noise draw {i} has shape {tuple(u.shape)}: "
                             f"its axis 1 is not the batch of "
                             f"{shard.total} samples")
    return [u.narrow(1, shard.lo, n) for u in tensors]


def _eval_set(state: StackedState, data: Dict[str, torch.Tensor],
              mcfg: ModelConfig, tcfg: TrainConfig,
              axis: Optional[meshlib.DataAxis]) -> Dict[str, np.ndarray]:
    """`fold_loop.eval_set` of every fold: per-row outputs (F, T, ...),
    `loss_sum` (F,); copied to the host. A sharded batch's rows are
    gathered from every position."""
    outs = []
    for b in _batches(data, tcfg.batch_size):
        shard = _shard(axis, b["w"].shape[1])
        with meshlib.sharded(shard):
            out = batched_eval_step(state, _rows(b, shard), mcfg, tcfg)
        if shard is not None:
            out = {k: v if k == "loss_sum"
                   else meshlib.all_gather_rows(v, shard, dim=1)
                   for k, v in out.items()}
        outs.append(out)
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
                       tcfg: TrainConfig, kind: str,
                       mesh: Optional[meshlib.Mesh] = None
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

    `mesh`: a (fold, data) mesh of more than one position, run inside
    `parallel.mesh.launch` (every rank of the world calls this with the
    same arguments). The fold axis must divide F; each position trains
    its row's folds on its slice of every batch, and every rank returns
    every fold's results. None, or a mesh of one device, trains in this
    process on the models' device.
    """
    t0 = time.perf_counter()
    own_test = [d["y"].shape[0] for d in test_datas]
    trains = pad_fold_data(train_datas)
    tests = pad_fold_data(test_datas)
    vals = pad_fold_data(val_datas) if val_datas is not None else None
    target = trains[0]["y"].shape[0]
    perms = np.stack([extend_perms(p, target) for p in perms_list])
    if mesh is None or mesh.size == 1:
        per_epoch, best, done = _train(models, generators, trains, vals,
                                       tests, perms, steps_per_epoch,
                                       own_test, mcfg, tcfg, kind, None)
    else:
        per_epoch, best = _train_on_mesh(models, generators, trains, vals,
                                         tests, perms, steps_per_epoch,
                                         own_test, mcfg, tcfg, kind, mesh)
        done = time.perf_counter()
    return per_epoch, best, done - t0


def _train_on_mesh(models, generators, trains, vals, tests, perms,
                   steps_per_epoch, own_test, mcfg, tcfg, kind,
                   mesh: meshlib.Mesh):
    """`_train` of this position's fold row on its data slices, then every
    fold's results from the data axis' first positions, in fold order;
    `models[f]` takes fold f's final weights. Raises when the data
    replicas of a fold row end with weights that differ in any bit."""
    f_count = len(models)
    rows = mesh.shape[0]
    if f_count % rows:
        raise ValueError(f"the mesh's fold axis ({rows}) does not divide "
                         f"the {f_count} folds")
    per_row = f_count // rows
    coords = meshlib.place(mesh)
    axis = meshlib.data_axis(mesh)
    mine, digest = None, None
    if coords is not None:
        sel = list(range(coords[0] * per_row, (coords[0] + 1) * per_row))
        pick = (lambda xs: [xs[f] for f in sel])
        per_epoch, best, _ = _train(
            pick(models), pick(generators), pick(trains),
            None if vals is None else pick(vals), pick(tests), perms[sel],
            pick(steps_per_epoch), pick(own_test), mcfg, tcfg, kind, axis)
        finals = [{k: v.detach().cpu() for k, v in models[f].state_dict()
                   .items()} for f in sel]
        digest = (coords[0], _digest(finals))
        if coords[1] == 0:
            mine = list(zip(sel, per_epoch, best, finals))
    results, digests = {}, {}
    for part, d in meshlib.gather_objects((mine, digest)):
        for f, pe, b, final in part or ():
            results[f] = (pe, b, final)
        if d is not None:
            digests.setdefault(d[0], set()).add(d[1])
    split = {row: len(ds) for row, ds in digests.items() if len(ds) > 1}
    if split:
        raise RuntimeError(f"the data replicas of fold rows {sorted(split)} "
                           "ended with different weights")
    for f, model in enumerate(models):
        model.load_state_dict(results[f][2])
    return ([results[f][0] for f in range(f_count)],
            [results[f][1] for f in range(f_count)])


def _digest(states: Sequence[Dict[str, torch.Tensor]]) -> str:
    """A hash of the bytes of host state_dicts (replicas compare it)."""
    h = hashlib.sha256()
    for state in states:
        for k, v in state.items():
            h.update(k.encode())
            h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def _train(models, generators, trains, vals, tests, perms, steps_per_epoch,
           own_test, mcfg, tcfg, kind, axis: Optional[meshlib.DataAxis]):
    """The epoch loop of equal-shape folds: `run_folds_parallel`'s
    (per_epoch, best) and the clock when the training was done on the
    device (before the results' host copies); `axis` shards the
    batches."""
    f_count = len(models)
    device = next(models[0].parameters()).device
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
            shard = _shard(axis, batch["w"].shape[1])
            with meshlib.sharded(shard):
                sums.append(batched_train_step(
                    state, _rows(batch, shard), mcfg, tcfg,
                    _rows(noise, shard), has_real))
        train_sum = torch.stack(sums).sum(dim=0).cpu().numpy()
        test_out = _eval_set(state, test, mcfg, tcfg, axis)
        val_sum = (_eval_set(state, val, mcfg, tcfg, axis)["loss_sum"]
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
    done = time.perf_counter()
    per_epoch, best = [], []
    for f in range(f_count):
        per_epoch.append({k: np.stack([np.asarray(r[k]) for r in records[f]])
                          for k in records[f][0]})
        best.append({"test": best_test[f], "val_loss_sum": float(best_val[f]),
                     "state": {k: v[f].cpu() for k, v in best_state.items()}})
    return per_epoch, best, done
