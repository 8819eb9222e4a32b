"""Batched inference: the serving path (port of `iggcn_tpu/predict.py`).

`batched_forward` pads a host cohort to a batch multiple, uploads it to the
model's device once, runs the eval-mode forward batch by batch under
`torch.inference_mode()`, and returns host arrays trimmed to the cohort:
log-probs, argmax predictions and, where the model has a regression head
(`FusedSGCN`, `GuideImgSnp`; not `ClusterLabelSGCN`), the clinical-score
regressions. `batched_forward_snps` serves the SNP-only families from a
SNP matrix alone: the GO network's encode-then-classify eval, or the
MLP's head, as a probability and `pred = prob > 0.5`.

bf16 serving: `dtype=torch.bfloat16` serves with the model's weights and
the padded inputs in bf16, as `dtype=jnp.bfloat16` does in the JAX
package (`cast_floating` casts the weights, the GO topology constants stay
fp32); products of a bf16 and an fp32 operand run in fp32 as `jnp`'s
promotion has them, and the GCN stack runs the kernel's bf16-operand form.
Outputs come back as fp32 host arrays.

Data-parallel serving (`batched_forward(..., mesh=)`, the JAX function's
`mesh=`): each serving batch is split into equal contiguous slices, one
per position of the mesh's first axis, and each slice runs on that
position's device with a replica of the weights. The effective batch is
rounded up to a multiple of the axis, as the JAX function rounds it.
Serving is a pure map with no collective, so the slices run in this
process: a forward is a few launches per batch, which one host thread
issues to several cards without waiting (launches are asynchronous),
where a process per card would add its start-up and a copy of every
result between processes.
"""
from __future__ import annotations

import copy
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from iggcn_tpu_torch.models.clusterlabel import ClusterLabelSGCN
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.tools.convert import weight_slots


def cast_floating(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast, in place, every floating weight of `model` to `dtype`: the
    tensors `tools/convert.py` maps to the flax `params` and
    `batch_stats` (the JAX `cast_floating` of those trees). Buffers that
    are no weight (the GO topology masks, the decoder's uniform
    attention, index lists) keep their type, as the JAX package keeps
    them as fp32 constants; `module.to(dtype)` would cast them too.
    Returns `model`."""
    with torch.no_grad():
        for _, mod, attr, _, _ in weight_slots(model):
            t = getattr(mod, attr)
            if not t.is_floating_point() or t.dtype == dtype:
                continue
            if isinstance(t, nn.Parameter):
                t.data = t.data.to(dtype)
            else:
                setattr(mod, attr, t.to(dtype))
    return model


def _in_dtype(model: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """`model` itself when its weights are all `dtype` (or `dtype` is None);
    else a copy cast by `cast_floating`, leaving the caller's as it is."""
    if dtype is None or all(
            getattr(mod, attr).dtype == dtype
            for _, mod, attr, _, _ in weight_slots(model)
            if getattr(mod, attr).is_floating_point()):
        return model
    return cast_floating(copy.deepcopy(model), dtype)


def pad_split_batches(arrays: Sequence[np.ndarray], batch_size: int,
                      device: torch.device | str = "cpu"
                      ) -> list[torch.Tensor]:
    """Pad each (S, ...) host array to a multiple of `batch_size` by
    repeating its first row, and return (NB, B, ...) float32 tensors on
    `device`."""
    n = int(np.asarray(arrays[0]).shape[0])
    b = batch_size
    pad = (-n) % b
    nb = (n + pad) // b
    out = []
    for v in arrays:
        v = np.asarray(v, dtype=np.float32)
        if pad:
            v = np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out.append(t.reshape((nb, b) + tuple(v.shape[1:])))
    return out


def validate_cohort_shapes(model, x, adj, snps) -> None:
    """Fail fast with the model's expected per-subject shapes (e.g. a
    multi-fusion bundle, 270 nodes with one feature, fed a (S, 90, 3)
    cohort) instead of a shape error deep in the forward."""
    cfg = model.cfg
    want = {"x": (cfg.rois, cfg.feat_dim), "adj": (cfg.rois, cfg.rois),
            "snps": (cfg.num_snps,)}
    got = {"x": tuple(x.shape[1:]), "adj": tuple(adj.shape[1:]),
           "snps": tuple(snps.shape[1:])}
    bad = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if bad:
        detail = "; ".join(f"{k} per-subject shape {g}, model expects {w}"
                           for k, (w, g) in bad.items())
        raise ValueError(
            f"cohort does not match the model ({detail}) — this "
            f"{type(model).__name__} was trained with rois={cfg.rois}, "
            f"feat_dim={cfg.feat_dim}, num_snps={cfg.num_snps}"
            + (", is_multi_fusion=True (270-node single-feature graphs)"
               if cfg.is_multi_fusion else ""))


def _replicas(model: nn.Module, devices) -> list:
    """`model` on each of `devices` (itself where it already is)."""
    home = next(model.parameters()).device
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = model if d == home else copy.deepcopy(model).to(d)
    return [copies[d] for d in devices]


def batched_forward(model, x: np.ndarray, adj: np.ndarray, snps: np.ndarray,
                    *, batch_size: int = 256, fixed_batch: bool = False,
                    dtype: torch.dtype | None = None, mesh=None
                    ) -> Dict[str, np.ndarray]:
    """Serve a cohort on the model's device.

    Args:
      model: an eval-mode `FusedSGCN`, `GuideImgSnp` or `ClusterLabelSGCN`.
      x (S, N, F), adj (S, N, N), snps (S, S_snp): host arrays.
      batch_size: serving batch.
      fixed_batch: keep the batch at exactly `batch_size` even when the
        cohort is smaller (what a long-lived server wants: every request
        has the same shapes); by default the batch shrinks to the cohort.
      dtype: `torch.bfloat16` for bf16 serving: the weights (of a cast
        copy, unless the model is cast already) and the inputs, after
        padding, in bf16; None serves in the model's fp32.
      mesh: a `parallel.mesh.Mesh` to serve data-parallel over its first
        axis (the batch rounded up to a multiple of it; slices after the
        first on their own devices' replicas); None serves on the
        model's device.
    Returns host arrays: log_probs (S, C) float32, pred (S,) int32 and,
    where the model has a regression head, our_reg (S, R) float32, padding
    rows removed.
    """
    validate_cohort_shapes(model, x, adj, snps)
    n = x.shape[0]
    b = batch_size if fixed_batch else (min(batch_size, n) if n
                                        else batch_size)
    device = next(model.parameters()).device
    model = _in_dtype(model, dtype)
    if mesh is not None:
        axis = mesh.shape[0]
        b = -(-b // axis) * axis       # the sample axis divides by the mesh
        devices = [mesh.devices[mesh.rank_of((j,) + (0,) * (len(mesh.shape)
                                                          - 1))]
                   for j in range(axis)]
    else:
        axis, devices = 1, [device]
    xb, ab, sb = pad_split_batches((x, adj, snps), b, device)
    if dtype is not None:
        xb, ab, sb = (v.to(dtype) for v in (xb, ab, sb))
    replicas = _replicas(model, devices)
    cfg = model.cfg
    has_regr = not isinstance(model, ClusterLabelSGCN)
    log_probs, our_reg = [], []
    step = b // axis
    with torch.inference_mode():
        for i in range(xb.shape[0]):
            for j, (rep, dev) in enumerate(zip(replicas, devices)):
                rows = slice(j * step, (j + 1) * step)
                out = rep(*(v[i, rows].to(dev) for v in (xb, ab, sb)))
                log_probs.append(out.log_probs.to(device))
                if has_regr:
                    our_reg.append(out.our_reg.to(device))
        if log_probs:
            lp = torch.cat(log_probs)
            res = {"log_probs": lp, "pred": lp.argmax(dim=-1).to(torch.int32)}
            if has_regr:
                res["our_reg"] = torch.cat(our_reg)
            return {k: (v[:n].float() if v.is_floating_point() else v[:n]
                        ).cpu().numpy() for k, v in res.items()}
    res = {"log_probs": np.zeros((0, cfg.num_classes), np.float32),
           "pred": np.zeros((0,), np.int32)}
    if has_regr:
        res["our_reg"] = np.zeros((0, cfg.num_regr), np.float32)
    return res


def snps_width(model) -> int:
    """The SNP count a SNP-only model takes."""
    if isinstance(model, GeneOntologyNetwork):
        return int(model.topo.num_snps)
    return int(model.num_snps)


def batched_forward_snps(model, snps: np.ndarray, *, batch_size: int = 256,
                         fixed_batch: bool = False,
                         expected_width: int | None = None,
                         dtype: torch.dtype | None = None
                         ) -> Dict[str, np.ndarray]:
    """Serve a SNP-only cohort on the model's device: (S, P) host matrix ->
    prob (S,) float32 and pred (S,) int32 (prob > 0.5).

    `model` is an eval-mode `GeneOntologyNetwork` built with
    `classifier=True` (encode, then classify the latent) or an `MLPModel`.
    `expected_width` fails fast with the model's SNP count on a matrix of
    another width; the batch and `dtype` recipe is `batched_forward`'s."""
    snps = np.asarray(snps)
    if snps.ndim != 2:
        raise ValueError(f"snps matrix must be 2-D (subjects, snps); got "
                         f"shape {snps.shape}")
    if expected_width is not None and snps.shape[1] != expected_width:
        raise ValueError(f"snps matrix has width {snps.shape[1]} but this "
                         f"model expects {expected_width}")
    n = snps.shape[0]
    b = batch_size if fixed_batch else (min(batch_size, n) if n
                                        else batch_size)
    device = next(model.parameters()).device
    (sb,) = pad_split_batches((snps,), b, device)
    model = _in_dtype(model, dtype)
    if dtype is not None:
        sb = sb.to(dtype)
    is_go = isinstance(model, GeneOntologyNetwork)
    probs = []
    with torch.inference_mode():
        for i in range(sb.shape[0]):
            if is_go:
                latent, _, _ = model(sb[i])
                y_hat = model.classify(latent, sb[i])
            else:
                y_hat = model(sb[i])
            probs.append(y_hat[:, 0])
        prob = (torch.cat(probs)[:n].float().cpu().numpy() if probs
                else np.zeros((0,), np.float32))
    return {"prob": prob, "pred": (prob > 0.5).astype(np.int32)}
