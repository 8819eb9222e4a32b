"""Batched inference: the serving path (port of `iggcn_tpu/predict.py`).

`batched_forward` pads a host cohort to a batch multiple, uploads it to the
model's device once, runs the eval-mode forward batch by batch under
`torch.inference_mode()`, and returns host arrays trimmed to the cohort:
log-probs, argmax predictions and, where the model has a regression head
(`FusedSGCN`, `GuideImgSnp`; not `ClusterLabelSGCN`), the clinical-score
regressions. `batched_forward_snps` serves the SNP-only families from a
SNP matrix alone: the GO network's encode-then-classify eval, or the
MLP's head, as a probability and `pred = prob > 0.5`. The bf16 and
multi-device options of the JAX functions come later.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from iggcn_tpu_torch.models.clusterlabel import ClusterLabelSGCN
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork


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


def batched_forward(model, x: np.ndarray, adj: np.ndarray, snps: np.ndarray,
                    *, batch_size: int = 256,
                    fixed_batch: bool = False) -> Dict[str, np.ndarray]:
    """Serve a cohort on the model's device.

    Args:
      model: an eval-mode `FusedSGCN`, `GuideImgSnp` or `ClusterLabelSGCN`.
      x (S, N, F), adj (S, N, N), snps (S, S_snp): host arrays.
      batch_size: serving batch.
      fixed_batch: keep the batch at exactly `batch_size` even when the
        cohort is smaller (what a long-lived server wants: every request
        has the same shapes); by default the batch shrinks to the cohort.
    Returns host arrays: log_probs (S, C) float32, pred (S,) int32 and,
    where the model has a regression head, our_reg (S, R) float32, padding
    rows removed.
    """
    validate_cohort_shapes(model, x, adj, snps)
    n = x.shape[0]
    b = batch_size if fixed_batch else (min(batch_size, n) if n
                                        else batch_size)
    device = next(model.parameters()).device
    xb, ab, sb = pad_split_batches((x, adj, snps), b, device)
    cfg = model.cfg
    has_regr = not isinstance(model, ClusterLabelSGCN)
    log_probs, our_reg = [], []
    with torch.inference_mode():
        for i in range(xb.shape[0]):
            out = model(xb[i], ab[i], sb[i])
            log_probs.append(out.log_probs)
            if has_regr:
                our_reg.append(out.our_reg)
        if log_probs:
            lp = torch.cat(log_probs)
            res = {"log_probs": lp, "pred": lp.argmax(dim=-1).to(torch.int32)}
            if has_regr:
                res["our_reg"] = torch.cat(our_reg)
            return {k: v[:n].cpu().numpy() for k, v in res.items()}
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
                         expected_width: int | None = None
                         ) -> Dict[str, np.ndarray]:
    """Serve a SNP-only cohort on the model's device: (S, P) host matrix ->
    prob (S,) float32 and pred (S,) int32 (prob > 0.5).

    `model` is an eval-mode `GeneOntologyNetwork` built with
    `classifier=True` (encode, then classify the latent) or an `MLPModel`.
    `expected_width` fails fast with the model's SNP count on a matrix of
    another width; the batch recipe is `batched_forward`'s."""
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
        prob = (torch.cat(probs)[:n].cpu().numpy() if probs
                else np.zeros((0,), np.float32))
    return {"prob": prob, "pred": (prob > 0.5).astype(np.int32)}
