"""Batched inference: the serving path (port of `iggcn_tpu/predict.py`).

`batched_forward` pads a host cohort to a batch multiple, uploads it to the
model's device once, runs the eval-mode forward batch by batch under
`torch.inference_mode()`, and returns host arrays trimmed to the cohort:
log-probs, argmax predictions and the clinical-score regressions. The
bf16 and multi-device options of the JAX function come later.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


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
      model: an eval-mode `FusedSGCN`.
      x (S, N, F), adj (S, N, N), snps (S, S_snp): host arrays.
      batch_size: serving batch.
      fixed_batch: keep the batch at exactly `batch_size` even when the
        cohort is smaller (what a long-lived server wants: every request
        has the same shapes); by default the batch shrinks to the cohort.
    Returns host arrays: log_probs (S, C) float32, pred (S,) int32 and
    our_reg (S, R) float32, padding rows removed.
    """
    validate_cohort_shapes(model, x, adj, snps)
    n = x.shape[0]
    b = batch_size if fixed_batch else (min(batch_size, n) if n
                                        else batch_size)
    device = next(model.parameters()).device
    xb, ab, sb = pad_split_batches((x, adj, snps), b, device)
    cfg = model.cfg
    log_probs, our_reg = [], []
    with torch.inference_mode():
        for i in range(xb.shape[0]):
            out = model(xb[i], ab[i], sb[i])
            log_probs.append(out.log_probs)
            our_reg.append(out.our_reg)
        if log_probs:
            lp = torch.cat(log_probs)
            res = {"log_probs": lp, "pred": lp.argmax(dim=-1).to(torch.int32),
                   "our_reg": torch.cat(our_reg)}
            return {k: v[:n].cpu().numpy() for k, v in res.items()}
    return {"log_probs": np.zeros((0, cfg.num_classes), np.float32),
            "pred": np.zeros((0,), np.int32),
            "our_reg": np.zeros((0, cfg.num_regr), np.float32)}
