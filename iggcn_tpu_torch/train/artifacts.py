"""Result artifact writers: the reference's npy files, under the same names
and shapes as the JAX package writes them (the port's copy of
`iggcn_tpu/train/artifacts.py`), so downstream analysis reads either:
  * `output_npy` / `output_importance` (`util/output.py:12-32`)
  * per-run score matrix, hidden/subid/linear dumps and regression arrays
    (`kernel/train_eval_sgcn_img_snps.py:228-239,459-464`)
Permutation-test runs suppress artifact writing (parity `util/output.py:13-14`).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def output_npy(path: Optional[str], data, *, is_permut_test: bool = False
               ) -> None:
    if is_permut_test or path is None:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        np.save(fh, np.asarray(data))


def output_importance(res_dir: str, result_file_name: str, fold: int,
                      prob: np.ndarray, snps_prob: "np.ndarray | None",
                      prob_bias: np.ndarray, *, is_permut_test: bool = False
                      ) -> None:
    """Parity `util/output.py:20-32` (same file names). `snps_prob` is None
    for the image-only SGCN family, which has no SNP importance."""
    names = {
        f"node_importance_{result_file_name}_fold_{fold}.npy": prob,
        f"edge_prob_bias_{result_file_name}_fold_{fold}.npy": prob_bias,
    }
    if snps_prob is not None:
        names[f"snps_importance_{result_file_name}_fold_{fold}.npy"] = snps_prob
    for fname, arr in names.items():
        output_npy(os.path.join(res_dir, fname), arr,
                   is_permut_test=is_permut_test)


def output_mask_importance(res_dir: str, result_file_name: str, fold: int,
                           bias_n: np.ndarray, *,
                           is_permut_test: bool = False) -> None:
    """The GUIDE family's per-fold importance: its raw (d, 2) Gumbel mask
    logits (softmax[:, 1] is each feature's keep probability), under the
    JAX package's name."""
    output_npy(
        os.path.join(res_dir,
                     f"mask_importance_{result_file_name}_fold_{fold}.npy"),
        bias_n, is_permut_test=is_permut_test)


def output_regression(res_dir: str, result_file_name: str,
                      score_names: Sequence[str],
                      true_scores: np.ndarray, true_labels: np.ndarray,
                      pred_scores: np.ndarray, *,
                      is_permut_test: bool = False) -> None:
    """Parity `cal_regression_score` file set
    (`kernel/train_eval_sgcn_img_snps.py:459-464`)."""
    for i, name in enumerate(score_names):
        output_npy(os.path.join(res_dir, f"score_true_{name}_{result_file_name}.npy"),
                   true_scores, is_permut_test=is_permut_test)
        output_npy(os.path.join(res_dir,
                                f"score_true_label_{name}_{result_file_name}.npy"),
                   true_labels, is_permut_test=is_permut_test)
        output_npy(os.path.join(res_dir, f"score_pred_{name}_{result_file_name}.npy"),
                   pred_scores, is_permut_test=is_permut_test)
