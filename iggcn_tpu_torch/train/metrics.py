"""Host-side evaluation metrics, NumPy, once per epoch on small arrays (the
port's copy of `iggcn_tpu/train/metrics.py`; scikit-learn's definitions,
computed without it)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def roc_auc_binary(y_true: np.ndarray, scores: np.ndarray) -> float:
    """AUC of the ROC curve, pos_label=1 (parity metrics.roc_curve+auc).
    Returns 0.0 when undefined (single-class fold), matching the reference's
    try/except guard (`train_eval_sgcn_img_snps.py:637-642`)."""
    y = np.asarray(y_true) == 1
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0 or not np.isfinite(scores).all():
        return 0.0
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    # midranks for ties
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def f1_weighted(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn f1_score(average='weighted') parity."""
    classes = np.unique(y_true)
    f1s, weights = [], []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp > 0 else 0.0
        rec = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)
        weights.append(np.sum(y_true == c))
    return float(np.average(f1s, weights=weights))


def sensitivity_specificity(y_true: np.ndarray, y_pred: np.ndarray
                            ) -> Tuple[float, float]:
    """Binary confusion-matrix sens/spec (parity `:663-667`)."""
    tp = np.sum((y_pred == 1) & (y_true == 1))
    tn = np.sum((y_pred == 0) & (y_true == 0))
    fp = np.sum((y_pred == 1) & (y_true == 0))
    fn = np.sum((y_pred == 0) & (y_true == 1))
    sens = tp / (tp + fn) if tp + fn > 0 else 0.0
    spec = tn / (tn + fp) if tn + fp > 0 else 0.0
    return float(sens), float(spec)


def pearson_r(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean()) ** 2)
    return float(1 - ss_res / ss_tot) if ss_tot > 0 else 0.0


def rmse(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """mean_squared_error(squared=False) parity (the reference reports RMSE
    under the name 'mse', `train_eval_sgcn_img_snps.py:652`)."""
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def regression_metrics(true_scores: np.ndarray, pred_scores: np.ndarray
                       ) -> Tuple[List[float], List[float], List[float]]:
    """Per-column (corr, r2, rmse); NaN predictions zeroed first (parity
    `train_eval_sgcn_img_snps.py:648-657`)."""
    pred_scores = np.where(np.isnan(pred_scores), 0.0, pred_scores)
    corr, r2s, mses = [], [], []
    for i in range(true_scores.shape[1]):
        corr.append(pearson_r(true_scores[:, i], pred_scores[:, i]))
        r2s.append(r2_score(true_scores[:, i], pred_scores[:, i]))
        mses.append(rmse(true_scores[:, i], pred_scores[:, i]))
    return corr, r2s, mses


def classification_metrics(y_true: np.ndarray, y_pred: np.ndarray,
                           scores: np.ndarray, num_classes: int
                           ) -> Dict[str, float]:
    acc = float(np.mean(y_true == y_pred))
    auc = roc_auc_binary(y_true, scores) if num_classes < 3 else 0.0
    f1 = f1_weighted(y_true, y_pred)
    if num_classes < 3:
        sens, spec = sensitivity_specificity(y_true, y_pred)
    else:
        sens, spec = 0.0, 0.0
    return {"acc": acc, "auc": auc, "f1": f1, "sen": sens, "spe": spec}
