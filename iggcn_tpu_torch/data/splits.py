"""K-fold splits, bit-equal to the JAX package's (`iggcn_tpu/data/splits.py`).

That module calls scikit-learn's `StratifiedKFold` with `shuffle=True,
random_state=seed`; the port reproduces its draws from
`np.random.RandomState(seed)` itself, so it needs no scikit-learn. The
validation fold of fold i is the test fold of fold i-1; train is the rest.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Split = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _stratified_test_folds(y: np.ndarray, folds: int, seed: int
                           ) -> np.ndarray:
    """Fold id of every sample, as `StratifiedKFold._make_test_folds` draws
    it: classes coded by order of first appearance, per-class fold sizes by
    round robin over the sorted codes, each class's fold ids shuffled."""
    rng = np.random.RandomState(seed)
    y = np.asarray(y).reshape(-1)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    if np.all(folds > np.bincount(y_encoded)):
        raise ValueError(f"n_splits={folds} cannot be greater than the "
                         f"number of members in each class")
    y_order = np.sort(y_encoded)
    allocation = np.asarray([np.bincount(y_order[i::folds],
                                         minlength=n_classes)
                             for i in range(folds)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(folds).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    return test_folds


def _with_val(test_indices: List[np.ndarray], n: int) -> List[Split]:
    folds = len(test_indices)
    out = []
    for i in range(folds):
        mask = np.ones(n, dtype=bool)
        mask[test_indices[i]] = False
        mask[test_indices[i - 1]] = False
        out.append((np.nonzero(mask)[0], test_indices[i], test_indices[i - 1]))
    return out


def k_fold(y: np.ndarray, folds: int, seed: int) -> List[Split]:
    """Stratified splits: [(train_idx, test_idx, val_idx)] per fold."""
    test_folds = _stratified_test_folds(y, folds, seed)
    return _with_val([np.flatnonzero(test_folds == i) for i in range(folds)],
                     len(test_folds))

