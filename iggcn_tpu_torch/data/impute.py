"""Per-fold, leakage-safe KNN imputation of the demographics (port of
`iggcn_tpu/data/impute.py`).

The JAX package fits scikit-learn's `KNNImputer(n_neighbors=3)` on the
train fold and applies it to the others, re-scales with the cohort's
MinMax scaler and selects the clinical-score columns. The port computes
the same imputer itself, step for step in the same dtypes (float32 input:
squared distances from a float64 product rounded to float32, nan-euclidean
rescaling, `argpartition` donors, masked mean), so it needs no
scikit-learn and its values are bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import List

import numpy as np

from iggcn_tpu_torch.data.adni import CLINICAL_SELECT_INDEX, MinMaxScaler


def _nan_euclidean(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Distances between the rows of x and y over their coordinates present
    in both, scaled by n_features / n_present; NaN where none is shared."""
    missing_x, missing_y = np.isnan(x), np.isnan(y)
    x = np.where(missing_x, 0, x).astype(x.dtype)
    y = np.where(missing_y, 0, y).astype(y.dtype)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d = -2 * (x64 @ y64.T)
    d += np.einsum("ij,ij->i", x64, x64)[:, None]
    d += np.einsum("ij,ij->i", y64, y64)[None, :]
    dist = d.astype(x.dtype)
    np.maximum(dist, 0, out=dist)
    dist -= np.dot(x * x, missing_y.T)
    dist -= np.dot(missing_x, (y * y).T)
    np.clip(dist, 0, None, out=dist)
    present = np.dot(1 - missing_x, (~missing_y).T)
    dist[present == 0] = np.nan
    np.maximum(1, present, out=present)
    dist /= present
    dist *= x.shape[1]
    np.sqrt(dist, out=dist)
    return dist


class KNNImputer:
    """Uniform-weight k-nearest-neighbour imputation of NaN entries, fitted
    on one array and applied to others. Every column must have a value in
    the fitted array."""

    def __init__(self, n_neighbors: int = 3):
        self.n_neighbors = n_neighbors

    def fit(self, x: np.ndarray) -> "KNNImputer":
        self.fit_x_ = np.array(x, dtype=x.dtype if x.dtype in (np.float32,
                                                               np.float64)
                               else np.float64)
        self.mask_fit_ = np.isnan(self.fit_x_)
        if self.mask_fit_.all(axis=0).any():
            raise ValueError("a column has no value in the fitted data")
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, dtype=self.fit_x_.dtype)
        mask = np.isnan(x)
        rows = np.flatnonzero(mask.any(axis=1))
        if not rows.size:
            return x
        dist = _nan_euclidean(x[rows], self.fit_x_)
        for col in range(x.shape[1]):
            recv = np.flatnonzero(mask[rows, col])
            if not recv.size:
                continue
            donors = np.flatnonzero(~self.mask_fit_[:, col])
            sub = dist[recv][:, donors]
            all_nan = np.isnan(sub).all(axis=1)
            if all_nan.any():
                x[rows[recv[all_nan]], col] = np.ma.array(
                    self.fit_x_[:, col], mask=self.mask_fit_[:, col]).mean()
                recv, sub = recv[~all_nan], sub[~all_nan]
                if not recv.size:
                    continue
            k = min(self.n_neighbors, len(donors))
            idx = np.argpartition(sub, k - 1, axis=1)[:, :k]
            near = sub[np.arange(len(idx))[:, None], idx]
            weights = np.ones_like(near)
            weights[np.isnan(near)] = 0.0
            vals = np.ma.array(self.fit_x_[donors, col].take(idx),
                               mask=self.mask_fit_[donors, col].take(idx))
            x[rows[recv], col] = np.ma.average(vals, axis=1,
                                               weights=weights).data
        return x

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


def knn_impute_scores(demographics_splits: List[np.ndarray],
                      scaler4score: MinMaxScaler,
                      clinical_score_index: int = -1,
                      k: int = 3) -> List[np.ndarray]:
    """Impute each split's demographics (the first split is the train fold:
    fit and transform; the others transform only) and return each split's
    clinical-score targets, float32."""
    imputer = KNNImputer(n_neighbors=k)
    imputed = [imputer.fit_transform(demographics_splits[0])]
    imputed += [imputer.transform(d) for d in demographics_splits[1:]]
    scaled = [scaler4score.transform(d) for d in imputed]
    sel = (CLINICAL_SELECT_INDEX if clinical_score_index == -1
           else np.array([clinical_score_index]))
    return [s[:, sel].astype(np.float32) for s in scaled]
