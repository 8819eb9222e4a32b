"""ADNI-shaped cohort container and its synthetic stand-in (port of
`iggcn_tpu/data/adni.py`).

`synthetic_cohort` draws from the same `np.random.Generator` calls in the
same order as the JAX package's, so one seed gives the same cohort in both
(the diffusion here is the NumPy path; the JAX package may take its C++
kernel, which agrees to float rounding). The loaders of the real `.mat` /
csv layouts, the held-out-ADNI-type split and the permutation-test
shuffle are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from iggcn_tpu_torch.data.diffusion import preprocess_diffusion

# demographics columns: label, age, edu, sex, abeta, tau, ptau, adas13, mmse
CLINICAL_SELECT_INDEX = np.array([5, 7, 8])   # tau, adas13, mmse
SCORE_NAMES_ALL = ["label", "age", "edu", "sex", "abeta", "tau", "ptau",
                   "adas13", "mmse"]
SCORE_NAMES_DEFAULT = ["tau", "adas13", "mmse"]


class MinMaxScaler:
    """Column-wise min-max scaling, NaN-aware fit (scikit-learn's
    MinMaxScaler with the default range); a constant column scales by 1."""

    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        self.data_min_ = np.nanmin(x, axis=0)
        self.data_max_ = np.nanmax(x, axis=0)
        rng = self.data_max_ - self.data_min_
        rng[rng == 0] = 1.0
        self.scale_ = 1.0 / rng
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.data_min_) * self.scale_

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


@dataclasses.dataclass
class AdniCohort:
    """Dense cohort arrays, subjects first."""

    x: np.ndarray              # (S, N, D) node features
    adj: np.ndarray            # (S, N, N) diffusion-processed weighted adjacency
    raw_adj: np.ndarray        # (S, N, N) correlation matrices before diffusion
    y: np.ndarray              # (S,) int labels
    clust_y: np.ndarray        # (S,) unsupervised cluster labels
    snps: np.ndarray           # (S, 54) scaled SNP features
    sbj_id: np.ndarray         # (S,) subject ids
    tsne_fdim: np.ndarray      # (S, F_sim) similarity features
    clini_score: np.ndarray    # (S, R) regression targets (before imputation)
    demographics: np.ndarray   # (S, 9) raw demographics with NaNs
    scaler4score: MinMaxScaler
    num_classes: int
    raw_y: Optional[np.ndarray] = None     # (S,) 5-way labels before remap
    adni_type: Optional[np.ndarray] = None  # (S,) acquisition cohort id

    def __len__(self) -> int:
        return self.x.shape[0]


def synthetic_cohort(rng: np.random.Generator, *, num_subjects: int = 96,
                     rois: int = 90, feat_dim: int = 3, num_snps: int = 54,
                     num_classes: int = 2, num_regr: int = 3,
                     knn_k: int = 10, top_k: int = 3, sim_dim: int = 8,
                     diffuse: bool = True,
                     planted_rois: Optional[Sequence[int]] = None,
                     planted_snps: Optional[Sequence[int]] = None,
                     planted_strength: float = 1.0) -> AdniCohort:
    """ADNI-shaped synthetic cohort with class-correlated signal: kNN-style
    symmetric correlation graphs, 3-channel ROI features, SNPs in [0, 1],
    clinical scores, demographics with NaN holes (for the imputation),
    cluster labels.

    `planted_rois` / `planted_snps` make only the listed ROIs / SNPs carry
    class signal (strength `planted_strength`), every other feature noise.
    """
    if num_regr > len(CLINICAL_SELECT_INDEX):
        raise ValueError(
            f"synthetic cohort supports at most {len(CLINICAL_SELECT_INDEX)} "
            f"regression targets (tau/adas13/mmse); got num_regr={num_regr}")
    s = num_subjects
    y = rng.integers(0, num_classes, size=s)
    caxis = (2.0 * np.arange(num_classes) / max(num_classes - 1, 1) - 1.0)
    if planted_rois is None:
        class_mu = rng.normal(0, 0.5, size=(num_classes, rois, feat_dim))
    else:
        class_mu = np.zeros((num_classes, rois, feat_dim))
        class_mu[:, list(planted_rois), :] = (
            planted_strength * caxis[:, None, None])
    x = class_mu[y] + rng.normal(0, 0.5, size=(s, rois, feat_dim))
    x = x.astype(np.float64)

    # symmetric positive correlation-like graphs, kNN-sparsified per row,
    # with self-degree > 0; in place, to spare (S, N, N) float64 temporaries
    base = rng.normal(size=(s, rois, rois))
    corr = base + np.swapaxes(base, 1, 2)
    del base
    np.abs(corr, out=corr)
    corr *= 0.5
    kth = np.partition(corr, rois - knn_k, axis=2)[:, :, rois - knn_k, None]
    corr[corr < kth] = 0.0
    sym = corr + np.swapaxes(corr, 1, 2)
    del corr
    sym *= 0.5
    diag = np.arange(rois)
    sym[:, diag, diag] += 0.5
    corr = sym

    adj = preprocess_diffusion(corr, top_k=top_k) if diffuse else corr

    if planted_snps is None:
        snps_mu = rng.random((num_classes, num_snps))
    else:
        snps_mu = np.full((num_classes, num_snps), 0.5)
        snps_mu[:, list(planted_snps)] = (
            0.5 + 0.35 * planted_strength * caxis[:, None])
    snps = np.clip(snps_mu[y] + rng.normal(0, 0.15, (s, num_snps)), 0, 1)

    demo = rng.normal(0.5, 0.2, size=(s, 9))
    demo[:, 0] = y
    holes = rng.random(demo.shape) < 0.1
    holes[:, 0] = False
    demo_missing = demo.copy()
    demo_missing[holes] = np.nan
    scaler = MinMaxScaler().fit(np.nan_to_num(demo, nan=0.5))

    clini = scaler.transform(np.nan_to_num(demo, nan=0.5))[
        :, CLINICAL_SELECT_INDEX[:num_regr]]
    tsne = (x.mean(axis=2)[:, :sim_dim] + rng.normal(0, 0.05, (s, sim_dim)))

    raw_y = np.where(y > 0, rng.integers(1, 5, size=s), 0).astype(np.int64)
    return AdniCohort(
        x=x.astype(np.float32), adj=adj.astype(np.float32),
        raw_adj=corr.astype(np.float32), y=y.astype(np.int64),
        clust_y=rng.integers(0, 2, size=s).astype(np.int64),
        snps=snps.astype(np.float32), sbj_id=np.arange(s, dtype=np.int64),
        tsne_fdim=tsne.astype(np.float32), clini_score=clini.astype(np.float32),
        demographics=demo_missing.astype(np.float32),
        scaler4score=scaler, num_classes=num_classes,
        raw_y=raw_y,
        adni_type=rng.integers(0, 2, size=s).astype(np.int64))
