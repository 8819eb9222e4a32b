"""ADNI cohort container, its loaders and its synthetic stand-in (port of
`iggcn_tpu/data/adni.py`).

`load_adni874` reads the reference's `.mat` layout
(`<data_path>/knn/<k>/`, parity `sgcn_data.py:113-292`: label remap per
disease_id, MinMax scaling of SNPs and clinical scores, the
permutation-test shuffle, the 270-node multi-fusion block assembly) and
`load_adni_csv` the per-task csv/mat layout; `separate_data_adnitype`
is the held-out-ADNI-type split and `permute_regression_targets` the
permutation-test null of the synthetic route. `synthetic_cohort` draws
from the same `np.random.Generator` calls in the same order as the JAX
package's, so one seed gives the same cohort in both. The diffusion here
is the NumPy path; the JAX package may take its C++ kernel, which agrees
to float rounding. `scipy.io` is imported inside the loaders only.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from iggcn_tpu_torch.config import DataConfig
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

    def select(self, idx: np.ndarray) -> "AdniCohort":
        """The subjects `idx`, every per-subject array sliced alike."""
        return dataclasses.replace(
            self, x=self.x[idx], adj=self.adj[idx], raw_adj=self.raw_adj[idx],
            y=self.y[idx], clust_y=self.clust_y[idx], snps=self.snps[idx],
            sbj_id=self.sbj_id[idx], tsne_fdim=self.tsne_fdim[idx],
            clini_score=self.clini_score[idx],
            demographics=self.demographics[idx],
            raw_y=None if self.raw_y is None else self.raw_y[idx],
            adni_type=(None if self.adni_type is None
                       else self.adni_type[idx]))


def _remap_labels(labels: np.ndarray, disease_id: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Subject selection + label remap, parity `sgcn_data.py:191-245`.

    Raw labels 0..4 = {HC, SMC, EMCI, LMCI, AD}.
    """
    lab = labels.reshape(-1)
    if disease_id == 0:
        sel = np.where((lab == 0) | (lab == 4))[0]
    elif disease_id == 1:
        sel = np.where((lab == 0) | (lab == 1) | (lab == 2) | (lab == 3))[0]
    elif disease_id == 2:
        sel = np.where((lab == 4) | (lab == 2) | (lab == 3) | (lab == 1))[0]
    elif disease_id == 3:
        sel = np.where(lab <= 4)[0]
    else:
        raise ValueError(f"disease_id must be 0..3, got {disease_id}")
    y = lab[sel].copy()
    if disease_id in (0, 1):
        y[y > 0] = 1
    elif disease_id == 2:
        y = np.where(y == 4, 1, 0)
    elif disease_id == 3:
        y = np.where(y == 4, 2, np.where(y > 0, 1, 0))
    return sel, y.astype(np.int64)


def permute_regression_targets(cohort: AdniCohort, seed: int) -> AdniCohort:
    """Permutation-test null: shuffle the subject->regression-target pairing
    (parity `sgcn_data.py:205-208`, which permutes `scores_regr` and the raw
    demographics rows before subject selection). Applied by `load_adni874`
    on the real cohort and by the CLI on the synthetic one."""
    rng = np.random.RandomState(seed)
    return dataclasses.replace(
        cohort,
        clini_score=rng.permutation(cohort.clini_score),
        demographics=rng.permutation(cohort.demographics))


def separate_data_adnitype(cohort: AdniCohort, disease_id: int,
                           adnitype_id: int = 0
                           ) -> Tuple[AdniCohort, AdniCohort]:
    """Split a cohort into (train, held-out-type test) for the
    generalization experiment.

    Parity `sgcn_data.py:24-60`: subjects whose `adni_type` equals
    `adnitype_id` become the test cohort (labels binarized y>0 -> 1); the
    rest are filtered by `disease_id` over the RAW 5-way labels and
    binarized the same way (disease_id 2 uses y==4 as the positive class).
    Requires `cohort.raw_y` and `cohort.adni_type`.
    """
    if cohort.raw_y is None or cohort.adni_type is None:
        raise ValueError("cohort must carry raw_y and adni_type")
    raw = cohort.raw_y.reshape(-1)
    is_test = cohort.adni_type.reshape(-1) == adnitype_id
    if disease_id == 0:
        keep = (raw == 0) | (raw == 4)
        pos = raw > 0
    elif disease_id == 1:
        keep = raw <= 3
        pos = raw > 0
    elif disease_id == 2:
        keep = raw >= 1
        pos = raw >= 4
    else:
        raise ValueError("generalization split supports disease_id 0-2")
    train_idx = np.where(~is_test & keep)[0]
    test_idx = np.where(is_test)[0]
    train = cohort.select(train_idx)
    test = cohort.select(test_idx)
    train = dataclasses.replace(train, y=pos[train_idx].astype(np.int64),
                                num_classes=2)
    test = dataclasses.replace(test, y=(raw[test_idx] > 0).astype(np.int64),
                               num_classes=2)
    return train, test


def load_adni874(cfg: DataConfig) -> AdniCohort:
    """Load the real ADNI-874 .mat cohort (requires the reference data layout
    under cfg.data_path, parity `sgcn_data.py:113-292`)."""
    import scipy.io as sio

    # os.path.join tolerates data_path with or without a trailing
    # slash (string concatenation mangled slashless paths)
    base = os.path.join(cfg.data_path, f"knn/{cfg.knn}/")
    sbj_id = sio.loadmat(base + "sbjID_int.mat")["sbjID_int"]
    scores_fill = sio.loadmat(base + "score_excel_val_adni874_fill.mat")[
        "info_score_val_fill"]
    scaler4score = MinMaxScaler()
    scores_fill = scaler4score.fit_transform(scores_fill)
    if cfg.clinical_score_index != -1:
        scores_regr = scores_fill[:, [cfg.clinical_score_index]]
    else:
        scores_regr = scores_fill[:, CLINICAL_SELECT_INDEX]

    scores_missing = sio.loadmat(base + "score_excel_val_adni874.mat")[
        "info_score_val_subs"]
    clusters = np.load(base + f"center_{cfg.num_cluster}/clusters_pred_label.npy"
                       ).astype(int).reshape(-1)
    if cfg.is_use_tsne4similar:
        tsne = np.load(base + "tsne_results.npy")
    elif cfg.is_multimodal4similarity:
        tsne = np.load(base + "multimodal_for_similarity.npy")
    else:
        tsne = np.load(base + "pet_for_similarity.npy")

    snps = sio.loadmat(base + "SNPS_data.mat")["SNPS_data"]
    snps[np.isnan(snps)] = 0
    snps = MinMaxScaler().fit_transform(snps)

    labels = sio.loadmat(base + "BL_DXGrp_label.mat")["BL_DXGrp_label"] - 1
    corr = sio.loadmat(base + "corr_data.mat")["corr_data"]
    img = sio.loadmat(base + "imgData_mat_normalized_fix.mat")[
        "imgData_mat_normalized"]
    img[np.isnan(img)] = 0
    img = img.reshape(img.shape[0], img.shape[1], -1)

    if cfg.is_permut_test:
        rng = np.random.RandomState(cfg.seed4permut_test)
        scores_regr = rng.permutation(scores_regr)
        scores_missing = rng.permutation(scores_missing)

    sel, y = _remap_labels(labels, cfg.disease_id)

    if cfg.is_multi_fusion:
        n = img.shape[1]
        mats = []
        for mod in ["MRI", "FDG-PET", "AV45-PET"]:
            m = sio.loadmat(os.path.join(
                cfg.data_path, f"{mod}/knn/{cfg.knn}/corr_data.mat")
                )["corr_data"][sel]
            mats.append(m)
        s = len(sel)
        big = np.zeros((s, 3 * n, 3 * n))
        for k, m in enumerate(mats):
            big[:, k * n:(k + 1) * n, k * n:(k + 1) * n] = m
        # reference quirk reproduced bug-for-bug: X.reshape((-1, 1)) on the
        # (90, 3) feature matrix is ROW-major (`sgcn_data.py:272`), so union
        # node j carries (ROI j//3, modality j%3) while the adjacency blocks
        # are modality-major — features and blocks address different
        # entities, exactly as in the reference's multi-fusion mode.
        x = img[sel].reshape(s, 3 * n, 1)
        raw_adj = big
    else:
        x = img[sel]
        raw_adj = corr[sel]

    adj = preprocess_diffusion(raw_adj, is_ppr=cfg.is_ppr, is_topk=cfg.is_topk,
                               top_k=cfg.top_k, alpha=cfg.ppr_alpha,
                               heat_t=cfg.heat_t)
    return AdniCohort(
        x=x.astype(np.float32), adj=adj.astype(np.float32),
        raw_adj=raw_adj.astype(np.float32), y=y,
        clust_y=clusters[sel], snps=snps[sel].astype(np.float32),
        sbj_id=sbj_id.reshape(-1)[sel], tsne_fdim=tsne[sel].astype(np.float32),
        clini_score=scores_regr[sel].astype(np.float32),
        demographics=scores_missing[sel].astype(np.float32),
        scaler4score=scaler4score, num_classes=cfg.num_classes,
        # NOTE: the reference's separate_data_adnitype reads a
        # `data.adni_type` attribute that its loader never sets
        # (`sgcn_data.py:37` — latent bug, SURVEY §4); here raw labels are
        # carried and adni_type stays None unless a sidecar file provides it.
        raw_y=labels.reshape(-1)[sel].astype(np.int64))


def load_adni_csv(cfg: DataConfig) -> AdniCohort:
    """Pre-binarized per-task CSV/mat cohort.

    Parity `sgcn_data.py:62-111` (`loadBrainImg_Snps_CSV`): task-specific
    directory (`data_AH`/`data_MH`/`data_AM` for disease_id 0/1/2) holding
    `snp.csv` (MinMax-scaled, NaN->0) plus `knn/<k>/` .mat imaging arrays
    with ALREADY-binary labels. The reference variant carries no clinical
    scores / demographics / cluster labels — zero placeholders here.
    """
    import scipy.io as sio

    sub = {0: "data_AH", 1: "data_MH"}.get(cfg.disease_id, "data_AM")
    base = os.path.join(cfg.data_path, sub)
    snps = np.genfromtxt(os.path.join(base, "snp.csv"), delimiter=",",
                         skip_header=1)
    snps[np.isnan(snps)] = 0
    snps = MinMaxScaler().fit_transform(snps)

    img_dir = os.path.join(base, f"knn/{cfg.knn}/")
    labels = sio.loadmat(img_dir + "BL_DXGrp_label.mat")["BL_DXGrp_label"]
    corr = sio.loadmat(img_dir + "corr_data.mat")["corr_data"]
    img = sio.loadmat(img_dir + "imgData_mat_normalized_fix.mat")[
        "imgData_mat_normalized"]
    img[np.isnan(img)] = 0
    img = img.reshape(img.shape[0], img.shape[1], -1)
    y = labels.reshape(-1).astype(np.int64)
    s = len(y)
    adj = preprocess_diffusion(corr, is_ppr=cfg.is_ppr, is_topk=cfg.is_topk,
                               top_k=cfg.top_k, alpha=cfg.ppr_alpha,
                               heat_t=cfg.heat_t)
    scaler = MinMaxScaler().fit(np.zeros((2, 9)) + [[0.0] * 9, [1.0] * 9])
    return AdniCohort(
        x=img.astype(np.float32), adj=adj.astype(np.float32),
        raw_adj=corr.astype(np.float32), y=y,
        clust_y=np.zeros(s, np.int64), snps=snps.astype(np.float32),
        sbj_id=np.arange(s, dtype=np.int64),
        tsne_fdim=img.reshape(s, -1)[:, :8].astype(np.float32),
        clini_score=np.zeros((s, 3), np.float32),
        demographics=np.zeros((s, 9), np.float32),
        scaler4score=scaler, num_classes=2, raw_y=y)


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
