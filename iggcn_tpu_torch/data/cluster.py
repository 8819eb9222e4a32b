"""Offline subject clustering / similarity-feature preparation (the port's
copy of `iggcn_tpu/data/cluster.py`).

Re-design of `util/image_cluster.py` (`run_cluster_ADNI874`, `:148-284`):
t-SNE embed the normalized imaging features, KMeans them into k clusters,
and write the artifact files the training loader consumes
(`clusters_pred_label.npy`, `tsne_results*.npy`,
`{pet,multimodal}_for_similarity.npy` — read back at
`iggcn_tpu_torch/data/adni.py`).

Host-side scikit-learn, run once per dataset, not on the card's path; it
is imported when a function needs it, and a host without it (the card
host has none) gets the install hint. The online counterpart (the RBF
similarity kernel of the consistency loss, `util/image_cluster.py:15-31`)
is `iggcn_tpu_torch/train/losses.py:rbf_kernel`.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np


def _sklearn():
    """scikit-learn's KMeans and TSNE, or ImportError with the hint."""
    try:
        from sklearn.cluster import KMeans
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError("scikit-learn is required for data/cluster.py "
                          "(pip install scikit-learn); the clustering "
                          "artifacts are made once per dataset on a host "
                          "that has it") from e
    return KMeans, TSNE


def similarity_features(img_normalized: np.ndarray,
                        mode: str = "multimodal") -> np.ndarray:
    """Flatten normalized imaging data into per-subject similarity features.

    Parity `util/image_cluster.py:157-172`: 'multimodal' flattens all (ROI,
    channel) entries; 'pet' keeps channel 2 (AV45-PET) only.
    """
    if mode == "multimodal":
        return img_normalized.reshape(img_normalized.shape[0], -1)
    if mode == "pet":
        return img_normalized[:, :, 2]
    raise ValueError(f"unknown similarity mode {mode}")


def calculate_wss(points: np.ndarray, kmax: int = 10,
                  seed: int = 1000) -> list:
    """Within-cluster sum of squares for k=1..kmax (elbow curve, parity
    `util/image_cluster.py` `calculate_WSS`)."""
    KMeans, _ = _sklearn()

    sse = []
    for k in range(1, kmax + 1):
        km = KMeans(n_clusters=k, init="k-means++", n_init=10,
                    random_state=seed).fit(points)
        sse.append(float(km.inertia_))
    return sse


def run_image_clustering(features: np.ndarray, *, k: int = 2,
                         perplexity: float = 40.0, seed: int = 1000,
                         tsne_cache: Optional[str] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """t-SNE(2) -> KMeans(k) over subject similarity features.

    Parity `util/image_cluster.py:184-245`: TSNE(n_components=2,
    init='pca', method='exact', random_state=1000) then
    KMeans(k, 'k-means++', random_state=1000). Returns (tsne_2d, labels).
    """
    import hashlib

    KMeans, TSNE = _sklearn()

    # the cache is only valid for THIS feature matrix + parameters; a
    # path-only check would silently reuse an embedding of different data
    # (e.g. after switching mode='multimodal' -> 'pet'). The small-cohort
    # clamp is applied BEFORE fingerprinting so requests that clamp to the
    # same effective perplexity share a cache entry.
    perplexity = min(perplexity, max(2.0, features.shape[0] / 4))
    fp = hashlib.sha1(np.ascontiguousarray(features).tobytes()
                      + f"|{perplexity}|{seed}".encode()).hexdigest()
    meta_path = (tsne_cache + ".meta.txt") if tsne_cache is not None else None
    cache_ok = False
    if (tsne_cache is not None and os.path.exists(tsne_cache)
            and meta_path is not None and os.path.exists(meta_path)):
        with open(meta_path) as fh:
            cache_ok = fh.read().strip() == fp
    if cache_ok:
        tsne_results = np.load(tsne_cache)
    else:
        tsne = TSNE(n_components=2, perplexity=perplexity, init="pca",
                    learning_rate="auto", method="exact", random_state=seed)
        tsne_results = tsne.fit_transform(features)
        if tsne_cache is not None:
            np.save(tsne_cache, tsne_results)
            with open(meta_path, "w") as fh:
                fh.write(fp)
    km = KMeans(n_clusters=k, init="k-means++", n_init=10,
                random_state=seed).fit(tsne_results)
    return tsne_results, km.predict(tsne_results).astype(np.int64)


DIAGNOSIS_NAMES = ("HC", "SMC", "EMCI", "LMCI", "AD")


def plot_tsne(tsne_results: np.ndarray, labels: np.ndarray,
              path: Optional[str] = None, *,
              label_names: Optional[Sequence[str]] = None,
              title: str = ""):
    """Scatter of the 2-D t-SNE embedding colored by label (parity with the
    reference's seaborn scatterplots of diagnosis / cluster assignments,
    `util/image_cluster.py:198-258`). `label_names` maps integer labels to
    legend names (e.g. `DIAGNOSIS_NAMES` for the 5-way raw labels).
    Gated import: matplotlib is optional (the card host has none)."""
    try:
        import matplotlib
        if path is not None:
            # only the save path forces the headless backend; an
            # interactive caller keeps whatever backend is active
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover - optional dep
        raise RuntimeError("plot_tsne requires matplotlib") from e
    labels = np.asarray(labels).reshape(-1)
    if label_names is not None and not (
            0 <= labels.min() and labels.max() < len(label_names)):
        raise ValueError(f"labels span [{labels.min()}, {labels.max()}] but "
                         f"label_names has {len(label_names)} entries")
    fig, ax = plt.subplots(figsize=(6, 5))
    for lab in np.unique(labels):
        sel = labels == lab
        name = (label_names[int(lab)] if label_names is not None
                else str(int(lab)))
        ax.scatter(tsne_results[sel, 0], tsne_results[sel, 1], s=14,
                   alpha=0.7, label=name)
    ax.set_xlabel("Dimension1")
    ax.set_ylabel("Dimension2")
    if title:
        ax.set_title(title)
    ax.legend()
    for side in ("right", "top"):
        ax.spines[side].set_color("none")
    if path is not None:
        fig.savefig(path, dpi=200, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig


def prepare_cluster_artifacts(img_normalized: np.ndarray, out_dir: str, *,
                              k: int = 2, mode: str = "multimodal",
                              perplexity: float = 40.0, seed: int = 1000,
                              plots: bool = False,
                              diagnosis_labels: Optional[np.ndarray] = None
                              ) -> np.ndarray:
    """Produce every file the training loader expects under `out_dir`
    (parity with the artifact names of `util/image_cluster.py`, read by
    `data/adni.py:load_adni874`). Returns the cluster labels."""
    os.makedirs(os.path.join(out_dir, f"center_{k}"), exist_ok=True)
    feats = similarity_features(img_normalized, mode)
    np.save(os.path.join(out_dir, f"{'multimodal' if mode == 'multimodal' else 'pet'}"
                         "_for_similarity.npy"), feats)
    tsne_results, labels = run_image_clustering(
        feats, k=k, perplexity=perplexity, seed=seed,
        tsne_cache=os.path.join(out_dir, "tsne_results.npy"))
    np.save(os.path.join(out_dir, f"center_{k}", "clusters_pred_label.npy"),
            labels)
    if plots:
        # the reference's inspection scatterplots
        # (util/image_cluster.py:198-258); requires matplotlib
        plot_tsne(tsne_results, labels,
                  os.path.join(out_dir, "tsne_clusters.png"),
                  title="KMeans clusters")
        if diagnosis_labels is not None:
            plot_tsne(tsne_results, diagnosis_labels,
                      os.path.join(out_dir, "tsne_diagnosis.png"),
                      label_names=DIAGNOSIS_NAMES, title="diagnosis")
    return labels
