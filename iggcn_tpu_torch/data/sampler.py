"""Class-imbalance-aware index sampling of the SNP-only trainer (a copy of
`iggcn_tpu/data/sampler.py`; NumPy, so its draws are bit-equal to the JAX
package's for the same generator).

Each epoch draws the train split with replacement, every sample weighted
by 1 / its class count (the reference's `ImbalancedDatasetSampler`), and
pads the draw to a batch multiple with 0-weight rows.
"""
from __future__ import annotations

import numpy as np


def imbalanced_sample_indices(y: np.ndarray, rng: np.random.Generator,
                              num_samples: int | None = None) -> np.ndarray:
    """`num_samples` (default len(y)) indices into `y`, drawn with
    replacement with probability proportional to 1 / class count."""
    y = np.asarray(y).reshape(-1)
    if num_samples is None:
        num_samples = len(y)
    _, inverse, counts = np.unique(y, return_inverse=True, return_counts=True)
    weights = 1.0 / counts[inverse]
    p = weights / weights.sum()
    return rng.choice(len(y), size=num_samples, replace=True, p=p)


def pad_epoch_indices(idx: np.ndarray, batch_size: int):
    """(padded idx, w): `idx` padded to a batch multiple with repeats of
    idx[0], and a 0/1 row weight that is 0 on the padding, so the ragged
    last batch still trains under the masked losses and stays out of the
    batch statistics."""
    if len(idx) == 0:
        raise ValueError("empty training split: no indices to pad into "
                         "epoch batches (check folds vs cohort size)")
    b = batch_size
    nb = -(-len(idx) // b)
    n_real = len(idx)
    if nb * b > n_real:
        idx = np.concatenate([idx, np.full(nb * b - n_real, idx[0],
                                           idx.dtype)])
    w = np.zeros(nb * b, np.float32)
    w[:n_real] = 1.0
    return idx, w
