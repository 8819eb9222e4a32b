"""Fixed-shape batching: dense (B, N, F) / (B, N, N) arrays, padded to a
whole number of batches with rows of weight 0 (port of
`iggcn_tpu/data/batching.py`). Everything here is NumPy; callers move the
arrays to their device with `torch.as_tensor(..., device=...)`."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from iggcn_tpu_torch.data.adni import AdniCohort


def cohort_batch_arrays(cohort: AdniCohort, clini_score: Optional[np.ndarray]
                        = None) -> Dict[str, np.ndarray]:
    """Cohort -> dict of the dense arrays the train and eval steps read."""
    return {
        "x": cohort.x.astype(np.float32),
        "adj": cohort.adj.astype(np.float32),
        "snps": cohort.snps.astype(np.float32),
        "y": cohort.y.astype(np.int32),
        "clini": (clini_score if clini_score is not None
                  else cohort.clini_score).astype(np.float32),
        "clust_y": cohort.clust_y.astype(np.int32),
        "tsne": cohort.tsne_fdim.astype(np.float32),
        "sbj_id": cohort.sbj_id.astype(np.int64),
    }


def pad_to_batches(arrays: Dict[str, np.ndarray], batch_size: int,
                   pad_to_count: Optional[int] = None
                   ) -> Dict[str, np.ndarray]:
    """Pad sample-major arrays with zeros to ceil(S/B)*B rows (or an
    explicit count) and add the 0/1 row weight `w`."""
    s = arrays["y"].shape[0]
    total = (pad_to_count if pad_to_count is not None
             else -(-s // batch_size) * batch_size)
    if total % batch_size or total < s:
        raise ValueError(f"cannot pad {s} rows to {total} in batches of "
                         f"{batch_size}")
    out = {}
    for k, v in arrays.items():
        out[k] = np.pad(v, [(0, total - s)] + [(0, 0)] * (v.ndim - 1))
    out["w"] = np.concatenate([np.ones(s, np.float32),
                               np.zeros(total - s, np.float32)])
    return out

