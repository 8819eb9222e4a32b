"""Run-identity fingerprint of the per-fold resume records (a copy of
`iggcn_tpu/train/records.py:config_fingerprint`).

A fold record's `meta` vector ends in this int64, so `--resume` restores a
fold only when everything that shapes its result matches: model family,
learning rate, loss weights, ablation flags. The value is the JAX
package's for the same configuration: the port's config dataclasses have
the same fields, field types and defaults, so `repr` of their sorted
`dataclasses.asdict` is the same string, and a record written by either
package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


def config_fingerprint(**fields) -> np.int64:
    """Stable int64 fingerprint of the run-identity fields: dataclass
    values are expanded with `dataclasses.asdict`, everything is rendered
    through `repr` of a key-sorted structure (no PYTHONHASHSEED
    dependence), and the first 8 bytes of its SHA-1 are the value."""
    def norm(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return sorted(dataclasses.asdict(v).items())
        return v

    payload = repr(sorted((k, norm(v)) for k, v in fields.items()))
    digest = hashlib.sha1(payload.encode("utf-8")).digest()
    return np.int64(int.from_bytes(digest[:8], "big", signed=True))
