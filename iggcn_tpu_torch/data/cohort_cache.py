"""Disk cache of processed cohorts (port of
`iggcn_tpu/data/cohort_cache.py`).

The reference's `ADNIDataset(InMemoryDataset)` caches its processed
tensors under `./<root>/processed/` and reloads them on every later run
(`sgcn_data.py:307,332-338`), so the per-subject PPR diffusion runs once
per dataset, not once per experiment. Here one `.npz` per cohort holds the
dense `AdniCohort` arrays (diffusion included), keyed by a fingerprint of
everything that determines the content: the loader parameters, the source
files' names, sizes and mtimes (real data) or the seed (synthetic), and a
format version. Key recipe, npz layout and version are the JAX package's,
so an entry written by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Callable, Tuple

import numpy as np

from iggcn_tpu_torch.data.adni import AdniCohort, MinMaxScaler

# the JAX package's version: an entry written by either package is read by
# the other. Bump both together whenever AdniCohort's layout or any
# generator/loader semantics change, so stale entries miss instead of
# deserializing wrong content
FORMAT_VERSION = 1

_ARRAY_FIELDS = ["x", "adj", "raw_adj", "y", "clust_y", "snps", "sbj_id",
                 "tsne_fdim", "clini_score", "demographics"]
_OPTIONAL_FIELDS = ["raw_y", "adni_type"]


def cohort_key(kind: str, **params) -> str:
    """Deterministic cache key: sha256 over the sorted parameter repr.

    Values must have stable reprs (ints/floats/strings/bools/tuples)."""
    blob = repr((FORMAT_VERSION, kind, sorted(params.items())))
    return f"{kind}-{hashlib.sha256(blob.encode()).hexdigest()[:20]}"


def dir_fingerprint(path: str) -> Tuple[Tuple[str, int, int], ...]:
    """(relpath, size, mtime_ns) of every regular file under `path`,
    RECURSIVELY — the real-loader cache key component. Recursion matters:
    `load_adni874` reads its sources from subdirectories
    (`<data_path>/knn/<k>/*.mat`, `center_<c>/clusters_pred_label.npy`,
    multi-fusion `<MOD>/knn/<k>/...`), so a top-level-only listing would
    never invalidate on a replaced source file."""
    entries = []
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            full = os.path.join(root, name)
            st = os.stat(full)
            entries.append((os.path.relpath(full, path), st.st_size,
                            st.st_mtime_ns))
    return tuple(entries)


def save_cohort(cohort: AdniCohort, path: str) -> None:
    """Atomic single-file npz write (tmp + os.replace)."""
    payload = {f: getattr(cohort, f) for f in _ARRAY_FIELDS}
    for f in _OPTIONAL_FIELDS:
        v = getattr(cohort, f)
        if v is not None:
            payload[f] = v
    payload["scaler_data_min"] = cohort.scaler4score.data_min_
    payload["scaler_data_max"] = cohort.scaler4score.data_max_
    payload["scaler_scale"] = cohort.scaler4score.scale_
    payload["num_classes"] = np.asarray(cohort.num_classes, np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_cohort(path: str) -> AdniCohort:
    with np.load(path, allow_pickle=False) as z:
        scaler = MinMaxScaler()
        scaler.data_min_ = z["scaler_data_min"]
        scaler.data_max_ = z["scaler_data_max"]
        scaler.scale_ = z["scaler_scale"]
        kw = {f: z[f] for f in _ARRAY_FIELDS}
        for f in _OPTIONAL_FIELDS:
            kw[f] = z[f] if f in z.files else None
        return AdniCohort(scaler4score=scaler,
                          num_classes=int(z["num_classes"]), **kw)


def load_or_build(cache_dir: str, key: str,
                  builder: Callable[[], AdniCohort]
                  ) -> Tuple[AdniCohort, bool]:
    """Return (cohort, was_cache_hit). Empty `cache_dir` disables caching.
    A corrupt/truncated entry (e.g. a crashed writer predating the atomic
    replace, or a foreign file) is rebuilt, not fatal."""
    if not cache_dir:
        return builder(), False
    path = os.path.join(cache_dir, f"{key}.npz")
    if os.path.exists(path):
        try:
            return load_cohort(path), True
        except Exception as e:  # corrupt entry: rebuild
            print(f"[data] cohort cache entry {path} unreadable ({e}); "
                  f"rebuilding")
    cohort = builder()
    try:
        save_cohort(cohort, path)
    except OSError as e:
        # best-effort cache: an unwritable/full cache dir must not kill a
        # run whose cohort is already built and in memory
        print(f"[data] cohort cache write to {path} failed ({e}); "
              f"continuing uncached")
    return cohort, False


def equal_cohorts(a: AdniCohort, b: AdniCohort) -> bool:
    """Exact equality (NaNs equal) — used by tests and sanity checks."""
    for f in _ARRAY_FIELDS + _OPTIONAL_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if (va is None) != (vb is None):
            return False
        if va is not None:
            va, vb = np.asarray(va), np.asarray(vb)
            if va.dtype.kind in "fc":
                if not np.array_equal(va, vb, equal_nan=True):
                    return False
            elif not np.array_equal(va, vb):
                return False
    sa, sb = a.scaler4score, b.scaler4score
    return (a.num_classes == b.num_classes
            and np.array_equal(sa.data_min_, sb.data_min_, equal_nan=True)
            and np.array_equal(sa.data_max_, sb.data_max_, equal_nan=True)
            and np.array_equal(sa.scale_, sb.scale_, equal_nan=True))


def _fields_are_exhaustive() -> None:
    """Import-time guard: a new AdniCohort field must be added to the
    save/load lists above (and FORMAT_VERSION bumped), or this raises."""
    declared = {f.name for f in dataclasses.fields(AdniCohort)}
    covered = set(_ARRAY_FIELDS + _OPTIONAL_FIELDS) | {"scaler4score",
                                                       "num_classes"}
    missing = declared - covered
    if missing:
        raise RuntimeError(
            f"cohort_cache does not serialize AdniCohort fields {missing}; "
            f"add them to _ARRAY_FIELDS/_OPTIONAL_FIELDS and bump "
            f"FORMAT_VERSION")


_fields_are_exhaustive()
