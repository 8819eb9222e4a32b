"""Graph-diffusion preprocessing: personalised PageRank and top-k
sparsification, host-side NumPy, once per subject.

The port's copy of the NumPy path of `iggcn_tpu/data/diffusion.py` (that
module imports JAX for its batched device solve). The batched device solve
and the C++ kernel of the JAX package are not ported yet.
"""
from __future__ import annotations

import numpy as np


def get_ppr_matrix(adj: np.ndarray, alpha: float = 0.05) -> np.ndarray:
    """alpha (I - (1-alpha) D^-1/2 A D^-1/2)^-1."""
    num_nodes = adj.shape[0]
    d_tilde = np.diag(1.0 / np.sqrt(adj.sum(axis=1)))
    h = d_tilde @ adj @ d_tilde
    return alpha * np.linalg.inv(np.eye(num_nodes) - (1 - alpha) * h)


def get_heat_matrix(adj: np.ndarray, t: float = 5.0) -> np.ndarray:
    """expm(-t (I - D^-1/2 A D^-1/2))."""
    from scipy.linalg import expm
    num_nodes = adj.shape[0]
    d_tilde = np.diag(1.0 / np.sqrt(adj.sum(axis=1)))
    h = d_tilde @ adj @ d_tilde
    return expm(-t * (np.eye(num_nodes) - h))


def get_top_k_matrix(a: np.ndarray, k: int = 5) -> np.ndarray:
    """Keep the top-k entries of each column, then normalise the columns.
    A stable argsort makes ties deterministic. Works on a copy."""
    a = a.copy()
    num_nodes = a.shape[0]
    row_idx = np.arange(num_nodes)
    a[a.argsort(axis=0, kind="stable")[: num_nodes - k], row_idx] = 0.0
    norm = a.sum(axis=0)
    norm[norm <= 0] = 1
    return a / norm


def preprocess_diffusion(adjs: np.ndarray, *, is_ppr: bool = True,
                         is_topk: bool = True, top_k: int = 3,
                         alpha: float = 0.05, heat_t: float = 5.0,
                         backend: str = "numpy") -> np.ndarray:
    """Diffuse and sparsify a stack of adjacencies (B, N, N), float64.

    With `is_topk=False` the heat kernel is applied to the already diffused
    matrix, as the reference does (its eps-clip sparsifier is defined but never
    called there, and the port has none). Only the NumPy backend exists in
    the port.
    """
    if backend != "numpy":
        raise ValueError(f"the port's diffusion has the 'numpy' backend "
                         f"only; got {backend!r}")
    out = np.empty_like(adjs, dtype=np.float64)
    for i in range(adjs.shape[0]):
        a = adjs[i].astype(np.float64)
        diff = get_ppr_matrix(a, alpha) if is_ppr else get_heat_matrix(a, heat_t)
        out[i] = (get_top_k_matrix(diff, top_k) if is_topk
                  else get_heat_matrix(diff, heat_t))
    return out
