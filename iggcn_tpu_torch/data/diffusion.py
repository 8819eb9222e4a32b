"""Graph-diffusion preprocessing: personalised PageRank and top-k
sparsification, once per subject (port of `iggcn_tpu/data/diffusion.py`).

`preprocess_diffusion` has the JAX module's three backends:

  * `auto` (the default, as in the JAX package, so the loaders use it):
    PPR + top-k through the native C++ library (`csrc/gdc_native.cpp`,
    the port's copy of the JAX package's), built by the host compiler
    into `_build/` at first use, bit-equal to the JAX package's native
    path and within LU round-off of `numpy` (the same stable-argsort tie
    handling); every other mode through `numpy`, as the JAX `auto` does.
    One difference from the JAX package: where the library cannot be
    built the port raises, where the JAX package falls back to NumPy;
  * `numpy`: the per-subject host loop, bit-equal to the JAX package's
    NumPy path;
  * `device`: the whole cohort as one batched `torch.linalg.solve` in fp32
    on a torch device (the card by default), with the JAX package's
    threshold rule (`ppr_topk_batch_torch`). A library solve, as the JAX
    package leaves it to XLA, not a kernel of the port. PPR + top-k only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

BACKENDS = ("auto", "device", "numpy")


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


def _native():
    """The native library, built at first use, with its C signature."""
    from iggcn_tpu_torch.utils.cuda_build import load_host_library
    lib = load_host_library("gdc_native.cpp")
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.ppr_topk_batch.restype = ctypes.c_int
    lib.ppr_topk_batch.argtypes = [dptr, ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_double, ctypes.c_longlong, dptr]
    return lib


def ppr_topk_batch_native(adjs: np.ndarray, alpha: float, top_k: int
                          ) -> np.ndarray:
    """PPR + column top-k + column normalisation of a (B, N, N) stack in
    float64 by the native library (k > N keeps every entry)."""
    adjs = np.ascontiguousarray(adjs, dtype=np.float64)
    if adjs.ndim != 3 or adjs.shape[-1] != adjs.shape[-2]:
        raise ValueError(f"expected (B, N, N), got {adjs.shape}")
    out = np.empty_like(adjs)
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = _native().ppr_topk_batch(adjs.ctypes.data_as(dptr), adjs.shape[0],
                                  adjs.shape[1], float(alpha), int(top_k),
                                  out.ctypes.data_as(dptr))
    if rc != 0:
        raise RuntimeError(f"gdc_native ppr_topk_batch failed (rc={rc})")
    return out


def ppr_topk_batch_torch(adjs: torch.Tensor, alpha: float = 0.05,
                         top_k: int = 3) -> torch.Tensor:
    """PPR + column top-k + column normalisation of a (B, N, N) stack as
    one batched solve, on the tensor's device and in its type.

    The JAX package's `ppr_topk_batch_jax`: it keeps every entry at or
    above the k-th largest of its column (more than k on ties), where the
    host paths zero exactly N - k entries by a stable argsort; on inputs
    without ties at the k-th value the two agree up to the solve's
    round-off."""
    n = adjs.shape[-1]
    d = 1.0 / torch.sqrt(adjs.sum(dim=-1))
    h = adjs * d[..., :, None] * d[..., None, :]
    eye = torch.eye(n, dtype=adjs.dtype, device=adjs.device)
    ppr = alpha * torch.linalg.solve(eye - (1 - alpha) * h,
                                     eye.expand(adjs.shape))
    kth = torch.sort(ppr, dim=-2).values[..., n - top_k, :]   # per column
    kept = torch.where(ppr >= kth[..., None, :], ppr,
                       torch.zeros((), dtype=ppr.dtype, device=ppr.device))
    norm = kept.sum(dim=-2, keepdim=True)
    norm = torch.where(norm <= 0, torch.ones_like(norm), norm)
    return kept / norm


def preprocess_diffusion(adjs: np.ndarray, *, is_ppr: bool = True,
                         is_topk: bool = True, top_k: int = 3,
                         alpha: float = 0.05, heat_t: float = 5.0,
                         backend: str = "auto",
                         device: str | torch.device | None = None
                         ) -> np.ndarray:
    """Diffuse and sparsify a stack of adjacencies (B, N, N), float64.

    With `is_topk=False` the heat kernel is applied to the already diffused
    matrix, as the reference does (its eps-clip sparsifier is defined but
    never called there, and the port has none). `backend` is `auto` (the
    native library for PPR + top-k, `numpy` for the other modes; raises
    when the library cannot be built, where the JAX package falls back to
    NumPy), `numpy`, or `device` (one batched solve on `device`, default
    the card; PPR + top-k only)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown diffusion backend {backend!r}; one of "
                         f"{BACKENDS}")
    if backend == "device" and not (is_ppr and is_topk):
        raise ValueError("backend='device' implements the PPR+top-k path "
                         "only; use backend='auto' or 'numpy'")
    if backend == "auto" and is_ppr and is_topk:
        return ppr_topk_batch_native(adjs, alpha, top_k)
    if backend == "device":
        from iggcn_tpu_torch.utils.platform import resolve_device
        t = torch.as_tensor(np.asarray(adjs, np.float32),
                            device=resolve_device(device))
        return ppr_topk_batch_torch(t, alpha, top_k).cpu().numpy().astype(
            np.float64)
    out = np.empty_like(adjs, dtype=np.float64)
    for i in range(adjs.shape[0]):
        a = adjs[i].astype(np.float64)
        diff = get_ppr_matrix(a, alpha) if is_ppr else get_heat_matrix(a, heat_t)
        out[i] = (get_top_k_matrix(diff, top_k) if is_topk
                  else get_heat_matrix(diff, heat_t))
    return out
