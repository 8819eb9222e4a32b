"""Dense batched GCN primitives (port of `iggcn_tpu/ops/gcn.py`).

Semantics match PyG 2.0.2 `gcn_norm`: `add_remaining_self_loops` (an
existing self-loop keeps its weight; a loop of weight 1, or 2 if
improved, is added only where the diagonal is zero), symmetric
D^-1/2 A D^-1/2 normalisation with degrees summed at edge targets
(column sums), and inf -> 0 on isolated nodes.
"""
from __future__ import annotations

import torch


def gcn_propagation_matrix(adj: torch.Tensor, *, add_self_loops: bool = True,
                           improved: bool = False) -> torch.Tensor:
    """Dense propagation matrix P with `out = P @ x` equal to PyG
    `GCNConv(x, edge_index, edge_weight)` aggregation.

    P = D^-1/2 (A + I)^T D^-1/2 with D = diag(colsum(A + I)).

    Args:
      adj: (..., N, N) dense weighted adjacency, adj[r, c] = weight of r->c.
    Returns:
      (..., N, N) propagation matrix, transposed in memory (strides
      (N*N, 1, N) for a contiguous `adj`): each of P's columns is a
      contiguous run. The GCN-stack kernel reads this layout as it is.
    """
    n = adj.shape[-1]
    fill = 2.0 if improved else 1.0
    m = adj
    if add_self_loops:
        eye = torch.eye(n, dtype=torch.bool, device=adj.device)
        diag = torch.diagonal(adj, dim1=-2, dim2=-1)
        new_diag = torch.where(diag != 0, diag, torch.full_like(diag, fill))
        m = torch.where(eye, new_diag[..., None, :] * eye, adj)
    deg = m.sum(dim=-2)  # column sums: degree at edge targets
    d_inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-38)),
                             torch.zeros_like(deg))
    # P[c, r] = d[c] * m[r, c] * d[r]
    return d_inv_sqrt[..., :, None] * m.transpose(-1, -2) * d_inv_sqrt[..., None, :]


def gcn_conv(x: torch.Tensor, prop: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor | None = None) -> torch.Tensor:
    """One GCN layer: out = P @ x @ W (+ b).

    Args:
      x: (..., N, F_in) node features.
      prop: (..., N, N) propagation matrix from `gcn_propagation_matrix`.
      weight: (F_in, F_out), the JAX package's layout.
      bias: optional (F_out,).
    """
    out = prop @ (x @ weight)
    if bias is not None:
        out = out + bias
    return out
