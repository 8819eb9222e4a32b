"""Dense batched GAT layer (port of `iggcn_tpu/ops/gat.py`): PyG `GATConv`
semantics with one head and a scalar edge feature.

Per edge r->c the logit is leaky_relu(a_src . h_r + a_dst . h_c + a_edge .
W_e e_rc), softmaxed over the incoming edges of each target c, with the
existing self-loops removed and one self-loop per node added whose weight
is the mean of that node's incoming edge weights (PyG `fill_value='mean'`).
Dense formulation: a (B, N, N) masked softmax and one batched matmul.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from iggcn_tpu_torch.models.nn_compat import promoted


class GATParams(NamedTuple):
    weight: torch.Tensor     # (F_in, F_out) node transform
    att_src: torch.Tensor    # (F_out,)
    att_dst: torch.Tensor    # (F_out,)
    lin_edge: torch.Tensor   # (1, F_out) edge feature transform
    att_edge: torch.Tensor   # (F_out,)
    bias: torch.Tensor       # (F_out,)


def _self_loop_fill(w_off: torch.Tensor, mask_off: torch.Tensor
                    ) -> torch.Tensor:
    """Per-target self-loop weight: the mean of the node's incoming edge
    weights (a scatter-mean over the edges' targets), 0 for a node with no
    incoming edge."""
    cnt_in = mask_off.sum(dim=1)                           # (B, N) per target
    return w_off.sum(dim=1) / torch.clamp(cnt_in, min=1)


def gat_conv(x: torch.Tensor, adj: torch.Tensor, p: GATParams,
             negative_slope: float = 0.2) -> torch.Tensor:
    """One dense GAT layer.

    Args:
      x: (B, N, F_in); adj: (B, N, N) with adj[b, r, c] = weight of r->c
        (0 = no edge).
    Returns: (B, N, F_out), aggregated at the targets.
    """
    n = x.shape[1]
    h = torch.matmul(*promoted(x, p.weight))               # (B, N, F)
    a_src = torch.matmul(*promoted(h, p.att_src))          # (B, N)
    a_dst = torch.matmul(*promoted(h, p.att_dst))          # (B, N)

    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    mask_off = (adj != 0) & ~eye
    zero = torch.zeros((), dtype=adj.dtype, device=adj.device)
    w_off = torch.where(mask_off, adj, zero)
    mean_in = _self_loop_fill(w_off, mask_off)
    adj_sl = torch.where(eye, mean_in[:, None, :] * eye, w_off)
    mask_sl = mask_off | eye

    # with one edge feature, PyG's per-edge sum_f (w lin_edge_f) att_edge_f
    # is w <lin_edge, att_edge>
    a_edge = adj_sl * torch.dot(p.lin_edge[0], p.att_edge)  # (B, N, N)
    logits = torch.nn.functional.leaky_relu(
        a_src[:, :, None] + a_dst[:, None, :] + a_edge, negative_slope)
    logits = torch.where(mask_sl, logits,
                         torch.full((), -torch.inf, device=x.device))
    # softmax over the sources r of each target c (dim 1); every target has
    # its self-loop, so no column is all -inf
    alpha = torch.softmax(logits, dim=1)
    alpha = torch.where(mask_sl, alpha, zero)
    return torch.matmul(*promoted(alpha.transpose(1, 2), h)) + p.bias
