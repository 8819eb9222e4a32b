"""Learned-importance masking of node features, edges and SNPs (port of
`iggcn_tpu/ops/masking.py`): the dense rank-1 edge scorer of the flagship's
explain pass."""
from __future__ import annotations

from typing import NamedTuple

import torch

from iggcn_tpu_torch.models.nn_compat import promoted


class ImportanceMasks(NamedTuple):
    x_masked: torch.Tensor        # (B, N, D) node features * prob
    adj_masked: torch.Tensor      # (B, N, N) edge weights * edge_prob
    edge_prob: torch.Tensor       # (B, N, N) dense sigmoid edge scores
    snps_masked: torch.Tensor | None  # (B, S) snps * sigmoid(snps_prob)


def edge_probability_dense(x_masked: torch.Tensor,
                           prob_bias: torch.Tensor) -> torch.Tensor:
    """Edge score for every ordered pair (r, c):
    sigmoid([x_r || x_c] @ prob_bias) = sigmoid(x_r @ b1 + x_c @ b2).

    Args:
      x_masked: (..., N, D) prob-masked node features.
      prob_bias: (2D, 1) or (2D,) edge scorer weights.
    Returns:
      (..., N, N) scores; entry [r, c] scores edge r->c.
    """
    d = x_masked.shape[-1]
    x_masked, b = promoted(x_masked, prob_bias.reshape(2 * d))
    u = x_masked @ b[:d]   # (..., N)
    v = x_masked @ b[d:]   # (..., N)
    return torch.sigmoid(u[..., :, None] + v[..., None, :])


def importance_masks(x: torch.Tensor, adj: torch.Tensor, prob: torch.Tensor,
                     prob_bias: torch.Tensor,
                     snps: torch.Tensor | None = None,
                     snps_prob: torch.Tensor | None = None) -> ImportanceMasks:
    """Apply learned importance probabilities.

    Node features are multiplied by the raw `prob` parameter (the sigmoid
    appears only in the sparsity loss), each edge weight by
    sigmoid([x'_r || x'_c] . prob_bias) with x' the prob-masked features,
    and SNPs by sigmoid(snps_prob).

    Args:
      x: (B, N, D) node features.
      adj: (B, N, N) dense weighted adjacency.
      prob: (N, D) ROI importance parameter.
      prob_bias: (2D, 1) edge scorer.
      snps: optional (B, S).
      snps_prob: optional (1, S); required when `snps` is given.
    """
    x_masked = x * prob
    edge_prob = edge_probability_dense(x_masked, prob_bias)
    adj_masked = adj * edge_prob
    snps_masked = None
    if snps is not None:
        if snps_prob is None:
            raise ValueError("snps_prob is required to mask snps")
        snps_masked = snps * torch.sigmoid(snps_prob)
    return ImportanceMasks(x_masked, adj_masked, edge_prob, snps_masked)
