"""Attention primitives (port of `iggcn_tpu/ops/attention.py`).

`multihead_cross_attention` is written out as plain tensor ops with the
forward semantics of `torch.nn.MultiheadAttention(embed_dim, num_heads,
batch_first=True)`: packed QKV projection, scaled dot product, output
projection, and attention weights averaged over heads. It takes the packed
weights as plain tensors so the flax parameter layout carries over as is.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class MHAParams(NamedTuple):
    in_proj_weight: torch.Tensor   # (3E, E)
    in_proj_bias: torch.Tensor     # (3E,)
    out_proj_weight: torch.Tensor  # (E, E)
    out_proj_bias: torch.Tensor    # (E,)


def multihead_cross_attention(params: MHAParams, query: torch.Tensor,
                              key: torch.Tensor, value: torch.Tensor,
                              num_heads: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched multi-head attention.

    Args:
      query: (B, Lq, E); key/value: (B, Lk, E).
    Returns:
      (attn_output (B, Lq, E), attn_weights (B, Lq, Lk) averaged over heads).
    """
    e = query.shape[-1]
    if e % num_heads:
        raise ValueError(f"embed dim {e} is not divisible by {num_heads} heads")
    hd = e // num_heads
    w_q, w_k, w_v = params.in_proj_weight.chunk(3, dim=0)
    b_q, b_k, b_v = params.in_proj_bias.chunk(3, dim=0)

    def heads(t):  # (B, L, E) -> (B, H, L, hd)
        b_, l_, _ = t.shape
        return t.reshape(b_, l_, num_heads, hd).transpose(1, 2)

    q = heads(query @ w_q.T + b_q)
    k = heads(key @ w_k.T + b_k)
    v = heads(value @ w_v.T + b_v)
    weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
    out = weights @ v                                   # (B, H, Lq, hd)
    b_, _, lq, _ = out.shape
    out = out.transpose(1, 2).reshape(b_, lq, e)
    out = out @ params.out_proj_weight.T + params.out_proj_bias
    return out, weights.mean(dim=1)


def masked_row_normalize(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Row-normalise positive scores over a static edge mask:
    A_hat[r, c] = s[r, c] / sum_c' s[r, c'] on mask entries; all-zero rows
    stay zero.

    Args:
      scores: (..., R, C) strictly positive scores (e.g. exp(tanh(.))).
      mask: (R, C) boolean static topology mask (broadcasts over batch).
    """
    masked = torch.where(mask, scores, torch.zeros_like(scores))
    row_sum = masked.sum(dim=-1, keepdim=True)
    return torch.where(row_sum > 0, masked / row_sum.clamp_min(1e-38),
                       torch.zeros_like(masked))
