"""Dense masked graph pooling and readout ops of the baseline zoo (port of
`iggcn_tpu/ops/pool.py`, function for function under the same names).

Everything runs on fixed-shape (B, N, F) node tensors with a (B, N)
validity mask; "pooling" changes the mask (or gathers into a smaller fixed
shape) instead of making ragged tensors:

  * `mean_pool` / `max_pool` / `add_pool`: masked global readouts;
  * `neighbor_mean`, `sage_conv`: SAGEConv / GraphConv(aggr='mean');
    `gin_conv_aggregate`: GINConv's (1 + eps) x + neighbour sum;
  * `topk_pool`: TopKPooling, score x.w/||w||, keep ceil(ratio n_valid)
    per graph, gate the kept nodes by tanh(score);
  * `sort_pool`: global_sort_pool by the last channel, zero-padded to k;
  * `set2set`: Set2Set, an LSTM (gates i, f, g, o) with attention readout;
  * `global_attention_pool`: softmax of per-node gate scores;
  * `diff_pool`: dense_diff_pool with its link and entropy losses;
  * `greedy_matching` (host NumPy) + `cluster_max_pool`: graclus + max_pool
    with a deterministic node-order matching.

Selection ranks with stable sorts and the JAX package's `NEG` fill, so
ties (equal scores, a relu's zeros in the last channel) pick the same
nodes as `jnp.argsort` does. None of these has a Pallas ancestor; they are
plain PyTorch ops.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

NEG = -1e30


def mean_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, N, F), (B, N) -> (B, F) masked mean."""
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def max_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], x,
                       torch.full((), NEG, dtype=x.dtype,
                                  device=x.device)).amax(dim=1)


def add_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask[..., None].to(x.dtype)).sum(dim=1)


def neighbor_mean(x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Mean over incoming neighbours (edge r->c aggregates x[r] at c)."""
    m = (adj != 0).to(x.dtype)
    deg = m.sum(dim=-2)                                    # (B, N) in-degree
    agg = m.transpose(-1, -2) @ x
    return agg / torch.clamp(deg, min=1.0)[..., None]


def sage_conv(x: torch.Tensor, adj: torch.Tensor, w_self: torch.Tensor,
              w_nb: torch.Tensor, bias: torch.Tensor | None = None
              ) -> torch.Tensor:
    """W_self x + W_nb mean_nb(x) (+ b); weights (F_in, F_out)."""
    out = x @ w_self + neighbor_mean(x, adj) @ w_nb
    if bias is not None:
        out = out + bias
    return out


def gin_conv_aggregate(x: torch.Tensor, adj: torch.Tensor,
                       eps: torch.Tensor | float) -> torch.Tensor:
    """GINConv's pre-MLP aggregate: (1 + eps) x + sum over in-neighbours."""
    m = (adj != 0).to(x.dtype)
    return (1.0 + eps) * x + m.transpose(-1, -2) @ x


class TopKResult(NamedTuple):
    x: torch.Tensor      # gated features, dropped nodes zeroed
    adj: torch.Tensor    # adjacency restricted to the kept nodes
    mask: torch.Tensor   # the kept nodes


def _stable_argsort(values: torch.Tensor, dim: int = 1) -> torch.Tensor:
    return torch.argsort(values, dim=dim, stable=True)


def topk_pool(x: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor, ratio: float = 0.8) -> TopKResult:
    """TopKPooling on dense masked batches: score = x . w / ||w||, keep the
    top ceil(ratio * n_valid) valid nodes of each graph (ties to the lower
    index), kept features x * tanh(score). Shapes stay (B, N, .)."""
    w = weight / torch.clamp(torch.linalg.vector_norm(weight), min=1e-12)
    score = x @ w
    score = torch.where(mask, score, torch.full((), NEG, dtype=x.dtype,
                                                device=x.device))
    n_valid = mask.sum(dim=1).to(x.dtype)
    k = torch.ceil(ratio * n_valid).to(torch.int32)
    order = _stable_argsort(-score)
    rank = _stable_argsort(order)
    keep = (rank < k[:, None]) & mask
    gated = x * torch.tanh(score)[..., None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_new = torch.where(keep[..., None], gated, zero)
    adj_new = torch.where(keep[:, :, None] & keep[:, None, :], adj, zero)
    return TopKResult(x_new, adj_new, keep)


def sort_pool(x: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """global_sort_pool: the valid nodes sorted by the last channel
    (descending, ties to the lower index), the first k, zero-padded to k
    nodes; (B, k, F)."""
    key = torch.where(mask, x[..., -1], torch.full((), NEG, dtype=x.dtype,
                                                   device=x.device))
    order = _stable_argsort(-key)[:, :k]
    gathered = torch.gather(x, 1, order[..., None].expand(-1, -1,
                                                          x.shape[-1]))
    valid = torch.gather(mask, 1, order)
    out = torch.where(valid[..., None], gathered,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    n = x.shape[1]
    if n < k:
        out = torch.nn.functional.pad(out, (0, 0, 0, k - n))
    return out


class Set2SetParams(NamedTuple):
    w_ih: torch.Tensor   # (4H, 2H) LSTM input weights, gates i, f, g, o
    w_hh: torch.Tensor   # (4H, H)
    b_ih: torch.Tensor   # (4H,)
    b_hh: torch.Tensor   # (4H,)


def set2set(x: torch.Tensor, mask: torch.Tensor, params: Set2SetParams,
            processing_steps: int = 4) -> torch.Tensor:
    """Set2Set: LSTM(q*) -> attention over the valid nodes -> readout,
    `processing_steps` times; (B, 2F)."""
    b, _, f = x.shape
    q_star = x.new_zeros((b, 2 * f))
    h = x.new_zeros((b, f))
    c = x.new_zeros((b, f))
    neg = torch.full((), NEG, dtype=x.dtype, device=x.device)
    m = mask.to(x.dtype)
    for _ in range(processing_steps):
        gates = (q_star @ params.w_ih.T + params.b_ih + h @ params.w_hh.T
                 + params.b_hh)
        i, fgt, g, o = torch.chunk(gates, 4, dim=-1)
        i, fgt, o = torch.sigmoid(i), torch.sigmoid(fgt), torch.sigmoid(o)
        c = fgt * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        e = torch.where(mask, (x @ h[..., None])[..., 0], neg)
        a = torch.softmax(e, dim=1) * m
        r = (a[:, None, :] @ x)[:, 0]
        q_star = torch.cat([h, r], dim=-1)
    return q_star


def global_attention_pool(x: torch.Tensor, mask: torch.Tensor,
                          gate: torch.Tensor) -> torch.Tensor:
    """GlobalAttention: softmax of the (B, N, 1) gate scores over each
    graph's valid nodes, weighted sum of x."""
    e = torch.where(mask, gate[..., 0], torch.full((), NEG, dtype=x.dtype,
                                                   device=x.device))
    a = torch.softmax(e, dim=1) * mask.to(x.dtype)
    return (a[:, None, :] @ x)[:, 0]


def diff_pool(z: torch.Tensor, adj: torch.Tensor, s_logits: torch.Tensor,
              mask: torch.Tensor, sample_weight: torch.Tensor | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """dense_diff_pool: S = softmax(s_logits) * mask; x' = S^T z,
    A' = S^T A S; link loss = ||A - S S^T||_F (one norm over the whole
    batch) / (B N^2); entropy loss = the row entropies summed over all B*N
    rows / (B N). A (B,) 0/1 `sample_weight` leaves the padding rows out
    of the numerators and of B. Returns (x', adj', link, ent)."""
    s = torch.softmax(s_logits, dim=-1) * mask[..., None].to(z.dtype)
    st = s.transpose(1, 2)
    x_new = st @ z
    adj_new = st @ adj @ s
    ss = s @ st
    n = adj.shape[1]
    sq_i = torch.square(adj - ss).sum(dim=(1, 2))            # (B,)
    ent_n = -(s * torch.log(s + 1e-15)).sum(dim=-1)         # (B, N)
    if sample_weight is None:
        b_eff = torch.tensor(float(adj.shape[0]), dtype=z.dtype,
                             device=z.device)
        sq_total = sq_i.sum()
        ent_total = ent_n.sum()
    else:
        sw = sample_weight.to(z.dtype)
        b_eff = torch.clamp(sw.sum(), min=1.0)
        sq_total = (sq_i * sw).sum()
        ent_total = (ent_n * sw[:, None]).sum()
    link = torch.sqrt(sq_total + 1e-12) / (b_eff * n * n)
    ent = ent_total / (b_eff * n)
    return x_new, adj_new, link, ent


def greedy_matching(adj: np.ndarray) -> np.ndarray:
    """Host-side deterministic greedy edge matching (the graclus stand-in):
    cluster ids (N,), matched pairs sharing one, each node matched to its
    first unmatched neighbour in node order."""
    n = adj.shape[0]
    cluster = -np.ones(n, dtype=np.int64)
    nxt = 0
    sym = (adj != 0) | (adj.T != 0)
    for u in range(n):
        if cluster[u] >= 0:
            continue
        partner = -1
        for v in np.nonzero(sym[u])[0]:
            if v != u and cluster[v] < 0:
                partner = int(v)
                break
        cluster[u] = nxt
        if partner >= 0:
            cluster[partner] = nxt
        nxt += 1
    return cluster


def cluster_max_pool(x: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
                     assign: torch.Tensor, num_clusters: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """max_pool(cluster, data) on dense batches: per-cluster feature max,
    the coarsened adjacency by one-hot aggregation with its diagonal
    zeroed, and the clusters holding a valid node as the new mask.
    assign: (B, N) int cluster ids below `num_clusters`."""
    onehot = torch.nn.functional.one_hot(assign.long(), num_clusters).to(
        x.dtype) * mask[..., None].to(x.dtype)              # (B, N, K)
    neg = torch.full((), NEG, dtype=x.dtype, device=x.device)
    big_neg = torch.where(mask[..., None], x, neg)
    xk = torch.where(onehot[:, :, :, None] > 0, big_neg[:, :, None, :],
                     neg).amax(dim=1)                        # (B, K, F)
    new_mask = onehot.sum(dim=1) > 0
    xk = torch.where(new_mask[..., None], xk,
                     torch.zeros((), dtype=x.dtype, device=x.device))
    adj_new = onehot.transpose(1, 2) @ adj @ onehot
    adj_new = adj_new * (1.0 - torch.eye(num_clusters, dtype=x.dtype,
                                         device=x.device))
    return xk, adj_new, new_mask
