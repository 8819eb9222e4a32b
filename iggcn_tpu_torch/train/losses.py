"""Loss terms of the fused families' objectives (port of
`iggcn_tpu/train/losses.py`).

All reductions are fp32. `sample_weight` is the (B,) 0/1 row mask of a
padded batch: padding rows carry weight 0, so edge counts and means equal
those of the reference's ragged final batch.

While a shard of the batch is active (`parallel.mesh.sharded`) every term
is that of the whole batch: the means' and sums' numerators and
denominators and the edge counts are summed over the data axis, and the
pairwise terms gather the rows of every position first.
"""
from __future__ import annotations

from typing import Optional

import torch

from iggcn_tpu_torch.config import SparsityWeights
from iggcn_tpu_torch.ops.masking import edge_probability_dense
from iggcn_tpu_torch.parallel import mesh


def _binary_entropy(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return -(p * torch.log(p + eps) + (1 - p) * torch.log((1 - p) + eps))


def _edge_terms(prob, prob_bias, x, adj, eps, sample_weight):
    """(L1, entropy) of the sigmoid edge scores, averaged over the batch's
    existing edges (those of real rows)."""
    ep = edge_probability_dense(x * prob, prob_bias)     # (B, N, N)
    mask = adj != 0
    if sample_weight is not None:
        mask = mask & (sample_weight[:, None, None] > 0)
    zero = torch.zeros((), device=ep.device)
    e_sum, e_ent, n_edges = mesh.all_reduce_sum(
        torch.where(mask, ep.abs(), zero).sum(),
        torch.where(mask, _binary_entropy(ep, eps), zero).sum(), mask.sum())
    n_edges = torch.clamp(n_edges, min=1)
    e_sum, e_ent = e_sum / n_edges, e_ent / n_edges
    return e_sum, e_ent


def sparsity_loss(prob: torch.Tensor, prob_bias: torch.Tensor,
                  snps_prob: torch.Tensor, x: torch.Tensor, adj: torch.Tensor,
                  sw: SparsityWeights, eps: float = 1e-6,
                  sample_weight: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """L1 + binary-entropy penalties on the node, edge and SNP importance.
    The node and SNP terms depend only on the parameters; the edge term
    averages the sigmoid edge scores over the batch's existing edges.

    x: (B, N, D) raw node features; adj: (B, N, N) edge weights.
    """
    xp = torch.sigmoid(prob)
    f_sum = xp.abs().mean()
    f_ent = _binary_entropy(xp, eps).mean()
    e_sum, e_ent = _edge_terms(prob, prob_bias, x, adj, eps, sample_weight)

    sp = torch.sigmoid(snps_prob)
    s_sum = sp.abs().mean()
    s_ent = _binary_entropy(sp, eps).mean()

    loss_l1 = (sw.lamda_x_l1 * f_sum + sw.lamda_e_l1 * e_sum
               + sw.lamda_x_l1 * s_sum)
    loss_ent = (sw.lamda_x_ent * f_ent + sw.lamda_e_ent * e_ent
                + sw.lamda_x_ent * s_ent)
    return loss_l1 + loss_ent


def sgcn_sparsity_loss(prob: torch.Tensor, prob_bias: torch.Tensor,
                       x: torch.Tensor, adj: torch.Tensor,
                       sw: SparsityWeights, eps: float = 1e-6,
                       sample_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The image-only SGCN family's penalty: no SNP term, and the node L1
    term sums over the channels and divides by N (not N * D)."""
    xp = torch.sigmoid(prob)
    f_sum = xp.abs().sum() / xp.shape[0]
    f_ent = _binary_entropy(xp, eps).mean()
    e_sum, e_ent = _edge_terms(prob, prob_bias, x, adj, eps, sample_weight)
    return (sw.lamda_x_l1 * f_sum + sw.lamda_e_l1 * e_sum
            + sw.lamda_x_ent * f_ent + sw.lamda_e_ent * e_ent)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor, gamma: float
               ) -> torch.Tensor:
    """exp(-gamma * ||x_i - y_j||^2)."""
    d2 = ((x[:, None, :] - y[None, :, :]) ** 2).sum(dim=-1)
    return torch.exp(-gamma * d2)


def consistency_loss(s: torch.Tensor, weight_matrix: torch.Tensor,
                     member: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Laplacian smoothness trace(s^T L s) / n^2 under a similarity matrix,
    over the rows with member = 1 (all rows when None); 0 when none is."""
    if member is None:
        member = torch.ones(s.shape[0], dtype=s.dtype, device=s.device)
    member = member.to(s.dtype)
    w = weight_matrix * member[:, None] * member[None, :]
    deg = w.sum(dim=1)
    gram = s @ s.T
    tr = (deg * torch.diagonal(gram)).sum() - (w * gram).sum()
    n = member.sum()
    return torch.where(n > 0, tr / torch.clamp(n * n, min=1.0),
                       torch.zeros((), device=s.device))


def orthogonal_loss(w: torch.Tensor,
                    sample_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """||W_n^T W_n - I||_F^2 / B^2 with row-normalised W_n; padding rows are
    zeroed and B counts real rows. With D > B it uses the (B, B) gram:
    ||W^T W - I_D||^2 = tr((W W^T)^2) - 2 ||W||^2 + D. Under a sharded
    batch, W and the weights are the whole batch's rows."""
    w, sample_weight = mesh.gather_columns(w, sample_weight)
    norm = torch.linalg.norm(w, dim=1, keepdim=True)
    wn = w / torch.clamp(norm, min=1e-12)
    if sample_weight is not None:
        wn = wn * sample_weight[:, None]
        b = torch.clamp(sample_weight.sum(), min=1.0)
    else:
        b = float(w.shape[0])
    d = w.shape[1]
    if d > w.shape[0]:
        gram_b = wn @ wn.T
        sq = (gram_b ** 2).sum() - 2.0 * (wn ** 2).sum() + d
        return sq / (b * b)
    gram = wn.T @ wn
    eye = torch.eye(d, dtype=w.dtype, device=w.device)
    return ((gram - eye) ** 2).sum() / (b * b)


def weighted_mean(values: torch.Tensor,
                  sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the real (non-padding) rows' elements."""
    if sample_weight is None and mesh.active() is None:
        return values.mean()
    if sample_weight is None:
        sample_weight = values.new_ones(values.shape[0])
    w = sample_weight.reshape(sample_weight.shape + (1,) * (values.dim() - 1))
    w = w.expand(values.shape)
    num, den = mesh.all_reduce_sum((values * w).sum(), w.sum())
    return num / torch.clamp(den, min=1.0)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.nll_loss with mean reduction over the real rows."""
    picked = -log_probs.gather(1, labels.long()[:, None])[:, 0]
    return weighted_mean(picked, sample_weight)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.mse_loss with mean reduction over the real rows' elements. The
    shapes must match exactly: (B, 3) against (B, 1) would broadcast."""
    if pred.shape != target.shape:
        raise ValueError(f"mse_loss shape mismatch: pred {tuple(pred.shape)} "
                         f"vs target {tuple(target.shape)}")
    return weighted_mean((pred - target) ** 2, sample_weight)


def recon_sum(pred: torch.Tensor, target: torch.Tensor,
              sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of squared errors over the real rows."""
    sq = (pred - target) ** 2
    if sample_weight is not None:
        sq = sq * sample_weight[:, None]
    return mesh.all_reduce_sum(sq.sum())
