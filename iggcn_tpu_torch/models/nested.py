"""Nested-GNN models over rooted-subgraph union graphs (port of
`iggcn_tpu/models/nested.py`).

The convs run over the block-diagonal union of every node's rooted
subgraph (`data/nested.py`), the node embeddings (the JK concat of the
layers) are mean-pooled to their subgraph by a one-hot segment matmul,
and the per-subgraph embeddings are flattened per graph and classified
(`readout='add'`, NestedGIN0 only, sums them instead). Optional hop /
distance labels (`use_z`: an Embedding(1000, 8) of normal(1) rows,
labels clipped to 0..999, multi-column labels summed) and resistance
distances (`use_rd`: a Linear(1, 8)) add into one 8-wide embedding that
is concatenated before the features. The union graph is dense (S, M, M)
with M up to N^2: the routes are for TU-sized graphs.
"""
from __future__ import annotations

import torch
from torch import nn

from iggcn_tpu_torch.models.baselines import (ZooModel, _GINMLP,
                                              add_gat_leaves, gat_leaves)
from iggcn_tpu_torch.models.nn_compat import TorchLinear, normal, pyg_glorot
from iggcn_tpu_torch.ops import pool as P
from iggcn_tpu_torch.ops.gat import gat_conv
from iggcn_tpu_torch.ops.gcn import gcn_conv, gcn_propagation_matrix

CONVS = ("gcn", "gat", "gin", "sage")


def subgraph_mean_pool(h: torch.Tensor, assign: torch.Tensor,
                       mask: torch.Tensor, num_subgraphs: int
                       ) -> torch.Tensor:
    """Mean of the union nodes' embeddings per subgraph. h: (B, M, D);
    assign: (B, M) int subgraph ids; mask: (B, M). Returns
    (B, num_subgraphs, D)."""
    ids = torch.arange(num_subgraphs, device=h.device)
    onehot = ((assign[..., None] == ids) & mask[..., None]).to(h.dtype)
    counts = torch.clamp(onehot.sum(dim=1), min=1.0)        # (B, N)
    return (onehot.transpose(1, 2) @ h) / counts[..., None]


class NestedGNN(ZooModel):
    """The nested skeleton; `conv` is 'gcn' | 'gat' | 'gin' | 'sage'. GIN
    and SAGE convs mask their input; GIN's BN statistics take only real
    nodes of real samples. The head's dropout, 0.5 in the reference and no
    flax field, is the attribute `dropout_lin`."""

    FLAX_FIELDS = ("conv", "num_layers", "hidden", "num_classes",
                   "num_subgraphs", "hidden_linear", "use_z", "use_rd",
                   "train_eps", "readout")
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS + ("dropout_lin",)

    def __init__(self, in_features: int, conv: str = "gcn",
                 num_layers: int = 2, hidden: int = 16, num_classes: int = 2,
                 num_subgraphs: int = 90, hidden_linear: int = 64,
                 use_z: bool = False, use_rd: bool = False,
                 train_eps: bool = True, readout: str = "flatten",
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"unknown conv {conv!r}; one of {CONVS}")
        g, dev = generator, device
        self.in_features, self.conv = in_features, conv
        self.num_layers, self.hidden = num_layers, hidden
        self.num_classes, self.num_subgraphs = num_classes, num_subgraphs
        self.hidden_linear, self.use_z, self.use_rd = (hidden_linear, use_z,
                                                       use_rd)
        self.train_eps, self.readout = train_eps, readout
        self.dropout_lin = dropout_lin
        if use_z:
            self.z_embedding = nn.Parameter(normal((1000, 8), 0.0, 1.0, g,
                                                   dev))
        if use_rd:
            self.rd_projection = TorchLinear(1, 8, generator=g, device=dev)
        fin = in_features + (8 if use_z or use_rd else 0)
        for i in range(num_layers):
            if conv == "gcn":
                self._param(f"conv_w_{i}", pyg_glorot((fin, hidden), g, dev))
                self._param(f"conv_b_{i}", torch.zeros(hidden, device=dev))
            elif conv == "gat":
                add_gat_leaves(self, i, fin, hidden, g, dev)
            elif conv == "gin":
                if train_eps:
                    self._param(f"eps_{i}", torch.zeros((), device=dev))
                setattr(self, f"mlp_{i}", _GINMLP(fin, hidden, generator=g,
                                                  device=dev))
            else:
                self._param(f"sage_ws_{i}", pyg_glorot((fin, hidden), g, dev))
                self._param(f"sage_wn_{i}", pyg_glorot((fin, hidden), g, dev))
                self._param(f"sage_b_{i}", torch.zeros(hidden, device=dev))
            fin = hidden
        jk = num_layers * hidden
        if readout == "add":
            self.lin1 = TorchLinear(jk, hidden, generator=g, device=dev)
            self.lin2 = TorchLinear(hidden, num_classes, generator=g,
                                    device=dev)
        else:
            self.lin1 = TorchLinear(num_subgraphs * jk, hidden_linear,
                                    generator=g, device=dev)
            self.lin2 = TorchLinear(hidden_linear, num_classes, generator=g,
                                    device=dev)

    def forward(self, x, adj, mask, assign, *, z=None, rd=None,
                sample_weight=None, generator=None):
        b = x.shape[0]
        bn_mask = mask if sample_weight is None else (
            mask & (sample_weight > 0)[:, None])
        if self.use_z or self.use_rd:
            emb = 0.0
            if self.use_z:
                zi = (torch.zeros(x.shape[:2], dtype=torch.long,
                                  device=x.device) if z is None else z)
                ze = self.z_embedding[torch.clamp(zi.long(), 0, 999)]
                if ze.dim() == 4:      # multi-column labels (spd): summed
                    ze = ze.sum(dim=2)
                emb = emb + ze
            if self.use_rd:
                ri = x.new_zeros(x.shape[:2] + (1,)) if rd is None else rd
                emb = emb + self.rd_projection(ri)
            x = torch.cat([emb, x], dim=-1)
        mf = mask[..., None].to(x.dtype)
        if self.conv == "gcn":
            prop = gcn_propagation_matrix(adj)
        feats, h = [], x
        for i in range(self.num_layers):
            if self.conv == "gcn":
                h = torch.relu(gcn_conv(h, prop, getattr(self, f"conv_w_{i}"),
                                        getattr(self, f"conv_b_{i}")))
            elif self.conv == "gat":
                h = torch.relu(gat_conv(h, adj, gat_leaves(self, i)))
            elif self.conv == "gin":
                eps = getattr(self, f"eps_{i}") if self.train_eps else 0.0
                agg = P.gin_conv_aggregate(h * mf, adj, eps)
                h = getattr(self, f"mlp_{i}")(agg, bn_mask)
            else:
                h = torch.relu(P.sage_conv(
                    h * mf, adj, getattr(self, f"sage_ws_{i}"),
                    getattr(self, f"sage_wn_{i}"))
                    + getattr(self, f"sage_b_{i}"))
            feats.append(h)
        sub = subgraph_mean_pool(torch.cat(feats, dim=-1), assign, mask,
                                 self.num_subgraphs)
        g = sub.sum(dim=1) if self.readout == "add" else sub.reshape(b, -1)
        return self._head(g, generator, self.dropout_lin)


def NestedGCN(in_features: int, **kw) -> NestedGNN:
    return NestedGNN(in_features, conv="gcn", **kw)


def NestedGAT(in_features: int, **kw) -> NestedGNN:
    return NestedGNN(in_features, conv="gat", **kw)


def NestedGIN(in_features: int, **kw) -> NestedGNN:
    return NestedGNN(in_features, conv="gin", **kw)


def NestedGIN0(in_features: int, **kw) -> NestedGNN:
    return NestedGNN(in_features, conv="gin", train_eps=False,
                     readout="add", **kw)


def NestedGraphSAGE(in_features: int, **kw) -> NestedGNN:
    return NestedGNN(in_features, conv="sage", **kw)
