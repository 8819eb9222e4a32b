"""Baseline models (port of `iggcn_tpu/models/baselines.py`): the graph zoo
of the generic CV trainer, the CNN over the adjacency and the SNP-only
`MLPModel`.

Every graph model runs on dense (B, N, F) node tensors with a (B, N)
validity mask, so variable-size TU graphs ride the same fixed-shape path
as the ADNI cohort (`data/tu.py`). Each keeps the flax module's parameter
names (`conv_w_0`, `lstm_w_ih`, `mlp_0.bn1`, ...), its layouts through
`FLAX_LEAVES` (`tools/convert.py` carries weights both ways), and its
repr: `repr(model)` is the flax module's, the fields in flax's order
(`FLAX_FIELDS`), because the generic CV's fold records fingerprint it.
The input width, which flax reads from the data, is the constructor's
`in_features`. Weights are drawn from an explicit generator onto an
explicit device; train mode follows `self.training`, dropout draws from
the forward's `generator`, and every dropout rate is an attribute that
tests zero.

`GCNFlat` runs its stack through `ops/gcn_stack.py:fused_gcn_stack`, the
port of the TPU kernel: the CUDA kernel on the card, its plain version on
the CPU. The other stacks are plain PyTorch ops (`SortPool` masks between
its layers; the zoo's pools have no kernel).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from iggcn_tpu_torch.models.nn_compat import (BatchNorm1d, TorchLinear,
                                              dropout, lecun_normal,
                                              pyg_glorot, pyg_glorot_att,
                                              torch_linear_init)
from iggcn_tpu_torch.ops import pool as P
from iggcn_tpu_torch.ops.gat import GATParams, gat_conv
from iggcn_tpu_torch.ops.gcn import gcn_conv, gcn_propagation_matrix
from iggcn_tpu_torch.ops.gcn_stack import fused_gcn_stack


class ZooModel(nn.Module):
    """A zoo model: `FLAX_FIELDS` are the flax module's fields in its
    order (they make `repr`), `CTOR_ARGS` every constructor keyword, so
    that `fresh` builds an untrained copy with new weights."""

    FLAX_FIELDS: Tuple[str, ...] = ()
    CTOR_ARGS: Tuple[str, ...] = ()

    def __repr__(self) -> str:
        lines = "".join(f"    {f} = {getattr(self, f)!r}\n"
                        for f in self.FLAX_FIELDS)
        return f"{type(self).__name__}(\n    # attributes\n{lines})"

    def fresh(self, generator=None, device=None) -> "ZooModel":
        return type(self)(**{k: getattr(self, k) for k in self.CTOR_ARGS},
                          generator=generator, device=device)

    def _param(self, name: str, t: torch.Tensor) -> None:
        setattr(self, name, nn.Parameter(t))

    def _head(self, z: torch.Tensor, generator, rate: float) -> torch.Tensor:
        """relu(lin1) -> dropout (train mode) -> lin2 -> log_softmax."""
        z = torch.relu(self.lin1(z))
        if self.training:
            z = dropout(z, rate, generator)
        return torch.log_softmax(self.lin2(z), dim=-1)


def _ones_mask(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)


def _bn_nodes(bn: BatchNorm1d, h: torch.Tensor, mask) -> torch.Tensor:
    """BatchNorm1d over the flattened nodes of a (B, N, F) tensor, batch
    statistics over the nodes `mask` marks (torch's BN over PyG's flat
    node list)."""
    b, n, f = h.shape
    w = None if mask is None else mask.reshape(b * n).to(h.dtype)
    return bn(h.reshape(b * n, f), w).reshape(b, n, f)


class Conv(nn.Module):
    """flax `nn.Conv` with VALID padding and stride 1 over 1 or 2 spatial
    axes: lecun-normal kernel, zero bias. The kernel is torch's
    (out, in, *k); flax's is (*k, in, out)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, ...], *,
                 generator=None, device=None):
        super().__init__()
        d = len(kernel)
        self.FLAX_LEAVES = {
            "weight": ("params", "kernel", (d + 1, d) + tuple(range(d))),
            "bias": ("params", "bias", False)}
        self.weight = nn.Parameter(lecun_normal(
            (out_ch, in_ch) + tuple(kernel), in_ch * math.prod(kernel),
            generator, device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv1d if self.weight.dim() == 3 else F.conv2d
        return conv(x, self.weight, self.bias)


class GCNFlat(ZooModel):
    """`GCN`: JK-concat GCN stack over `gcn_propagation_matrix(adj)` through
    `fused_gcn_stack` (one kernel launch per forward on the card), flatten
    readout (fixed-N graphs) -> lin1 -> dropout -> lin2."""

    FLAX_FIELDS = ("num_layers", "hidden", "num_classes", "hidden_linear",
                   "dropout_lin")
    CTOR_ARGS = ("in_features", "num_nodes") + FLAX_FIELDS

    def __init__(self, in_features: int, num_nodes: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 hidden_linear: int = 64, dropout_lin: float = 0.5, *,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.in_features, self.num_nodes = in_features, num_nodes
        self.num_layers, self.hidden = num_layers, hidden
        self.num_classes, self.hidden_linear = num_classes, hidden_linear
        self.dropout_lin = dropout_lin
        fin = in_features
        for i in range(num_layers):
            self._param(f"conv_w_{i}", pyg_glorot((fin, hidden), g, dev))
            self._param(f"conv_b_{i}", torch.zeros(hidden, device=dev))
            fin = hidden
        self.lin1 = TorchLinear(num_nodes * num_layers * hidden,
                                hidden_linear, generator=g, device=dev)
        self.lin2 = TorchLinear(hidden_linear, num_classes, generator=g,
                                device=dev)

    def forward(self, x, adj, *, generator=None):
        prop = gcn_propagation_matrix(adj)
        n = self.num_layers
        jk = fused_gcn_stack(
            prop, x, [getattr(self, f"conv_w_{i}") for i in range(n)],
            [getattr(self, f"conv_b_{i}") for i in range(n)])
        return self._head(jk.reshape(x.shape[0], -1), generator,
                          self.dropout_lin)


def add_gat_leaves(module: nn.Module, i: int, fin: int, hidden: int,
                   generator, device) -> None:
    """Layer i's dense GAT leaves under the zoo's flax names (`gat_w_i`,
    `att_src_i`, `att_dst_i`, `lin_edge_i`, `att_edge_i`, `gat_b_i`),
    initialised as PyG's GATConv is."""
    g, dev = generator, device
    for name, t in (("gat_w", pyg_glorot((fin, hidden), g, dev)),
                    ("att_src", pyg_glorot_att((hidden,), g, dev)),
                    ("att_dst", pyg_glorot_att((hidden,), g, dev)),
                    ("lin_edge", pyg_glorot((1, hidden), g, dev)),
                    ("att_edge", pyg_glorot_att((hidden,), g, dev)),
                    ("gat_b", torch.zeros(hidden, device=dev))):
        setattr(module, f"{name}_{i}", nn.Parameter(t))


def gat_leaves(module: nn.Module, i: int) -> GATParams:
    return GATParams(*(getattr(module, f"{name}_{i}") for name in (
        "gat_w", "att_src", "att_dst", "lin_edge", "att_edge", "gat_b")))


class GATFlat(ZooModel):
    """`GAT`: JK-concat dense GAT stack, flatten readout."""

    FLAX_FIELDS = GCNFlat.FLAX_FIELDS
    CTOR_ARGS = GCNFlat.CTOR_ARGS

    def __init__(self, in_features: int, num_nodes: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 hidden_linear: int = 64, dropout_lin: float = 0.5, *,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.in_features, self.num_nodes = in_features, num_nodes
        self.num_layers, self.hidden = num_layers, hidden
        self.num_classes, self.hidden_linear = num_classes, hidden_linear
        self.dropout_lin = dropout_lin
        for i in range(num_layers):
            add_gat_leaves(self, i, in_features if i == 0 else hidden, hidden,
                           g, dev)
        self.lin1 = TorchLinear(num_nodes * num_layers * hidden,
                                hidden_linear, generator=g, device=dev)
        self.lin2 = TorchLinear(hidden_linear, num_classes, generator=g,
                                device=dev)

    def forward(self, x, adj, *, generator=None):
        feats, h = [], x
        for i in range(self.num_layers):
            h = torch.relu(gat_conv(h, adj, gat_leaves(self, i)))
            feats.append(h)
        z = torch.cat(feats, dim=-1).reshape(x.shape[0], -1)
        return self._head(z, generator, self.dropout_lin)


class _GINMLP(nn.Module):
    """GIN0's / NestedGIN's per-conv MLP: Linear-BN-ReLU-Linear-BN-ReLU."""

    def __init__(self, fin: int, hidden: int, *, generator=None,
                 device=None):
        super().__init__()
        g, dev = generator, device
        self.l1 = TorchLinear(fin, hidden, generator=g, device=dev)
        self.bn1 = BatchNorm1d(hidden, device=dev)
        self.l2 = TorchLinear(hidden, hidden, generator=g, device=dev)
        self.bn2 = BatchNorm1d(hidden, device=dev)

    def forward(self, x, mask=None):
        h = torch.relu(_bn_nodes(self.bn1, self.l1(x), mask))
        return torch.relu(_bn_nodes(self.bn2, self.l2(h), mask))


class _GINMLPLateBN(nn.Module):
    """GIN's per-conv MLP: Linear-ReLU-Linear-ReLU-BN, one BN at the end."""

    def __init__(self, fin: int, hidden: int, *, generator=None,
                 device=None):
        super().__init__()
        g, dev = generator, device
        self.l1 = TorchLinear(fin, hidden, generator=g, device=dev)
        self.l2 = TorchLinear(hidden, hidden, generator=g, device=dev)
        self.bn1 = BatchNorm1d(hidden, device=dev)

    def forward(self, x, mask=None):
        h = torch.relu(self.l2(torch.relu(self.l1(x))))
        return _bn_nodes(self.bn1, h, mask)


class GIN(ZooModel):
    """`GIN` (`train_eps=True`: learned eps, Linear-ReLU-Linear-ReLU-BN,
    mean-pool readout) and `GIN0` (`train_eps=False`: eps 0,
    Linear-BN-ReLU-Linear-BN-ReLU, add-pool readout). The BN statistics
    take only real nodes of real samples (`sample_weight` > 0)."""

    FLAX_FIELDS = ("num_layers", "hidden", "num_classes", "train_eps",
                   "dropout_lin")
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS

    def __init__(self, in_features: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 train_eps: bool = True, dropout_lin: float = 0.5, *,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.in_features, self.num_layers, self.hidden = (in_features,
                                                          num_layers, hidden)
        self.num_classes, self.train_eps = num_classes, train_eps
        self.dropout_lin = dropout_lin
        mlp_cls = _GINMLPLateBN if train_eps else _GINMLP
        fin = in_features
        for i in range(num_layers):
            if train_eps:
                self._param(f"eps_{i}", torch.zeros((), device=dev))
            setattr(self, f"mlp_{i}", mlp_cls(fin, hidden, generator=g,
                                              device=dev))
            fin = hidden
        self.lin1 = TorchLinear(num_layers * hidden, hidden, generator=g,
                                device=dev)
        self.lin2 = TorchLinear(hidden, num_classes, generator=g, device=dev)

    def forward(self, x, adj, mask=None, *, sample_weight=None,
                generator=None):
        if mask is None:
            mask = _ones_mask(x)
        bn_mask = mask if sample_weight is None else (
            mask & (sample_weight > 0)[:, None])
        feats, h = [], x
        for i in range(self.num_layers):
            eps = getattr(self, f"eps_{i}") if self.train_eps else 0.0
            agg = P.gin_conv_aggregate(h, adj, eps)
            h = getattr(self, f"mlp_{i}")(agg, bn_mask) * mask[..., None]
            feats.append(h)
        readout = P.mean_pool if self.train_eps else P.add_pool
        z = readout(torch.cat(feats, dim=-1), mask)
        return self._head(z, generator, self.dropout_lin)


def _add_sage_leaves(module: nn.Module, i: int, fin: int, hidden: int,
                     generator, device) -> None:
    module._param(f"w_self_{i}", pyg_glorot((fin, hidden), generator, device))
    module._param(f"w_nb_{i}", pyg_glorot((fin, hidden), generator, device))
    module._param(f"b_{i}", torch.zeros(hidden, device=device))


def _sage_layer(module: nn.Module, i: int, h, adj, mask) -> torch.Tensor:
    """relu(SAGE conv i) on the valid nodes."""
    return torch.relu(P.sage_conv(h, adj, getattr(module, f"w_self_{i}"),
                                  getattr(module, f"w_nb_{i}"),
                                  getattr(module, f"b_{i}"))) * mask[..., None]


class _SageNet(ZooModel):
    """The SAGE-conv stack shared by GraphSAGE, TopK, Set2SetNet,
    GlobalAttentionNet and Graclus (`w_self_i`, `w_nb_i`, `b_i`)."""

    FLAX_FIELDS = ("num_layers", "hidden", "num_classes", "dropout_lin")
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS

    def __init__(self, in_features: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__()
        self.in_features, self.num_layers, self.hidden = (in_features,
                                                          num_layers, hidden)
        self.num_classes, self.dropout_lin = num_classes, dropout_lin
        for i in range(num_layers):
            _add_sage_leaves(self, i, in_features if i == 0 else hidden,
                             hidden, generator, device)

    def _add_head(self, fin: int, generator, device) -> None:
        self.lin1 = TorchLinear(fin, self.hidden, generator=generator,
                                device=device)
        self.lin2 = TorchLinear(self.hidden, self.num_classes,
                                generator=generator, device=device)


class GraphSAGE(_SageNet):
    """`GraphSAGE`: SAGE convs, JK concat, mean-pool readout; `jk=False`
    is GraphSAGEWithoutJK (the last layer only)."""

    FLAX_FIELDS = _SageNet.FLAX_FIELDS + ("jk",)
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS

    def __init__(self, in_features: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, jk: bool = True, *,
                 generator=None, device=None):
        super().__init__(in_features, num_layers, hidden, num_classes,
                         dropout_lin, generator=generator, device=device)
        self.jk = jk
        self._add_head(num_layers * hidden if jk else hidden, generator,
                       device)

    def forward(self, x, adj, mask=None, *, generator=None):
        if mask is None:
            mask = _ones_mask(x)
        feats, h = [], x
        for i in range(self.num_layers):
            h = _sage_layer(self, i, h, adj, mask)
            feats.append(h)
        z = P.mean_pool(torch.cat(feats, dim=-1) if self.jk else feats[-1],
                        mask)
        return self._head(z, generator, self.dropout_lin)


class TopK(_SageNet):
    """`TopK`: GraphConv(mean) stack, mean-pool readout after every layer,
    TopKPooling(ratio) after layers 2, 4, ... (`pool_w_i`, i even)."""

    FLAX_FIELDS = ("num_layers", "hidden", "num_classes", "dropout_lin",
                   "ratio")
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS

    def __init__(self, in_features: int, num_layers: int = 3,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, ratio: float = 0.8, *,
                 generator=None, device=None):
        super().__init__(in_features, num_layers, hidden, num_classes,
                         dropout_lin, generator=generator, device=device)
        self.ratio = ratio
        for i in range(0, num_layers - 1, 2):
            # PyG TopKPooling's weight init: U(+-1/sqrt(in_channels))
            self._param(f"pool_w_{i}", torch_linear_init(
                (hidden,), hidden, generator, device))
        self._add_head(num_layers * hidden, generator, device)

    def forward(self, x, adj, mask=None, *, generator=None):
        if mask is None:
            mask = _ones_mask(x)
        h = _sage_layer(self, 0, x, adj, mask)
        readouts = [P.mean_pool(h, mask)]
        for i in range(self.num_layers - 1):
            h = _sage_layer(self, i + 1, h, adj, mask)
            readouts.append(P.mean_pool(h, mask))
            if i % 2 == 0:
                h, adj, mask = P.topk_pool(h, adj, mask,
                                           getattr(self, f"pool_w_{i}"),
                                           self.ratio)
        return self._head(torch.cat(readouts, dim=-1), generator,
                          self.dropout_lin)


class SortPool(ZooModel):
    """`SortPool`: masked GCN stack -> sort-pool of the top k=30 nodes by
    the last channel -> Conv1d(32, kernel 5) -> flatten channel-major."""

    FLAX_FIELDS = ("num_layers", "hidden", "num_classes", "dropout_lin", "k",
                   "conv1d_channels", "conv1d_kernel")
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS

    def __init__(self, in_features: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, k: int = 30,
                 conv1d_channels: int = 32, conv1d_kernel: int = 5, *,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.in_features, self.num_layers, self.hidden = (in_features,
                                                          num_layers, hidden)
        self.num_classes, self.dropout_lin, self.k = (num_classes,
                                                      dropout_lin, k)
        self.conv1d_channels, self.conv1d_kernel = (conv1d_channels,
                                                    conv1d_kernel)
        fin = in_features
        for i in range(num_layers):
            self._param(f"conv_w_{i}", pyg_glorot((fin, hidden), g, dev))
            self._param(f"conv_b_{i}", torch.zeros(hidden, device=dev))
            fin = hidden
        self.conv1d = Conv(hidden, conv1d_channels, (conv1d_kernel,),
                           generator=g, device=dev)
        self.lin1 = TorchLinear(conv1d_channels * (k - conv1d_kernel + 1),
                                hidden, generator=g, device=dev)
        self.lin2 = TorchLinear(hidden, num_classes, generator=g, device=dev)

    def forward(self, x, adj, mask=None, *, generator=None):
        if mask is None:
            mask = _ones_mask(x)
        prop = gcn_propagation_matrix(adj)
        h = x
        for i in range(self.num_layers):
            h = torch.relu(gcn_conv(h, prop, getattr(self, f"conv_w_{i}"),
                                    getattr(self, f"conv_b_{i}"))
                           ) * mask[..., None]
        z = P.sort_pool(h, mask, self.k)                   # (B, k, H)
        z = torch.relu(self.conv1d(z.transpose(1, 2)))      # (B, C, k - 4)
        return self._head(z.reshape(z.shape[0], -1), generator,
                          self.dropout_lin)


class Set2SetNet(_SageNet):
    """`Set2SetNet`: SAGE convs -> Set2Set (4 steps; every LSTM weight and
    bias U(+-1/sqrt(H)), as torch's nn.LSTM draws them)."""

    def __init__(self, in_features: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__(in_features, num_layers, hidden, num_classes,
                         dropout_lin, generator=generator, device=device)
        h = hidden
        for name, shape in (("lstm_w_ih", (4 * h, 2 * h)),
                            ("lstm_w_hh", (4 * h, h)),
                            ("lstm_b_ih", (4 * h,)), ("lstm_b_hh", (4 * h,))):
            self._param(name, torch_linear_init(shape, h, generator, device))
        self._add_head(2 * hidden, generator, device)

    def forward(self, x, adj, mask=None, *, generator=None):
        if mask is None:
            mask = _ones_mask(x)
        h = x
        for i in range(self.num_layers):
            h = _sage_layer(self, i, h, adj, mask)
        params = P.Set2SetParams(self.lstm_w_ih, self.lstm_w_hh,
                                 self.lstm_b_ih, self.lstm_b_hh)
        z = P.set2set(h, mask, params, processing_steps=4)
        return self._head(z, generator, self.dropout_lin)


class GlobalAttentionNet(_SageNet):
    """`GlobalAttentionNet`: SAGE convs -> a linear gate -> attention pool."""

    def __init__(self, in_features: int, num_layers: int = 2,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__(in_features, num_layers, hidden, num_classes,
                         dropout_lin, generator=generator, device=device)
        self.gate = TorchLinear(hidden, 1, generator=generator, device=device)
        self._add_head(hidden, generator, device)

    def forward(self, x, adj, mask=None, *, generator=None):
        if mask is None:
            mask = _ones_mask(x)
        h = x
        for i in range(self.num_layers):
            h = _sage_layer(self, i, h, adj, mask)
        z = P.global_attention_pool(h, mask, self.gate(h))
        return self._head(z, generator, self.dropout_lin)


class Graclus(_SageNet):
    """`Graclus`: GraphConv(mean) stack with one cluster max-pool after the
    second layer, over the host-side `greedy_matching` assignments
    (`assign`); the pooled node count stays N (masked)."""

    def __init__(self, in_features: int, num_layers: int = 3,
                 hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__(in_features, num_layers, hidden, num_classes,
                         dropout_lin, generator=generator, device=device)
        self._add_head(num_layers * hidden, generator, device)

    def forward(self, x, adj, mask=None, assign=None, *, generator=None):
        if mask is None:
            mask = _ones_mask(x)
        n = x.shape[1]
        h = _sage_layer(self, 0, x, adj, mask)
        readouts = [P.mean_pool(h, mask)]
        pooled = False
        for i in range(self.num_layers - 1):
            h = _sage_layer(self, i + 1, h, adj, mask)
            readouts.append(P.mean_pool(h, mask))
            if i % 2 == 0 and assign is not None and not pooled:
                h, adj, mask = P.cluster_max_pool(h, adj, mask, assign, n)
                pooled = True
        return self._head(torch.cat(readouts, dim=-1), generator,
                          self.dropout_lin)


class _DiffPoolBlock(nn.Module):
    """`Block`: two DenseSAGEConvs (lin_rel(A x / clamp(rowsum A, 1)),
    bias-free, + lin_root(x); masked rows zeroed) with a JK linear:
    x1 = relu(conv1(x)), x2 = relu(conv2(x1)), out = lin([x1 || x2])."""

    def __init__(self, fin: int, hidden: int, out: int, *, generator=None,
                 device=None):
        super().__init__()
        g, dev = generator, device
        self.conv1_rel = TorchLinear(fin, hidden, bias=False, generator=g,
                                     device=dev)
        self.conv1_root = TorchLinear(fin, hidden, generator=g, device=dev)
        self.conv2_rel = TorchLinear(hidden, out, bias=False, generator=g,
                                     device=dev)
        self.conv2_root = TorchLinear(hidden, out, generator=g, device=dev)
        self.lin = TorchLinear(hidden + out, out, generator=g, device=dev)

    def forward(self, x, adj, mask=None):
        deg = torch.clamp(adj.sum(dim=-1, keepdim=True), min=1.0)

        def conv(rel, root, h):
            o = rel((adj @ h) / deg) + root(h)
            return o if mask is None else o * mask[..., None]

        x1 = torch.relu(conv(self.conv1_rel, self.conv1_root, x))
        x2 = torch.relu(conv(self.conv2_rel, self.conv2_root, x1))
        return self.lin(torch.cat([x1, x2], dim=-1))


class DiffPool(ZooModel):
    """`DiffPool`: pool/embed block pairs with 0.25 coarsening
    (n_k = ceil(0.25 max_nodes)); each level's readout is the mean over
    the full padded node axis; (num_layers // 2) - 1 more pairs on the
    coarsened, unmasked graphs; JK concat -> lin1 -> dropout -> lin2.
    Returns (log_probs, link_loss, ent_loss), the losses summed over the
    pools (the trainer adds them only with `aux_loss`)."""

    FLAX_FIELDS = ("max_nodes", "num_layers", "hidden", "num_classes",
                   "dropout_lin")
    CTOR_ARGS = ("in_features",) + FLAX_FIELDS

    def __init__(self, in_features: int, max_nodes: int = 90,
                 num_layers: int = 2, hidden: int = 16, num_classes: int = 2,
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.in_features, self.max_nodes = in_features, max_nodes
        self.num_layers, self.hidden = num_layers, hidden
        self.num_classes, self.dropout_lin = num_classes, dropout_lin
        n_k = max(1, math.ceil(0.25 * max_nodes))
        self.pool_block1 = _DiffPoolBlock(in_features, hidden, n_k,
                                          generator=g, device=dev)
        self.embed_block1 = _DiffPoolBlock(in_features, hidden, hidden,
                                           generator=g, device=dev)
        self.levels = 1 + max(0, num_layers // 2 - 1)
        for i in range(self.levels - 1):
            n_k = max(1, math.ceil(0.25 * n_k))
            setattr(self, f"pool_block{i + 2}", _DiffPoolBlock(
                hidden, hidden, n_k, generator=g, device=dev))
            setattr(self, f"embed_block{i + 2}", _DiffPoolBlock(
                hidden, hidden, hidden, generator=g, device=dev))
        self.lin1 = TorchLinear(self.levels * hidden, hidden, generator=g,
                                device=dev)
        self.lin2 = TorchLinear(hidden, num_classes, generator=g, device=dev)

    def forward(self, x, adj, mask=None, *, sample_weight=None,
                generator=None):
        if mask is None:
            mask = _ones_mask(x)
        s = self.pool_block1(x, adj, mask)
        z = torch.relu(self.embed_block1(x, adj, mask))
        readouts = [z.mean(dim=1)]
        x, adj, link, ent = P.diff_pool(z, adj, s, mask,
                                        sample_weight=sample_weight)
        for i in range(self.levels - 1):
            s = getattr(self, f"pool_block{i + 2}")(x, adj)
            z = torch.relu(getattr(self, f"embed_block{i + 2}")(x, adj))
            readouts.append(z.mean(dim=1))
            x, adj, link_i, ent_i = P.diff_pool(
                z, adj, s, _ones_mask(z), sample_weight=sample_weight)
            link, ent = link + link_i, ent + ent_i
        logp = self._head(torch.cat(readouts, dim=-1), generator,
                          self.dropout_lin)
        return logp, link, ent


class CNNModel(ZooModel):
    """`CNN_Model` over the (B, N, N) adjacency: Conv2d(1, 4, 3) (VALID) ->
    MaxPool(3, 3) -> Conv2d(4, 4, 3) -> MaxPool(3, 3) -> flatten
    channel-major (90x90 gives 4 * 9 * 9 = 324) -> fc1(64) -> dropout ->
    fc2(16) -> fc3(num_classes). `dropout_lin` (0.5) is no flax field."""

    FLAX_FIELDS = ("num_classes", "rois")
    CTOR_ARGS = FLAX_FIELDS + ("dropout_lin",)

    def __init__(self, num_classes: int = 2, rois: int = 90,
                 dropout_lin: float = 0.5, *, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.num_classes, self.rois, self.dropout_lin = (num_classes, rois,
                                                         dropout_lin)
        self.conv1 = Conv(1, 4, (3, 3), generator=g, device=dev)
        self.conv2 = Conv(4, 4, (3, 3), generator=g, device=dev)
        side = ((rois - 2) // 3 - 2) // 3
        self.fc1 = TorchLinear(4 * side * side, 64, generator=g, device=dev)
        self.fc2 = TorchLinear(64, 16, generator=g, device=dev)
        self.fc3 = TorchLinear(16, num_classes, generator=g, device=dev)

    def forward(self, adj, *, generator=None):
        h = F.max_pool2d(torch.relu(self.conv1(adj[:, None])), 3, 3)
        h = F.max_pool2d(torch.relu(self.conv2(h)), 3, 3)
        h = torch.relu(self.fc1(h.reshape(h.shape[0], -1)))
        if self.training:
            h = dropout(h, self.dropout_lin, generator)
        h = torch.relu(self.fc2(h))
        return torch.log_softmax(self.fc3(h), dim=-1)


class MLPModel(nn.Module):
    """`MLP_Model`: num_snps -> 32 -> 16 -> 1 sigmoid SNP classifier, relu
    between the layers and dropout after the first. The JAX module is
    lazy (its input width comes from the data); here it is the
    constructor's `num_snps` (54 in the reference), and a serving bundle
    gives it from the weights. `dropout_rate` is an attribute so that
    tests can zero it."""

    CTOR_FIELDS = ()

    def __init__(self, num_snps: int = 54, *, dropout_rate: float = 0.3,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.dropout_rate = dropout_rate
        self.fc1 = TorchLinear(num_snps, 32, generator=g, device=dev)
        self.fc2 = TorchLinear(32, 16, generator=g, device=dev)
        self.fc3 = TorchLinear(16, 1, generator=g, device=dev)

    @property
    def num_snps(self) -> int:
        return self.fc1.weight.shape[1]

    def forward(self, snps: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 1) probabilities; train mode follows `self.training`
        (dropout from `generator`)."""
        h = torch.relu(self.fc1(snps))
        if self.training:
            h = dropout(h, self.dropout_rate, generator)
        h = torch.relu(self.fc2(h))
        return torch.sigmoid(self.fc3(h))
