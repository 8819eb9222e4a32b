"""Image-only SGCN family, no genetics branch (port of
`iggcn_tpu/models/sgcn_image.py`):

  * `SGCNImage`: SGCN_GCN, and SGCN_GAT with `use_gat`: a conv stack with
    a jumping-knowledge concat, flatten readout, lin1/lin2 head;
  * `SGCNOri`: SGCN_Ori, the fixed conv1 -> conv3 net whose readout is the
    flattened concat of both convs' activations, then fc1/bn1 -> fc2/bn2 ->
    fc3 with dropout 0.5 / 0.7.

Both learn the ROI/edge importance masks of the explain pass, with `prob`
zero-initialised in this family. Each forward is `trunk` (the conv stack
up to the last conv's pre-relu output, the grad-CAM seam) then `head`.
The last conv is pre-relu, so the stack is not the GCN-stack kernel's
function: it runs as plain `ops/gcn.py:gcn_conv` calls, as in the JAX
package. The sparsity penalty of the family is
`train/losses.py:sgcn_sparsity_loss`.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from iggcn_tpu_torch.models.nn_compat import (BatchNorm1d, TorchLinear,
                                              add_gat_params, dropout,
                                              gat_layer, kaiming_uniform_a5,
                                              pyg_glorot)
from iggcn_tpu_torch.ops.gat import gat_conv
from iggcn_tpu_torch.ops.gcn import gcn_conv, gcn_propagation_matrix
from iggcn_tpu_torch.ops.masking import importance_masks


def _masked(module: nn.Module, x: torch.Tensor, adj: torch.Tensor,
            is_explain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if not is_explain:
        return x, adj
    masks = importance_masks(x, adj, module.prob, module.prob_bias)
    return masks.x_masked, masks.adj_masked


class SGCNImage(nn.Module):
    """SGCN_GCN / SGCN_GAT: JK-concat conv stack + flatten readout."""

    def __init__(self, *, num_layers: int = 2, hidden: int = 16,
                 rois: int = 90, feat_dim: int = 3, num_classes: int = 2,
                 hidden_linear: int = 64, use_gat: bool = False,
                 dropout_lin: float = 0.5, generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.num_layers = num_layers
        self.use_gat = use_gat
        self.dropout_lin = dropout_lin
        if use_gat:
            add_gat_params(self, num_layers, feat_dim, hidden, g, dev)
        else:
            for i in range(num_layers):
                fin = feat_dim if i == 0 else hidden
                setattr(self, f"conv_w_{i}",
                        nn.Parameter(pyg_glorot((fin, hidden), g, dev)))
                setattr(self, f"conv_b_{i}",
                        nn.Parameter(torch.zeros(hidden, device=dev)))
        self.prob = nn.Parameter(torch.zeros(rois, feat_dim, device=dev))
        self.prob_bias = nn.Parameter(
            kaiming_uniform_a5((2 * feat_dim, 1), g, dev))
        self.lin1 = TorchLinear(rois * hidden * num_layers, hidden_linear,
                                generator=g, device=dev)
        self.lin2 = TorchLinear(hidden_linear, num_classes, generator=g,
                                device=dev)

    def trunk(self, x: torch.Tensor, adj: torch.Tensor, *,
              is_explain: bool = False):
        """(post-relu outputs of all but the last layer, the last layer's
        pre-relu output)."""
        h, adj_used = _masked(self, x, adj, is_explain)
        feats = []
        last = self.num_layers - 1
        if self.use_gat:
            for i in range(last):
                h = torch.relu(gat_conv(h, adj_used, gat_layer(self, i)))
                feats.append(h)
            return tuple(feats), gat_conv(h, adj_used, gat_layer(self, last))
        prop = gcn_propagation_matrix(adj_used)
        for i in range(last):
            h = torch.relu(gcn_conv(h, prop, getattr(self, f"conv_w_{i}"),
                                    getattr(self, f"conv_b_{i}")))
            feats.append(h)
        return tuple(feats), gcn_conv(h, prop, getattr(self, f"conv_w_{last}"),
                                      getattr(self, f"conv_b_{last}"))

    def head(self, prefix_feats, acts: torch.Tensor, *,
             sample_weight: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        del sample_weight   # no batch statistics in this model
        b = acts.shape[0]
        z = torch.cat(list(prefix_feats) + [torch.relu(acts)], dim=-1)
        z = torch.relu(self.lin1(z.reshape(b, -1)))
        if self.training:
            z = dropout(z, self.dropout_lin, generator)
        return torch.log_softmax(self.lin2(z), dim=-1)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, *,
                is_explain: bool = False,
                sample_weight: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, num_classes) log-probabilities; train mode follows
        `self.training` (dropout from `generator`)."""
        prefix, acts = self.trunk(x, adj, is_explain=is_explain)
        return self.head(prefix, acts, sample_weight=sample_weight,
                         generator=generator)


class SGCNOri(nn.Module):
    """SGCN_Ori: fixed conv1 -> conv3 (conv2 is bypassed in the reference
    too) with a concat readout and a batch-normed head."""

    def __init__(self, *, h0: int = 3, h1: int = 32, h3: int = 5,
                 num_classes: int = 2, rois: int = 90, dim2: int = 64,
                 dim3: int = 16, dropout1: float = 0.5, dropout2: float = 0.7,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.dropout1, self.dropout2 = dropout1, dropout2
        self.conv1_w = nn.Parameter(pyg_glorot((h0, h1), g, dev))
        self.conv1_b = nn.Parameter(torch.zeros(h1, device=dev))
        self.conv3_w = nn.Parameter(pyg_glorot((h1, h3), g, dev))
        self.conv3_b = nn.Parameter(torch.zeros(h3, device=dev))
        self.fc1 = TorchLinear(rois * (h1 + h3), dim2, generator=g, device=dev)
        self.bn1 = BatchNorm1d(dim2, device=dev)
        self.fc2 = TorchLinear(dim2, dim3, generator=g, device=dev)
        self.bn2 = BatchNorm1d(dim3, device=dev)
        self.fc3 = TorchLinear(dim3, num_classes, generator=g, device=dev)
        self.prob = nn.Parameter(torch.zeros(rois, h0, device=dev))
        self.prob_bias = nn.Parameter(kaiming_uniform_a5((2 * h0, 1), g, dev))

    def trunk(self, x: torch.Tensor, adj: torch.Tensor, *,
              is_explain: bool = False):
        """((h1,), conv3's pre-relu output)."""
        x_used, adj_used = _masked(self, x, adj, is_explain)
        prop = gcn_propagation_matrix(adj_used)
        h1 = torch.relu(gcn_conv(x_used, prop, self.conv1_w, self.conv1_b))
        return (h1,), gcn_conv(h1, prop, self.conv3_w, self.conv3_b)

    def head(self, prefix_feats, acts: torch.Tensor, *,
             sample_weight: torch.Tensor | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """`sample_weight`: (B,) 0/1 padding mask of the batch norms'
        statistics in train mode."""
        (h1,) = prefix_feats
        b = acts.shape[0]
        train = self.training
        w = sample_weight if train else None
        z = torch.cat([h1.reshape(b, -1), torch.relu(acts).reshape(b, -1)],
                      dim=-1)
        z = self.bn1(torch.relu(self.fc1(z)), w)
        if train:
            z = dropout(z, self.dropout1, generator)
        z = self.bn2(torch.relu(self.fc2(z)), w)
        if train:
            z = dropout(z, self.dropout2, generator)
        return torch.log_softmax(self.fc3(z), dim=-1)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, *,
                is_explain: bool = False,
                sample_weight: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        prefix, acts = self.trunk(x, adj, is_explain=is_explain)
        return self.head(prefix, acts, sample_weight=sample_weight,
                         generator=generator)
