"""Cluster-label multitask fused model, SGCN_GCN_CLUSTERLABEL (port of
`iggcn_tpu/models/clusterlabel.py`).

The fused SGCN x GO skeleton with two classification heads, disease and
unsupervised image cluster, and no regression head. Its imaging stack
(relu on every layer, jumping-knowledge concat) is the GCN-stack kernel's
function, so it runs through `ops.gcn_stack.fused_gcn_stack` as
`FusedSGCN`'s does: the CUDA kernel on a CUDA device, the plain version on
the CPU. `is_predict_cluster=False` feeds zeros to the cluster head.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.models.nn_compat import (TorchLinear, dropout,
                                              kaiming_uniform_a5, pyg_glorot,
                                              torch_linear_init, uniform)
from iggcn_tpu_torch.ops.attention import MHAParams, multihead_cross_attention
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.ops.gcn_stack import fused_gcn_stack
from iggcn_tpu_torch.ops.masking import importance_masks


class ClusterOutputs(NamedTuple):
    log_probs: torch.Tensor          # disease head
    log_probs_cluster: torch.Tensor  # cluster head
    snps_hat: torch.Tensor
    out_z: torch.Tensor


class ClusterLabelSGCN(nn.Module):
    def __init__(self, cfg: ModelConfig, topo: GoTopology, *,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.cfg = cfg
        self.topo = topo
        hidden = cfg.hidden
        for i in range(cfg.num_layers):
            fin = cfg.feat_dim if i == 0 else hidden
            setattr(self, f"conv_w_{i}",
                    nn.Parameter(pyg_glorot((fin, hidden), g, dev)))
            setattr(self, f"conv_b_{i}",
                    nn.Parameter(torch.zeros(hidden, device=dev)))
        self.prob = nn.Parameter(
            kaiming_uniform_a5((cfg.rois, cfg.feat_dim), g, dev))
        self.prob_bias = nn.Parameter(
            kaiming_uniform_a5((2 * cfg.feat_dim, 1), g, dev))
        self.snps_prob = nn.Parameter(
            kaiming_uniform_a5((1, cfg.num_snps), g, dev))
        e = cfg.jk_dim
        self.go_network = GeneOntologyNetwork(
            topo, in_f_dim=cfg.go_in_f_dim, n_l=cfg.go_n_l, f_dim=cfg.go_f_dim,
            l_dim=cfg.l_dim, dim_snps_atten=e,
            attention_impl=cfg.go_attention_impl, dropout_gcn=cfg.dropout_go,
            dropout_readout=cfg.dropout_readout, generator=g, device=dev)
        if cfg.is_cross_atten:
            # torch MultiheadAttention xavier-inits in_proj only
            self.mha_in_proj_weight = nn.Parameter(
                uniform((3 * e, e), (6.0 / (4 * e)) ** 0.5, g, dev))
            self.mha_in_proj_bias = nn.Parameter(torch.zeros(3 * e, device=dev))
            self.mha_out_proj_weight = nn.Parameter(
                torch_linear_init((e, e), e, g, dev))
            self.mha_out_proj_bias = nn.Parameter(torch.zeros(e, device=dev))
        z_dim = cfg.rois * e + cfg.l_dim
        hl = cfg.hidden_linear
        self.lin1_classify = TorchLinear(z_dim, hl, generator=g, device=dev)
        self.lin2_classify = TorchLinear(hl, cfg.num_classes, generator=g,
                                         device=dev)
        self.lin1_cluster = TorchLinear(z_dim, hl, generator=g, device=dev)
        self.lin2_cluster = TorchLinear(hl, cfg.num_cluster, generator=g,
                                        device=dev)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, snps: torch.Tensor,
                *, is_explain: bool = False,
                sample_weight: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> ClusterOutputs:
        """Forward of one dense batch; train mode follows `self.training`
        (dropout from `generator`, batch statistics over the real rows)."""
        cfg = self.cfg
        b = x.shape[0]
        if is_explain:
            masks = importance_masks(x, adj, self.prob, self.prob_bias,
                                     snps, self.snps_prob)
            x_used, adj_used, snps_used = (masks.x_masked, masks.adj_masked,
                                           masks.snps_masked)
        else:
            x_used, adj_used, snps_used = x, adj, snps

        n_layers = cfg.num_layers
        batch_x = fused_gcn_stack(
            gcn_propagation_matrix(adj_used), x_used.contiguous(),
            [getattr(self, f"conv_w_{i}") for i in range(n_layers)],
            [getattr(self, f"conv_b_{i}") for i in range(n_layers)])
        img_out = batch_x.reshape(b, -1)

        latent, snps_hat, atten_out = self.go_network(
            snps_used, sample_weight=sample_weight, generator=generator)
        if cfg.is_cross_atten:
            mha = MHAParams(self.mha_in_proj_weight, self.mha_in_proj_bias,
                            self.mha_out_proj_weight, self.mha_out_proj_bias)
            attn_out, _ = multihead_cross_attention(
                mha, batch_x, atten_out, atten_out, cfg.num_attn_heads)
            cross = torch.relu(attn_out).reshape(b, -1)
        else:
            cross = img_out
        out_z = torch.cat([(img_out + cross) / 2.0, latent], dim=-1)

        def head(lin1, lin2, inp):
            h = torch.relu(lin1(inp))
            if self.training:
                h = dropout(h, cfg.dropout_lin, generator)
            return torch.log_softmax(lin2(h), dim=-1)

        cluster_in = (out_z if cfg.is_predict_cluster
                      else torch.zeros_like(out_z))
        lp_cluster = head(self.lin1_cluster, self.lin2_cluster, cluster_in)
        lp = head(self.lin1_classify, self.lin2_classify, out_z)
        return ClusterOutputs(lp, lp_cluster, snps_hat, out_z)
