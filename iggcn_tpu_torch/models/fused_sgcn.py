"""Flagship fused imaging x genetics model (port of
`iggcn_tpu/models/fused_sgcn.py`).

SGCN brain-GCN stack with jumping-knowledge concat + GO encoder/decoder +
2-head cross-attention fusion + classification and regression heads. The
GCN imaging stack always runs through `ops.gcn_stack.fused_gcn_stack`: the
hand-written CUDA kernel on a CUDA device, its plain version on the CPU.
With `use_gat` the stack is the dense GAT of `ops/gat.py` in plain
PyTorch instead, as it is plain JAX in the reference.

Parameter names and layouts follow the flax module, so
`tools/convert.py` maps a JAX variable tree onto this module leaf by leaf.
Train mode (`.train()`) drops out at the JAX package's sites, from the
generator the caller passes, and normalises the GO branch's batch norms
over the batch's real rows (`sample_weight`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.models.go_network import GeneOntologyNetwork
from iggcn_tpu_torch.models.nn_compat import (TorchLinear, add_gat_params,
                                              dropout, gat_layer,
                                              kaiming_uniform_a5, pyg_glorot,
                                              torch_linear_init, uniform)
from iggcn_tpu_torch.ops.attention import MHAParams, multihead_cross_attention
from iggcn_tpu_torch.ops.gat import gat_conv
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.ops.gcn_stack import fused_gcn_stack
from iggcn_tpu_torch.ops.masking import importance_masks


class FusedOutputs(NamedTuple):
    log_probs: torch.Tensor     # (B, num_classes) log-softmax
    snps_hat: torch.Tensor      # (B, S) SNP reconstruction
    out_z: torch.Tensor         # fused embedding
    out_lin: torch.Tensor       # pre-head features ("hidden" artifact)
    linear_outf: torch.Tensor   # post-lin1 features ("linear_out" artifact)
    our_reg: torch.Tensor       # (B, num_regr) clinical-score regression


def _pool3(t: torch.Tensor) -> torch.Tensor:
    """Graph readout: concat of mean, max and sum over the node axis."""
    return torch.cat([t.mean(dim=1), t.amax(dim=1), t.sum(dim=1)], dim=-1)


class FusedSGCN(nn.Module):
    """SGCN_GCN_IMGSNP-parity fused model."""

    def __init__(self, cfg: ModelConfig, topo: GoTopology, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        self.topo = topo
        g, dev = generator, device
        hidden = cfg.hidden
        if cfg.use_gat:
            add_gat_params(self, cfg.num_layers, cfg.feat_dim, hidden, g, dev)
        else:
            for i in range(cfg.num_layers):
                fin = cfg.feat_dim if i == 0 else hidden
                setattr(self, f"conv_w_{i}",
                        nn.Parameter(pyg_glorot((fin, hidden), g, dev)))
                setattr(self, f"conv_b_{i}",
                        nn.Parameter(torch.zeros(hidden, device=dev)))

        # learned importance parameters
        self.prob = nn.Parameter(kaiming_uniform_a5((cfg.rois, cfg.feat_dim), g, dev))
        self.prob_bias = nn.Parameter(kaiming_uniform_a5((2 * cfg.feat_dim, 1), g, dev))
        self.snps_prob = nn.Parameter(kaiming_uniform_a5((1, cfg.num_snps), g, dev))

        e = cfg.jk_dim
        self.go_network = GeneOntologyNetwork(
            topo, in_f_dim=cfg.go_in_f_dim, n_l=cfg.go_n_l, f_dim=cfg.go_f_dim,
            l_dim=cfg.l_dim, dim_snps_atten=e,
            attention_impl=cfg.go_attention_impl, dropout_gcn=cfg.dropout_go,
            dropout_readout=cfg.dropout_readout, generator=g, device=dev)

        if cfg.is_cross_atten:
            # torch MultiheadAttention xavier-inits in_proj only; out_proj
            # keeps nn.Linear's default
            self.mha_in_proj_weight = nn.Parameter(
                uniform((3 * e, e), (6.0 / (4 * e)) ** 0.5, g, dev))
            self.mha_in_proj_bias = nn.Parameter(torch.zeros(3 * e, device=dev))
            self.mha_out_proj_weight = nn.Parameter(
                torch_linear_init((e, e), e, g, dev))
            self.mha_out_proj_bias = nn.Parameter(torch.zeros(e, device=dev))

        # head input widths (flax infers them at first call)
        img_dim = 3 * e if cfg.graph_pool else cfg.rois * e
        if cfg.is_image_only:
            lin_dim = img_dim
        elif cfg.is_snps_only:
            lin_dim = cfg.num_snps + cfg.l_dim
        else:
            lin_dim = img_dim + cfg.l_dim
        regr_dim = lin_dim
        if cfg.is_use_prob4regr and not cfg.is_snps_only:
            regr_dim += cfg.rois * cfg.feat_dim
        hl = cfg.hidden_linear
        self.lin1 = TorchLinear(lin_dim, hl, generator=g, device=dev)
        self.lin2 = TorchLinear(hl, cfg.num_classes, generator=g, device=dev)
        if cfg.model4eachregr:
            for i in range(cfg.num_regr):
                setattr(self, f"lin1_regr_{i}",
                        TorchLinear(regr_dim, hl, generator=g, device=dev))
                setattr(self, f"lin2_regr_{i}",
                        TorchLinear(hl, 1, generator=g, device=dev))
        else:
            self.lin1_regr = TorchLinear(regr_dim, hl, generator=g, device=dev)
            self.lin2_regr = TorchLinear(hl, cfg.num_regr, generator=g,
                                         device=dev)

    def forward(self, x: torch.Tensor, adj: torch.Tensor, snps: torch.Tensor,
                *, is_explain: bool = False,
                raw_x: torch.Tensor | None = None,
                sample_weight: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> FusedOutputs:
        """Forward of one dense batch; train mode follows `self.training`.

        Args:
          x: (B, N, D) ROI features.
          adj: (B, N, N) weighted adjacency, adj[b, r, c] = weight of r->c.
          snps: (B, S) SNP vector.
          is_explain: apply the learned importance masks first.
          raw_x: unmasked ROI features for the prob4regr regression input;
            defaults to `x`.
          sample_weight: (B,) 0/1 padding mask for the batch statistics
            (train mode).
          generator: dropout stream on the inputs' device (train mode).
        """
        cfg = self.cfg
        train = self.training
        b = x.shape[0]
        if raw_x is None:
            raw_x = x
        if is_explain:
            masks = importance_masks(x, adj, self.prob, self.prob_bias,
                                     snps, self.snps_prob)
            x_used, adj_used, snps_used = (masks.x_masked, masks.adj_masked,
                                           masks.snps_masked)
        else:
            x_used, adj_used, snps_used = x, adj, snps

        # ---- imaging GCN stack with jumping-knowledge concat -------------
        n_layers = cfg.num_layers
        if cfg.use_gat:
            h, feats = x_used, []
            for i in range(n_layers):
                h = torch.relu(gat_conv(h, adj_used, gat_layer(self, i)))
                feats.append(h)
            batch_x = torch.cat(feats, dim=-1)
        else:
            prop = gcn_propagation_matrix(adj_used)  # the kernel reads its layout
            batch_x = fused_gcn_stack(
                prop, x_used.contiguous(),
                [getattr(self, f"conv_w_{i}") for i in range(n_layers)],
                [getattr(self, f"conv_b_{i}") for i in range(n_layers)])
        img_out = _pool3(batch_x) if cfg.graph_pool else batch_x.reshape(b, -1)

        # ---- genetics branch -----------------------------------------------
        latent, snps_hat, atten_out = self.go_network(
            snps_used, sample_weight=sample_weight, generator=generator)

        # ---- fusion ----------------------------------------------------------
        out_cross = None
        if cfg.is_cross_atten:
            mha = MHAParams(self.mha_in_proj_weight, self.mha_in_proj_bias,
                            self.mha_out_proj_weight, self.mha_out_proj_bias)
            attn_out, _ = multihead_cross_attention(
                mha, batch_x, atten_out, atten_out, cfg.num_attn_heads)
            out_cross = torch.relu(attn_out)
            out_cross = (_pool3(out_cross) if cfg.graph_pool
                         else out_cross.reshape(b, -1))

        # ---- heads -----------------------------------------------------------
        if cfg.is_image_only:
            out_z = out_lin = img_out
        elif cfg.is_snps_only:
            out_z = latent
            out_lin = torch.cat([snps_used, latent], dim=-1)
        elif out_cross is None:
            # concat fusion (the reference's isCrossAtten=False branch cannot
            # run upstream; rebuilt as the JAX package did)
            out_z = img_out
            out_lin = torch.cat([img_out, latent], dim=-1)
        else:
            out_z = (img_out + out_cross) / 2.0
            out_lin = torch.cat([out_z, latent], dim=-1)

        linear_outf = torch.relu(self.lin1(out_lin))
        hcls = (dropout(linear_outf, cfg.dropout_lin, generator) if train
                else linear_outf)
        logits = self.lin2(hcls)

        if cfg.is_use_prob4regr and not cfg.is_snps_only:
            img_feat = (raw_x * self.prob).reshape(b, -1)   # raw feats * prob
            feat4regr = torch.cat([out_lin, img_feat], dim=-1)
        else:
            feat4regr = out_lin

        def regr_head(lin1, lin2):
            r = torch.relu(lin1(feat4regr))
            return lin2(dropout(r, cfg.dropout_regr, generator) if train
                        else r)

        if cfg.model4eachregr:
            reg = torch.cat([regr_head(getattr(self, f"lin1_regr_{i}"),
                                       getattr(self, f"lin2_regr_{i}"))
                             for i in range(cfg.num_regr)], dim=-1)
        else:
            reg = regr_head(self.lin1_regr, self.lin2_regr)

        return FusedOutputs(torch.log_softmax(logits, dim=-1), snps_hat,
                            out_z, out_lin, linear_outf, reg)
