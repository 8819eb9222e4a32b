"""Model configuration of the port.

A copy of `iggcn_tpu.config.ModelConfig` with the same field set, order
and defaults, so that the `config` meta of a serving bundle written by
either package loads unchanged in the other (a test pins the field sets
equal). The training and data configs come with the slices that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of the fused SGCN x GO model (`models/fused_sgcn.py`)."""

    num_layers: int = 2
    hidden: int = 16
    rois: int = 90
    feat_dim: int = 3           # imaging channels per ROI
    num_classes: int = 2
    num_regr: int = 3
    hidden_linear: int = 64
    l_dim: int = 32             # GO latent dim
    go_in_f_dim: int = 2        # GO gene-encoding channels
    go_n_l: int = 2             # GO encoder/decoder depth used by the fusion model
    go_f_dim: Tuple[int, ...] = (5, 5)
    num_snps: int = 54
    is_cross_atten: bool = True
    num_attn_heads: int = 2
    use_gat: bool = False
    num_cluster: int = 2
    is_predict_cluster: bool = True
    is_soft_similarity: bool = True
    rbf_gamma: float = 0.01
    graph_pool: bool = False
    is_use_prob4regr: bool = True
    model4eachregr: bool = False
    is_image_only: bool = False
    is_snps_only: bool = False
    is_multi_fusion: bool = False
    # Kept for bundle compatibility only. In the JAX package it chose a
    # TPU implementation of the imaging GCN stack with identical math; in
    # the port it chooses nothing: the stack always runs through
    # `ops.gcn_stack.fused_gcn_stack`, which launches the CUDA kernel on a
    # CUDA device and runs the plain PyTorch version on the CPU.
    use_pallas_gcn: bool = False
    # GO-branch encoder attention: 'dense' (masked (B, n, n) matmuls),
    # 'edge' ((B, E) gathers + index_add_ aggregation), or 'auto' ('edge'
    # at batch >= 64, else 'dense'; identical math).
    go_attention_impl: str = "auto"
    dropout_lin: float = 0.5
    dropout_regr: float = 0.3
    dropout_go: float = 0.4
    dropout_readout: float = 0.5

    @property
    def jk_dim(self) -> int:
        """Jumping-knowledge concat width of the imaging GCN stack."""
        return self.num_layers * self.hidden
