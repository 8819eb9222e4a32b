"""Configuration of the port.

Copies of `iggcn_tpu.config`'s dataclasses with the same field sets, order
and defaults (tests pin them equal), so the `config` meta of a serving
bundle written by either package loads unchanged in the other and one
command line means the same run in both.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SparsityWeights:
    """Importance-probability penalty weights (`train/losses.sparsity_loss`)."""

    lamda_x_l1: float = 0.1
    lamda_e_l1: float = 0.1
    lamda_x_ent: float = 0.1
    lamda_e_ent: float = 0.1
    lamda_mi: float = 1.0
    lamda_ce: float = 1.0


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """The reference's positional `lambda_loss` list, named:
    [disease, regr, prob, reco, simi, orth]."""

    disease: float = 0.0
    regr: float = 1.0
    prob: float = 0.5
    reco: float = 0.0000015
    simi: float = 0.1
    orth: float = 0.0


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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimisation and cross-validation settings.

    `use_fold_scan`, `device_gather`, `dual_pass_vmap`, `scan_unroll` and
    `remat` are kept so that a configuration means the same in both
    packages; they choose execution strategies of the JAX package with
    identical results and choose nothing in the port, whose folds run as a
    Python epoch loop (`train/fold_loop.py`) with the two passes of a step
    run one after the other. `fold_parallel=True` (all folds as one batched
    program) is not ported yet and raises in `train/cv.py`.
    """

    epochs: int = 200
    batch_size: int = 32
    lr: float = 1e-3
    lr_decay_factor: float = 0.5
    lr_decay_step_size: int = 50
    weight_decay: float = 0.0
    folds: int = 5
    seed: int = 1000
    no_val: bool = False
    temperature: float = 0.1
    num_cluster: int = 2
    clinical_score_index: int = -1
    is_permut_test: bool = False
    use_fold_scan: bool = True
    fold_parallel: bool = False
    device_gather: bool = True
    dual_pass_vmap: bool = True
    scan_unroll: int = 1
    remat: bool = False
    loss: LossWeights = dataclasses.field(default_factory=LossWeights)
    sparsity: SparsityWeights = dataclasses.field(
        default_factory=SparsityWeights)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Ingestion and preprocessing settings. The port reads only the
    synthetic cohort so far; the paths are kept for the real-data loaders."""

    data_path: str = "./data/snps/data/preprocessing/"
    json_path: str = "./data/snps/analysis.json"
    go_connection_path: str = "./data/go_root_connection.txt"
    snps_to_gene_path: str = "./data/snps_to_gene.txt"
    knn: int = 5
    disease_id: int = 3
    clinical_score_index: int = -1
    is_ppr: bool = True
    is_topk: bool = True
    top_k: int = 3
    ppr_alpha: float = 0.05
    heat_t: float = 5.0
    num_cluster: int = 2
    is_use_tsne4similar: bool = False
    is_multimodal4similarity: bool = False
    is_multi_fusion: bool = False
    is_permut_test: bool = False
    seed4permut_test: int = 1

    @property
    def num_classes(self) -> int:
        return 2 if self.disease_id < 3 else 3
