"""Experiment CLI of the port: the fused-family and SNP-only routes of the
JAX package's `main.py` on the card.

    python -m iggcn_tpu_torch.main --data_path DIR --json_path J \\
        --go_connection_path C --snps_to_gene_path G --epochs 200 \\
        --lambda_disease 1.0 --no-search --layers 2 --hiddens 16

reads the reference's `.mat` cohort under DIR/knn/<k>/ and the GO DAG
from the three GO source files (`--synthetic`, or a missing DIR, builds
the synthetic ADNI-shaped cohort and DAG instead), both through the
processed-cohort cache (`--cohort_cache_dir`), runs k-fold CV with a
validation split over the (layers, hiddens, h) grid (`--search`, the
default, is the reference's five configurations; `--isMultiFusion` has
its own) and prints the per-epoch lines, a `[throughput]` line per
configuration and the
`Result - <mean> +/- <std>, with L layers and H hidden units and h = ...`
line; the npy artifacts, each fold's checkpoint and record (and with
`--export_bundle` its serving bundle) go to results/ADNI<save_appendix>/,
and `--resume` with the same appendix restores the folds already done.
`--model` takes the seven fused families of `FUSION_MODELS`, with the JAX
CLI's routing, and the flagship's variant flags, the two SNP-only
families of `SNP_MODELS` (binary; a `Result - ... (SNP-only, <model>)`
line) and the 18 baseline, pooling and nested models of `ZOO_MODELS`,
trained by the generic CV (`train/generic_cv.py`) on the ADNI cohort as
a graph list, on a raw TU benchmark under `--tu_root` (`--data NAME`),
or with `--synthetic` on a synthetic TU benchmark when its files are
missing; the Nested* names re-batch every graph as the union of its
h-hop rooted subgraphs (`--h`, `--node_label`, `--use_rd`, `--use_rp`,
`--max_nodes_per_hop`), which is for TU-sized graphs. `--isTestAdnitype`
tests every fold on a held-out ADNI type, `--isPermutTest` runs the
permutation-test null (results under results_permuttest/), and
`--init_from_torch` starts every fold from a reference
`gcn_state_dict_*.pt`. It runs on the card and raises without one unless
`--device cpu` is given. The flags mean what they mean in the JAX
package, whose command lines of these routes parse here too; the
seed-batch and batch-file routes (`--cv_seeds`, `--permut_seeds`,
`--batch_file`) are not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import shlex
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from iggcn_tpu_torch.config import (DataConfig, LossWeights, ModelConfig,
                                    TrainConfig)

# --model -> model kind of train/cv.py:MODEL_FAMILIES (the JAX CLI's table)
FUSION_MODELS = {
    "SGCN_GCN_IMGSNP": "sgcn_imgsnp",
    "GCN_IMGSNP": "gcn_imgsnp",
    "GUIDE_IMGSNP": "guide_imgsnp",
    "SGCN_GCN_CLUSTERLABEL": "clusterlabel",
    "SGCN_GCN": "sgcn_image",
    "SGCN_GAT": "sgcn_image",
    "SGCN_Ori": "sgcn_ori",
}
SNP_MODELS = ("MLP_Model", "Gene_ontology_network")
# the baseline, pooling and nested zoo of the generic trainer
ZOO_MODELS = ("GCN", "GAT", "GIN", "GIN0", "GraphSAGE", "GraphSAGEWithoutJK",
              "TopK", "DiffPool", "SortPool", "Set2Set", "GlobalAttention",
              "Graclus", "CNN_Model", "NestedGCN", "NestedGAT", "NestedGIN",
              "NestedGIN0", "NestedGraphSAGE")
# the JAX CLI's routes of a later slice (ROADMAP Queue 1 item 13)
NOT_PORTED_FLAGS = ("--cv_seeds", "--permut_seeds", "--batch_file")
# the GO DAG of the synthetic route: synthetic_topology's default levels,
# as the JAX package's CLI draws it
DEFAULT_GO_LEVELS = "24,16,10,6,1"
KNOWN_MODELS = tuple(FUSION_MODELS) + SNP_MODELS + ZOO_MODELS


def go_levels(text: str) -> List[int]:
    """`--synthetic_go_levels`: five positive node counts, leaves first,
    ending in the root's 1 (the five-level DAG `synthetic_topology`
    builds); anything else is a parser error."""
    try:
        levels = [int(v) for v in text.split(",")]
    except ValueError:
        levels = []
    if len(levels) != 5 or min(levels) < 1 or levels[-1] != 1:
        raise argparse.ArgumentTypeError(
            f"{text!r} is not five positive node counts ending in the "
            f"root's 1 (e.g. {DEFAULT_GO_LEVELS}): the synthetic GO DAG has "
            "five levels")
    return levels


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="IG-GCN cross-validation on an NVIDIA GPU (PyTorch port)")
    p.add_argument("--model", type=str, default="SGCN_GCN_IMGSNP",
                   help="model family by reference name; the port has "
                        + ", ".join(KNOWN_MODELS))
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="use the synthetic ADNI-shaped cohort (also used "
                        "when the real data directory is absent)")
    p.add_argument("--synthetic_subjects", type=int, default=256,
                   help="subject count of the synthetic cohort")
    p.add_argument("--synthetic_go_levels", type=go_levels,
                   default=DEFAULT_GO_LEVELS,
                   help="comma list of the five node counts per level of "
                        "the synthetic GO DAG, leaves first, ending in the "
                        "root's 1 (250,120,50,15,1 is the real graph's "
                        "scale)")
    p.add_argument("--data_path", type=str,
                   default="./data/snps/data/preprocessing/",
                   help="ADNI preprocessing dir holding knn/<k>/ (falls "
                        "back to the synthetic cohort when absent)")
    p.add_argument("--json_path", type=str, default="./data/snps/analysis.json",
                   help="PANTHER GO analysis json (GO term hierarchy)")
    p.add_argument("--go_connection_path", type=str,
                   default="./data/go_root_connection.txt",
                   help="scraped GO root-connection list "
                        "(build with iggcn_tpu_torch.data.go_scraper)")
    p.add_argument("--snps_to_gene_path", type=str,
                   default="./data/snps_to_gene.txt",
                   help="SNP-to-gene mapping table")
    p.add_argument("--cohort_cache_dir", type=str, default="./cohort_cache",
                   help="directory for the processed-cohort npz cache "
                        "(parity: ADNIDataset caches its pre_transformed "
                        "tensors under ./<root>/processed/, "
                        "sgcn_data.py:307,332-338); '' disables caching")
    p.add_argument("--knn", type=int, default=5,
                   help="k of the preprocessed kNN layout: mats are read "
                        "under <data_path>/knn/<k>/")
    p.add_argument("--isPPr", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="PPR graph-diffusion pre-transform "
                        "(--no-isPPr switches to the heat kernel)")
    p.add_argument("--isTopK", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="sparsify the diffused adjacency by per-row top-k "
                        "(--no-isTopK applies the heat kernel instead)")
    p.add_argument("--isMultilModal4Similarity", action="store_true",
                   default=False,
                   help="use the precomputed multimodal similarity features "
                        "(multimodal_for_similarity.npy) instead of the PET "
                        "features")
    p.add_argument("--isTestAdnitype", action="store_true", default=False,
                   help="train on CV folds, test on a held-out ADNI type")
    p.add_argument("--adnitype_id", type=int, default=0,
                   help="ADNI study-phase id held out as the external test "
                        "cohort under --isTestAdnitype")
    p.add_argument("--disease_id4Adnitype", type=int, default=0,
                   help="disease task filtering the TRAIN side of the "
                        "held-out-type split (labels binarized)")
    p.add_argument("--isPermutTest", action="store_true", default=False,
                   help="permutation-test control: shuffle the subject-to-"
                        "score pairing (seed --Seed4PermutTest); results go "
                        "to results_permuttest/ and importance npys are "
                        "suppressed")
    p.add_argument("--Seed4PermutTest", type=int, default=1,
                   help="seed of the label permutation under --isPermutTest "
                        "(vary it to build the null distribution)")
    p.add_argument("--init_from_torch", type=str, default="",
                   help="warm-start every fold of a SGCN_GCN_IMGSNP "
                        "experiment from a reference-trained torch checkpoint "
                        "(gcn_state_dict_*.pt, converted in-process by "
                        "iggcn_tpu_torch.tools.import_torch; architecture "
                        "must match the run's --layers/--hiddens). Optimizer "
                        "state and data splits stay fresh")
    p.add_argument("--disease_id", type=int, default=3,
                   help="0=HC-vs-AD, 1=HC-vs-prodromal, 2=MCI-vs-AD "
                        "(binary), 3=HC/prodromal/AD (3-class)")
    p.add_argument("--no_val", action="store_true", default=False,
                   help="train/test folds only; the test loss picks the "
                        "best epoch")
    p.add_argument("--isMultiFusion", action="store_true", default=False,
                   help="fuse all three imaging modalities as one 270-node "
                        "graph (90 ROIs x {MRI, FDG-PET, AV45-PET})")
    p.add_argument("--isImageOnly", action="store_true", default=False,
                   help="ablation: drop the GO/SNP branch from the fused "
                        "model (imaging features only)")
    p.add_argument("--isSNPsOnly", action="store_true", default=False,
                   help="ablation: drop the imaging branch from the fused "
                        "model (GO/SNP features only)")
    p.add_argument("--isCrossAtten", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="cross-modal multihead attention between the "
                        "imaging and GO branches (--no-isCrossAtten: "
                        "concat fusion)")
    p.add_argument("--isSoftSimilarity", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="soft RBF subject-similarity consistency loss; "
                        "--no-isSoftSimilarity uses hard per-cluster "
                        "membership consistency")
    p.add_argument("--rbf_gamma", type=float, default=0.01,
                   help="RBF bandwidth of the subject-similarity weights")
    p.add_argument("--clinical_score_index", type=int, default=-1,
                   help="regress ONE clinical score by index (forces "
                        "--num_regr 1); -1 regresses all three")
    p.add_argument("--num_regr", type=int, default=None,
                   help="number of clinical-score regression targets "
                        "(default 3; must be 1 when --clinical_score_index "
                        "selects a single score)")
    p.add_argument("--model4eachregr", action="store_true", default=False,
                   help="one regression head per clinical score instead of "
                        "a shared multi-output head")
    p.add_argument("--isuseProb4Regr", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="append the importance-weighted raw ROI features to "
                        "the regression head input")
    p.add_argument("--temperature", type=float, default=0.1,
                   help="Gumbel/softmax temperature (GUIDE)")
    p.add_argument("--go_attention_impl", type=str, default="auto",
                   choices=("auto", "dense", "edge"),
                   help="GO-branch edge-attention aggregation: 'dense', "
                        "'edge', or 'auto' ('edge' at batch >= 64)")
    p.add_argument("--top_k", type=int, default=3,
                   help="k for the diffusion top-k sparsifier")
    p.add_argument("--lambda_disease", type=float, default=0.0,
                   help="weight of the diagnosis NLL loss term")
    p.add_argument("--lambda_regr", type=float, default=1.0,
                   help="weight of the clinical-score MSE loss term")
    p.add_argument("--lambda_prob", type=float, default=0.5,
                   help="weight of the importance-sparsity loss")
    p.add_argument("--lambda_reco", type=float, default=0.0000015,
                   help="weight of the SNP reconstruction loss")
    p.add_argument("--lambda_simi", type=float, default=0.1,
                   help="weight of the subject-similarity consistency loss")
    p.add_argument("--lambda_orth", type=float, default=0.0,
                   help="weight of the embedding orthogonality loss")
    p.add_argument("--layers", type=int, default=2,
                   help="GCN depth of the single configuration (--no-search)")
    p.add_argument("--hiddens", type=int, default=5,
                   help="hidden width of the single configuration "
                        "(--no-search)")
    p.add_argument("--h", type=int, default=2,
                   help="h of the single configuration: the hop count of the "
                        "Nested* subgraphs (it names the results of the "
                        "other families)")
    p.add_argument("--data", type=str, default="ADNI",
                   help="dataset of the zoo models: ADNI (the cohort as a "
                        "graph list) or a TU benchmark name under --tu_root "
                        "(e.g. MUTAG)")
    p.add_argument("--tu_root", type=str, default="./data",
                   help="root directory holding raw TU datasets "
                        "(<root>/<name>/<name>_A.txt ...)")
    p.add_argument("--node_label", type=str, default="hop",
                   choices=["hop", "spd", "spd2", "spd3", "drnl"],
                   help="structural node-label scheme of the Nested* "
                        "subgraphs (hop distance, shortest-path distances, "
                        "or DRNL)")
    p.add_argument("--use_rd", action="store_true", default=False,
                   help="append resistance-distance features (Nested*)")
    p.add_argument("--use_rp", type=int, default=None,
                   help="random-walk return-probability feature steps "
                        "(Nested*)")
    p.add_argument("--max_nodes_per_hop", type=int, default=None,
                   help="subsample each BFS frontier to this many nodes "
                        "during Nested* subgraph extraction")
    p.add_argument("--search", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="sweep the reference's (layers, hiddens, h) triples; "
                        "--no-search runs (--layers, --hiddens, --h)")
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="Adam coupled-L2 weight decay (torch semantics)")
    p.add_argument("--epochs", type=int, default=200,
                   help="training epochs per fold")
    p.add_argument("--batch_size", type=int, default=32,
                   help="graphs per training step")
    p.add_argument("--lr", type=float, default=1e-3, help="Adam learning rate")
    p.add_argument("--lr_decay_factor", type=float, default=0.5,
                   help="StepLR multiplicative decay")
    p.add_argument("--lr_decay_step_size", type=int, default=50,
                   help="StepLR decay interval in epochs")
    p.add_argument("--fold", type=int, default=5,
                   help="number of stratified CV folds")
    p.add_argument("--seed", type=int, default=1000,
                   help="seed of the splits, inits, shuffling and the "
                        "synthetic cohort")
    p.add_argument("--save_appendix", default="",
                   help="suffix of the results dir results/ADNI<appendix> "
                        "(default: a timestamp)")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume an interrupted experiment: folds with a "
                        "fold_result_*.npz of this configuration in the "
                        "results dir are restored instead of retrained "
                        "(needs the --save_appendix of that run)")
    p.add_argument("--export_bundle", action="store_true", default=False,
                   help="also write a serving bundle per fold from its "
                        "best epoch (serve with iggcn_tpu_torch.tools.serve)")
    p.add_argument("--snps_csv_root", type=str, default="./data/snps/data",
                   help="root of the standalone SNP csv cohorts "
                        "(<root>/data_{AH,MH,AM}/{snp,dia}.csv) of the "
                        "SNP-only families; without them they train on the "
                        "cohort's SNP matrix")
    # the JAX CLI's flags that choose nothing here, accepted so that its
    # command lines parse: the port runs where --device says, has one
    # implementation of the imaging stack (the kernel on the card) and one
    # fold loop; the last three are dead in the reference too
    p.add_argument("--cuda", type=int, default=None,
                   help="ignored (reference compat): use --device")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="ignored (reference compat): use --device cpu")
    p.add_argument("--use_pallas_gcn", action="store_true", default=False,
                   help="chooses nothing in the port (the imaging stack "
                        "always runs its CUDA kernel on the card); recorded "
                        "in the model config as the JAX CLI records it")
    p.add_argument("--no_fold_scan", action="store_true", default=False,
                   help="chooses nothing in the port (its folds always run "
                        "as a Python epoch loop)")
    for flag in NOT_PORTED_FLAGS:
        p.add_argument(flag, type=str, default=None,
                       help="not ported yet (ROADMAP Queue 1 item 13)")
    p.add_argument("--clean", action="store_true", default=False,
                   help="ignored (dead flag in the reference too)")
    p.add_argument("--keep_old", action="store_true", default=False,
                   help="ignored (dead flag in the reference too)")
    p.add_argument("--reprocess", action="store_true", default=False,
                   help="ignored (dead flag in the reference too)")
    return p


def combos(args) -> List[tuple]:
    """(layers, hiddens, h) triples: under --search the reference's grid
    (--isMultiFusion has its own), else the single configuration."""
    if args.search:
        if args.isMultiFusion:
            return list(zip([3, 2, 4, 2, 3], [2, 3, 3, 5, 10],
                            [3, 2, 4, 2, 4]))
        return list(zip([2, 3, 2, 3, 4], [16, 16, 10, 10, 5],
                        [2, 3, 4, 4, 2]))
    return [(args.layers, args.hiddens, args.h)]


def imaging_shape(args) -> tuple:
    """(rois, feat_dim): 270 nodes of one channel with --isMultiFusion."""
    return (270, 1) if args.isMultiFusion else (90, 3)


def regression_targets(args) -> int:
    """--num_regr with its default resolved: one target when
    --clinical_score_index selects a score, else all three."""
    if args.num_regr is not None:
        return args.num_regr
    return 1 if args.clinical_score_index != -1 else 3


def fused_cfgs(args, dcfg: DataConfig, num_layers: int, hidden: int):
    """(ModelConfig, TrainConfig) of one configuration of the grid."""
    rois, feat_dim = imaging_shape(args)
    mcfg = ModelConfig(
        num_layers=num_layers, hidden=hidden, rois=rois, feat_dim=feat_dim,
        num_classes=dcfg.num_classes, num_regr=regression_targets(args),
        is_cross_atten=args.isCrossAtten,
        is_soft_similarity=args.isSoftSimilarity, rbf_gamma=args.rbf_gamma,
        is_use_prob4regr=args.isuseProb4Regr,
        model4eachregr=args.model4eachregr, is_image_only=args.isImageOnly,
        is_snps_only=args.isSNPsOnly, is_multi_fusion=args.isMultiFusion,
        use_gat=args.model == "SGCN_GAT", use_pallas_gcn=args.use_pallas_gcn,
        go_attention_impl=args.go_attention_impl)
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay,
        lr_decay_factor=args.lr_decay_factor,
        lr_decay_step_size=args.lr_decay_step_size, folds=args.fold,
        seed=args.seed, no_val=args.no_val,
        is_permut_test=args.isPermutTest, temperature=args.temperature,
        clinical_score_index=args.clinical_score_index,
        loss=LossWeights(args.lambda_disease, args.lambda_regr,
                         args.lambda_prob, args.lambda_reco,
                         args.lambda_simi, args.lambda_orth))
    return mcfg, tcfg


def build_dcfg(args) -> DataConfig:
    """The DataConfig of a command line, field for field as the JAX CLI's
    `_build_dcfg` builds it."""
    return DataConfig(
        data_path=args.data_path, json_path=args.json_path,
        go_connection_path=args.go_connection_path,
        snps_to_gene_path=args.snps_to_gene_path, knn=args.knn,
        disease_id=args.disease_id,
        clinical_score_index=args.clinical_score_index,
        is_ppr=args.isPPr, is_topk=args.isTopK, top_k=args.top_k,
        is_multimodal4similarity=args.isMultilModal4Similarity,
        is_multi_fusion=args.isMultiFusion, is_permut_test=args.isPermutTest,
        seed4permut_test=args.Seed4PermutTest)


# what the real route reads, named when a load fails
REAL_LAYOUT = ("<data_path>/knn/<k>/{sbjID_int, score_excel_val_adni874, "
               "score_excel_val_adni874_fill, SNPS_data, BL_DXGrp_label, "
               "corr_data, imgData_mat_normalized_fix}.mat, "
               "<data_path>/knn/<k>/center_2/clusters_pred_label.npy, "
               "<data_path>/knn/<k>/pet_for_similarity.npy (or "
               "multimodal_for_similarity.npy), with --isMultiFusion "
               "<data_path>/{MRI,FDG-PET,AV45-PET}/knn/<k>/corr_data.mat, "
               "and the three GO source files")


def load_cohort(args, dcfg: DataConfig, rng: np.random.Generator):
    """(cohort, topology): the reference's `.mat` cohort and the GO DAG
    parsed from its three source files when `--data_path` exists (and
    `--synthetic` is not given), else the synthetic cohort over a
    synthetic DAG; either cohort through the processed-cohort cache, with
    the JAX CLI's keys (`_load_cohort`)."""
    from iggcn_tpu_torch.data import adni, cohort_cache, go_graph
    if args.synthetic or not os.path.isdir(dcfg.data_path):
        print("[data] using synthetic ADNI-shaped cohort")
        rois, feat_dim = imaging_shape(args)
        # the topology is drawn BEFORE the cohort, so a cache hit (which
        # skips the cohort's draws) leaves it as a miss would
        topo = go_graph.synthetic_topology(
            rng, level_sizes=args.synthetic_go_levels)
        params = dict(seed=args.seed, num_subjects=args.synthetic_subjects,
                      rois=rois, feat_dim=feat_dim,
                      num_classes=dcfg.num_classes,
                      num_regr=regression_targets(args), top_k=dcfg.top_k)
        if args.synthetic_go_levels != go_levels(DEFAULT_GO_LEVELS):
            # other levels draw other numbers before the cohort; the JAX
            # CLI has no such flag, and the default key stays its key
            params["go_levels"] = tuple(args.synthetic_go_levels)
        key = cohort_cache.cohort_key("synthetic", **params)
        cohort, hit = cohort_cache.load_or_build(
            args.cohort_cache_dir, key,
            lambda: adni.synthetic_cohort(
                rng, num_subjects=args.synthetic_subjects, rois=rois,
                feat_dim=feat_dim, num_classes=dcfg.num_classes,
                num_regr=regression_targets(args), top_k=dcfg.top_k))
        if dcfg.is_permut_test:
            # after the cache, so that entries hold the true pairing; the
            # real loader shuffles inside load_adni874
            cohort = adni.permute_regression_targets(
                cohort, dcfg.seed4permut_test)
    else:
        # the source files (name, size, mtime) and every loader field are
        # in the key, the permutation seed too: load_adni874 shuffles
        key = cohort_cache.cohort_key(
            "adni874",
            files=cohort_cache.dir_fingerprint(dcfg.data_path),
            data_path=os.path.abspath(dcfg.data_path),
            disease_id=dcfg.disease_id, knn=dcfg.knn,
            num_cluster=dcfg.num_cluster,
            clinical_score_index=dcfg.clinical_score_index,
            is_ppr=dcfg.is_ppr, is_topk=dcfg.is_topk, top_k=dcfg.top_k,
            ppr_alpha=dcfg.ppr_alpha, heat_t=dcfg.heat_t,
            is_multimodal4similarity=dcfg.is_multimodal4similarity,
            is_use_tsne4similar=dcfg.is_use_tsne4similar,
            is_multi_fusion=dcfg.is_multi_fusion,
            is_permut_test=dcfg.is_permut_test,
            seed4permut_test=dcfg.seed4permut_test)
        try:
            cohort, hit = cohort_cache.load_or_build(
                args.cohort_cache_dir, key, lambda: adni.load_adni874(dcfg))
            topo = go_graph.parse_go_json(dcfg.json_path,
                                          dcfg.go_connection_path,
                                          dcfg.snps_to_gene_path)
        except Exception as e:
            # the data dir exists: name what failed and what the route
            # reads, and re-raise unchanged (a code fault keeps its
            # traceback)
            print(f"[data] failed to load the ADNI cohort/GO sources "
                  f"({type(e).__name__}: {e}) from --data_path "
                  f"{dcfg.data_path} (--knn {dcfg.knn}), --json_path "
                  f"{dcfg.json_path}, --go_connection_path "
                  f"{dcfg.go_connection_path}, --snps_to_gene_path "
                  f"{dcfg.snps_to_gene_path}. The route reads "
                  f"{REAL_LAYOUT}.", file=sys.stderr)
            raise
    if hit:
        print(f"[data] cohort loaded from cache ({key})")
    return cohort, topo


def setup_run_dir(args, argv: Optional[List[str]]):
    """Create results/ADNI<appendix> (results_permuttest/ under
    --isPermutTest), record the command line, and return (res_dir, logger)
    where logger appends a line to its log.txt."""
    sub = "results_permuttest" if args.isPermutTest else "results"
    res_dir = os.path.join(os.getcwd(), sub, f"ADNI{args.save_appendix}")
    os.makedirs(res_dir, exist_ok=True)
    cmd = ("python -m iggcn_tpu_torch.main "
           + shlex.join(sys.argv[1:] if argv is None else argv))
    with open(os.path.join(res_dir, "cmd_input.txt"), "a") as fh:
        fh.write(cmd + "\n")

    def logger(info):
        with open(os.path.join(res_dir, "log.txt"), "a") as fh:
            print(info, file=fh)

    return res_dir, logger


def snps_inputs(args, parser, dcfg: DataConfig, rng: np.random.Generator):
    """(snps, labels, topology) of the SNP-only families: the standalone
    csv cohort when it is there (not with --synthetic), with the GO DAG
    parsed from its source files when all three are there, else the
    cohort's SNP matrix and labels, as the JAX CLI's `_snps_inputs`."""
    from iggcn_tpu_torch.data import go_graph
    from iggcn_tpu_torch.data.snps import load_snps_csv
    if dcfg.num_classes != 2:
        parser.error("SNP trainers are binary classifiers (BCE); use "
                     "--disease_id 0|1|2")
    snps_csv = None
    if not args.synthetic:
        try:
            snps_csv = load_snps_csv(args.snps_csv_root, args.disease_id)
            print(f"[data] SNP csv cohort: {snps_csv[0].shape[0]} subjects")
        except FileNotFoundError:
            pass
    if snps_csv is None:
        cohort, topo = load_cohort(args, dcfg, rng)
        return cohort.snps, cohort.y.astype(np.float32), topo
    go_files = (dcfg.json_path, dcfg.go_connection_path,
                dcfg.snps_to_gene_path)
    if all(os.path.exists(p) for p in go_files):
        topo = go_graph.parse_go_json(*go_files)
    else:
        # parse_go_json needs all three source files
        print("[data] GO source files missing "
              f"({[p for p in go_files if not os.path.exists(p)]}); using a "
              "synthetic GO topology")
        topo = go_graph.synthetic_topology(rng)
    if args.model == "Gene_ontology_network" and \
            snps_csv[0].shape[1] != topo.go_snps.shape[1]:
        parser.error(f"csv cohort has {snps_csv[0].shape[1]} SNPs but the GO "
                     f"topology expects {topo.go_snps.shape[1]}")
    return snps_csv[0], snps_csv[1], topo


def run_snps_experiment(args, res_dir: str, logger, snps_x, snps_y, topo,
                        device):
    """One SNP-only CV run (a fixed architecture, no grid); prints and logs
    the `Result - ... (SNP-only, <model>)` line and returns the
    `SnpsCVResult`."""
    from iggcn_tpu_torch.train.snps_trainer import cross_validation_snps
    kind = "mlp" if args.model == "MLP_Model" else "go"
    res = cross_validation_snps(
        snps_x, snps_y, topo, folds=args.fold, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, seed=args.seed,
        model_kind=kind,
        result_path=os.path.join(res_dir, f"result_snps_{kind}.npy"),
        bundle_dir=res_dir if args.export_bundle else None,
        record_dir=res_dir, resume=args.resume, verbose=True, device=device)
    log = (f"Result - {res.best_acc:.3f} +/- {res.best_acc_std:.3f} "
           f"(SNP-only, {args.model})")
    print(log)
    logger(log)
    return res


def build_zoo_model(name: str, num_layers: int, hidden: int, dataset):
    """(model, cv_kwargs) of a zoo name for `cross_validation_generic`, the
    JAX CLI's `_build_zoo_model` table: the model is built on the CPU as
    the template whose untrained copies train the folds, its input width
    (and node count where the readout flattens) from the dataset."""
    from iggcn_tpu_torch.models import baselines as B
    from iggcn_tpu_torch.models import nested as N
    nc = dataset.num_classes
    f, n = dataset.num_features, dataset.x.shape[1]
    common = dict(num_layers=num_layers, hidden=hidden, num_classes=nc,
                  generator=torch.Generator().manual_seed(0))
    mask = dict(needs_mask=True)
    if name == "GCN":
        return B.GCNFlat(f, n, **common), dict(needs_mask=False)
    if name == "GAT":
        return B.GATFlat(f, n, **common), dict(needs_mask=False)
    if name in ("GIN", "GIN0"):
        return (B.GIN(f, train_eps=name == "GIN", **common),
                dict(needs_mask=True, takes_weight=True))
    if name in ("GraphSAGE", "GraphSAGEWithoutJK"):
        return B.GraphSAGE(f, jk=name == "GraphSAGE", **common), mask
    if name == "TopK":
        return B.TopK(f, **common), mask
    if name == "DiffPool":
        # the reference discards dense_diff_pool's link and entropy losses,
        # so the objective is the plain NLL (aux_loss=False)
        return (B.DiffPool(f, max_nodes=n, **common),
                dict(needs_mask=True, aux_loss=False, takes_weight=True))
    if name == "SortPool":
        # k=30 whatever the graph size; smaller graphs are zero-padded to k
        return B.SortPool(f, **common), mask
    if name == "Set2Set":
        return B.Set2SetNet(f, **common), mask
    if name == "GlobalAttention":
        return B.GlobalAttentionNet(f, **common), mask
    if name == "Graclus":
        return B.Graclus(f, **common), dict(needs_mask=True,
                                            needs_assign=True)
    if name == "CNN_Model":
        return (B.CNNModel(num_classes=nc, rois=n,
                           generator=common["generator"]),
                dict(adj_only=True))
    if name.startswith("Nested"):
        factory = getattr(N, name)
        return (factory(f, **common, num_subgraphs=dataset.num_subgraphs,
                        use_z=getattr(dataset, "z", None) is not None,
                        use_rd=getattr(dataset, "rd", None) is not None),
                dict(needs_mask=True, needs_assign=True, takes_weight=True))
    raise ValueError(name)


def zoo_dataset(args, dcfg: DataConfig, rng: np.random.Generator):
    """The zoo's dataset: the ADNI cohort as a fixed-size graph list
    (`--data ADNI`), the raw TU files of `--data` under `--tu_root`, or,
    with `--synthetic` when those are missing, the synthetic TU
    benchmark drawn from `rng`."""
    from iggcn_tpu_torch.data import tu
    if args.data == "ADNI":
        cohort, _ = load_cohort(args, dcfg, rng)
        return tu.from_graph_list(list(cohort.x), list(cohort.adj),
                                  cohort.y.astype(np.int64))
    try:
        return tu.read_tu_dir(args.tu_root, args.data)
    except FileNotFoundError:
        if not args.synthetic:
            raise
        print(f"[data] no raw {args.data} files under {args.tu_root}; using "
              "a synthetic TU benchmark")
        return tu.synthetic_tu_dataset(rng)


def run_zoo_experiment(args, res_dir: str, logger, dataset, grid, device):
    """Grid-search `cross_validation_generic` over one zoo model (the
    Nested* names over the nested dataset of each configuration's h, built
    once per h); prints and logs the `Using ...` line of each
    configuration and the `Result - ...` line of the one with the lowest
    mean test loss. Returns the `GenericCVResult` of every configuration."""
    from iggcn_tpu_torch.data.nested import create_nested_dataset
    from iggcn_tpu_torch.train.generic_cv import cross_validation_generic
    nested = {}

    def nested_for(h):
        if h not in nested:
            nested[h] = create_nested_dataset(
                dataset, h=h, node_label=args.node_label, use_rd=args.use_rd,
                use_return_prob=args.use_rp is not None,
                return_prob_steps=(args.use_rp if args.use_rp is not None
                                   else 16),
                max_nodes_per_hop=args.max_nodes_per_hop, seed=args.seed)
        return nested[h]

    results = []
    best = (float("inf"), 0.0, 0.0)
    best_hyper = grid[0]
    for num_layers, hidden, h in grid:
        # h shapes only the Nested* datasets; the other models ignore it
        combo_ds = (nested_for(h) if args.model.startswith("Nested")
                    else dataset)
        model, cv_kw = build_zoo_model(args.model, num_layers, hidden,
                                       combo_ds)
        msg = f"Using {num_layers} layers, {hidden} hidden units, h = {h}"
        print(msg)
        logger(msg)
        res = cross_validation_generic(
            combo_ds, model, folds=args.fold, epochs=args.epochs,
            batch_size=args.batch_size, lr=args.lr,
            lr_decay_factor=args.lr_decay_factor,
            lr_decay_step_size=args.lr_decay_step_size,
            weight_decay=args.weight_decay, seed=args.seed,
            no_val=args.no_val, verbose=True, record_dir=res_dir,
            record_tag=f"{args.model}_layers{num_layers}_hidden{hidden}_h{h}",
            resume=args.resume, device=device, **cv_kw)
        results.append(res)
        if improves(res.mean_loss, best[0]):
            best = (res.mean_loss, res.best_acc, res.best_acc_std)
            best_hyper = (num_layers, hidden, h)
    log = (f"Result - {best[1]:.3f} +/- {best[2]:.3f}, with {best_hyper[0]} "
           f"layers and {best_hyper[1]} hidden units and h = {best_hyper[2]}")
    print(log)
    logger(log)
    return results


def improves(loss: float, best_loss: float) -> bool:
    """NaN-aware grid selection: a NaN loss only replaces the initial inf,
    any real loss beats a NaN best."""
    if np.isnan(loss):
        return bool(np.isinf(best_loss))
    return bool(np.isnan(best_loss)) or loss < best_loss


def build_warm_start(args, dcfg: DataConfig, topo, grid, logger):
    """`--init_from_torch` (a reference gcn_state_dict_*.pt) as the
    `(params, batch_stats, tag)` warm start of `cross_validation`, as the
    JAX CLI's `_build_warm_start` makes it: the checkpoint fixes one
    architecture, so a grid is refused, and every architectural field must
    match the run's configuration (no partial load); the tag (file name
    and content hash) enters the fold records' run identity."""
    import hashlib

    from iggcn_tpu_torch.tools import import_torch as it

    if len(grid) > 1:
        print("[init_from_torch] a grid search cannot warm-start from one "
              "fixed-architecture checkpoint; pass --no-search with the "
              "checkpoint's --layers/--hiddens", file=sys.stderr)
        raise SystemExit(2)
    sd = it._load_state_dict(args.init_from_torch)
    try:
        icfg = it.infer_model_config(sd, topo)
        mcfg, _ = fused_cfgs(args, dcfg, grid[0][0], grid[0][1])
        arch_fields = ("num_layers", "hidden", "rois", "feat_dim",
                       "num_classes", "num_regr", "hidden_linear", "l_dim",
                       "go_in_f_dim", "go_n_l", "go_f_dim", "num_snps",
                       "is_use_prob4regr")
        mismatch = [f"{f}: checkpoint {getattr(icfg, f)} vs run "
                    f"{getattr(mcfg, f)}" for f in arch_fields
                    if getattr(icfg, f) != getattr(mcfg, f)]
        if mismatch:
            print("[init_from_torch] checkpoint architecture does not "
                  "match the run's configuration:\n  "
                  + "\n  ".join(mismatch), file=sys.stderr)
            raise SystemExit(2)
        params, batch_stats = it.convert_fused_state_dict(sd, topo, icfg)
    except it.ImportError_ as e:
        print(f"[init_from_torch] FAILED: {e}", file=sys.stderr)
        raise SystemExit(2)
    with open(args.init_from_torch, "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    tag = f"{os.path.basename(args.init_from_torch)}:{digest}"
    msg = f"[init_from_torch] warm-starting every fold from {tag}"
    print(msg)
    logger(msg)
    return params, batch_stats, tag


def main(argv: Optional[List[str]] = None):
    """Run the experiment; returns the CVResult of every configuration, or
    the SnpsCVResult of a SNP-only family."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model not in KNOWN_MODELS:
        parser.error(f"--model {args.model!r} is unknown; the port has: "
                     f"{', '.join(KNOWN_MODELS)}")
    for flag in NOT_PORTED_FLAGS:
        if getattr(args, flag[2:]) is not None:
            parser.error(f"{flag} is not ported yet (ROADMAP Queue 1 item "
                         "13)")
    if args.cuda is not None or args.cpu:
        print("[device] --cuda/--cpu are reference-compat no-ops: the port "
              "runs where --device says (default cuda)", file=sys.stderr)
    image_only = {m for m, k in FUSION_MODELS.items()
                  if k in ("sgcn_image", "sgcn_ori")}
    if args.export_bundle and (args.model in image_only
                               or args.model in ZOO_MODELS):
        parser.error(
            f"--export_bundle does not support --model {args.model}: "
            "serving bundles exist for the fused imaging-genetics families "
            f"({', '.join(sorted(set(FUSION_MODELS) - image_only))}) and the "
            f"SNP-only families ({', '.join(SNP_MODELS)})")
    if args.export_bundle and args.isPermutTest:
        parser.error("--export_bundle with --isPermutTest: permutation "
                     "runs train on shuffled labels; refusing to export "
                     "serving bundles from them")
    if args.init_from_torch:
        # the reference writes checkpoints of the fused flagship only
        if FUSION_MODELS.get(args.model) != "sgcn_imgsnp":
            parser.error("--init_from_torch supports --model "
                         "SGCN_GCN_IMGSNP only (the one family the "
                         "reference writes checkpoints for)")
        if args.isTestAdnitype:
            # the held-out-type split re-binarises the classifier head, so
            # the checkpoint's head cannot match the run's
            parser.error("--init_from_torch does not combine with "
                         "--isTestAdnitype: the held-out-ADNI-type split "
                         "re-binarizes the classifier head, so the "
                         "checkpoint's head cannot match the run's")
        if not os.path.exists(args.init_from_torch):
            parser.error(f"--init_from_torch: {args.init_from_torch} "
                         "does not exist")
    if args.resume and args.save_appendix == "":
        parser.error("--resume needs --save_appendix naming the results "
                     "dir of the interrupted run (a fresh timestamped dir "
                     "has nothing to resume from)")
    if args.clinical_score_index != -1 and args.num_regr not in (None, 1):
        # one selected score is one regression target: a 3-wide head
        # against a (B, 1) target would broadcast in the MSE
        parser.error("--clinical_score_index selects a single score; "
                     "--num_regr must be 1 (or left unset)")
    args.num_regr = regression_targets(args)
    from iggcn_tpu_torch.data.adni import separate_data_adnitype
    from iggcn_tpu_torch.train.cv import cross_validation
    from iggcn_tpu_torch.utils.platform import resolve_device
    device = resolve_device(args.device)
    if args.save_appendix == "":
        args.save_appendix = "_" + time.strftime("%Y%m%d%H%M%S")
    res_dir, logger = setup_run_dir(args, argv)
    dcfg = build_dcfg(args)
    rng = np.random.default_rng(args.seed)
    if args.model in SNP_MODELS:
        # before the imaging cohort: a csv cohort needs none of it
        return run_snps_experiment(args, res_dir, logger,
                                   *snps_inputs(args, parser, dcfg, rng),
                                   device)
    if args.model in ZOO_MODELS:
        return run_zoo_experiment(args, res_dir, logger,
                                  zoo_dataset(args, dcfg, rng), combos(args),
                                  device)
    cohort, topo = load_cohort(args, dcfg, rng)

    results = []
    best = (float("inf"), 0.0, 0.0)
    grid = combos(args)
    if args.search and FUSION_MODELS[args.model] == "sgcn_ori":
        # a fixed architecture: the grid would train five identical models
        print("[search] SGCN_Ori has a fixed architecture; running one "
              "configuration instead of the grid")
        grid = grid[:1]
    warm_start = (build_warm_start(args, dcfg, topo, grid, logger)
                  if args.init_from_torch else None)
    train_cohort, external_test = cohort, None
    if args.isTestAdnitype:
        train_cohort, external_test = separate_data_adnitype(
            cohort, args.disease_id4Adnitype, args.adnitype_id)
    best_hyper = grid[0]
    for num_layers, hidden, h in grid:
        mcfg, tcfg = fused_cfgs(args, dcfg, num_layers, hidden)
        # the held-out-type split binarises the labels: the head and the
        # metrics follow the cohort, not --disease_id
        mcfg = dataclasses.replace(mcfg, num_classes=train_cohort.num_classes)
        msg = f"Using {num_layers} layers, {hidden} hidden units, h = {h}"
        print(msg)
        logger(msg)
        res = cross_validation(
            train_cohort, topo, mcfg, tcfg, res_dir=res_dir,
            result_file_name=(f"result_sgcn_img_snp_layers{num_layers}"
                              f"_hidden{hidden}_h{h}"),
            clinical_score_index=args.clinical_score_index, logger=logger,
            model_kind=FUSION_MODELS[args.model],
            external_test=external_test, export_bundle=args.export_bundle,
            resume=args.resume, warm_start=warm_start, device=device)
        results.append(res)
        print(f"[throughput] {res.throughput_graphs_per_sec:.1f} graphs/s")
        if improves(res.mean_test_loss, best[0]):
            best = (res.mean_test_loss, res.best_acc, res.best_acc_std)
            best_hyper = (num_layers, hidden, h)
    log = (f"Result - {best[1]:.3f} +/- {best[2]:.3f}, with {best_hyper[0]} "
           f"layers and {best_hyper[1]} hidden units and h = {best_hyper[2]}")
    print(log)
    logger(log)
    return results


if __name__ == "__main__":
    main()
