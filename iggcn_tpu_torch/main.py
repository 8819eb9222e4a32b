"""Experiment CLI of the port: the default route of the JAX package's
`main.py`, `--model SGCN_GCN_IMGSNP`, on the card.

    python -m iggcn_tpu_torch.main --synthetic --synthetic_subjects 874 \\
        --epochs 200 --lambda_disease 1.0 --no-search --layers 2 --hiddens 16

builds the synthetic ADNI-shaped cohort, runs k-fold CV with a validation
split over the (layers, hiddens, h) grid (`--search`, the default, is the
reference's five configurations) and prints the per-epoch lines, a
`[throughput]` line per configuration and the `Result - <mean> +/- <std>,
with L layers and H hidden units and h = ...` line; the npy artifacts go
to results/ADNI<save_appendix>/. It runs on the card and raises without
one unless `--device cpu` is given. The flags mean what they mean in the
JAX package; the real-data loaders, the other model families and the
batch/permutation/resume routes are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import shlex
import sys
import time
from typing import List, Optional

import numpy as np

from iggcn_tpu_torch.config import (DataConfig, LossWeights, ModelConfig,
                                    TrainConfig)

MODELS = ("SGCN_GCN_IMGSNP",)
# the GO DAG of the synthetic route: synthetic_topology's default levels,
# as the JAX package's CLI draws it
DEFAULT_GO_LEVELS = "24,16,10,6,1"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="IG-GCN cross-validation on an NVIDIA GPU (PyTorch port)")
    p.add_argument("--model", type=str, default="SGCN_GCN_IMGSNP",
                   help="model family by reference name; the port has "
                        + ", ".join(MODELS))
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="use the synthetic ADNI-shaped cohort (also used "
                        "when the real data directory is absent)")
    p.add_argument("--synthetic_subjects", type=int, default=256,
                   help="subject count of the synthetic cohort")
    p.add_argument("--synthetic_go_levels", type=str,
                   default=DEFAULT_GO_LEVELS,
                   help="comma list of node counts per level of the "
                        "synthetic GO DAG, leaves first, root last "
                        "(250,120,50,15,1 is the real graph's scale)")
    p.add_argument("--disease_id", type=int, default=3,
                   help="0=HC-vs-AD, 1=HC-vs-prodromal, 2=MCI-vs-AD "
                        "(binary), 3=HC/prodromal/AD (3-class)")
    p.add_argument("--no_val", action="store_true", default=False,
                   help="train/test folds only; the test loss picks the "
                        "best epoch")
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
                   help="h of the single configuration (names the results)")
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
    return p


def combos(args) -> List[tuple]:
    """(layers, hiddens, h) triples: the reference's grid under --search."""
    if args.search:
        return list(zip([2, 3, 2, 3, 4], [16, 16, 10, 10, 5],
                        [2, 3, 4, 4, 2]))
    return [(args.layers, args.hiddens, args.h)]


def fused_cfgs(args, dcfg: DataConfig, num_layers: int, hidden: int):
    """(ModelConfig, TrainConfig) of one configuration of the grid."""
    mcfg = ModelConfig(num_layers=num_layers, hidden=hidden,
                       num_classes=dcfg.num_classes, num_regr=3)
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay,
        lr_decay_factor=args.lr_decay_factor,
        lr_decay_step_size=args.lr_decay_step_size, folds=args.fold,
        seed=args.seed, no_val=args.no_val,
        loss=LossWeights(args.lambda_disease, args.lambda_regr,
                         args.lambda_prob, args.lambda_reco,
                         args.lambda_simi, args.lambda_orth))
    return mcfg, tcfg


def load_cohort(args, dcfg: DataConfig, rng: np.random.Generator):
    """(cohort, topology) of the synthetic route; the topology is drawn
    before the cohort from the same generator, as the JAX package does."""
    from iggcn_tpu_torch.data import adni, go_graph
    if not (args.synthetic or not os.path.isdir(dcfg.data_path)):
        raise NotImplementedError(
            f"{dcfg.data_path} exists, but the port's real-data loaders are "
            f"not ported yet (ROADMAP Queue 1 item 7); pass --synthetic")
    print("[data] using synthetic ADNI-shaped cohort")
    levels = [int(v) for v in args.synthetic_go_levels.split(",")]
    topo = go_graph.synthetic_topology(rng, level_sizes=levels)
    cohort = adni.synthetic_cohort(rng, num_subjects=args.synthetic_subjects,
                                   num_classes=dcfg.num_classes, num_regr=3,
                                   top_k=dcfg.top_k)
    return cohort, topo


def setup_run_dir(args, argv: Optional[List[str]]):
    """Create results/ADNI<appendix>, record the command line, and return
    (res_dir, logger) where logger appends a line to its log.txt."""
    res_dir = os.path.join(os.getcwd(), "results", f"ADNI{args.save_appendix}")
    os.makedirs(res_dir, exist_ok=True)
    cmd = ("python -m iggcn_tpu_torch.main "
           + shlex.join(sys.argv[1:] if argv is None else argv))
    with open(os.path.join(res_dir, "cmd_input.txt"), "a") as fh:
        fh.write(cmd + "\n")

    def logger(info):
        with open(os.path.join(res_dir, "log.txt"), "a") as fh:
            print(info, file=fh)

    return res_dir, logger


def improves(loss: float, best_loss: float) -> bool:
    """NaN-aware grid selection: a NaN loss only replaces the initial inf,
    any real loss beats a NaN best."""
    if np.isnan(loss):
        return bool(np.isinf(best_loss))
    return bool(np.isnan(best_loss)) or loss < best_loss


def main(argv: Optional[List[str]] = None):
    """Run the experiment; returns the CVResult of every configuration."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model not in MODELS:
        parser.error(f"unknown --model {args.model!r} for the port; choose "
                     f"one of: {', '.join(MODELS)}")
    from iggcn_tpu_torch.train.cv import cross_validation
    from iggcn_tpu_torch.utils.platform import resolve_device
    device = resolve_device(args.device)
    if args.save_appendix == "":
        args.save_appendix = "_" + time.strftime("%Y%m%d%H%M%S")
    res_dir, logger = setup_run_dir(args, argv)
    dcfg = DataConfig(disease_id=args.disease_id)
    cohort, topo = load_cohort(args, dcfg, np.random.default_rng(args.seed))

    results = []
    best = (float("inf"), 0.0, 0.0)
    grid = combos(args)
    best_hyper = grid[0]
    for num_layers, hidden, h in grid:
        mcfg, tcfg = fused_cfgs(args, dcfg, num_layers, hidden)
        msg = f"Using {num_layers} layers, {hidden} hidden units, h = {h}"
        print(msg)
        logger(msg)
        res = cross_validation(
            cohort, topo, mcfg, tcfg, res_dir=res_dir,
            result_file_name=(f"result_sgcn_img_snp_layers{num_layers}"
                              f"_hidden{hidden}_h{h}"),
            logger=logger, device=device)
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
