"""Stratified k-fold cross-validation of the flagship model (port of
`iggcn_tpu/train/cv.py:cross_validation`, model kind `sgcn_imgsnp`).

Per fold: leakage-safe KNN imputation of the clinical scores, padded dense
train/val/test arrays moved to the device once, a fresh model from a
generator seeded by (seed, fold) (or the warm-start weights), and the
epoch loop of `fold_loop.run_fold`. With a validation split the val fold
stays out of training and picks the best epoch; without one
(`tcfg.no_val`) the val fold joins the train set and the test loss picks
it. It prints the JAX package's per-epoch line, writes its npy artifacts
under the same names, and returns the same `CVResult`.

Not ported yet, and refused: other model kinds, `resume` and the per-fold
records and checkpoints it reads, `export_bundle`, `external_test`,
permutation tests and `fold_parallel`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from iggcn_tpu_torch.config import ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import (SCORE_NAMES_ALL, SCORE_NAMES_DEFAULT,
                                       AdniCohort)
from iggcn_tpu_torch.data.batching import cohort_batch_arrays, pad_to_batches
from iggcn_tpu_torch.data.go_graph import GoTopology
from iggcn_tpu_torch.data.impute import knn_impute_scores
from iggcn_tpu_torch.data.splits import k_fold
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.tools.convert import load_flax_variables
from iggcn_tpu_torch.train import artifacts, metrics
from iggcn_tpu_torch.train.fold_loop import fold_perms, run_fold
from iggcn_tpu_torch.train.steps import TrainState
from iggcn_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class CVResult:
    mean_test_loss: float
    best_acc: float
    best_acc_std: float
    score_result: np.ndarray        # (folds, epochs, 5): acc/auc/f1/sen/spe
    durations: List[float]
    throughput_graphs_per_sec: float
    regression_summary: Dict[str, Dict[str, float]]


def prepare_fold(cohort: AdniCohort, full: Dict[str, np.ndarray], split,
                 fold: int, tcfg: TrainConfig, clinical_score_index: int
                 ) -> Dict[str, Any]:
    """Host-side data of one fold, all NumPy: per-fold imputed clinical
    scores, padded train/val/test arrays (val is None without a validation
    split), the test subject ids and the epoch permutations."""
    train_idx, test_idx, val_idx = split
    use_val = not tcfg.no_val
    if not use_val:
        train_idx = np.concatenate([train_idx, val_idx])
    demo = cohort.demographics
    parts = ([train_idx, val_idx, test_idx] if use_val
             else [train_idx, test_idx])
    scores = knn_impute_scores([demo[i] for i in parts], cohort.scaler4score,
                               clinical_score_index)

    def padded(idx, clini):
        arrs = {k: v[idx] for k, v in full.items() if k != "sbj_id"}
        arrs["clini"] = clini
        return pad_to_batches(arrs, tcfg.batch_size)

    train_data = padded(train_idx, scores[0])
    return dict(
        train_data=train_data,
        val_data=padded(val_idx, scores[1]) if use_val else None,
        test_data=padded(test_idx, scores[-1]),
        test_subids=full["sbj_id"][test_idx],
        n_train=len(train_idx), n_test=len(test_idx),
        n_val=len(val_idx) if use_val else len(test_idx),
        perms=fold_perms(tcfg.seed, tcfg.epochs, fold, len(train_idx),
                         train_data["y"].shape[0]))


def to_device(data: Optional[Dict[str, np.ndarray]], device: torch.device
              ) -> Optional[Dict[str, torch.Tensor]]:
    if data is None:
        return None
    return {k: torch.as_tensor(v, device=device) for k, v in data.items()}


def init_fold_model(mcfg: ModelConfig, topo: GoTopology, seed: int,
                    fold: int, device: torch.device, warm_start=None):
    """(model, dropout generator) of one fold. The weights are drawn on the
    CPU from a generator seeded by seed + fold, so they are the same on
    every device; the dropout stream is seeded from that generator and
    lives on `device`. `warm_start` = (params, batch_stats[, tag]) flax
    trees replace the drawn weights."""
    g = torch.Generator().manual_seed(seed + fold)
    model = FusedSGCN(mcfg, topo, generator=g, device=device)
    if warm_start is not None:
        load_flax_variables(model, warm_start[0], warm_start[1])
    drop_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    return model, torch.Generator(device=device).manual_seed(drop_seed)


def cross_validation(cohort: AdniCohort, topo: GoTopology, mcfg: ModelConfig,
                     tcfg: TrainConfig, *,
                     res_dir: Optional[str] = None,
                     result_file_name: str = "result",
                     clinical_score_index: Optional[int] = None,
                     logger: Optional[Callable[[str], None]] = None,
                     model_kind: str = "sgcn_imgsnp",
                     external_test: Optional[AdniCohort] = None,
                     verbose: bool = True,
                     export_bundle: bool = False,
                     resume: bool = False,
                     warm_start=None,
                     device: str | torch.device | None = None) -> CVResult:
    """Run the CV experiment on `device` (default: the card). `warm_start`
    = (params, batch_stats, tag) flax trees start every fold (the
    optimiser state starts fresh)."""
    refused = {"model_kind other than 'sgcn_imgsnp'": model_kind != "sgcn_imgsnp",
               "resume": resume, "export_bundle": export_bundle,
               "external_test": external_test is not None,
               "is_permut_test": tcfg.is_permut_test,
               "fold_parallel": tcfg.fold_parallel}
    for what, asked in refused.items():
        if asked:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP Queue 1); the port's CV "
                f"runs the default SGCN_GCN_IMGSNP route")
    dev = resolve_device(device)
    if clinical_score_index is None:
        clinical_score_index = tcfg.clinical_score_index
    use_val = not tcfg.no_val
    splits = k_fold(cohort.y, tcfg.folds, tcfg.seed)
    full = cohort_batch_arrays(cohort)
    score_names = (SCORE_NAMES_DEFAULT if clinical_score_index == -1
                   else [SCORE_NAMES_ALL[clinical_score_index]])

    all_score_results, test_losses, accs, durations = [], [], [], []
    best_parts: Dict[str, List[np.ndarray]] = {
        k: [] for k in ("hidden", "subid", "linear", "true_scores",
                        "true_labels", "pred_scores")}
    fold_graphs: List[int] = []
    fold_cold: List[bool] = []
    seen_shapes: set = set()

    for fold, split in enumerate(splits):
        p = prepare_fold(cohort, full, split, fold, tcfg, clinical_score_index)
        n_train, n_test, n_val = p["n_train"], p["n_test"], p["n_val"]
        t_start = time.perf_counter()
        wmask = p["test_data"]["w"] > 0
        y_true = p["test_data"]["y"][wmask]
        clini_true = p["test_data"]["clini"][wmask]
        score_result_epoch, fold_test_losses, fold_accs = [], [], []

        def on_epoch(epoch, rec, fold=fold):
            log_probs = rec["log_probs"][wmask]
            reg_pred = rec["our_reg"][wmask]
            cm = metrics.classification_metrics(
                y_true, rec["pred"][wmask],
                log_probs[:, 1] if log_probs.shape[1] > 1 else log_probs[:, 0],
                cohort.num_classes)
            corr, r2s, mses = metrics.regression_metrics(clini_true, reg_pred)
            test_loss = rec["test_loss_sum"] / n_test
            fold_test_losses.append(test_loss)
            fold_accs.append(cm["acc"])
            score_result_epoch.append([cm["acc"], cm["auc"], cm["f1"],
                                       cm["sen"], cm["spe"]])
            if verbose:
                msg = (f"Fold: {fold}, epoch:{epoch}, train_loss: "
                       f"{rec['train_loss_sum'] / n_train:.4f},"
                       f" val_loss: {rec['val_loss_sum'] / n_val:.4f},"
                       f" test_loss: {test_loss:.4f},"
                       f" acc: {cm['acc']:.4f}, auc: {cm['auc']:.4f}")
                for i, nm in enumerate(score_names):
                    msg += (f"; {nm} corr: {corr[i]:.5f}, r2: {r2s[i]:.5f},"
                            f" mse: {mses[i]:.5f}")
                print(msg)
                if logger is not None:
                    logger(msg)

        model, generator = init_fold_model(mcfg, topo, tcfg.seed, fold, dev,
                                           warm_start)
        state = TrainState(model, tcfg,
                           p["train_data"]["y"].shape[0] // tcfg.batch_size)
        _, best, state = run_fold(
            state, to_device(p["train_data"], dev), to_device(p["val_data"], dev),
            to_device(p["test_data"], dev), p["perms"], mcfg, tcfg, generator,
            on_epoch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        durations.append(time.perf_counter() - t_start)
        fold_graphs.append(n_train * tcfg.epochs)
        # the first fold of each new set of split sizes pays the one-time
        # costs (kernel build, allocator and library warm-up): it is left
        # out of the steady-state throughput, as the JAX package leaves out
        # folds that compile
        shape_key = tuple(p[k]["y"].shape[0] for k in ("train_data",
                                                       "test_data"))
        shape_key += (p["val_data"]["y"].shape[0] if use_val
                      else shape_key[1],)
        fold_cold.append(shape_key not in seen_shapes)
        seen_shapes.add(shape_key)
        test_losses.extend(fold_test_losses)
        accs.extend(fold_accs)
        all_score_results.append(score_result_epoch)

        if res_dir is not None:
            artifacts.output_importance(
                res_dir, result_file_name, fold,
                state.model.prob.detach().cpu().numpy(),
                state.model.snps_prob.detach().cpu().numpy(),
                state.model.prob_bias.detach().cpu().numpy())
        best_test = best["test"]
        best_parts["hidden"].append(best_test["out_lin"][wmask])
        best_parts["linear"].append(best_test["linear_outf"][wmask])
        best_parts["subid"].append(p["test_subids"])
        best_parts["true_scores"].append(clini_true)
        best_parts["true_labels"].append(y_true)
        best_parts["pred_scores"].append(best_test["our_reg"][wmask])

    loss_arr = np.asarray(test_losses).reshape(tcfg.folds, tcfg.epochs)
    acc_arr = np.asarray(accs).reshape(tcfg.folds, tcfg.epochs)
    acc_mean = acc_arr.mean(axis=0)
    argmax = int(acc_mean.argmax())
    score_result = np.asarray(all_score_results)
    cat = {k: np.concatenate(v) for k, v in best_parts.items()}

    if res_dir is not None:
        artifacts.output_npy(f"{res_dir}/{result_file_name}.npy", score_result)
        for name, key in (("hidden", "hidden"), ("subids", "subid"),
                          ("linear_out", "linear")):
            artifacts.output_npy(f"{res_dir}/{name}_{result_file_name}.npy",
                                 cat[key])

    corr, r2s, mses = metrics.regression_metrics(cat["true_scores"],
                                                 cat["pred_scores"])
    regression_summary = {nm: {"corr": corr[i], "r2": r2s[i], "rmse": mses[i]}
                          for i, nm in enumerate(score_names)}
    if res_dir is not None:
        artifacts.output_regression(res_dir, result_file_name, score_names,
                                    cat["true_scores"], cat["true_labels"],
                                    cat["pred_scores"])
        for nm, vals in regression_summary.items():
            msg = (f"Regression for all clinical score {nm}: correlation:"
                   f" {vals['corr']:.5f}, r2: {vals['r2']:.5f}, mse:"
                   f" {vals['rmse']:.5f}")
            print(msg)
            if logger is not None:
                logger(msg)

    warm = [(g, d) for g, d, cold in zip(fold_graphs, durations, fold_cold)
            if not cold] or list(zip(fold_graphs, durations))
    throughput = sum(g for g, _ in warm) / max(sum(d for _, d in warm), 1e-9)
    return CVResult(
        mean_test_loss=float(loss_arr.mean()),
        best_acc=float(acc_mean[argmax]),
        best_acc_std=float(acc_arr[:, argmax].std(ddof=1)
                           if acc_arr.shape[0] > 1 else 0.0),
        score_result=score_result, durations=durations,
        throughput_graphs_per_sec=float(throughput),
        regression_summary=regression_summary)

