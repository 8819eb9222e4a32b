"""Stratified k-fold cross-validation of the fused model families (port of
`iggcn_tpu/train/cv.py:cross_validation`).

`MODEL_FAMILIES` maps each model kind of the JAX package to its builder;
the objective comes from `steps.OBJECTIVES` under the same key (the two
tables are checked to list the same kinds). The image-only kinds
(`sgcn_image`, `sgcn_ori`) build without a GO topology or SNP width and
their per-epoch lines carry no regression scores, as in the JAX package.

Per fold: leakage-safe KNN imputation of the clinical scores, padded dense
train/val/test arrays moved to the device once, a fresh model from a
generator seeded by (seed, fold) (or the warm-start weights), and the
epoch loop of `fold_loop.run_fold`. With a validation split the val fold
stays out of training and picks the best epoch; without one
(`tcfg.no_val`) the val fold joins the train set and the test loss picks
it. It prints the JAX package's per-epoch line, writes its npy artifacts
under the same names, and returns the same `CVResult`.

With a results directory each fold also writes, under the JAX package's
names: the best epoch's weights as a flax-layout msgpack checkpoint
(`gcn_state_dict_{name}_fold_{k}.msgpack`), with `export_bundle` a
serving bundle from them (`serving_bundle_{name}_fold_{k}.npz`, for the
families with a GO topology), and last an atomic fold record
(`fold_result_{name}_fold_{k}.npz`) of everything the aggregates need.
`resume` restores the folds whose record matches this run's identity
(`records.config_fingerprint`, the same int64 as the JAX package's) and
trains only the rest; records written by either package resume in the
other.

With `external_test` (the held-out-ADNI-type experiment) every fold
tests on that cohort instead of its test split: its clinical scores are
imputed per fold from its own demographics against the fold's train
rows, and its subject ids go into the artifacts. A permutation-test run
(`tcfg.is_permut_test`) keeps each fold's last epoch, not its best, and
writes no checkpoint, bundle or npy artifact, only the fold records, as
the JAX package does.

With `tcfg.fold_parallel` all folds train as one batched program
(`fold_parallel.run_folds_parallel`), and each fold's outputs then go
through the same per-fold post-processing as a sequential fold's: epoch
lines, metrics, checkpoint, bundle, record, npy artifacts. A resume
under it restores a complete set of saved folds; a partial set is
retrained whole. `cross_validation_seed_batch` (one cohort, S CV seeds)
and `cross_validation_permut_batch` (S permutation nulls) train all
S x k fold entries as one such program and replay each seed's
post-processing through `cross_validation`.

Inside a world of ranks (`parallel.mesh.launch`, one process per device)
the batched program runs on `fold_mesh(entries)` over the world's
devices (`fold_parallel_runs`, whose `mesh` a caller may choose): each
rank trains its own fold entries on its own device, on its slice of
every batch, every rank gets every entry's results and runs the same
post-processing, and rank 0 alone prints, logs and writes.
"""
from __future__ import annotations

import dataclasses
import os
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
from iggcn_tpu_torch.models.clusterlabel import ClusterLabelSGCN
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.guide import GuideImgSnp
from iggcn_tpu_torch.models.sgcn_image import SGCNImage, SGCNOri
from iggcn_tpu_torch.parallel import mesh as meshlib
from iggcn_tpu_torch.tools.convert import (load_flax_variables,
                                           to_flax_variables)
from iggcn_tpu_torch.tools.serve import save_bundle
from iggcn_tpu_torch.train import artifacts, metrics
from iggcn_tpu_torch.train.checkpoint import save_checkpoint
from iggcn_tpu_torch.train.fold_loop import fold_perms, run_fold
from iggcn_tpu_torch.train.fold_parallel import run_folds_parallel
from iggcn_tpu_torch.train.records import config_fingerprint
from iggcn_tpu_torch.train.steps import OBJECTIVES, TrainState
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


def _build_sgcn_image(mcfg, topo, **kw):
    return SGCNImage(num_layers=mcfg.num_layers, hidden=mcfg.hidden,
                     rois=mcfg.rois, feat_dim=mcfg.feat_dim,
                     num_classes=mcfg.num_classes,
                     hidden_linear=mcfg.hidden_linear, use_gat=mcfg.use_gat,
                     **kw)


def _build_sgcn_ori(mcfg, topo, **kw):
    # a fixed conv1 -> conv3 architecture: num_layers and hidden are
    # constants of the model there, not flags
    return SGCNOri(h0=mcfg.feat_dim, rois=mcfg.rois,
                   num_classes=mcfg.num_classes, **kw)


# model kind -> build(mcfg, topo, generator=, device=); the objective is
# steps.OBJECTIVES[kind]
MODEL_FAMILIES = {
    "sgcn_imgsnp": FusedSGCN,
    "gcn_imgsnp": FusedSGCN,
    "guide_imgsnp": GuideImgSnp,
    "clusterlabel": ClusterLabelSGCN,
    "sgcn_image": _build_sgcn_image,
    "sgcn_ori": _build_sgcn_ori,
}
if set(MODEL_FAMILIES) != set(OBJECTIVES):  # not assert: survives python -O
    raise RuntimeError(
        "MODEL_FAMILIES and steps.OBJECTIVES must list the same model kinds")


def prepare_fold(cohort: AdniCohort, full: Dict[str, np.ndarray], split,
                 fold: int, tcfg: TrainConfig, clinical_score_index: int,
                 external_test: Optional[AdniCohort] = None
                 ) -> Dict[str, Any]:
    """Host-side data of one fold, all NumPy: per-fold imputed clinical
    scores, padded train/val/test arrays (val is None without a validation
    split), the test subject ids and the epoch permutations. With
    `external_test` that cohort is the fold's test set, imputed from its
    own demographics (the JAX package's `_impute_fold`)."""
    train_idx, test_idx, val_idx = split
    use_val = not tcfg.no_val
    if not use_val:
        train_idx = np.concatenate([train_idx, val_idx])
    demo = cohort.demographics
    parts = [demo[train_idx]] + ([demo[val_idx]] if use_val else [])
    parts.append(demo[test_idx] if external_test is None
                 else external_test.demographics)
    scores = knn_impute_scores(parts, cohort.scaler4score,
                               clinical_score_index)

    def padded(arrays, idx, clini):
        arrs = {k: v[idx] for k, v in arrays.items() if k != "sbj_id"}
        arrs["clini"] = clini
        return pad_to_batches(arrs, tcfg.batch_size)

    test_full = full
    if external_test is not None:
        test_full = cohort_batch_arrays(external_test)
        test_idx = np.arange(len(external_test))
    train_data = padded(full, train_idx, scores[0])
    return dict(
        train_data=train_data,
        val_data=padded(full, val_idx, scores[1]) if use_val else None,
        test_data=padded(test_full, test_idx, scores[-1]),
        test_subids=test_full["sbj_id"][test_idx],
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
                    fold: int, device: torch.device, warm_start=None,
                    kind: str = "sgcn_imgsnp"):
    """(model, dropout generator) of one fold of model kind `kind`. The
    weights are drawn on the CPU from a generator seeded by seed + fold, so
    they are the same on every device; the dropout (and Gumbel) stream is
    seeded from that generator and lives on `device`. `warm_start` =
    (params, batch_stats[, tag]) flax trees replace the drawn weights."""
    g = torch.Generator().manual_seed(seed + fold)
    model = MODEL_FAMILIES[kind](mcfg, topo, generator=g, device=device)
    if warm_start is not None:
        load_flax_variables(model, warm_start[0], warm_start[1])
    drop_seed = int(torch.randint(2 ** 62, (1,), generator=g))
    return model, torch.Generator(device=device).manual_seed(drop_seed)


def write_importance(res_dir: str, result_file_name: str, fold: int,
                     model: torch.nn.Module, is_permut_test: bool = False
                     ) -> None:
    """A fold's importance npys from its final weights: the ROI and edge
    importance (and the SNP importance where the family has it), or the
    GUIDE family's Gumbel mask logits; none in a permutation test."""
    def host(t):
        return t.detach().cpu().numpy()

    if hasattr(model, "prob"):
        snps_prob = getattr(model, "snps_prob", None)
        artifacts.output_importance(
            res_dir, result_file_name, fold, host(model.prob),
            None if snps_prob is None else host(snps_prob),
            host(model.prob_bias), is_permut_test=is_permut_test)
    elif hasattr(model, "bias_n"):
        artifacts.output_mask_importance(res_dir, result_file_name, fold,
                                         host(model.bias_n),
                                         is_permut_test=is_permut_test)


# execution-strategy fields of TrainConfig whose results are identical:
# left out of a record's run identity, so a resume may switch them
EXECUTION_FIELDS = ("use_fold_scan", "fold_parallel", "device_gather",
                    "dual_pass_vmap", "scan_unroll")
# the per-fold parts of the aggregates, in a fold record under these keys
FOLD_PARTS = ("hidden", "subid", "linear", "true_scores", "true_labels",
              "pred_scores")


def record_meta(tcfg: TrainConfig, mcfg: ModelConfig, model_kind: str,
                external_test: bool = False, warm_start=None) -> np.ndarray:
    """The int64 `meta` vector of a fold record: the explicit run axes,
    then the fingerprint of the model kind, the ModelConfig and the
    TrainConfig without its execution-strategy fields (plus the
    warm-start tag), as the JAX package's `cross_validation` builds it."""
    run_identity = dataclasses.asdict(tcfg)
    for key in EXECUTION_FIELDS:
        run_identity.pop(key)
    if warm_start is not None:
        run_identity["warm_start"] = str(warm_start[2])
    return np.asarray(
        [tcfg.epochs, tcfg.folds, tcfg.seed, tcfg.batch_size,
         int(tcfg.no_val), int(tcfg.is_permut_test), int(external_test),
         config_fingerprint(model_kind=model_kind, mcfg=mcfg,
                            **run_identity)], np.int64)


def load_fold_records(paths: List[str], want_meta: np.ndarray
                      ) -> Dict[int, Dict[str, np.ndarray]]:
    """{fold: record} of the readable records in `paths` (one per fold)
    whose meta is `want_meta`; the others are reported and retrained."""
    done = {}
    for fold, path in enumerate(paths):
        if not os.path.exists(path):
            continue
        try:
            with np.load(path) as zf:
                if not np.array_equal(zf["meta"], want_meta):
                    print(f"[resume] {path} was written by a different "
                          f"config (meta {zf['meta'].tolist()} vs "
                          f"{want_meta.tolist()}); retraining fold {fold}")
                    continue
                done[fold] = {k: zf[k] for k in zf.files}
        except Exception as e:  # any unreadable file is retrained
            print(f"[resume] ignoring unreadable {path} ({e}); "
                  f"retraining fold {fold}")
    return done


def write_fold_record(path: str, **arrays) -> None:
    """Write a fold record atomically: a temporary file, then a rename.
    Creates its directory: a permutation test writes nothing before it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"   # savez appends .npz when absent
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def fold_parallel_runs(entries: List[Dict[str, Any]], topo: GoTopology,
                       mcfg: ModelConfig, tcfg: TrainConfig, kind: str,
                       device: torch.device, warm_start=None,
                       mesh: Optional[meshlib.Mesh] = None
                       ) -> List[Dict[str, Any]]:
    """Train every fold entry at once (`run_folds_parallel`) on `mesh`
    (default `fold_mesh(len(entries))` over the world's devices: this
    device alone outside a world). An entry is {"p": `prepare_fold`'s
    data, "seed": its init seed, "fold": its fold}; each gets back
    "per_epoch", "best", "model" (its final weights) and "seconds" (its
    share of the run's wall time)."""
    if mesh is None:
        mesh = meshlib.fold_mesh(len(entries), meshlib.world_devices(device))
    inits = [init_fold_model(mcfg, topo, e["seed"], e["fold"], device,
                             warm_start, kind) for e in entries]
    models = [m for m, _ in inits]
    ps = [e["p"] for e in entries]
    per_epoch, best, seconds = run_folds_parallel(
        models, [g for _, g in inits], [p["train_data"] for p in ps],
        None if tcfg.no_val else [p["val_data"] for p in ps],
        [p["test_data"] for p in ps], [p["perms"] for p in ps],
        [p["train_data"]["y"].shape[0] // tcfg.batch_size for p in ps],
        mcfg, tcfg, kind, mesh)
    return [{**e, "per_epoch": pe, "best": b, "model": m,
             "seconds": seconds / len(entries)}
            for e, pe, b, m in zip(entries, per_epoch, best, models)]


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
                     device: str | torch.device | None = None,
                     trained: Optional[List[Dict[str, Any]]] = None
                     ) -> CVResult:
    """Run the CV experiment on `device` (default: the card). `warm_start`
    = (params, batch_stats, tag) flax trees start every fold (the
    optimiser state starts fresh). `external_test` is a held-out cohort
    that every fold tests on instead of its test split. With `res_dir`,
    every fold writes its checkpoint and record (and with `export_bundle`
    its serving bundle); `resume` restores the folds whose record matches
    this run. `tcfg.fold_parallel` trains the folds as one batched
    program. `trained`: the folds already trained by a seed or
    permutation batch (`fold_parallel_runs`' entries, one per fold), which
    only go through the post-processing (the JAX package's `_injected`).
    Inside a world of ranks the batched program runs on its mesh
    (`fold_parallel_runs`), every rank returns the same result and only
    rank 0 prints, logs and writes."""
    if model_kind not in MODEL_FAMILIES:
        raise ValueError(f"unknown model_kind {model_kind}; "
                         f"one of {sorted(MODEL_FAMILIES)}")
    dev = resolve_device(device)
    if clinical_score_index is None:
        clinical_score_index = tcfg.clinical_score_index
    use_val = not tcfg.no_val
    if not meshlib.is_lead():
        verbose, logger = False, None
    writes = res_dir is not None and meshlib.is_lead()
    splits = k_fold(cohort.y, tcfg.folds, tcfg.seed)
    full = cohort_batch_arrays(cohort)
    score_names = (SCORE_NAMES_DEFAULT if clinical_score_index == -1
                   else [SCORE_NAMES_ALL[clinical_score_index]])

    def fold_file(stem: str, fold: int, ext: str) -> str:
        return os.path.join(res_dir,
                            f"{stem}_{result_file_name}_fold_{fold}.{ext}")

    want_meta = record_meta(tcfg, mcfg, model_kind,
                            external_test=external_test is not None,
                            warm_start=warm_start)
    permut = tcfg.is_permut_test
    done_folds: Dict[int, Dict[str, np.ndarray]] = {}
    if resume and res_dir is not None:
        done_folds = load_fold_records(
            [fold_file("fold_result", f, "npz") for f in range(tcfg.folds)],
            want_meta)
        if done_folds and tcfg.fold_parallel and len(done_folds) < tcfg.folds:
            print(f"[resume] fold_parallel trains all folds in one program; "
                  f"{len(done_folds)}/{tcfg.folds} saved folds is not a "
                  "complete set — retraining everything (drop "
                  "--fold_parallel to resume fold-by-fold)")
            done_folds = {}

    runs: Dict[int, Dict[str, Any]] = {}
    if trained is not None:
        runs = dict(enumerate(trained))
    elif tcfg.fold_parallel and len(done_folds) < tcfg.folds:
        entries = [{"p": prepare_fold(cohort, full, split, fold, tcfg,
                                      clinical_score_index, external_test),
                    "seed": tcfg.seed, "fold": fold}
                   for fold, split in enumerate(splits)]
        runs = dict(enumerate(fold_parallel_runs(
            entries, topo, mcfg, tcfg, model_kind, dev, warm_start)))

    all_score_results, test_losses, accs, durations = [], [], [], []
    best_parts: Dict[str, List[np.ndarray]] = {k: [] for k in FOLD_PARTS}
    fold_graphs: List[int] = []
    fold_cold: List[bool] = []
    seen_shapes: set = set()

    for fold, split in enumerate(splits):
        if fold in done_folds:
            d = done_folds[fold]
            test_losses.extend(d["test_losses"].tolist())
            accs.extend(d["accs"].tolist())
            all_score_results.append(d["score_result_epoch"])
            for part in FOLD_PARTS:
                best_parts[part].append(d[part])
            # nothing trained: left out of the steady-state throughput
            durations.append(0.0)
            fold_graphs.append(0)
            fold_cold.append(True)
            msg = (f"[resume] fold {fold} restored from "
                   f"{fold_file('fold_result', fold, 'npz')} "
                   "(training skipped)")
            if verbose:
                print(msg)
            if logger is not None:
                logger(msg)
            continue
        run = runs.get(fold)
        p = run["p"] if run is not None else prepare_fold(
            cohort, full, split, fold, tcfg, clinical_score_index,
            external_test)
        n_train, n_test, n_val = p["n_train"], p["n_test"], p["n_val"]
        t_start = time.perf_counter()
        wmask = p["test_data"]["w"] > 0
        y_true = p["test_data"]["y"][wmask]
        clini_true = p["test_data"]["clini"][wmask]
        score_result_epoch, fold_test_losses, fold_accs = [], [], []

        def on_epoch(epoch, rec, fold=fold):
            log_probs = rec["log_probs"][wmask]
            has_regr = "our_reg" in rec
            reg_pred = (rec["our_reg"][wmask] if has_regr
                        else np.zeros_like(clini_true))
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
                for i, nm in enumerate(score_names if has_regr else ()):
                    msg += (f"; {nm} corr: {corr[i]:.5f}, r2: {r2s[i]:.5f},"
                            f" mse: {mses[i]:.5f}")
                print(msg)
                if logger is not None:
                    logger(msg)

        if run is not None:
            # trained with the other folds in one batched program: its
            # epoch records go through the same lines and metrics
            per_epoch, best, model = run["per_epoch"], run["best"], run["model"]
            for epoch in range(per_epoch["train_loss_sum"].shape[0]):
                on_epoch(epoch + 1, {k: v[epoch] for k, v in per_epoch.items()})
            durations.append(run["seconds"])
            # the batched run's one-time costs are not split out, as the
            # JAX package counts its fold-parallel execution whole
            fold_cold.append(False)
        else:
            model, generator = init_fold_model(mcfg, topo, tcfg.seed, fold,
                                               dev, warm_start, model_kind)
            state = TrainState(model, tcfg, p["train_data"]["y"].shape[0]
                               // tcfg.batch_size, model_kind)
            per_epoch, best, state = run_fold(
                state, to_device(p["train_data"], dev),
                to_device(p["val_data"], dev), to_device(p["test_data"], dev),
                p["perms"], mcfg, tcfg, generator, on_epoch)
            model = state.model
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            durations.append(time.perf_counter() - t_start)
            # the first fold of each new set of split sizes pays the
            # one-time costs (kernel build, allocator and library warm-up):
            # it is left out of the steady-state throughput, as the JAX
            # package leaves out folds that compile
            shape_key = tuple(p[k]["y"].shape[0] for k in ("train_data",
                                                           "test_data"))
            shape_key += (p["val_data"]["y"].shape[0] if use_val
                          else shape_key[1],)
            fold_cold.append(shape_key not in seen_shapes)
            seen_shapes.add(shape_key)
        fold_graphs.append(n_train * tcfg.epochs)
        test_losses.extend(fold_test_losses)
        accs.extend(fold_accs)
        all_score_results.append(score_result_epoch)

        # a permutation test keeps the last epoch, not the best, and of it
        # the outputs the JAX package's fold scan keeps per epoch: its
        # records hold zeros for the hidden and linear features
        best_test = ({k: per_epoch[k][-1] for k in ("log_probs", "pred",
                                                    "our_reg")
                      if k in per_epoch} if permut else best["test"])
        zeros = np.zeros((int(wmask.sum()), 1), np.float32)
        parts = {part: (best_test[key][wmask] if key in best_test
                        else missing)
                 for part, key, missing in (
                     ("hidden", "out_lin", zeros),
                     ("linear", "linear_outf", zeros),
                     ("pred_scores", "our_reg", np.zeros_like(clini_true)))}
        parts.update(subid=p["test_subids"], true_scores=clini_true,
                     true_labels=y_true)
        for part in FOLD_PARTS:
            best_parts[part].append(parts[part])

        if writes:
            if not permut:
                best_vars = to_flax_variables(model, best["state"])
                save_checkpoint(fold_file("gcn_state_dict", fold, "msgpack"),
                                best_vars["params"], best_vars["batch_stats"])
            write_importance(res_dir, result_file_name, fold, model, permut)
            if (export_bundle and not permut
                    and getattr(model, "topo", None) is not None):
                save_bundle(fold_file("serving_bundle", fold, "npz"),
                            model, best_vars["params"],
                            best_vars["batch_stats"])
            write_fold_record(
                fold_file("fold_result", fold, "npz"),
                score_result_epoch=np.asarray(score_result_epoch, np.float64),
                test_losses=np.asarray(fold_test_losses, np.float64),
                accs=np.asarray(fold_accs, np.float64),
                **parts, score_names=np.asarray(score_names), meta=want_meta)

    loss_arr = np.asarray(test_losses).reshape(tcfg.folds, tcfg.epochs)
    acc_arr = np.asarray(accs).reshape(tcfg.folds, tcfg.epochs)
    acc_mean = acc_arr.mean(axis=0)
    argmax = int(acc_mean.argmax())
    score_result = np.asarray(all_score_results)
    cat = {k: np.concatenate(v) for k, v in best_parts.items()}

    if writes:
        artifacts.output_npy(f"{res_dir}/{result_file_name}.npy", score_result,
                             is_permut_test=permut)
        for name, key in (("hidden", "hidden"), ("subids", "subid"),
                          ("linear_out", "linear")):
            artifacts.output_npy(f"{res_dir}/{name}_{result_file_name}.npy",
                                 cat[key], is_permut_test=permut)

    corr, r2s, mses = metrics.regression_metrics(cat["true_scores"],
                                                 cat["pred_scores"])
    regression_summary = {nm: {"corr": corr[i], "r2": r2s[i], "rmse": mses[i]}
                          for i, nm in enumerate(score_names)}
    if writes:
        artifacts.output_regression(res_dir, result_file_name, score_names,
                                    cat["true_scores"], cat["true_labels"],
                                    cat["pred_scores"], is_permut_test=permut)
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


def _batch_preconditions(tcfg: TrainConfig, what: str) -> None:
    """The JAX package's preconditions of its batched CVs. `use_fold_scan`
    and `device_gather` choose nothing in the port; the errors keep their
    wording."""
    if not (tcfg.fold_parallel and tcfg.use_fold_scan):
        raise ValueError(f"{what} requires fold_parallel + use_fold_scan")
    if not tcfg.device_gather:
        raise ValueError(f"{what} requires device_gather (the batched fold "
                         "assembly)")


def _padded_sizes(entries: List[Dict[str, Any]]) -> Dict[str, int]:
    """Per split kind, the largest padded size over a seed's folds."""
    kinds = ("train_data", "val_data", "test_data")
    return {k: max(e["p"][k]["y"].shape[0] for e in entries)
            for k in kinds if entries[0]["p"][k] is not None}


def cross_validation_seed_batch(cohort: AdniCohort, seeds, topo: GoTopology,
                                mcfg: ModelConfig, tcfg: TrainConfig, *,
                                res_dirs, result_file_name: str = "result",
                                clinical_score_index: Optional[int] = None,
                                loggers=None,
                                model_kind: str = "sgcn_imgsnp",
                                export_bundle: bool = False,
                                verbose: bool = True,
                                device: str | torch.device | None = None
                                ) -> List[CVResult]:
    """Replicate the same experiment across CV seeds as one batched
    program (the JAX package's `cross_validation_seed_batch`): each seed
    redraws the splits, the per-fold imputation, the inits, the dropout
    streams and the epoch shuffling, and every seed x fold entry trains in
    one `run_folds_parallel`. Each seed's outputs are then those of a
    standalone fold-parallel run with `tcfg.seed = s`, written to its
    `res_dirs` entry by `cross_validation`'s post-processing."""
    _batch_preconditions(tcfg, "cross_validation_seed_batch")
    if tcfg.is_permut_test:
        raise ValueError("seed replication shuffles nothing; combine with "
                         "--permut_seeds (per-seed null batch) instead of "
                         "is_permut_test")
    if clinical_score_index is None:
        clinical_score_index = tcfg.clinical_score_index
    seeds = list(seeds)
    if len(res_dirs) != len(seeds):
        raise ValueError("one res_dir per seed required")
    dev = resolve_device(device)
    full = cohort_batch_arrays(cohort)
    tcfgs = [dataclasses.replace(tcfg, seed=s) for s in seeds]
    by_seed = [[{"p": prepare_fold(cohort, full, split, fold, tc,
                                   clinical_score_index),
                 "seed": tc.seed, "fold": fold}
                for fold, split in enumerate(k_fold(cohort.y, tc.folds,
                                                    tc.seed))]
               for tc in tcfgs]
    sizes = [_padded_sizes(entries) for entries in by_seed]
    if any(sz != sizes[0] for sz in sizes[1:]):
        # cannot happen for stratified k-fold (sizes are seed-invariant);
        # guard loudly rather than train misaligned stacked shapes
        raise AssertionError(
            f"seed-batch entries disagree on padded fold sizes ({sizes}); "
            "splits must be size-invariant across seeds")
    runs = fold_parallel_runs([e for entries in by_seed for e in entries],
                              topo, mcfg, tcfg, model_kind, dev)
    k = tcfg.folds
    return [cross_validation(
        cohort, topo, mcfg, tcfgs[i], res_dir=res_dirs[i],
        result_file_name=result_file_name,
        clinical_score_index=clinical_score_index,
        logger=loggers[i] if loggers is not None else None,
        model_kind=model_kind, verbose=verbose, export_bundle=export_bundle,
        device=dev, trained=runs[i * k:(i + 1) * k])
        for i in range(len(seeds))]


# the cohort fields a permutation variant shares with the first one: only
# the subject-to-score pairing may differ across permutation seeds
PERMUT_SHARED_FIELDS = ("x", "adj", "snps", "y", "clust_y", "tsne_fdim")


def cross_validation_permut_batch(variants, topo: GoTopology,
                                  mcfg: ModelConfig, tcfg: TrainConfig, *,
                                  res_dirs, result_file_name: str = "result",
                                  clinical_score_index: Optional[int] = None,
                                  loggers=None,
                                  model_kind: str = "sgcn_imgsnp",
                                  verbose: bool = True,
                                  device: str | torch.device | None = None
                                  ) -> List[CVResult]:
    """A permutation null of S seeds as one batched program (the JAX
    package's `cross_validation_permut_batch`). `variants` are
    (seed label, cohort) pairs of the same subjects with per-seed shuffled
    subject-to-score pairings; splits, inits, dropout streams and epoch
    permutations are those of `tcfg.seed`, shared by every seed, and only
    the imputed clinical scores differ. Each seed's outputs are those of a
    standalone fold-parallel `--isPermutTest --Seed4PermutTest <s>` run."""
    _batch_preconditions(tcfg, "cross_validation_permut_batch")
    if not tcfg.is_permut_test:
        raise ValueError("cross_validation_permut_batch is the permutation-"
                         "null batch; tcfg.is_permut_test must be True")
    if clinical_score_index is None:
        clinical_score_index = tcfg.clinical_score_index
    if len(res_dirs) != len(variants):
        raise ValueError("one res_dir per variant required")
    base = variants[0][1]
    for label, c in variants[1:]:
        for name in PERMUT_SHARED_FIELDS:
            if not np.array_equal(np.asarray(getattr(base, name)),
                                  np.asarray(getattr(c, name))):
                raise ValueError(
                    f"permut-batch variant {label!r} disagrees with the "
                    f"first variant on cohort field {name!r}; only the "
                    "subject->score pairing may differ across seeds")
    dev = resolve_device(device)
    splits = k_fold(base.y, tcfg.folds, tcfg.seed)
    entries = []
    for _, c in variants:
        full = cohort_batch_arrays(c)
        entries += [{"p": prepare_fold(c, full, split, fold, tcfg,
                                       clinical_score_index),
                     "seed": tcfg.seed, "fold": fold}
                    for fold, split in enumerate(splits)]
    runs = fold_parallel_runs(entries, topo, mcfg, tcfg, model_kind, dev)
    k = tcfg.folds
    return [cross_validation(
        c, topo, mcfg, tcfg, res_dir=res_dirs[i],
        result_file_name=result_file_name,
        clinical_score_index=clinical_score_index,
        logger=loggers[i] if loggers is not None else None,
        model_kind=model_kind, verbose=verbose, device=dev,
        trained=runs[i * k:(i + 1) * k])
        for i, (_, c) in enumerate(variants)]
