"""Results aggregator: summarize experiment dirs, compute permutation p-values
(the port's copy of `iggcn_tpu/tools/report.py`, host-side NumPy only).

It reads the fold records that either package writes, so a results dir of
the JAX package or of the port reports the same. `--plot` renders the
JAX tool's figures (`utils/plots.py`; matplotlib, which the card host
does not have).

The reference leaves analysis to the user: it prints one `Result - ...`
line per run, writes per-epoch score matrices as bare npys
(`kernel/train_eval_sgcn_img_snps.py:228-239`), and its permutation-test
mode (`--isPermutTest`) produces null runs it never aggregates. This tool
closes that loop host-side:

  * `collect_dir` reads every per-fold result record
    (`fold_result_*.npz`, written by all three trainers — present even for
    permutation runs, whose npy artifacts are suppressed for reference
    parity) plus legacy `result_*.npy` score matrices, and derives the
    reported surface: best epoch by fold-mean accuracy, acc +/- std across
    folds, and the other four metrics at that epoch.
  * `--permut_null` computes the standard permutation p-value
    p = (1 + #{null >= observed}) / (1 + N) of the observed best accuracy
    against the null runs' best accuracies.

Usage:
  python -m iggcn_tpu_torch.tools.report results/ADNI_a [results/ADNI_b ...]
  python -m iggcn_tpu_torch.tools.report results/ADNI_a \
      --permut_null results_permuttest/ADNI_p1 results_permuttest/ADNI_p2
  python -m iggcn_tpu_torch.tools.report results/ADNI_a --csv summary.csv
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from typing import Dict, List, Optional

import numpy as np

METRIC_NAMES = ("acc", "auc", "f1", "sen", "spe")
_RECORD_RE = re.compile(r"fold_result_(.+)_fold_(\d+)\.npz$")
_IMP_RE = re.compile(r"(node|snps|mask)_importance_(.+)_fold_(\d+)\.npy$")


def _score_matrix_rows(tag: str, mats: List[np.ndarray],
                       src: str) -> Optional[Dict]:
    """Aggregate per-fold (E, 5) score matrices into one summary row."""
    epochs = {m.shape[0] for m in mats}
    if len(epochs) != 1:
        print(f"[report] {src}: fold records of {tag} disagree on epoch "
              f"count {sorted(epochs)}; skipping", file=sys.stderr)
        return None
    score = np.stack(mats)                      # (folds, E, 5)
    acc_mean = score[:, :, 0].mean(axis=0)
    best = int(acc_mean.argmax())
    row = {
        "dir": src, "tag": tag,
        "folds": score.shape[0], "epochs": score.shape[1],
        # 1-based, matching the trainer's log lines (cv.py prints
        # `epoch:{e + 1}`) so the report cross-references log.txt directly
        "best_epoch": best + 1,
        "acc": float(acc_mean[best]),
        "acc_std": float(score[:, best, 0].std(ddof=1)
                         if score.shape[0] > 1 else 0.0),
    }
    for i, name in enumerate(METRIC_NAMES[1:], start=1):
        row[name] = float(score[:, best, i].mean())
    return row


def _load_records(res_dir: str) -> Dict[str, Dict[int, tuple]]:
    """Per-fold result records of one dir:
    `{tag: {fold: (score_mat (E, 5), test_losses (E,) or None)}}`."""
    groups: Dict[str, Dict[int, tuple]] = {}
    for path in sorted(glob.glob(os.path.join(res_dir, "fold_result_*.npz"))):
        m = _RECORD_RE.search(os.path.basename(path))
        if not m:
            continue
        tag, fold = m.group(1), int(m.group(2))
        try:
            with np.load(path) as zf:
                if "score_result_epoch" in zf.files:      # fused / snps
                    mat = np.asarray(zf["score_result_epoch"], np.float64)
                else:                                      # generic zoo
                    accs = np.asarray(zf["accs"], np.float64)
                    mat = np.full((accs.shape[0], 5), np.nan)
                    mat[:, 0] = accs
                losses = None
                for k in ("test_losses", "losses"):   # fused / zoo+snps
                    if k in zf.files:
                        arr = np.asarray(zf[k], np.float64)
                        if arr.shape == (mat.shape[0],):
                            losses = arr
                            break
        except Exception as e:
            print(f"[report] skipping unreadable {path} ({e})",
                  file=sys.stderr)
            continue
        groups.setdefault(tag, {})[fold] = (mat, losses)
    return groups


def collect_dir(res_dir: str) -> List[Dict]:
    """Summary rows for one results dir (one row per model/config tag)."""
    rows: List[Dict] = []
    groups = _load_records(res_dir)
    for tag, by_fold in sorted(groups.items()):
        row = _score_matrix_rows(tag,
                                 [by_fold[f][0] for f in sorted(by_fold)],
                                 res_dir)
        if row is not None:
            rows.append(row)
    # legacy aggregated score matrices (runs that predate fold records)
    seen = {r["tag"] for r in rows}
    for path in sorted(glob.glob(os.path.join(res_dir, "result_*.npy"))):
        tag = os.path.basename(path)[len("result_"):-len(".npy")]
        if ("result_" + tag) in seen or tag in seen:
            continue
        try:
            score = np.load(path)
        except Exception as e:
            print(f"[report] skipping unreadable {path} ({e})",
                  file=sys.stderr)
            continue
        if score.ndim != 3 or score.shape[2] != 5:
            continue
        row = _score_matrix_rows("result_" + tag, list(score), res_dir)
        if row is not None and row["tag"] not in seen:
            rows.append(row)
    return rows


def collect_regression(res_dir: str) -> List[Dict]:
    """Pooled regression metrics per (tag, clinical score) from the fused
    fold records' best-epoch true/pred score arrays (present even for
    permutation runs, whose score_{true,pred}_* npys are suppressed).
    Mirrors the trainer's own pooled summary (`cv.py` regression_summary:
    concatenate best-epoch test predictions over folds, then corr/r2/rmse
    per column)."""
    from iggcn_tpu_torch.train.metrics import regression_metrics

    groups: Dict[str, Dict[int, tuple]] = {}
    names_by_tag: Dict[str, List[str]] = {}
    for path in sorted(glob.glob(os.path.join(res_dir, "fold_result_*.npz"))):
        m = _RECORD_RE.search(os.path.basename(path))
        if not m:
            continue
        tag, fold = m.group(1), int(m.group(2))
        try:
            with np.load(path) as zf:
                if "true_scores" not in zf.files:
                    continue
                ts = np.asarray(zf["true_scores"], np.float64)
                ps = np.asarray(zf["pred_scores"], np.float64)
                if "score_names" in zf.files:
                    names_by_tag[tag] = [str(s) for s in zf["score_names"]]
        except Exception as e:
            print(f"[report] skipping unreadable {path} ({e})",
                  file=sys.stderr)
            continue
        if ts.ndim != 2 or ts.shape != ps.shape or not np.any(ps):
            continue          # regression-less family (zero placeholders)
        groups.setdefault(tag, {})[fold] = (ts, ps)
    rows: List[Dict] = []
    for tag, by_fold in sorted(groups.items()):
        ts = np.concatenate([by_fold[f][0] for f in sorted(by_fold)])
        ps = np.concatenate([by_fold[f][1] for f in sorted(by_fold)])
        corr, r2s, rmses = regression_metrics(ts, ps)
        names = names_by_tag.get(tag, [f"score{i}" for i in range(len(corr))])
        for i, nm in enumerate(names[:len(corr)]):
            rows.append({"dir": res_dir, "tag": tag, "score": nm,
                         "corr": float(corr[i]), "r2": float(r2s[i]),
                         "rmse": float(rmses[i])})
    return rows


def permutation_pvalue_regression(observed_rows: List[Dict],
                                  null_dirs: List[str]) -> List[Dict]:
    """Permutation p-value per (tag, score) on the pooled correlation —
    the statistic the reference's --isPermutTest mode exists to test (it
    shuffles the subject->score pairing) but never aggregates."""
    null_rows: List[Dict] = []
    for d in null_dirs:
        null_rows.extend(collect_regression(d))
    out = []
    for obs in observed_rows:
        nulls = [r["corr"] for r in null_rows
                 if r["tag"] == obs["tag"] and r["score"] == obs["score"]]
        if not nulls:
            continue
        ge = sum(1 for c in nulls if c >= obs["corr"] - 1e-12)
        out.append({"tag": obs["tag"], "score": obs["score"],
                    "observed_corr": obs["corr"], "null_n": len(nulls),
                    "null_mean": float(np.mean(nulls)),
                    "null_max": float(np.max(nulls)),
                    "p_value": (1 + ge) / (1 + len(nulls)),
                    "dir": obs["dir"], "nulls": nulls})
    return out


def _fmt(v) -> str:
    if isinstance(v, float):
        return "nan" if np.isnan(v) else f"{v:.4f}"
    return str(v)


COLUMNS = ("dir", "tag", "folds", "epochs", "best_epoch", "acc", "acc_std",
           "auc", "f1", "sen", "spe")


def render_table(rows: List[Dict], columns=COLUMNS) -> str:
    lines = ["| " + " | ".join(columns) + " |",
             "|" + "---|" * len(columns)]
    for r in rows:
        lines.append("| " + " | ".join(_fmt(r.get(c, "")) for c in columns)
                     + " |")
    return "\n".join(lines)


def render_csv(rows: List[Dict], columns=COLUMNS) -> str:
    lines = [",".join(columns)]
    for r in rows:
        lines.append(",".join(_fmt(r.get(c, "")) for c in columns))
    return "\n".join(lines) + "\n"


def _dedup_dirs(dirs: List[str], what: str) -> List[str]:
    """Drop repeated dirs (same realpath) keeping first-given spellings — a
    re-matching shell glob would otherwise double-count every tag and
    fabricate an across-run 'replication' of a dir with itself (or double
    every permutation null)."""
    seen, out = set(), []
    for d in dirs:
        rp = os.path.realpath(d)
        if rp in seen:
            print(f"[report] ignoring duplicate {what} dir {d}",
                  file=sys.stderr)
            continue
        seen.add(rp)
        out.append(d)
    return out


def permutation_pvalue(observed_rows: List[Dict], null_dirs: List[str]
                       ) -> List[Dict]:
    """Permutation p-value per observed tag: the observed statistic is the
    best fold-mean accuracy; the null distribution is the same statistic
    over the permutation runs (label-pairing shuffled, --isPermutTest).
    p = (1 + #{null >= obs}) / (1 + N) — the add-one estimator, unbiased
    under the null and never exactly zero."""
    null_rows: List[Dict] = []
    for d in null_dirs:
        null_rows.extend(collect_dir(d))
    out = []
    for obs in observed_rows:
        nulls = [r["acc"] for r in null_rows if r["tag"] == obs["tag"]]
        if not nulls:
            print(f"[report] no null runs found for tag {obs['tag']}",
                  file=sys.stderr)
            continue
        ge = sum(1 for a in nulls if a >= obs["acc"] - 1e-12)
        out.append({
            "tag": obs["tag"], "observed_acc": obs["acc"],
            "null_n": len(nulls),
            "null_mean": float(np.mean(nulls)),
            "null_max": float(np.max(nulls)),
            "p_value": (1 + ge) / (1 + len(nulls)),
            # not printed columns: the rows of the JAX tool, whose --plot
            # reads them
            "dir": obs["dir"], "nulls": nulls,
        })
    return out


def replication_rows(rows: List[Dict]) -> List[Dict]:
    """Across-run aggregate per tag: when the SAME tag appears in >= 2 of
    the given dirs (e.g. `--cv_seeds` writes results/ADNI_x_seed<s> per
    seed), summarize the per-run best accuracies as mean +/- std — the same
    statistic the CLI prints as 'Replication over N seeds', recomputable
    from the records alone."""
    by_tag: Dict[str, List[Dict]] = {}
    for r in rows:
        by_tag.setdefault(r["tag"], []).append(r)
    out = []
    for tag, rs in sorted(by_tag.items()):
        if len(rs) < 2:
            continue
        accs = np.asarray([r["acc"] for r in rs])
        out.append({"tag": tag, "runs": len(rs),
                    "acc_mean": float(accs.mean()),
                    "acc_std": float(accs.std(ddof=1)),
                    "acc_min": float(accs.min()),
                    "acc_max": float(accs.max())})
    return out


def collect_importance(res_dir: str) -> Dict[tuple, Dict[int, np.ndarray]]:
    """Per-fold importance vectors of one dir, in the ANALYSIS units the
    interpretability tests pin (`tests/test_interpretability.py`): the
    trainers export raw logits (`node_importance_*` is the (rois, feat)
    `prob` parameter — one ROI per ROW, so sigmoid then mean over the feat
    axis; `snps_importance_*` is the (1, n_snps) SNP logit row — one SNP
    per COLUMN, so sigmoid then flatten; reference `util/output.py:20-32`;
    `mask_importance_*` is the guide family's (d, 2) Gumbel-ST Bernoulli
    mask logits — softmax[:, 1] = feature keep-probability).
    Returns `{(kind, tag): {fold: (n_features,) vector}}`. Permutation
    dirs yield nothing (their importance npys are suppressed, parity)."""
    out: Dict[tuple, Dict[int, np.ndarray]] = {}
    for path in sorted(glob.glob(os.path.join(res_dir,
                                              "*_importance_*_fold_*.npy"))):
        m = _IMP_RE.search(os.path.basename(path))
        if not m:
            continue
        kind, tag, fold = m.group(1), m.group(2), int(m.group(3))
        try:
            arr = np.load(path)
        except Exception as e:
            print(f"[report] skipping unreadable {path} ({e})",
                  file=sys.stderr)
            continue
        a = np.asarray(arr, np.float64)
        if kind == "mask":
            e = np.exp(a - a.max(axis=-1, keepdims=True))
            v = (e / e.sum(axis=-1, keepdims=True))[:, 1]
        else:
            v = 1.0 / (1.0 + np.exp(-a))
            v = (v.mean(axis=1) if kind == "node" and v.ndim == 2
                 else v.reshape(-1))
        out.setdefault((kind, tag), {})[fold] = v
    return out


def importance_stability(results_dirs: List[str], top_k: int = 10
                         ) -> List[Dict]:
    """Aggregate the learned importances across replication units and score
    their SELECTION STABILITY — the across-replication check the framework's
    headline interpretability outputs otherwise lack (one run's top-k could
    be seed luck; a feature selected in every replicate is not).

    The replication unit is the RUN when a (kind, tag) appears in >= 2 of
    the given dirs (the per-seed layout `--cv_seeds` writes; each run
    contributes its fold-mean vector) and the FOLD within a single run
    otherwise. For each unit the top-`top_k` set is computed; a feature's
    stability is the fraction of units selecting it. Returns one row per
    top-`top_k` feature of the mean vector, ranked by mean importance."""
    runs: Dict[tuple, List[tuple]] = {}
    for d in results_dirs:
        for key, by_fold in collect_importance(d).items():
            vecs = [by_fold[f] for f in sorted(by_fold)]
            if len({v.shape for v in vecs}) != 1:
                print(f"[report] {d}: importance shapes of {key} disagree; "
                      "skipping", file=sys.stderr)
                continue
            runs.setdefault(key, []).append((d, np.stack(vecs)))
    rows: List[Dict] = []
    for (kind, tag), per_run in sorted(runs.items()):
        if len({m.shape[1] for _, m in per_run}) != 1:
            # e.g. a 90-ROI run and a 270-ROI --isMultiFusion run sharing a
            # (layers, hidden, h) tag — skip like the per-fold check above
            # instead of crashing the whole report on np.stack
            print(f"[report] importance widths of {(kind, tag)} disagree "
                  f"across dirs ({sorted({m.shape[1] for _, m in per_run})});"
                  " skipping", file=sys.stderr)
            continue
        if len(per_run) >= 2:
            unit = "run"
            mats = np.stack([m.mean(axis=0) for _, m in per_run])
        else:
            unit = "fold"
            mats = per_run[0][1]
        n_feat = mats.shape[1]
        k = min(top_k, n_feat)
        top_sets = [set(np.argsort(-row)[:k].tolist()) for row in mats]
        mean = mats.mean(axis=0)
        std = (mats.std(axis=0, ddof=1) if mats.shape[0] > 1
               else np.zeros(n_feat))
        name = {"node": "ROI", "snps": "SNP", "mask": "feature"}[kind]
        for i in np.argsort(-mean)[:k]:
            rows.append({
                "tag": tag, "kind": kind, "feature": f"{name} {int(i)}",
                "mean_importance": float(mean[i]),
                "importance_std": float(std[i]),
                "stability": float(np.mean([i in ts for ts in top_sets])),
                "unit": unit, "n_units": mats.shape[0],
                "dir": per_run[0][0], "mean_vector": mean,
                "item_name": name})
    return rows


def make_plots(results_dirs: List[str], pv: List[Dict],
               pvr: List[Dict], imp_rows: List[Dict] = ()) -> List[str]:
    """Figures for `--plot` (same conventions as `tools/explain.py --plot`):
    per-tag training curves (per-fold accuracy/loss over epochs, fold-mean
    strong with best epoch marked) next to each dir's records, — when
    p-values were computed — permutation-null histograms with the observed
    statistic marked, and — with --importance — sorted mean-importance bars
    next to the first dir holding each tag. Returns the written paths."""
    from iggcn_tpu_torch.utils.plots import (plot_importance_bar,
                                             plot_null_distribution,
                                             plot_training_curves)

    written: List[str] = []
    for d in results_dirs:
        for tag, by_fold in sorted(_load_records(d).items()):
            folds = sorted(by_fold)
            mats = [by_fold[f][0] for f in folds]
            if len({m.shape[0] for m in mats}) != 1:
                continue          # epoch-count mismatch; summary warns
            acc = np.stack([m[:, 0] for m in mats])
            losses = [by_fold[f][1] for f in folds]
            loss = (np.stack(losses)
                    if all(ls is not None for ls in losses) else None)
            written.append(plot_training_curves(
                acc, os.path.join(d, f"report_curves_{tag}.png"),
                title=f"{tag}: test accuracy by epoch", loss_by_fold=loss))
    for r in pv:
        written.append(plot_null_distribution(
            r["nulls"], r["observed_acc"], r["p_value"],
            os.path.join(r["dir"], f"report_null_{r['tag']}.png"),
            title=f"{r['tag']}: permutation null (best accuracy)"))
    for r in pvr:
        written.append(plot_null_distribution(
            r["nulls"], r["observed_corr"], r["p_value"],
            os.path.join(r["dir"], f"report_null_{r['tag']}_{r['score']}.png"),
            title=f"{r['tag']} / {r['score']}: permutation null "
                  "(pooled correlation)", statistic="pooled correlation"))
    done = set()
    for r in imp_rows:
        key = (r["kind"], r["tag"])
        if key in done:
            continue          # rows of one (kind, tag) share mean_vector
        done.add(key)
        written.append(plot_importance_bar(
            r["mean_vector"],
            os.path.join(r["dir"],
                         f"report_importance_{r['kind']}_{r['tag']}.png"),
            title=(f"{r['tag']}: mean {r['item_name']} importance over "
                   f"{r['n_units']} {r['unit']}s"),
            item_name=r["item_name"]))
    return written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results_dirs", nargs="+",
                   help="experiment results dir(s) (results/ADNI_<appendix>); "
                        "when the same config tag appears in >= 2 dirs (e.g. "
                        "the per-seed dirs of --cv_seeds), an across-run "
                        "replication table (acc mean +/- std) is added")
    p.add_argument("--permut_null", nargs="*", default=None,
                   help="permutation-run dirs (results_permuttest/...) to "
                        "compute p-values for the observed accuracies")
    p.add_argument("--csv", default=None,
                   help="also write the summary as CSV to this path (with "
                        "--importance, the stability table goes to a "
                        "sibling <path>_importance.csv)")
    p.add_argument("--plot", action="store_true", default=False,
                   help="also render figures (png) next to the records: "
                        "per-fold training curves per config tag, the "
                        "permutation-null histogram with the observed "
                        "statistic (with --permut_null), and mean-"
                        "importance bars (with --importance)")
    p.add_argument("--importance", action="store_true", default=False,
                   help="also aggregate the learned importances "
                        "(node_importance_*/snps_importance_* npys in "
                        "sigmoid analysis units; the guide family's "
                        "mask_importance_* in softmax keep-probability "
                        "units) and report each top "
                        "feature's SELECTION STABILITY: the fraction of "
                        "replication units (runs when a tag spans >= 2 "
                        "dirs, e.g. the --cv_seeds per-seed layout; folds "
                        "within a single run) whose top-k contains it. "
                        "Edge importance is per-subject (edge_prob_bias "
                        "npys hold scorer weights, not edge scores) — use "
                        "python -m iggcn_tpu_torch.tools.explain with "
                        "--x_npy for edge heatmaps")
    p.add_argument("--importance_top_k", type=int, default=10,
                   help="k of the per-unit top-k selection sets (and the "
                        "number of features reported) for --importance")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.importance and args.importance_top_k < 1:
        print("[report] --importance_top_k must be >= 1", file=sys.stderr)
        return 1
    results_dirs = _dedup_dirs(args.results_dirs, "results")
    rows = []
    for d in results_dirs:
        rows.extend(collect_dir(d))
    if not rows:
        print("[report] no result records found (fold_result_*.npz / "
              "result_*.npy) in the given dirs", file=sys.stderr)
        return 1
    print(render_table(rows))
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write(render_csv(rows))
        print(f"[report] wrote {args.csv}", file=sys.stderr)
    rep = replication_rows(rows)
    if rep:
        print()
        print(render_table(rep, ("tag", "runs", "acc_mean", "acc_std",
                                 "acc_min", "acc_max")))
    reg_rows = []
    for d in results_dirs:
        reg_rows.extend(collect_regression(d))
    if reg_rows:
        print()
        print(render_table(reg_rows,
                           ("dir", "tag", "score", "corr", "r2", "rmse")))
    imp_rows: List[Dict] = []
    if args.importance:
        imp_rows = importance_stability(results_dirs,
                                        top_k=args.importance_top_k)
        if imp_rows:
            cols = ("tag", "kind", "feature", "mean_importance",
                    "importance_std", "stability", "unit", "n_units")
            print()
            print(render_table(imp_rows, cols))
            if args.csv:
                base, ext = os.path.splitext(args.csv)
                imp_path = f"{base}_importance{ext or '.csv'}"
                with open(imp_path, "w") as fh:
                    fh.write(render_csv(imp_rows, cols))
                print(f"[report] wrote {imp_path}", file=sys.stderr)
        else:
            print("[report] no importance npys found (permutation dirs "
                  "suppress them; GCN_IMGSNP exports untrained values — "
                  "see PARITY.md)", file=sys.stderr)
    pv: List[Dict] = []
    pvr: List[Dict] = []
    if args.permut_null is not None:
        null_dirs = _dedup_dirs(args.permut_null, "null")
        pv = permutation_pvalue(rows, null_dirs)
        if pv:
            print()
            print(render_table(pv, ("tag", "observed_acc", "null_n",
                                    "null_mean", "null_max", "p_value")))
        pvr = permutation_pvalue_regression(reg_rows, null_dirs)
        if pvr:
            print()
            print(render_table(pvr, ("tag", "score", "observed_corr",
                                     "null_n", "null_mean", "null_max",
                                     "p_value")))
        if not (pv or pvr):
            return 1
    if args.plot:
        for path in make_plots(results_dirs, pv, pvr, imp_rows):
            print(f"[report] wrote {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
