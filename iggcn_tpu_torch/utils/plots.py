"""Static renderings of the interpretability artifacts (matplotlib, Agg;
the port's copy of `iggcn_tpu/utils/plots.py`, pixel for pixel).

The framework's headline outputs are learned importances (ROI / edge / SNP
probabilities, Gumbel keep-masks, grad-CAM saliency); the reference exports
them only as bare npys and leaves figures to the user. These helpers render
publication-style figures next to the npys (`tools/explain.py --plot`,
`tools/report.py --plot`).

Chart conventions (kept deliberately minimal and consistent):
  * magnitude-per-identity -> one sorted bar chart, ONE sequential hue
    (light->dark encodes nothing here; the bar length carries the value);
  * matrices (edge probabilities) -> single-hue sequential heatmap
    ("Blues", light->dark = magnitude) with a colorbar, never a rainbow;
  * recessive axes: no top/right spines, light value grid, neutral ink for
    all text; the npy next to the figure is the exact-value "table view".

matplotlib is an optional dependency (the card host has none; same gating
as `utils/visualize.py`): a plot without it raises with the install
hint.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

BAR_COLOR = "#3b6ea5"       # one mid-blue hue; single-series, no legend
INK = "#333333"
MUTED = "#777777"


def _plt():
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "matplotlib is required for --plot (install the [viz] extra)"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _style_axes(ax):
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(MUTED)
    ax.tick_params(colors=INK, labelsize=8)
    ax.xaxis.label.set_color(INK)
    ax.yaxis.label.set_color(INK)
    ax.title.set_color(INK)


def plot_importance_bar(values: np.ndarray, out_path: str, *, title: str,
                        item_name: str = "ROI",
                        names: Optional[Sequence[str]] = None,
                        top: int = 30) -> str:
    """Sorted horizontal bar chart of per-item importance (largest on top).

    `values`: (n,) importance in [0, 1] (pass probabilities, not logits).
    Shows the `top` largest items (the tail is summarized in the subtitle);
    the full vector lives in the npy next to the figure.
    """
    plt = _plt()
    v = np.asarray(values, np.float64).reshape(-1)
    order = np.argsort(v)[::-1]
    k = min(top, v.size)
    sel = order[:k]
    labels = ([str(names[i]) for i in sel] if names is not None
              else [f"{item_name} {i}" for i in sel])

    fig, ax = plt.subplots(figsize=(6, max(2.2, 0.24 * k + 1.2)))
    y = np.arange(k)[::-1]
    ax.barh(y, v[sel], height=0.62, color=BAR_COLOR, edgecolor="none")
    ax.set_yticks(y)
    ax.set_yticklabels(labels, fontsize=7)
    ax.set_xlabel("importance")
    sub = f"top {k} of {v.size}" if k < v.size else f"all {v.size}"
    ax.set_title(f"{title} ({sub})", fontsize=10, loc="left")
    ax.set_xlim(0, max(1.0, float(v[sel].max()) * 1.05))
    ax.grid(axis="x", color="#dddddd", linewidth=0.6)
    ax.set_axisbelow(True)
    _style_axes(ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_training_curves(acc_by_fold: np.ndarray, out_path: str, *,
                         title: str,
                         loss_by_fold: Optional[np.ndarray] = None) -> str:
    """Per-epoch training curves from the per-fold result records.

    `acc_by_fold`: (folds, E) test accuracy per epoch. Each fold draws as a
    thin muted line; the fold-mean (the aggregation statistic — the trainer
    reports max over epochs of fold-mean accuracy) draws strong with its
    best epoch marked. `loss_by_fold` (folds, E), when given, adds a second
    panel with the same encoding. One hue throughout: the series are one
    family (folds of one run), not categories.
    """
    plt = _plt()
    acc = np.atleast_2d(np.asarray(acc_by_fold, np.float64))
    panels = 1 if loss_by_fold is None else 2
    fig, axes = plt.subplots(panels, 1, figsize=(6, 2.6 * panels),
                             sharex=True, squeeze=False)
    epochs = np.arange(1, acc.shape[1] + 1)

    def draw(ax, mat, ylabel, mark_best):
        for row in mat:
            ax.plot(epochs, row, color=BAR_COLOR, alpha=0.25, linewidth=0.8)
        mean = mat.mean(axis=0)
        ax.plot(epochs, mean, color=BAR_COLOR, linewidth=1.8,
                label=f"fold mean ({mat.shape[0]} folds)")
        if mark_best:
            best = int(mean.argmax())
            ax.plot(epochs[best], mean[best], "o", color=INK, markersize=4)
            ax.annotate(f"best epoch {epochs[best]}: {mean[best]:.3f}",
                        (epochs[best], mean[best]), textcoords="offset points",
                        xytext=(6, 6), fontsize=7, color=INK)
        ax.set_ylabel(ylabel)
        ax.grid(axis="y", color="#dddddd", linewidth=0.6)
        ax.set_axisbelow(True)
        ax.legend(frameon=False, fontsize=7, loc="lower right",
                  labelcolor=INK)
        _style_axes(ax)

    draw(axes[0][0], acc, "test accuracy", mark_best=True)
    axes[0][0].set_title(title, fontsize=10, loc="left")
    if loss_by_fold is not None:
        loss = np.atleast_2d(np.asarray(loss_by_fold, np.float64))
        draw(axes[1][0], loss, "test loss", mark_best=False)
    axes[-1][0].set_xlabel("epoch")
    from matplotlib.ticker import MaxNLocator
    axes[-1][0].xaxis.set_major_locator(MaxNLocator(integer=True))
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_null_distribution(nulls: Sequence[float], observed: float,
                           p_value: float, out_path: str, *, title: str,
                           statistic: str = "accuracy") -> str:
    """Permutation-null histogram with the observed statistic marked.

    The nulls draw as a single-hue histogram; the observed value is a dark
    vertical line annotated with the add-one p-value. This is the picture
    behind `tools/report.py --permut_null`'s p-value table.
    """
    plt = _plt()
    nulls = np.asarray(list(nulls), np.float64)
    fig, ax = plt.subplots(figsize=(5.4, 3.2))
    bins = min(20, max(5, nulls.size))
    ax.hist(nulls, bins=bins, color=BAR_COLOR, alpha=0.75,
            edgecolor="white", linewidth=0.5,
            label=f"null runs (n={nulls.size})")
    ax.axvline(observed, color=INK, linewidth=1.6)
    ax.annotate(f"observed {observed:.3f}\np = {p_value:.4g}",
                (observed, ax.get_ylim()[1] * 0.95), ha="left", va="top",
                fontsize=8, color=INK, xytext=(5, 0),
                textcoords="offset points")
    ax.set_xlabel(f"{statistic} under label permutation")
    ax.set_ylabel("null runs")
    ax.set_title(title, fontsize=10, loc="left")
    ax.grid(axis="y", color="#dddddd", linewidth=0.6)
    ax.set_axisbelow(True)
    ax.legend(frameon=False, fontsize=7, labelcolor=INK)
    _style_axes(ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_matrix(mat: np.ndarray, out_path: str, *, title: str,
                axis_name: str = "ROI") -> str:
    """Single-hue sequential heatmap (light->dark = magnitude) of a square
    score matrix, e.g. the subject-mean edge probabilities."""
    plt = _plt()
    m = np.asarray(mat, np.float64)
    fig, ax = plt.subplots(figsize=(5.4, 4.6))
    im = ax.imshow(m, cmap="Blues", aspect="equal",
                   vmin=float(np.nanmin(m)), vmax=float(np.nanmax(m)))
    cb = fig.colorbar(im, ax=ax, shrink=0.85)
    cb.ax.tick_params(colors=INK, labelsize=8)
    ax.set_xlabel(axis_name)
    ax.set_ylabel(axis_name)
    ax.set_title(title, fontsize=10, loc="left")
    _style_axes(ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
