"""The work a computation needs, from its shapes alone: bytes and FLOPs of
the GCN stack's kernels (frozen from `chip_smoke.py`'s `stack_work`,
`grouped_work` and `backward_work`, which give PERF.md's Bound column)
and the model FLOPs of one graph through the fused model.

Bytes count each input read once and each output written once; FLOPs
count 2 per multiply-add. The model count takes the products of the
reference's dense formulation (elementwise work is left out), so its
share of a peak is a lower bound of what the device did.
"""
from __future__ import annotations

from typing import Sequence


def _params(f0: int, widths: Sequence[int]) -> int:
    dims = [f0] + list(widths)
    return sum(dims[i] * dims[i + 1] + dims[i + 1]
               for i in range(len(widths)))


def stack_work(b, n, f0, widths):
    """(bytes, flops) of the forward of B samples: P, x, the weights read,
    every layer's output written; products, bias and relu."""
    dims = [f0] + list(widths)
    nbytes = 4 * (b * n * n + b * n * f0 + b * n * sum(widths)
                  + _params(f0, widths))
    flops = b * sum(2 * n * dims[i] * dims[i + 1] + 2 * n * n * dims[i + 1]
                    + 2 * n * dims[i + 1] for i in range(len(widths)))
    return nbytes, flops


def grouped_work(f, b, n, f0, widths):
    """(bytes, flops) of the grouped forward: `stack_work` of F*B samples
    with F weight sets read once each."""
    nbytes, flops = stack_work(f * b, n, f0, widths)
    return nbytes + 4 * (f - 1) * _params(f0, widths), flops


def backward_work(f, b, n, f0, widths):
    """(bytes, flops) of the backward of F*B samples (F = 0: shared
    weights): P, x, the output gradient and each weight set read once;
    dP, dx and each set's dW, db written once; the recompute's and the
    backward's products and elementwise steps."""
    sets, s = max(f, 1), max(f, 1) * b
    dims = [f0] + list(widths)
    nbytes = 4 * (2 * s * n * n + 2 * s * n * f0 + s * n * sum(widths)
                  + 2 * sets * _params(f0, widths))
    per = 2 * n * n * sum(widths)                         # dP
    for fin, h in zip(dims[:-1], dims[1:]):
        per += 2 * n * fin * h + 2 * n * n * h + 2 * n * h  # a, P a + b, relu
        per += 2 * n * n * h + 2 * n * fin * h + 3 * n * h  # da, dW; mask, db
        per += 2 * n * h * fin + n * fin                    # e, + g
    return nbytes, s * per


def bound_s(nbytes: float, flops: float, bandwidth: float,
            peak: float) -> float:
    """The least time the card could take: the larger of bytes over its
    bandwidth and FLOPs over its peak."""
    return max(nbytes / bandwidth, flops / peak)


def pass_flops(model: dict, levels: Sequence[int]) -> int:
    """Model FLOPs of one plain forward pass of one graph of the fused
    model (`model`: the configuration's `model` block; `levels`: the GO
    DAG's level sizes, leaves first)."""
    n_roi, d = model["rois"], model["feat_dim"]
    widths = [model["hidden"]] * model["num_layers"]
    e = model["num_layers"] * model["hidden"]
    snps, c_in = model["num_snps"], model["go_in_f_dim"]
    fdims = [c_in] + list(model["go_f_dim"])
    n_l, l_dim, hl = model["go_n_l"], model["l_dim"], model["hidden_linear"]
    pool = list(levels)
    n = sum(pool)
    total = stack_work(1, n_roi, d, widths)[1]
    total += c_in * 2 * snps * n                               # gene encoding
    for i in range(n_l):                                       # encoder
        m, fi, fo = n - sum(pool[:i]), fdims[i], fdims[i + 1]
        total += 2 * 2 * m * fi * fo + 2 * 2 * m * fo + 2 * m * m * fo \
            + 2 * m * fo
    top = n - sum(pool[:n_l])
    total += 2 * top * fdims[-1] * (e + 1) + 2 * top * 32 + 2 * 32 * l_dim
    for i in range(n_l):                                       # decoder
        r, c = n - sum(pool[:n_l - i - 1]), n - sum(pool[:n_l - i])
        fi, fo = fdims[n_l - i], fdims[n_l - i - 1]
        total += 2 * 2 * c * fi * fo + 2 * r * c * fo
    total += 2 * n * fdims[0] + 2 * n * snps                  # readout, genes
    total += 2 * 2 * n_roi * e * e + 2 * 2 * top * e * e      # attention
    total += 2 * 2 * n_roi * top * e
    lin = n_roi * e + l_dim
    total += 2 * lin * hl + 2 * hl * model["num_classes"]
    total += 2 * (lin + n_roi * d) * hl + 2 * hl * model["num_regr"]
    return total


def masked_pass_flops(model: dict, levels: Sequence[int]) -> int:
    """One importance-masked pass: a plain pass plus the edge scorer's
    two projections of the masked features."""
    return pass_flops(model, levels) + 2 * 2 * model["rois"] \
        * model["feat_dim"]
