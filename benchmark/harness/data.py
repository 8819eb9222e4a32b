"""Inputs drawn from the seed: a cohort in the shapes of ADNI's, its GO
DAG, the permutation-test variants and the weights.

The real ADNI cohort is access-controlled, so the cohort is synthetic at
its published shapes: per subject an ROI graph (kNN-sparsified symmetric
weights with self loops, what the diffusion step of the loader hands the
model), ROI features with class-dependent means, SNP dosages in [0, 1],
nine demographics columns with the label first, t-SNE-like similarity
features and a cluster label. Large arrays are drawn on the device with a
`torch.Generator`, the DAG and the permutations on the host with NumPy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

# the demographics columns that hold the three regression targets (tau,
# adas13, mmse): the reference's `clinical_select_index`
CLINICAL_COLUMNS = (5, 7, 8)
DEMOGRAPHICS = 9
SIM_DIM = 8


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream named by `path` under `seed`."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(
        2, np.uint32).view(np.uint64)[0] >> np.uint64(1))


def go_dag(seed: int, levels: Sequence[int], num_snps: int,
           snp_share: float = 0.1) -> Dict[str, np.ndarray]:
    """A layered GO DAG, leaves first and the root last: every node below
    the root has one parent in the next shallower level and, with even
    odds, a second one anywhere shallower; each term holds a SNP with
    probability `snp_share`, the root every SNP."""
    if levels[-1] != 1:
        raise ValueError("the last level is the root and has one node")
    rng = np.random.default_rng(sub_seed(seed, 1))
    n = int(sum(levels))
    starts = np.concatenate([[0], np.cumsum(levels)]).astype(int)
    adj = np.zeros((n, n), np.float32)
    for li in range(len(levels) - 1):
        child = np.arange(starts[li], starts[li + 1])
        first = rng.integers(starts[li + 1], starts[li + 2], len(child))
        adj[child, first] = 1
        more = rng.random(len(child)) < 0.5
        second = rng.integers(starts[li + 1], n, len(child))
        adj[child[more], second[more]] = 1
    go_snps = (rng.random((n, num_snps)) < snp_share).astype(np.float32)
    go_snps[-1] = 1
    return {"adj_child_parent": adj, "go_snps": go_snps,
            "pool": np.asarray(levels, np.int64)}


def cohort(seed: int, subjects: int, rois: int, feat_dim: int,
           num_snps: int, num_classes: int, knn: int,
           device: torch.device) -> Dict[str, np.ndarray]:
    """Host arrays of one cohort: x (S, N, D), adj (S, N, N), snps (S, P),
    y (S,), clust_y (S,), tsne (S, 8), demographics (S, 9)."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, 2))
    kw = {"generator": g, "device": device}
    y = torch.randint(num_classes, (subjects,), **kw)
    mu = 0.5 * torch.randn(num_classes, rois, feat_dim, **kw)
    x = mu[y] + 0.5 * torch.randn(subjects, rois, feat_dim, **kw)
    adj = _graphs(subjects, rois, knn, kw)
    snp_mu = torch.rand(num_classes, num_snps, **kw)
    snps = (snp_mu[y] + 0.15 * torch.randn(subjects, num_snps, **kw)
            ).clamp(0, 1)
    demo = 0.5 + 0.2 * torch.randn(subjects, DEMOGRAPHICS, **kw)
    demo[:, 0] = y.float()
    tsne = x.mean(dim=2)[:, :SIM_DIM] + 0.05 * torch.randn(
        subjects, SIM_DIM, **kw)
    clust_y = torch.randint(2, (subjects,), **kw)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    return {"x": host(x), "adj": host(adj), "snps": host(snps),
            "y": host(y).astype(np.int64), "clust_y": host(clust_y),
            "tsne": host(tsne), "demographics": host(demo)}


def _graphs(subjects: int, rois: int, knn: int, kw) -> torch.Tensor:
    """Symmetric non-negative weights, each row's `knn` largest kept,
    symmetrised, with a self loop of weight 0.5 added; built in chunks of
    subjects to bound the device's temporaries."""
    out = torch.empty(subjects, rois, rois, device=kw["device"])
    for lo in range(0, subjects, 256):
        n = min(256, subjects - lo)
        base = torch.randn(n, rois, rois, **kw)
        corr = (base + base.transpose(1, 2)).abs_() * 0.5
        kth = corr.topk(knn, dim=2).values[..., -1:]
        corr = torch.where(corr >= kth, corr, torch.zeros(()).to(corr))
        sym = (corr + corr.transpose(1, 2)) * 0.5
        sym.diagonal(dim1=1, dim2=2).add_(0.5)
        out[lo:lo + n] = sym
    return out


def permutations(seed: int, count: int, subjects: int) -> List[np.ndarray]:
    """The subject -> score pairing of each permutation-null variant."""
    return [np.random.default_rng(sub_seed(seed, 3, v)).permutation(subjects)
            for v in range(count)]


def init_rule(name: str, shape: Sequence[int]):
    """(mean, std) of a weight's normal draw: norm scales and the GO
    network's multiplicative gene weights around 1, biases and running
    means around 0, running variances around 1, every other matrix
    N(0, 1 / fan-in) (fan-in: the last axis of a `.weight` in torch's
    (out, in) layout, else the first)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "running_var") or "gene_enc" in name \
            or "gene_dec" in name:
        return 1.0, 0.1
    if leaf in ("bias", "running_mean") or name.startswith("conv_b") \
            or name.endswith("_proj_bias"):
        return 0.0, 0.1
    fan_in = shape[-1] if leaf == "weight" or leaf.endswith("_weight") \
        else shape[0]
    return 0.0, 1.0 / np.sqrt(max(int(fan_in), 1))


def weight_sets(shapes: Dict[str, Sequence[int]], sets: int, seed: int,
                device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """`sets` independent weight sets on the device, from one normal draw
    of all their values."""
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    total = sum(sizes.values())
    g = torch.Generator(device).manual_seed(sub_seed(seed, 4))
    z = torch.randn(sets, total, generator=g, device=device)
    out = []
    for i in range(sets):
        parts = z[i].split(list(sizes.values()))
        ws = {}
        for (name, shape), part in zip(shapes.items(), parts):
            mean, std = init_rule(name, shape)
            v = part.reshape(tuple(shape)) * std + mean
            if name.endswith("running_var"):
                v = v.abs()
            ws[name] = v.contiguous()
        out.append(ws)
    return out
