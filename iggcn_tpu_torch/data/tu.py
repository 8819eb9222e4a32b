"""Variable-size graph-classification datasets of the baseline zoo (a copy
of `iggcn_tpu/data/tu.py`; host NumPy, so every array is bit-equal to the
JAX package's for the same files or the same generator).

Graphs are padded to the dataset's largest node count: (S, N, F)
features, (S, N, N) dense adjacency, an (S, N) validity mask and the
graclus cluster ids of `ops/pool.py:greedy_matching` in `assign`.
`read_tu_dir` parses a raw TU-benchmark directory (with the
degree-feature fallback for graphs without node features);
`synthetic_tu_dataset` draws a MUTAG-shaped benchmark when no files are
there.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from iggcn_tpu_torch.ops.pool import greedy_matching


@dataclasses.dataclass
class GraphDataset:
    """Dense padded graph-classification dataset."""

    x: np.ndarray            # (S, N_max, F)
    adj: np.ndarray          # (S, N_max, N_max)
    mask: np.ndarray         # (S, N_max) bool validity
    y: np.ndarray            # (S,)
    assign: np.ndarray       # (S, N_max) graclus-style cluster ids
    num_classes: int

    def __len__(self):
        return self.x.shape[0]

    @property
    def num_features(self):
        return self.x.shape[-1]


def from_graph_list(xs: List[np.ndarray], adjs: List[np.ndarray],
                    ys: np.ndarray, num_classes: Optional[int] = None,
                    n_max: Optional[int] = None) -> GraphDataset:
    """Pad a list of (n_i, F) features + (n_i, n_i) adjacencies to N_max."""
    if n_max is None:
        n_max = max(a.shape[0] for a in adjs)
    s = len(xs)
    f = xs[0].shape[1]
    x = np.zeros((s, n_max, f), np.float32)
    adj = np.zeros((s, n_max, n_max), np.float32)
    mask = np.zeros((s, n_max), bool)
    assign = np.zeros((s, n_max), np.int64)
    for i, (xi, ai) in enumerate(zip(xs, adjs)):
        n = ai.shape[0]
        x[i, :n] = xi
        adj[i, :n, :n] = ai
        mask[i, :n] = True
        assign[i, :n] = greedy_matching(ai)
        assign[i, n:] = np.arange(n, n_max)  # pads in singleton clusters
    if num_classes is None:
        num_classes = int(np.max(ys)) + 1
    return GraphDataset(x=x, adj=adj, mask=mask, y=np.asarray(ys, np.int64),
                        assign=assign, num_classes=num_classes)


def degree_features(adjs: List[np.ndarray], max_degree: int = 10
                    ) -> List[np.ndarray]:
    """One-hot degree node features (parity `kernel/datasets.py:30-41` for
    datasets without node attributes)."""
    out = []
    for a in adjs:
        deg = np.minimum((a != 0).sum(axis=1), max_degree).astype(int)
        one = np.zeros((a.shape[0], max_degree + 1), np.float32)
        one[np.arange(a.shape[0]), deg] = 1.0
        out.append(one)
    return out


def normalized_degree_features(adjs: List[np.ndarray]) -> List[np.ndarray]:
    """Z-scored scalar degree feature (parity `kernel/datasets.py:15-24,
    62-67`: used instead of one-hot when the global max degree >= 1000)."""
    degs = np.concatenate([(a != 0).sum(axis=1).astype(np.float64)
                           for a in adjs])
    mean, std = degs.mean(), degs.std()
    return [(((a != 0).sum(axis=1).astype(np.float32) - mean)
             / std)[:, None].astype(np.float32) for a in adjs]


def read_tu_dir(root: str, name: str) -> GraphDataset:
    """Parse a standard raw TU-benchmark directory into a dense GraphDataset.

    Capability parity with the reference's vendored TUDataset + get_dataset
    plumbing (`kernel/tu_dataset.py:11-154` process()-> PyG read_tu_data,
    `kernel/datasets.py:27-91`): reads `<name>_A.txt` (1-based "row, col"
    edge list), `<name>_graph_indicator.txt` (1-based per-node graph id),
    `<name>_graph_labels.txt` (arbitrary ints, remapped to 0..C-1 by sorted
    unique value), optional `<name>_node_labels.txt` (ints -> one-hot) and
    `<name>_node_attributes.txt` (comma-separated floats); node features are
    [attributes || one-hot labels]. Edge labels/attributes are ignored (the
    reference nulls edge_attr at `kernel/datasets.py:53`). Graphs without
    any node feature get the degree fallback: one-hot up to the global max
    degree when < 1000, else the z-scored scalar degree
    (`kernel/datasets.py:55-67`). Self-loops are dropped; duplicate edges
    collapse in the dense adjacency.

    Files may live at `<root>/<name>/` or `<root>/<name>/raw/`.
    """
    import os

    base = os.path.join(root, name)
    if not os.path.exists(os.path.join(base, f"{name}_A.txt")):
        raw = os.path.join(base, "raw")
        if os.path.exists(os.path.join(raw, f"{name}_A.txt")):
            base = raw
        else:
            raise FileNotFoundError(
                f"no {name}_A.txt under {base} or {base}/raw")

    def path(suffix):
        return os.path.join(base, f"{name}_{suffix}.txt")

    indicator = np.loadtxt(path("graph_indicator"), dtype=np.int64,
                           delimiter=",").reshape(-1)
    edges = np.loadtxt(path("A"), dtype=np.int64, delimiter=",", ndmin=2)
    graph_labels = np.loadtxt(path("graph_labels"), dtype=np.int64,
                              delimiter=",").reshape(-1)
    _, ys = np.unique(graph_labels, return_inverse=True)

    num_nodes = indicator.shape[0]
    num_graphs = int(indicator.max())
    # node index offsets per graph (nodes of one graph are contiguous)
    first_node = np.zeros(num_graphs + 1, np.int64)
    counts = np.bincount(indicator, minlength=num_graphs + 1)
    first_node[1:] = np.cumsum(counts)[:-1]

    feats = None
    if os.path.exists(path("node_attributes")):
        feats = np.loadtxt(path("node_attributes"), dtype=np.float32,
                           delimiter=",", ndmin=2)
        if feats.shape[0] != num_nodes:
            raise ValueError("node_attributes row count mismatch")
    if os.path.exists(path("node_labels")):
        # one-hot each label column separately and concatenate
        # (PyG read_tu_data parity for multi-column node_labels files)
        nl = np.loadtxt(path("node_labels"), dtype=np.int64,
                        delimiter=",", ndmin=2)
        if nl.shape[0] != num_nodes:
            raise ValueError("node_labels row count mismatch")
        hots = []
        for c in range(nl.shape[1]):
            col = nl[:, c] - nl[:, c].min()
            oh = np.zeros((num_nodes, int(col.max()) + 1), np.float32)
            oh[np.arange(num_nodes), col] = 1.0
            hots.append(oh)
        one_hot = np.concatenate(hots, axis=1)
        feats = (one_hot if feats is None
                 else np.concatenate([feats, one_hot], axis=1))

    xs: List[np.ndarray] = []
    adjs: List[np.ndarray] = []
    for g in range(num_graphs):
        n = int(counts[g + 1])
        adjs.append(np.zeros((n, n), np.float32))
        if feats is not None:
            xs.append(feats[first_node[g + 1]:first_node[g + 1] + n])
    # vectorized edge placement (real TU benchmarks have millions of edges)
    eg = indicator[edges[:, 0] - 1] - 1            # 0-based graph per edge
    ei = edges[:, 0] - 1 - first_node[eg + 1]      # local node indices
    ej = edges[:, 1] - 1 - first_node[eg + 1]
    keep = ei != ej                 # drop self loops (PyG read_tu_data parity)
    eg, ei, ej = eg[keep], ei[keep], ej[keep]
    order = np.argsort(eg, kind="stable")
    eg, ei, ej = eg[order], ei[order], ej[order]
    bounds = np.searchsorted(eg, np.arange(num_graphs + 1))
    for g in range(num_graphs):
        lo, hi = bounds[g], bounds[g + 1]
        adjs[g][ei[lo:hi], ej[lo:hi]] = 1.0

    if feats is None:
        max_deg = max(int((a != 0).sum(axis=1).max()) if a.size else 0
                      for a in adjs)
        xs = (degree_features(adjs, max_degree=max_deg) if max_deg < 1000
              else normalized_degree_features(adjs))
    return from_graph_list(xs, adjs, ys.astype(np.int64))


def synthetic_tu_dataset(rng: np.random.Generator, *, num_graphs: int = 120,
                         n_min: int = 8, n_max: int = 24,
                         num_classes: int = 2, feat_dim: int = 0
                         ) -> GraphDataset:
    """MUTAG-shaped synthetic benchmark: class-dependent edge density, sizes
    in [n_min, n_max]; degree one-hot features when feat_dim == 0."""
    xs, adjs = [], []
    ys = rng.integers(0, num_classes, num_graphs)
    for i in range(num_graphs):
        n = int(rng.integers(n_min, n_max + 1))
        p = 0.15 + 0.25 * (ys[i] / max(num_classes - 1, 1))
        a = (rng.random((n, n)) < p).astype(np.float32)
        a = np.triu(a, 1)
        a = a + a.T
        # ensure connectivity-ish: ring backbone
        for j in range(n):
            a[j, (j + 1) % n] = a[(j + 1) % n, j] = 1.0
        adjs.append(a)
        if feat_dim > 0:
            xs.append(rng.normal(ys[i] * 0.3, 1.0, (n, feat_dim)
                                 ).astype(np.float32))
    if feat_dim == 0:
        xs = degree_features(adjs)
    return from_graph_list(xs, adjs, ys, num_classes=num_classes)
