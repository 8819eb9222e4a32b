"""Nested-GNN subgraph extraction (a copy of `iggcn_tpu/data/nested.py`;
host NumPy, so every array, the seeded `max_nodes_per_hop` draws
included, is bit-equal to the JAX package's).

For every node of a graph its h-hop rooted subgraph is extracted, and all
subgraphs of one graph are re-batched as one disconnected (block-diagonal)
dense union graph with a node -> subgraph assignment in `assign`, hop or
shortest-path-distance labels in `z` and, optionally, resistance
distances in `rd` and random-walk return probabilities appended to the
features. The union graph holds up to N^2 nodes: the nested routes are
for TU-sized graphs (tens of nodes), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from iggcn_tpu_torch.data.tu import GraphDataset


def k_hop_subgraph(node: int, h: int, adj: np.ndarray,
                   max_nodes_per_hop: Optional[int] = None,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """BFS h-hop neighborhood of `node`.

    Returns (nodes, z) where `nodes[0] == node` (root first, then hop order)
    and `z[i]` is the hop distance of `nodes[i]` from the root — the 'hop'
    node-labeling scheme of `utils.py:150-160`. `max_nodes_per_hop`
    subsamples each frontier (parity `utils.py:141-144`).
    """
    n = adj.shape[0]
    visited = np.zeros(n, bool)
    visited[node] = True
    nodes = [node]
    hops = [0]
    frontier = np.array([node])
    for hop in range(1, h + 1):
        neigh = np.unique(np.nonzero(adj[frontier] != 0)[1])
        neigh = neigh[~visited[neigh]]
        if max_nodes_per_hop is not None and len(neigh) > max_nodes_per_hop:
            gen = rng if rng is not None else np.random.default_rng(0)
            neigh = gen.choice(neigh, max_nodes_per_hop, replace=False)
        if len(neigh) == 0:
            break
        visited[neigh] = True
        nodes.extend(int(v) for v in neigh)
        hops.extend([hop] * len(neigh))
        frontier = neigh
    return np.asarray(nodes), np.asarray(hops)


def spd_labels(nodes: np.ndarray, adj: np.ndarray, h: int,
               num_spd: int = 2) -> np.ndarray:
    """Top-`num_spd` BFS-ring distances per subgraph node from the root
    (parity `utils.py:182-198` 'spd' labels: every hop at which the frontier
    expansion reaches a node again, first `num_spd` kept)."""
    root = nodes[0]
    reached: dict = {int(root): [0]}
    frontier = np.array([root])
    node_set = set(int(v) for v in nodes)
    for hop in range(1, h + 1):
        neigh = np.unique(np.nonzero(adj[frontier] != 0)[1])
        neigh = np.asarray([v for v in neigh if int(v) in node_set])
        nxt = []
        for v in neigh:
            lst = reached.setdefault(int(v), [])
            if not lst:                       # first time -> joins frontier
                nxt.append(int(v))
            if len(lst) < num_spd and (not lst or lst[-1] != hop):
                lst.append(hop)
        if not nxt:
            break
        frontier = np.asarray(nxt, dtype=np.int64)
    z = np.zeros((len(nodes), num_spd), np.int64)
    for i, v in enumerate(nodes):
        dists = reached.get(int(v), [])[:num_spd]
        z[i, :len(dists)] = dists
    return z


def drnl_labels(nodes: np.ndarray, adj: np.ndarray, h: int) -> np.ndarray:
    """Double-radius node labels (parity `utils.py:189-204`, the SEAL
    labeling as a special case of spd2): dist1*(h+1)+dist2 when a second
    ring distance exists, else dist1."""
    spd = spd_labels(nodes, adj, h, num_spd=2)
    d1, d2 = spd[:, 0], spd[:, 1]
    return np.where(d2 == 0, d1, d1 * (h + 1) + d2)[:, None]


def return_prob(adj: np.ndarray, steps: int = 16) -> np.ndarray:
    """Random-walk return probabilities [P^1..P^steps]_{ii} per node
    (parity `utils.py:237-266`)."""
    deg = np.maximum(adj.sum(axis=1, keepdims=True), 1.0)
    p = adj / deg
    out = np.zeros((adj.shape[0], steps), np.float32)
    pk = np.eye(adj.shape[0])
    for s in range(steps):
        pk = pk @ p
        out[:, s] = np.diag(pk)
    return out


def resistance_distance(adj: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Resistance distance from the root (nodes[0]) to each subgraph node via
    the pseudo-inverse Laplacian (parity `utils.py` rd labels)."""
    sub = adj[np.ix_(nodes, nodes)]
    lap = np.diag(sub.sum(axis=1)) - sub
    pinv = np.linalg.pinv(lap)
    r = pinv[0, 0] + np.diag(pinv) - 2 * pinv[0]
    return np.maximum(r, 0.0).astype(np.float32)[:, None]


@dataclasses.dataclass
class NestedGraphDataset(GraphDataset):
    """Union-of-subgraphs dense dataset.

    `x`/`adj`/`mask` cover the union graph (all rooted subgraphs of one
    original graph, block-diagonal); `assign` maps each union node to its
    subgraph id in [0, num_subgraphs); `z` holds integer hop labels and `rd`
    resistance distances when requested.
    """

    num_subgraphs: int = 0
    z: Optional[np.ndarray] = None    # (S, M, K) int node labels
    rd: Optional[np.ndarray] = None   # (S, M, 1) resistance distance


def create_nested_dataset(dataset: GraphDataset, h: int = 1, *,
                          max_nodes_per_hop: Optional[int] = None,
                          node_label: str = "hop",
                          use_rd: bool = False,
                          use_return_prob: bool = False,
                          return_prob_steps: int = 16,
                          seed: int = 0) -> NestedGraphDataset:
    """Replace every graph with the union of its per-node h-hop rooted
    subgraphs (parity `utils.py:18-122`).

    Each original node i yields a subgraph rooted at i; the union graph is
    their disjoint (block-diagonal) sum. Features are copied per subgraph
    node; hop labels go to `z`; `assign[m]` = subgraph id of union node m.
    """
    rng = np.random.default_rng(seed)
    s = len(dataset)
    f = dataset.num_features
    sizes = []
    per_graph: List[dict] = []
    for g in range(s):
        n = int(dataset.mask[g].sum())
        adj = dataset.adj[g, :n, :n]
        xg = dataset.x[g, :n]
        rp = (return_prob(adj, steps=return_prob_steps) if use_return_prob else None)
        ux, urows, uz, urd, uassign = [], [], [], [], []
        blocks = []
        offset = 0
        for i in range(n):
            nodes, hops = k_hop_subgraph(i, h, adj, max_nodes_per_hop, rng)
            k = len(nodes)
            feat = xg[nodes]
            if use_return_prob:
                feat = np.concatenate([feat, rp[nodes]], axis=1)
            ux.append(feat)
            if node_label == "hop":
                uz.append(hops[:, None])
            elif node_label.startswith("spd"):
                num_spd = int(node_label[3:]) if len(node_label) > 3 else 2
                uz.append(spd_labels(nodes, adj, h, num_spd))
            elif node_label == "drnl":
                uz.append(drnl_labels(nodes, adj, h))
            else:
                raise ValueError(f"unknown node_label {node_label}")
            if use_rd:
                urd.append(resistance_distance(adj, nodes))
            uassign.append(np.full(k, i, np.int64))
            blocks.append(adj[np.ix_(nodes, nodes)])
            offset += k
        per_graph.append(dict(
            x=np.concatenate(ux, axis=0),
            z=np.concatenate(uz, axis=0),
            rd=np.concatenate(urd, axis=0) if use_rd else None,
            assign=np.concatenate(uassign, axis=0),
            blocks=blocks, n=n))
        sizes.append(offset)

    m_max = max(sizes)
    n_max = dataset.x.shape[1]
    f_out = f + (return_prob_steps if use_return_prob else 0)
    x = np.zeros((s, m_max, f_out), np.float32)
    adj_u = np.zeros((s, m_max, m_max), np.float32)
    mask = np.zeros((s, m_max), bool)
    assign = np.zeros((s, m_max), np.int64)
    z_dim = per_graph[0]["z"].shape[1]
    z = np.zeros((s, m_max, z_dim), np.int64)
    rd = np.zeros((s, m_max, 1), np.float32) if use_rd else None
    for g, pg in enumerate(per_graph):
        m = pg["x"].shape[0]
        x[g, :m] = pg["x"]
        mask[g, :m] = True
        assign[g, :m] = pg["assign"]
        # padding nodes keep assign 0; pooling masks them out via `mask`
        z[g, :m] = pg["z"]
        if use_rd:
            rd[g, :m] = pg["rd"]
        off = 0
        for blk in pg["blocks"]:
            k = blk.shape[0]
            adj_u[g, off:off + k, off:off + k] = blk
            off += k
    return NestedGraphDataset(
        x=x, adj=adj_u, mask=mask, y=dataset.y, assign=assign,
        num_classes=dataset.num_classes, num_subgraphs=n_max, z=z, rd=rd)
