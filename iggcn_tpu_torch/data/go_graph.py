"""Gene-Ontology DAG topology consumed by the GO network.

The port's own copy of `iggcn_tpu.data.go_graph`'s `GoTopology` and
`synthetic_topology` (same fields, same masks, same numpy draws, so one
seed gives the same topology in both packages). The JSON/DAG parser that
builds a topology from the real data files comes with the host-data slice;
a serving bundle carries its topology arrays, so serving needs no parser.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

ROOT_GO_ID = "GO:0008150"


@dataclasses.dataclass
class GoTopology:
    """Static GO-DAG structure consumed by `models/go_network.py`.

    Attributes:
      adj_child_parent: (n, n) 0/1, entry (child, parent) = 1, nodes sorted
        by descending level (leaves first, root last).
      go_snps: (n, num_snps) 0/1 GO x SNP incidence.
      pool: per-level node counts, leaves-first.
      go_level: (n,) BFS level per node (descending order).
      go_ids: node names.
    """

    adj_child_parent: np.ndarray
    go_snps: np.ndarray
    pool: List[int]
    n_l: int
    go_level: np.ndarray
    go_ids: List[str]
    go_genes: List[List[str]]

    @property
    def n(self) -> int:
        return len(self.adj_child_parent)

    @property
    def num_snps(self) -> int:
        return self.go_snps.shape[1]

    def encoder_masks(self, n_l: int) -> List[np.ndarray]:
        """Layer-i message mask over the surviving nodes: A = adj_child_parent.T
        (parent <- child messages), cumulatively slicing off the leading
        (deepest) pool[i] nodes per layer."""
        a = self.adj_child_parent.T
        masks = []
        for i in range(n_l):
            s = sum(self.pool[:i])
            masks.append((a[s:, s:] != 0))
        return masks

    def decoder_masks(self, n_l: int) -> List[np.ndarray]:
        """Layer-jj un-pooling mask (rows = grown node set, cols = current):
        rectangular slices of the raw child->parent adjacency."""
        a_t = self.adj_child_parent
        masks = []
        for i in range(n_l):
            r = sum(self.pool[:n_l - i - 1])
            c = sum(self.pool[:n_l - i])
            masks.append((a_t[r:, c:] != 0))
        return masks


def synthetic_topology(rng: np.random.Generator, *, num_levels: int = 5,
                       level_sizes: Optional[Sequence[int]] = None,
                       num_snps: int = 54, n_l: int = 4,
                       fanin: int = 2) -> GoTopology:
    """Random layered DAG shaped like the ADNI GO graph (leaves-first order,
    single root, every non-root node has >= 1 parent at a strictly shallower
    level)."""
    if level_sizes is None:
        level_sizes = [24, 16, 10, 6, 1][-num_levels:]
    if level_sizes[-1] != 1:
        raise ValueError("root level must have exactly one node")
    n = int(np.sum(level_sizes))
    # node ordering: deepest level first (leaves), root last
    level_of = np.concatenate([
        np.full(sz, num_levels - 1 - li) for li, sz in enumerate(level_sizes)])
    starts = np.concatenate([[0], np.cumsum(level_sizes)])
    adj = np.zeros((n, n))  # (child, parent)
    for li in range(0, num_levels - 1):          # li indexes blocks, 0=deepest
        lo, hi = starts[li], starts[li + 1]
        for child in range(lo, hi):
            # parents from any strictly shallower block
            plo = starts[li + 1]
            k = int(rng.integers(1, fanin + 1))
            parents = rng.choice(np.arange(plo, n), size=min(k, n - plo),
                                 replace=False)
            adj[child, parents] = 1
    # every child gets at least one parent in the next shallower block, so
    # the root reaches every node
    for li in range(0, num_levels - 1):
        lo, hi = starts[li], starts[li + 1]
        plo, phi = starts[li + 1], starts[li + 2]
        for child in range(lo, hi):
            if not adj[child, plo:phi].any():
                adj[child, int(rng.integers(plo, phi))] = 1
    go_level = level_of.astype(float)
    go_snps = (rng.random((n, num_snps)) < 0.25).astype(np.float64)
    go_snps[-1, :] = 1  # root row all ones
    pool = [int(sz) for sz in level_sizes]
    go_ids = [f"GO:{i:07d}" for i in range(n - 1)] + [ROOT_GO_ID]
    return GoTopology(adj_child_parent=adj, go_snps=go_snps, pool=pool,
                      n_l=n_l, go_level=go_level, go_ids=go_ids,
                      go_genes=[[] for _ in range(n)])
