"""Gene-Ontology DAG topology consumed by the GO network (port of
`iggcn_tpu/data/go_graph.py`).

The port's own copy of `GoTopology`, `synthetic_topology` (same fields,
same masks, same numpy draws, so one seed gives the same topology in both
packages) and of the parser that builds a topology from the real data
files: `parse_go_json` walks a PANTHER overrepresentation JSON in two
passes, merges the scraped root-connection chains, levels the DAG by BFS
from GO:0008150 (leaves first, root last) and builds the GO x SNP
incidence from `snps_to_gene.txt`, step for step as the JAX package does,
so both give the same topology from the same files.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------------------
# PANTHER JSON parsing
# ---------------------------------------------------------------------------

def _walk_pathways(data: dict, keep_ids: Optional[set] = None):
    """Yield (pathway_index, term_id, term_level, genes) in file order,
    skipping terms not in keep_ids when a filter is given."""
    for way_i, each_way in enumerate(data["overrepresentation"]["group"]):
        result = each_way["result"]
        terms = result if isinstance(result, list) else [result]
        for go_term in terms:
            term_id = go_term["term"]["id"]
            term_level = go_term["term"]["level"]
            if keep_ids is not None and term_id not in keep_ids:
                continue
            mapped = go_term["input_list"]["mapped_id_list"]["mapped_id"]
            genes = list(mapped) if isinstance(mapped, list) else [mapped]
            yield way_i, term_id, term_level, genes


def _parse_pass(data: dict, keep_ids: Optional[set] = None):
    """One parsing pass over the pathways.

    Returns (go_ids, go_ids_genes, edges(row=child, col=parent),
    subgraph_ids) mirroring `snps_graph.py:28-95` exactly: the edge for a term
    goes to the nearest previous term in the same pathway with a strictly
    smaller level; `subgraph_ids` collects first-terms, per-run roots and
    last terms (the filter set for the second pass).

    Reference quirk reproduced bug-for-bug: `go_ids_genes` appends one entry
    per term OCCURRENCE while `go_ids` dedupes (`snps_graph.py:131-141`), so
    when a GO term repeats across pathways the positional gene lists shift
    for all later ids — the reference consumes them positionally the same
    way (`preprocess_genes`, `snps_graph.py:219-226`).
    """
    go_ids: List[str] = []
    go_ids_genes: List[List[str]] = []
    go_adj_row: List[int] = []
    go_adj_col: List[int] = []
    go_subgraph_ids: List[str] = []

    current_way = -1
    go_index_perway: List[int] = []
    go_level_perway: List[int] = []
    current_root = -1
    term_index = -1
    first_in_way = True

    def end_way():
        nonlocal term_index
        if term_index >= 0 and keep_ids is None:
            if go_ids[term_index] not in go_subgraph_ids:
                go_subgraph_ids.append(go_ids[term_index])

    for way_i, term_id, term_level, genes in _walk_pathways(data, keep_ids):
        if way_i != current_way:
            end_way()
            current_way = way_i
            go_index_perway, go_level_perway = [], []
            current_root, term_index = -1, -1
            first_in_way = True

        go_ids_genes.append(genes)
        if term_id not in go_ids:
            go_ids.append(term_id)
        term_index = go_ids.index(term_id)

        if keep_ids is None and first_in_way and term_id not in go_subgraph_ids:
            go_subgraph_ids.append(term_id)
        first_in_way = False

        for idx in range(len(go_level_perway) - 1, -1, -1):
            if term_level > go_level_perway[idx]:
                go_adj_col.append(go_index_perway[idx])
                go_adj_row.append(term_index)
                break
        if len(go_level_perway) == 0 or term_level > go_level_perway[-1]:
            current_root = term_index
        else:
            if keep_ids is None and current_root >= 0:
                if go_ids[current_root] not in go_subgraph_ids:
                    go_subgraph_ids.append(go_ids[current_root])
            current_root = term_index

        go_index_perway.append(term_index)
        go_level_perway.append(term_level)

    end_way()
    return go_ids, go_ids_genes, go_adj_row, go_adj_col, go_subgraph_ids


def merge_root_connections(connection_path: str, go_ids: List[str],
                           go_adj_row: List[int], go_adj_col: List[int]
                           ) -> Tuple[List[str], np.ndarray]:
    """Merge CTD root-connection chains and build the dense 0/1 adjacency.

    Parity: `snps_get_root_go_by_html.py:42-97`. Each line of the file is a
    dot-separated chain of GO numbers (without the "GO:" prefix); chain
    positions with 2 < idx < len-1 are skipped; consecutive kept terms get an
    edge (row=parent=earlier, col=child=later)... note the reference appends
    (row=pre_term, col=term): row is the *earlier/shallower* term here,
    opposite orientation to the JSON edges — both end up sym-ORed into one
    reachability structure by the BFS because `get_level` follows rows.
    """
    with open(connection_path, "r") as fh:
        for line in fh:
            go_terms = line.split(".")
            pre_term_index = -1
            for idx in range(len(go_terms)):
                if 2 < idx < len(go_terms) - 1:
                    continue
                term_id = "GO:" + go_terms[idx].replace("\n", "")
                if term_id not in go_ids:
                    go_ids.append(term_id)
                term_index = go_ids.index(term_id)
                if pre_term_index >= 0:
                    go_adj_col.append(term_index)
                    go_adj_row.append(pre_term_index)
                pre_term_index = term_index

    n = len(go_ids)
    adj = np.zeros((n, n), dtype=np.float64)
    adj[np.asarray(go_adj_row, dtype=int), np.asarray(go_adj_col, dtype=int)] = 1.0
    return go_ids, adj


# ---------------------------------------------------------------------------
# Level assignment / sorting / incidence
# ---------------------------------------------------------------------------

def bfs_levels(adj: np.ndarray, root_index: int) -> np.ndarray:
    """Min depth from root following adjacency rows (parity `snps_graph.py:177-183`,
    implemented iteratively — the reference recursion is exponential on DAGs)."""
    n = len(adj)
    level = np.full(n, np.inf)
    level[root_index] = 0
    frontier = [root_index]
    while frontier:
        nxt = []
        for u in frontier:
            for v in np.nonzero(adj[u] > 0)[0]:
                if level[v] > level[u] + 1:
                    level[v] = level[u] + 1
                    nxt.append(int(v))
        frontier = nxt
    return level


def build_go_gene_snps(go_ids_genes_list: Sequence[Sequence[str]],
                       root_index: int,
                       snps_to_gene_path: str) -> np.ndarray:
    """GO x SNP 0/1 incidence (parity `snps_graph.py:228-249`): entry (i, j)=1
    iff GO term i's gene list intersects SNP j's gene list; the root row is
    all ones."""
    snps_to_genes: List[set] = []
    with open(snps_to_gene_path, "r") as fh:
        for line in fh:
            snps_to_genes.append({g.replace("\n", "") for g in line.split(";")})
    num_go = len(go_ids_genes_list)
    num_snps = len(snps_to_genes)
    go_snps = np.zeros((num_go, num_snps))
    for i in range(num_go):
        gene_set = set(go_ids_genes_list[i])
        for j in range(num_snps):
            if gene_set & snps_to_genes[j]:
                go_snps[i, j] = 1
    go_snps[root_index, :] = 1
    return go_snps


def build_topology(go_ids: List[str], go_ids_genes: List[List[str]],
                   adj: np.ndarray,
                   snps_to_gene_path: str,
                   n_l: int = 4, num_levels: int = 5) -> GoTopology:
    """Level-sort the merged DAG and assemble the topology.

    Parity: `build_graph` (`snps_graph.py:251-293`). Gene lists exist only for
    JSON-derived terms; terms added from the root-connection file get empty
    lists (`preprocess_genes`, `snps_graph.py:219-226`).
    """
    genes_map: Dict[int, List[str]] = {i: go_ids_genes[i] for i in range(len(go_ids_genes))}
    for i in range(len(go_ids_genes), len(go_ids)):
        genes_map[i] = []
    go_ids_genes_list = [genes_map[i] for i in range(len(go_ids))]

    root_index = go_ids.index(ROOT_GO_ID)
    go_level = bfs_levels(adj, root_index)
    # the reference would crash later with an opaque LayerNorm shape error if
    # any term is unreachable from the root or deeper than num_levels-1
    # (pool would not cover all nodes); fail early with a useful message
    n_uncovered = int(np.sum(~np.isin(go_level, np.arange(num_levels))))
    if n_uncovered:
        bad = [go_ids[i] for i in range(len(go_ids))
               if go_level[i] not in range(num_levels)][:5]
        raise ValueError(
            f"{n_uncovered} GO terms are unreachable from {ROOT_GO_ID} or "
            f"deeper than level {num_levels - 1} (e.g. {bad}); check the "
            "root-connection file covers every retained term")

    sort_index = np.argsort(-go_level, kind="stable")
    go_level = go_level[sort_index]
    go_ids = [go_ids[i] for i in sort_index]
    go_ids_genes_list = [go_ids_genes_list[i] for i in sort_index]
    adj = adj[sort_index, :][:, sort_index]

    root_index = go_ids.index(ROOT_GO_ID)
    pool = [int(np.sum(go_level == lv)) for lv in range(num_levels - 1, -1, -1)]

    go_snps = build_go_gene_snps(go_ids_genes_list, root_index, snps_to_gene_path)
    return GoTopology(adj_child_parent=adj, go_snps=go_snps, pool=pool,
                      n_l=n_l, go_level=go_level, go_ids=go_ids,
                      go_genes=go_ids_genes_list)


def parse_go_json(json_path: str, connection_path: str,
                  snps_to_gene_path: str) -> GoTopology:
    """Full pipeline: two-pass JSON parse -> root-connection merge -> topology.

    Parity: `parse_go_json` (`snps_graph.py:13-95`) including the subgraph
    filtering second pass (`:97-175`).
    """
    with open(json_path) as fh:
        data = json.load(fh)
    # pass 1: discover the subgraph id set
    _, _, _, _, subgraph_ids = _parse_pass(data, keep_ids=None)
    # pass 2: re-parse keeping only subgraph terms
    go_ids, go_genes, rows, cols, _ = _parse_pass(data, keep_ids=set(subgraph_ids))
    go_ids, adj = merge_root_connections(connection_path, go_ids, rows, cols)
    return build_topology(go_ids, go_genes, adj, snps_to_gene_path)


# ---------------------------------------------------------------------------
# Synthetic topology (no data files needed)
# ---------------------------------------------------------------------------

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
