"""GO-DAG / graph visualization helper (the port's copy of
`iggcn_tpu/utils/visualize.py`).

Re-design of `util/GraphVisualization.py` (networkx DiGraph plotting of the
GO hierarchy, invoked from `snps_graph.py:333-376` in the reference, mostly
for offline inspection). Imports are gated: matplotlib/networkx are optional
(the card host has neither).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


class GraphVisualization:
    """Collect directed edges (+ optional per-node labels/levels) and render
    them with networkx. Mirrors the reference API: `addEdge` then
    `visualize`."""

    def __init__(self):
        self.edges: List[Tuple[int, int]] = []
        self.labels = {}

    def addEdge(self, a: int, b: int) -> None:
        self.edges.append((a, b))

    def add_edges(self, edges: Sequence[Tuple[int, int]]) -> None:
        self.edges.extend(tuple(e) for e in edges)

    def set_labels(self, labels: dict) -> None:
        self.labels.update(labels)

    def visualize(self, path: Optional[str] = None, *,
                  with_labels: bool = True, figsize=(12, 12)):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import networkx as nx
        except ImportError as e:  # pragma: no cover - optional deps
            raise RuntimeError(
                "visualization requires networkx + matplotlib") from e
        g = nx.DiGraph()
        g.add_edges_from(self.edges)
        fig = plt.figure(figsize=figsize)
        try:
            pos = nx.nx_agraph.graphviz_layout(g, prog="dot")
        except Exception:
            pos = nx.spring_layout(g, seed=0)
        nx.draw_networkx(g, pos, labels=self.labels or None,
                         with_labels=with_labels, node_size=80, font_size=6,
                         arrowsize=6)
        if path is not None:
            fig.savefig(path, dpi=200, bbox_inches="tight")
            plt.close(fig)
            return None
        return fig
