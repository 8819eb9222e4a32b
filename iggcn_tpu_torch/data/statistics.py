"""Dataset statistics of the baseline zoo (a copy of
`iggcn_tpu/data/statistics.py`)."""
from __future__ import annotations

from typing import Dict

from iggcn_tpu_torch.data.tu import GraphDataset


def dataset_statistics(dataset: GraphDataset, name: str = "dataset"
                       ) -> Dict[str, float]:
    """Graphs / mean nodes / mean undirected edges / features / classes of a
    dense padded dataset (parity `kernel/statistics.py:4-16`)."""
    nodes = dataset.mask.sum(axis=1)
    edges = (dataset.adj != 0).sum(axis=(1, 2)) / 2
    return {
        "name": name,
        "graphs": len(dataset),
        "nodes": float(nodes.mean()),
        "edges": float(edges.mean()),
        "features": dataset.num_features,
        "classes": dataset.num_classes,
    }


def print_dataset(dataset: GraphDataset, name: str = "dataset") -> None:
    s = dataset_statistics(dataset, name)
    print("Name", s["name"])
    print("Graphs", s["graphs"])
    print("Nodes", s["nodes"])
    print("Edges", s["edges"])
    print("Features", s["features"])
    print("Classes", s["classes"])
    print()
