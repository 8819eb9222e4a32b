"""The benchmark's inputs in the port's own types: the GO DAG as a
`GoTopology`, a configuration's model block as a `ModelConfig`. The port
is imported here only when these are called (after the look for a
card)."""
from __future__ import annotations

import numpy as np


def topology(dag: dict):
    from iggcn_tpu_torch.data.go_graph import GoTopology
    n = int(dag["pool"].sum())
    return GoTopology(
        adj_child_parent=dag["adj_child_parent"].astype(np.float64),
        go_snps=dag["go_snps"].astype(np.float64),
        pool=[int(p) for p in dag["pool"]], n_l=len(dag["pool"]) - 1,
        go_level=np.zeros(n), go_ids=[f"GO:{i:07d}" for i in range(n)],
        go_genes=[[] for _ in range(n)])


def model_config(model: dict):
    from iggcn_tpu_torch.config import ModelConfig
    return ModelConfig(**dict(model, go_f_dim=tuple(model["go_f_dim"])))
