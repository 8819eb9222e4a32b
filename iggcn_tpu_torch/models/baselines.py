"""Baseline models (port of `iggcn_tpu/models/baselines.py`). Only the
SNP-only `MLPModel` is ported so far; the graph zoo (GCN, GIN, pooling,
nested GNNs, the CNN) comes with its trainer (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import torch
from torch import nn

from iggcn_tpu_torch.models.nn_compat import TorchLinear, dropout


class MLPModel(nn.Module):
    """`MLP_Model`: num_snps -> 32 -> 16 -> 1 sigmoid SNP classifier, relu
    between the layers and dropout after the first. The JAX module is
    lazy (its input width comes from the data); here it is the
    constructor's `num_snps` (54 in the reference), and a serving bundle
    gives it from the weights. `dropout_rate` is an attribute so that
    tests can zero it."""

    CTOR_FIELDS = ()

    def __init__(self, num_snps: int = 54, *, dropout_rate: float = 0.3,
                 generator=None, device=None):
        super().__init__()
        g, dev = generator, device
        self.dropout_rate = dropout_rate
        self.fc1 = TorchLinear(num_snps, 32, generator=g, device=dev)
        self.fc2 = TorchLinear(32, 16, generator=g, device=dev)
        self.fc3 = TorchLinear(16, 1, generator=g, device=dev)

    @property
    def num_snps(self) -> int:
        return self.fc1.weight.shape[1]

    def forward(self, snps: torch.Tensor, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, 1) probabilities; train mode follows `self.training`
        (dropout from `generator`)."""
        h = torch.relu(self.fc1(snps))
        if self.training:
            h = dropout(h, self.dropout_rate, generator)
        h = torch.relu(self.fc2(h))
        return torch.sigmoid(self.fc3(h))
