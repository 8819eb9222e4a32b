"""Layers and inits shared by the port's models (port of
`iggcn_tpu/models/nn_compat.py`).

Each layer here keeps the JAX package's parameter names and states how its
tensors map onto the flax variable tree (`FLAX_LEAVES`: torch attribute ->
(collection, flax leaf name, transposed)), which `tools/convert.py` reads
to carry weights across in both directions:

  * `TorchLinear`: y = x @ W^T + b with torch's default init; the flax
    kernel is (in, out), the torch weight (out, in).
  * `BatchNorm1d`: torch semantics for (B, C) and (B, C, L) input (feature
    axis 1). Train mode normalises with the biased batch variance over the
    real rows of a padded batch (a 0/1 `weight` per row) and stores the
    unbiased variance in the running statistics; eval mode reads them.
    Under a sharded batch (`parallel.mesh.sharded`) the statistics are
    those of the whole batch.
  * `NodeLayerNorm`: LayerNorm over the node axis of (B, N, F) with a
    per-node affine.
  * `dropout` / `node_dropout`: elementwise and Dropout2d-style (whole node
    rows of a (B, N, F) tensor) dropout from an explicit generator, or
    from a `NoiseSource` of uniforms drawn beforehand (the fold-parallel
    trainer draws each fold's from that fold's own generator, in the
    order the sequential forward would, and hands them in stacked under
    `torch.func.vmap`, where a generator cannot give each fold its own
    stream). `ShapeRecorder` records the draws' shapes once.
  * `add_gat_params` / `gat_layer`: the per-layer leaves of the dense GAT
    stack (`ops/gat.py`) under the flax names `gat_*_{i}`.

`promoted` casts a product's operands to their common type as
`jnp.promote_types` gives it: `jnp` runs a bf16 x fp32 product in fp32,
where torch's products refuse mixed types. bf16 serving (`predict.
cast_floating`) mixes them; everywhere else the operands share a type
and it changes nothing.

Init helpers draw from an explicit `torch.Generator` onto an explicit
device. Their values differ from JAX's for the same seed (the streams
cannot cross frameworks); weights are carried across with `tools/convert`.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
from torch import nn

from iggcn_tpu_torch.parallel import mesh


def promoted(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """`tensors` cast to their common type (`torch.promote_types`, which
    agrees with `jnp.promote_types` on the float types), for a product
    that may see bf16 and fp32 operands."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return tuple(t if t.dtype == dtype else t.to(dtype) for t in tensors)


def uniform(shape: Sequence[int], bound: float, generator, device
            ) -> torch.Tensor:
    """U(-bound, bound) drawn on the generator's device, placed on `device`."""
    src = generator.device if generator is not None else device
    t = torch.empty(tuple(shape), device=src).uniform_(
        -bound, bound, generator=generator)
    return t.to(device)


def normal(shape: Sequence[int], mean: float, std: float, generator, device
           ) -> torch.Tensor:
    src = generator.device if generator is not None else device
    t = torch.empty(tuple(shape), device=src).normal_(
        mean, std, generator=generator)
    return t.to(device)


def pyg_glorot(shape, generator, device) -> torch.Tensor:
    """PyG glorot: U(+-sqrt(6 / (fan_in + fan_out))) on an (in, out) kernel."""
    return uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])),
                   generator, device)


def pyg_glorot_att(shape, generator, device) -> torch.Tensor:
    """PyG GATConv attention-vector init: glorot over its (1, heads, C)
    parameter, U(+-sqrt(6 / (1 + C))) with one head, on a (C,) vector."""
    return uniform(shape, math.sqrt(6.0 / (1 + shape[-1])), generator, device)


def kaiming_uniform_a5(shape, generator, device) -> torch.Tensor:
    """torch kaiming_uniform_(a=sqrt(5)) on a 2-D tensor: U(+-1/sqrt(shape[1]))."""
    return uniform(shape, 1.0 / math.sqrt(max(shape[1], 1)), generator, device)


def torch_linear_init(shape, fan_in: int, generator, device) -> torch.Tensor:
    """nn.Linear's default: U(+-1/sqrt(fan_in))."""
    return uniform(shape, 1.0 / math.sqrt(max(fan_in, 1)), generator, device)


def lecun_normal(shape, fan_in: int, generator, device) -> torch.Tensor:
    """flax's default kernel init (`nn.Conv`): a normal of variance
    1 / fan_in truncated at two standard deviations, its scale corrected
    for the truncation."""
    std = math.sqrt(1.0 / max(fan_in, 1)) / 0.87962566103423978
    src = generator.device if generator is not None else device
    t = torch.nn.init.trunc_normal_(torch.empty(tuple(shape), device=src),
                                    std=std, a=-2 * std, b=2 * std,
                                    generator=generator)
    return t.to(device)


class TorchLinear(nn.Module):
    """nn.Linear semantics: y = x @ W^T + b, weight (out, in)."""

    FLAX_LEAVES = {"weight": ("params", "kernel", True),
                   "bias": ("params", "bias", False)}

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, generator=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch_linear_init(
            (out_features, in_features), in_features, generator, device))
        self.bias = (nn.Parameter(torch_linear_init(
            (out_features,), in_features, generator, device))
            if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = promoted(x, self.weight)
        y = x @ w.T
        return y + self.bias if self.bias is not None else y


# torch's BatchNorm momentum: running = (1 - m) * running + m * batch
BN_MOMENTUM = 0.1


def unbiased_var_factor(n_red: torch.Tensor | float) -> torch.Tensor | float:
    """Bessel's correction n / (n - 1) for the reduced element count: torch
    stores the unbiased variance in `running_var` while it normalises with
    the biased one."""
    if isinstance(n_red, torch.Tensor):
        return n_red / torch.clamp(n_red - 1.0, min=1.0)
    return n_red / max(n_red - 1.0, 1.0)


class BatchNorm1d(nn.Module):
    """torch.nn.BatchNorm1d semantics. (B, C): per feature; (B, C, L): per
    channel C over (B, L).

    Train mode normalises with the batch statistics, E[x^2] - E[x]^2 for
    the variance as the JAX package computes it; with a (B,) 0/1 `weight`
    only the real rows count, so a padded dense batch normalises exactly as
    its ragged original. The running statistics move by `BN_MOMENTUM`
    towards the batch mean and unbiased variance, and stay as they are on
    a batch without real rows. Eval mode normalises with them. While a
    shard of the batch is active (`parallel.mesh.sharded`), sum(w x),
    sum(w x^2) and sum(w) are summed over the data axis first, so each
    position normalises its rows with the whole batch's statistics and
    every position's running statistics end identical.
    """

    FLAX_LEAVES = {"scale": ("params", "scale", False),
                   "bias": ("params", "bias", False),
                   "running_mean": ("batch_stats", "mean", False),
                   "running_var": ("batch_stats", "var", False)}

    def __init__(self, num_features: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, device=device))
        self.register_buffer("running_var",
                             torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor, weight: torch.Tensor | None = None
                ) -> torch.Tensor:
        if x.dim() not in (2, 3):
            raise ValueError(f"BatchNorm1d expects 2-D/3-D input, got "
                             f"{x.dim()}-D")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = (0, 2) if x.dim() == 3 else (0,)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            if weight is None and mesh.active() is None:
                mean = x.mean(dim=axes)
                var = (x * x).mean(dim=axes) - mean * mean
                n_red = float(x.numel() // x.shape[1])
                rows = None
            else:
                if weight is None:
                    weight = x.new_ones(x.shape[0])
                w = weight.reshape((-1,) + (1,) * (x.dim() - 1))
                sx, sxx, rows = mesh.all_reduce_sum(
                    (x * w).sum(dim=axes), (x * x * w).sum(dim=axes),
                    weight.sum())
                n_red = torch.clamp(rows * (x.shape[2] if x.dim() == 3
                                                else 1), min=1.0)
                mean = sx / n_red
                var = sxx / n_red - mean * mean
            with torch.no_grad():
                m = BN_MOMENTUM
                new_mean = (1 - m) * self.running_mean + m * mean
                new_var = ((1 - m) * self.running_var
                           + m * (var * unbiased_var_factor(n_red)))
                if rows is not None:
                    has_real = rows > 0
                    new_mean = torch.where(has_real, new_mean,
                                           self.running_mean)
                    new_var = torch.where(has_real, new_var, self.running_var)
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        y = ((x - mean.reshape(shape))
             * torch.rsqrt(var.reshape(shape) + self.eps))
        return y * self.scale.reshape(shape) + self.bias.reshape(shape)


class NodeLayerNorm(nn.Module):
    """LayerNorm over the node axis of a (B, N, F) tensor with per-node
    affine: torch `nn.LayerNorm(N)` applied to x.permute(0, 2, 1)."""

    FLAX_LEAVES = {"scale": ("params", "scale", False),
                   "bias": ("params", "bias", False)}

    def __init__(self, num_nodes: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.num_nodes = num_nodes
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_nodes, device=device))
        self.bias = nn.Parameter(torch.zeros(num_nodes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != self.num_nodes:
            raise ValueError(f"expected {self.num_nodes} nodes, got "
                             f"{tuple(x.shape)}")
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.scale[None, :, None] + self.bias[None, :, None]


class NoiseSource:
    """Uniforms drawn beforehand, handed to the random sites of a forward
    in the order they draw (`uniform_noise`); used in place of a
    generator. Each draw must have the shape that site asks for."""

    def __init__(self, draws):
        self._draws = list(draws)
        self._next = 0

    def take(self, shape) -> torch.Tensor:
        if self._next >= len(self._draws):
            raise ValueError(f"the forward drew more than the "
                             f"{len(self._draws)} noise tensors given")
        u = self._draws[self._next]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"noise draw {self._next} has shape "
                             f"{tuple(u.shape)}; the site asks for "
                             f"{tuple(shape)}")
        self._next += 1
        return u

    def done(self) -> bool:
        return self._next == len(self._draws)

    def rows(self, lo: int, hi: int, total: int, dim: int = 0
             ) -> "NoiseSource":
        """The draws' rows [lo, hi) along the sample axis `dim`: a shard's
        part of uniforms drawn for the whole batch of `total` rows."""
        for i, u in enumerate(self._draws):
            if u.shape[dim] != total:
                raise ValueError(f"noise draw {i} has shape "
                                 f"{tuple(u.shape)}: its axis {dim} is not "
                                 f"the batch of {total} samples")
        return NoiseSource(u.narrow(dim, lo, hi - lo) for u in self._draws)


class ShapeRecorder(NoiseSource):
    """A noise source that records the shape of every draw (and returns
    uniforms from a throwaway generator): one forward with it lists the
    draws a forward of that model and batch shape makes."""

    def __init__(self):
        super().__init__(())
        self.shapes = []
        self._gen = torch.Generator().manual_seed(0)

    def take(self, shape) -> torch.Tensor:
        self.shapes.append(tuple(int(d) for d in shape))
        return torch.rand(tuple(shape), generator=self._gen)


def uniform_noise(shape, generator, device) -> torch.Tensor:
    """U(0, 1) of `shape`: the next draw of a `NoiseSource`, or drawn from
    an explicit torch.Generator on `device`."""
    if isinstance(generator, NoiseSource):
        return generator.take(shape)
    if generator is None:
        raise ValueError("train-mode dropout draws from an explicit "
                         "torch.Generator: pass generator= (on the inputs' "
                         "device), or set the dropout rates to 0")
    if generator.device.type != torch.device(device).type:
        raise ValueError(f"dropout generator is on {generator.device}, the "
                         f"input on {device}")
    return torch.rand(tuple(shape), generator=generator, device=device)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | NoiseSource | None) -> torch.Tensor:
    """Elementwise dropout: zero each entry with probability `rate`, scale
    the kept ones by 1 / (1 - rate). Draws nothing at rate 0."""
    if rate == 0.0:
        return x
    keep = uniform_noise(x.shape, generator, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def node_dropout(x: torch.Tensor, rate: float,
                 generator: torch.Generator | NoiseSource | None
                 ) -> torch.Tensor:
    """Dropout2d on (B, N, F): zero whole node rows with probability `rate`,
    scale the kept rows by 1 / (1 - rate). Draws nothing at rate 0."""
    if rate == 0.0:
        return x
    keep = uniform_noise(x.shape[:2] + (1,), generator, x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


def add_gat_params(module: nn.Module, num_layers: int, feat_dim: int,
                   hidden: int, generator, device) -> None:
    """Register the dense GAT stack's leaves on `module` under the flax
    names (`gat_w_{i}`, `gat_att_{src,dst,edge}_{i}`, `gat_lin_edge_{i}`,
    `gat_b_{i}`), initialised as PyG's GATConv is."""
    g, dev = generator, device
    for i in range(num_layers):
        fin = feat_dim if i == 0 else hidden
        leaves = {"w": pyg_glorot((fin, hidden), g, dev),
                  "att_src": pyg_glorot_att((hidden,), g, dev),
                  "att_dst": pyg_glorot_att((hidden,), g, dev),
                  "lin_edge": pyg_glorot((1, hidden), g, dev),
                  "att_edge": pyg_glorot_att((hidden,), g, dev),
                  "b": torch.zeros(hidden, device=dev)}
        for name, t in leaves.items():
            setattr(module, f"gat_{name}_{i}", nn.Parameter(t))


def gat_layer(module: nn.Module, i: int) -> GATParams:
    """Layer i's `GATParams` from the leaves `add_gat_params` registered."""
    from iggcn_tpu_torch.ops.gat import GATParams   # ops/gat imports this module
    return GATParams(*(getattr(module, f"gat_{name}_{i}") for name in
                       ("w", "att_src", "att_dst", "lin_edge", "att_edge",
                        "b")))
