"""Carry weights between a flax variable tree and a port module.

The port's modules keep the flax module's names: a flax leaf
`params/go_network/w_inc_0/kernel` is the port's
`go_network.w_inc_0.weight`, transposed. Layers whose tensors map
differently from "same name, same layout, in `params`" declare it in a
`FLAX_LEAVES` table (`models/nn_compat.py`); every other parameter maps by
name as is. Buffers are not weights unless a table names them (the BN
running statistics, which live in `batch_stats`).

Both directions check every leaf: a missing or extra key or a shape that
differs raises, so a tree never loads half-way unnoticed.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


def _leaves(model: nn.Module) -> Iterator[Tuple[Path, torch.Tensor, bool]]:
    """(collection + flax path, tensor, transposed) for every weight."""
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        table = getattr(mod, "FLAX_LEAVES", None)
        if table is None:
            for name, p in mod.named_parameters(recurse=False):
                yield ("params",) + prefix + (name,), p, False
            continue
        for attr, (collection, leaf, transposed) in table.items():
            t = getattr(mod, attr)
            if t is not None:
                yield (collection,) + prefix + (leaf,), t, transposed


def _flatten(tree: Dict[str, Any], prefix: Path) -> Dict[Path, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def load_flax_variables(model: nn.Module, params: Dict[str, Any],
                        batch_stats: Dict[str, Any] | None = None) -> nn.Module:
    """Copy a flax param / batch_stats tree of arrays (nested dicts, as
    `load_bundle` or `jax.device_get(variables)` gives them) into `model`.
    Returns `model`."""
    given = {**_flatten(params, ("params",)),
             **_flatten(batch_stats or {}, ("batch_stats",))}
    want = {path: (t, tr) for path, t, tr in _leaves(model)}
    missing = sorted("/".join(p) for p in want.keys() - given.keys())
    extra = sorted("/".join(p) for p in given.keys() - want.keys())
    if missing or extra:
        raise KeyError(f"flax tree does not match {type(model).__name__}: "
                       f"missing {missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for path, (t, transposed) in want.items():
            arr = np.asarray(given[path], dtype=np.float32)
            if transposed:
                arr = arr.T
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: flax shape "
                                 f"{tuple(np.shape(given[path]))} does not fit "
                                 f"the port's {tuple(t.shape)}"
                                 + (" (transposed)" if transposed else ""))
            t.copy_(torch.from_numpy(np.array(arr, order="C")))
    return model


def to_flax_variables(model: nn.Module) -> Dict[str, Dict[str, Any]]:
    """{'params': ..., 'batch_stats': ...} nested dicts of float32 numpy
    arrays in the flax layout of `model`'s JAX counterpart."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for path, t, transposed in _leaves(model):
        arr = t.detach().cpu().numpy().astype(np.float32)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if path[-1] in node:
            raise ValueError(f"two port tensors map to {'/'.join(path)}")
        node[path[-1]] = np.ascontiguousarray(arr.T if transposed else arr)
    return out
