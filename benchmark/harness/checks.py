"""The numbers `correct` compares, and the look for JAX in the process."""
from __future__ import annotations

import sys
from typing import Dict, Iterable, List, Tuple

import numpy as np

# top-level module names the benchmark's process may not hold: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "iggcn_tpu")

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
NOUGHT_GRADIENT = 1e-3


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (the port, `iggcn_tpu_torch`, is not `iggcn_tpu`)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops & set(FORBIDDEN_MODULES))


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Iterable[str] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    keys = sorted(ref) if leaves is None else list(leaves)
    if not keys:
        return 0.0
    median = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in keys)


def moving_leaves(first_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference first gradient is at least
    NOUGHT_GRADIENT of the median leaf's."""
    median = float(np.median(list(first_grad.values())))
    return sorted(k for k, v in first_grad.items()
                  if v >= NOUGHT_GRADIENT * median)


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """Every reading against its limit: (all within, {name: {value,
    limit}}). A reading that is not a finite number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        good = bool(np.isfinite(value)) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
