"""The mesh paths on N gloo CPU ranks, one step or epoch each (the port's
counterpart of `dryrun_multichip` in the repository's `__graft_entry__.py`).

    python -m iggcn_tpu_torch.parallel.dryrun N

Runs, in one world of N spawned CPU ranks: the data-parallel step on
`make_mesh(N)` against the single step; the flagship's fold-parallel CV
on `fold_mesh(4)` when 4 divides N (4 x 2 at N = 8), else on
`fold_mesh(max(3, N // 2))`; 5 unequal folds (batch 4, 48 subjects) on
`fold_mesh(5)`; a permutation null and a CV-seed replication of 2 seeds
x 2 folds each as one seeds x folds program; and, in this process,
data-parallel serving on `make_mesh(N)` against one device. Prints one
`... ok` line per case and exits 1 on a failure.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import (permute_regression_targets,
                                       synthetic_cohort)
from iggcn_tpu_torch.data.batching import cohort_batch_arrays, pad_to_batches
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.parallel import mesh as meshlib

CPU = torch.device("cpu")
SMALL = dict(num_layers=1, hidden=4, hidden_linear=8, l_dim=8)


def _describe(m: meshlib.Mesh) -> str:
    return " x ".join(f"{n}={s}" for n, s in zip(m.axis_names, m.shape))


def dp_step_case(n: int):
    """(single loss, DP loss, largest parameter difference) of one step
    of the flagship at batch max(n, 8) rounded up to a multiple of n."""
    from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
    from iggcn_tpu_torch.train.steps import TrainState, train_step
    batch_size = -(-max(n, 8) // n) * n
    cohort = synthetic_cohort(np.random.default_rng(2),
                              num_subjects=batch_size)
    topo = synthetic_topology(np.random.default_rng(2))
    arrays = pad_to_batches({k: v for k, v in cohort_batch_arrays(cohort)
                             .items() if k != "sbj_id"}, batch_size)
    batch = {k: torch.as_tensor(v) for k, v in arrays.items()}
    mcfg, tcfg = ModelConfig(**SMALL), TrainConfig(epochs=1,
                                                   batch_size=batch_size)
    out = []
    for mesh in (None, meshlib.make_mesh(n, meshlib.world().devices)):
        model = FusedSGCN(mcfg, topo,
                          generator=torch.Generator().manual_seed(0),
                          device=CPU)
        state = TrainState(model, tcfg, 1)
        gen = torch.Generator().manual_seed(5)
        step = (train_step if mesh is None
                else meshlib.make_dp_train_step(train_step, mesh))
        loss = float(step(state, batch, mcfg, tcfg, gen))
        out.append((loss, {k: v.detach().clone()
                           for k, v in model.state_dict().items()}))
    (l1, p1), (l2, p2) = out
    return l1, l2, max(float((p1[k] - p2[k]).abs().max()) for k in p1)


def _cv(cohort, topo, tcfg, **kw):
    from iggcn_tpu_torch.train.cv import cross_validation
    return cross_validation(cohort, topo, ModelConfig(**SMALL), tcfg,
                            res_dir=None, verbose=False, device=CPU, **kw)


def world_cases(n: int):
    """Every case that runs in the world; rank 0's lines."""
    from iggcn_tpu_torch.train.cv import (cross_validation_permut_batch,
                                          cross_validation_seed_batch)
    devices = meshlib.world().devices
    lines = []
    l1, l2, dp = dp_step_case(n)
    if not (np.isfinite(l2) and abs(l2 - l1) <= 1e-5 * abs(l1)
            and dp <= 1e-4):
        raise RuntimeError(f"dp step on {n} ranks: loss {l2} vs single {l1},"
                           f" params differ by {dp}")
    lines.append(f"dp_step({n} ranks) ok, loss={l2:.4f} (single "
                 f"{l1:.4f}, params within {dp:.2e})")

    folds = 4 if n % 4 == 0 else max(3, n // 2)
    topo = synthetic_topology(np.random.default_rng(3))
    cohort = synthetic_cohort(np.random.default_rng(3),
                              num_subjects=max(8 * folds, 24))
    tcfg = TrainConfig(epochs=1, batch_size=8, folds=folds, seed=0,
                       fold_parallel=True, loss=LossWeights(disease=1.0))
    res = _cv(cohort, topo, tcfg)
    _finite(res.mean_test_loss, "fold_parallel")
    lines.append(f"fold_parallel(FusedSGCN, {folds} folds, mesh "
                 f"{_describe(meshlib.fold_mesh(folds, devices))}) ok, "
                 f"loss={res.mean_test_loss:.4f}")

    pad = synthetic_cohort(np.random.default_rng(5), num_subjects=48)
    res = _cv(pad, topo, TrainConfig(epochs=1, batch_size=4, folds=5, seed=7,
                                     fold_parallel=True,
                                     loss=LossWeights(disease=1.0)))
    _finite(res.mean_test_loss, "fold_parallel_padded")
    lines.append(f"fold_parallel_padded(5 unequal folds, batch 4, mesh "
                 f"{_describe(meshlib.fold_mesh(5, devices))}) ok, "
                 f"loss={res.mean_test_loss:.4f}")

    seeds, pfolds = (1, 2), 2
    grid = _describe(meshlib.fold_mesh(len(seeds) * pfolds, devices))
    ptcfg = TrainConfig(epochs=1, batch_size=8, folds=pfolds, seed=0,
                        no_val=True, fold_parallel=True, is_permut_test=True,
                        loss=LossWeights(regr=1.0))
    pres = cross_validation_permut_batch(
        [(s, permute_regression_targets(cohort, s)) for s in seeds], topo,
        ModelConfig(**SMALL), ptcfg, res_dirs=[None] * len(seeds),
        verbose=False, device=CPU)
    for r in pres:
        _finite(r.mean_test_loss, "permut_seed_parallel")
    lines.append(f"permut_seed_parallel({len(seeds)} seeds x {pfolds} folds,"
                 f" mesh {grid}) ok, losses="
                 + ",".join(f"{r.mean_test_loss:.4f}" for r in pres))

    ctcfg = TrainConfig(epochs=1, batch_size=8, folds=pfolds, seed=0,
                        no_val=True, fold_parallel=True,
                        loss=LossWeights(disease=1.0))
    cres = cross_validation_seed_batch(
        cohort, seeds, topo, ModelConfig(**SMALL), ctcfg,
        res_dirs=[None] * len(seeds), verbose=False, device=CPU)
    for r in cres:
        _finite(r.mean_test_loss, "cv_seed_parallel")
    lines.append(f"cv_seed_parallel({len(seeds)} seeds x {pfolds} folds, "
                 f"mesh {grid}) ok, losses="
                 + ",".join(f"{r.mean_test_loss:.4f}" for r in cres))
    return lines


def _finite(value: float, what: str) -> None:
    if not np.isfinite(value):
        raise RuntimeError(f"{what}: non-finite loss {value}")


def serving_case(n: int) -> str:
    """Data-parallel serving on `make_mesh(n)` CPU devices against one."""
    from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
    from iggcn_tpu_torch.predict import batched_forward
    topo = synthetic_topology(np.random.default_rng(3))
    cohort = synthetic_cohort(np.random.default_rng(4), num_subjects=30)
    model = FusedSGCN(ModelConfig(**SMALL), topo,
                      generator=torch.Generator().manual_seed(0),
                      device=CPU).eval()
    args = (cohort.x, cohort.adj, cohort.snps)
    one = batched_forward(model, *args, batch_size=8)
    par = batched_forward(model, *args, batch_size=8,
                          mesh=meshlib.make_mesh(n, [CPU] * n))
    agree = float((one["pred"] == par["pred"]).mean())
    err = float(np.abs(one["log_probs"] - par["log_probs"]).max())
    if err > 1e-5:
        raise RuntimeError(f"dp serving differs by {err}")
    return f"dp_serving({n} devices) ok, agree={agree:.2f}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, help="ranks (CPU processes)")
    args = p.parse_args(argv)
    lines = meshlib.launch(world_cases, (args.n,),
                           meshlib.make_mesh(devices=[CPU] * args.n),
                           threads=1)
    lines.append(serving_case(args.n))
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
