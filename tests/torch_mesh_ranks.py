"""Rank-side functions of the port's mesh tests
(`tests/test_torch_port_mesh.py`, `tests/test_torch_port_mesh_cv.py`).

Spawned ranks import this module by its path, so it imports nothing of
JAX: each function runs inside a world of CPU ranks
(`iggcn_tpu_torch.parallel.mesh.launch`) and returns its results on every
rank (the launch keeps rank 0's).
"""
import contextlib
import functools
import os

import numpy as np
import torch

from iggcn_tpu_torch.config import LossWeights, ModelConfig, TrainConfig
from iggcn_tpu_torch.data.adni import synthetic_cohort
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.nn_compat import BatchNorm1d
from iggcn_tpu_torch.parallel import mesh as meshlib
from iggcn_tpu_torch.tools.convert import load_flax_variables, to_flax_variables
from iggcn_tpu_torch.train import losses, steps

CPU = torch.device("cpu")
PIECE_ROWS = (7, 3)      # batch rows of the pieces: unequal, and fewer than 4


def piece_inputs(rows: int, seed: int = 0):
    """The pieces' inputs: float64 arrays of `rows` samples, two padding
    rows (w = 0) where there are more than three."""
    rng = np.random.default_rng(seed + rows)
    w = np.ones(rows)
    if rows > 3:
        w[[1, rows - 1]] = 0.0
    return {"x2": rng.normal(size=(rows, 5)),
            "x3": rng.normal(size=(rows, 4, 6)),
            "r2": rng.normal(size=(rows, 5)),
            "r3": rng.normal(size=(rows, 4, 6)),
            "v": rng.normal(size=(rows, 3)),
            "z": rng.normal(size=(rows, 4)),
            "zw": rng.normal(size=(rows, 2 * rows)),
            "tsne": rng.normal(size=(rows, 3)),
            "clust_y": rng.integers(0, 3, size=rows).astype(np.float64),
            "pred": rng.normal(size=(rows, 6)),
            "target": rng.normal(size=(rows, 6)),
            "x": rng.normal(size=(rows, 9, 2)),
            "adj": np.where(rng.random((rows, 9, 9)) < 0.4,
                            rng.random((rows, 9, 9)), 0.0),
            "w": w}


def _bn(dim: int):
    bn = BatchNorm1d(5 if dim == 2 else 4).double().train()
    with torch.no_grad():
        bn.scale.copy_(torch.linspace(0.5, 1.5, bn.scale.numel()))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, bn.bias.numel()))
    return bn


def _edge_params():
    g = torch.Generator().manual_seed(3)
    return [torch.randn(shape, generator=g, dtype=torch.float64)
            .requires_grad_(True) for shape in ((9, 2), (4,), (6,))]


def _piece(name: str, t: dict, params: list):
    """Piece `name`'s global value on the (possibly sharded) inputs `t`;
    `params` collects the tensors whose gradients are compared."""
    w = t["w"]
    if name.startswith("bn"):
        dim = int(name[2])
        bn = _bn(dim)
        params.extend([bn.scale, bn.bias])
        y = bn(t[f"x{dim}"], w)
        params.append(bn)
        return meshlib.all_reduce_sum((y * t[f"r{dim}"]).sum())
    if name == "weighted_mean":
        return losses.weighted_mean(t["v"], w)
    if name == "nll":
        lp = torch.log_softmax(t["v"], dim=-1)
        return losses.nll_loss(lp, t["clust_y"].long(), w)
    if name == "recon_sum":
        return losses.recon_sum(t["pred"], t["target"], w)
    if name.startswith("consistency"):
        soft = name.endswith("soft")
        mcfg = ModelConfig(is_soft_similarity=soft, rbf_gamma=0.3)
        tcfg = TrainConfig(num_cluster=3)
        batch = {"w": w, "tsne": t["tsne"], "clust_y": t["clust_y"].long()}
        return steps._consistency(t["z"], batch, mcfg, tcfg)
    if name == "orthogonal_wide":
        return losses.orthogonal_loss(t["zw"], w)
    if name == "orthogonal_narrow":
        return losses.orthogonal_loss(t["z"], w)
    if name == "sparsity":
        from iggcn_tpu_torch.config import SparsityWeights
        prob, prob_bias, snps_prob = _edge_params()
        params.extend([prob, prob_bias, snps_prob])
        return losses.sparsity_loss(prob, prob_bias, snps_prob, t["x"],
                                    t["adj"], SparsityWeights(),
                                    sample_weight=w)
    raise ValueError(name)


PIECES = ("bn2", "bn3", "weighted_mean", "nll", "recon_sum",
          "consistency_soft", "consistency_hard", "orthogonal_wide",
          "orthogonal_narrow", "sparsity")
DIFFERENTIABLE = ("x2", "x3", "v", "z", "zw", "pred", "x")


def piece_result(name: str, arrays: dict, shard=None):
    """(value, input gradients of the whole batch, parameter gradients,
    batch-norm running statistics) of piece `name`: unsharded, or on this
    position's rows of `shard` with the gradients gathered and summed."""
    lo, hi = (0, len(arrays["w"])) if shard is None else (shard.lo, shard.hi)
    t = {k: torch.tensor(v[lo:hi], requires_grad=k in DIFFERENTIABLE)
         for k, v in arrays.items()}
    params: list = []
    with meshlib.sharded(shard):
        value = _piece(name, t, params)
    bn = [p for p in params if isinstance(p, BatchNorm1d)]
    params = [p for p in params if not isinstance(p, BatchNorm1d)]
    (value if shard is None else value * shard.lead).backward()
    grads = {}
    for k in DIFFERENTIABLE:
        g = t[k].grad
        if g is not None:
            grads[k] = (g if shard is None
                        else meshlib.all_gather_rows(g, shard)).numpy()
    pgrads = [p.grad if shard is None
              else meshlib.all_reduce_sum(p.grad, shard=shard)
              for p in params]
    stats = [(m.running_mean.numpy().copy(), m.running_var.numpy().copy())
             for m in bn]
    return (float(value.detach()), grads, [g.detach().numpy() for g in pgrads],
            stats)


def pieces_on(d: int):
    """Every piece at every `PIECE_ROWS` on a data mesh of `d` positions
    of the world: {(name, rows): piece_result}."""
    axis = meshlib.data_axis(meshlib.make_mesh(d, meshlib.world().devices))
    out = {}
    for rows in PIECE_ROWS:
        arrays = piece_inputs(rows)
        for name in PIECES:
            shard = None
            if axis is not None:
                lo, hi = axis.bounds(rows)
                shard = meshlib.Shard(axis, lo, hi, rows)
            out[name, rows] = piece_result(name, arrays, shard)
    return out


def replicated():
    """Every rank's tensor after `replicate` from rank 0 (each rank starts
    from its own rank number)."""
    t = torch.full((3,), float(meshlib.world().rank))
    meshlib.replicate([t])
    return meshlib.gather_objects(t.tolist())


def dp_step(d: int, variables, batch_np, mcfg_kw: dict, tcfg_kw: dict,
            loss_kw: dict, seed: int = 5):
    """One `make_dp_train_step` step on a data mesh of `d` positions of the
    world, from flax `variables` on the whole padded batch, dropout from a
    generator seeded `seed`: (loss * sum(w), flax variables after)."""
    mesh = meshlib.make_mesh(d, meshlib.world().devices)
    loss, model = single_step(variables, batch_np, mcfg_kw, tcfg_kw,
                              loss_kw, seed, mesh)
    return loss, to_flax_variables(model)


def single_step(variables, batch_np, mcfg_kw, tcfg_kw, loss_kw, seed=5,
                mesh=None):
    """(loss * sum(w), model) after one port step, unsharded or on `mesh`."""
    mcfg = ModelConfig(**mcfg_kw)
    tcfg = TrainConfig(**tcfg_kw, loss=LossWeights(**loss_kw))
    model = FusedSGCN(mcfg, synthetic_topology(np.random.default_rng(0)))
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    state = steps.TrainState(model, tcfg, steps_per_epoch=1)
    batch = {k: torch.as_tensor(v) for k, v in batch_np.items()}
    step = (steps.train_step if mesh is None
            else meshlib.make_dp_train_step(steps.train_step, mesh))
    loss = float(step(state, batch, mcfg, tcfg,
                      torch.Generator().manual_seed(seed)))
    return loss, model


def world_mesh(shape):
    """A (fold, data) mesh of `shape` over the first of the world's
    devices."""
    n = shape[0] * shape[1]
    return meshlib.Mesh(meshlib.world().devices[:n], shape,
                        (meshlib.FOLD, meshlib.DATA))


@contextlib.contextmanager
def batched_on(shape):
    """The CV entry points' batched program (`cv.fold_parallel_runs`) on
    a (fold, data) mesh of `shape` (None: its default, `fold_mesh` of the
    world's devices) for the duration."""
    from iggcn_tpu_torch.train import cv
    orig = cv.fold_parallel_runs
    if shape is not None:
        cv.fold_parallel_runs = functools.partial(orig,
                                                  mesh=world_mesh(shape))
    try:
        yield
    finally:
        cv.fold_parallel_runs = orig


def cv_runs(cases, cohort_kw, mcfg_kw, tcfg_kw, loss_kw, warm):
    """`cross_validation(..., fold_parallel=True)` of each case, a
    (fold, data) mesh shape (None: `fold_mesh` of the world's devices),
    on the world: [(CVResult, the per-epoch log lines)]."""
    from iggcn_tpu_torch.train.cv import cross_validation
    out = []
    for shape, folds in cases:
        tcfg = TrainConfig(**tcfg_kw, folds=folds, fold_parallel=True,
                           loss=LossWeights(**loss_kw))
        lines = []
        with batched_on(shape):
            res = cross_validation(
                synthetic_cohort(np.random.default_rng(1), **cohort_kw),
                synthetic_topology(np.random.default_rng(0)),
                ModelConfig(**mcfg_kw), tcfg, res_dir=None,
                logger=lines.append, warm_start=warm, device=CPU)
        out.append((res, lines))
    return out


def seed_batch_run(seeds, cohort_kw, mcfg_kw, tcfg_kw, loss_kw, shape):
    """`cross_validation_seed_batch` on a (fold, data) mesh of `shape`."""
    from iggcn_tpu_torch.train.cv import cross_validation_seed_batch
    tcfg = TrainConfig(**tcfg_kw, fold_parallel=True,
                       loss=LossWeights(**loss_kw))
    with batched_on(shape):
        return cross_validation_seed_batch(
            synthetic_cohort(np.random.default_rng(1), **cohort_kw), seeds,
            synthetic_topology(np.random.default_rng(0)),
            ModelConfig(**mcfg_kw), tcfg, res_dirs=[None] * len(seeds),
            verbose=False, device=CPU)


def replica_digests(shape):
    """Every rank's (fold row, digest of its row's final weights) after a
    4-fold flagship run on a (fold, data) mesh of `shape` (None on a rank
    the mesh leaves idle), as `fold_parallel` compares them."""
    from iggcn_tpu_torch.data.batching import cohort_batch_arrays
    from iggcn_tpu_torch.data.splits import k_fold
    from iggcn_tpu_torch.train import fold_parallel
    from iggcn_tpu_torch.train.cv import init_fold_model, prepare_fold
    cohort = synthetic_cohort(np.random.default_rng(1), num_subjects=49)
    topo = synthetic_topology(np.random.default_rng(0))
    mcfg = ModelConfig(num_layers=2, hidden=8, hidden_linear=16, l_dim=8)
    tcfg = TrainConfig(epochs=2, batch_size=8, folds=4, seed=1,
                       loss=LossWeights(disease=1.0, regr=1.0, simi=0.1))
    full = cohort_batch_arrays(cohort)
    ps = [prepare_fold(cohort, full, split, f, tcfg, -1)
          for f, split in enumerate(k_fold(cohort.y, 4, tcfg.seed))]
    inits = [init_fold_model(mcfg, topo, tcfg.seed, f, CPU) for f in range(4)]
    seen = []
    digest = fold_parallel._digest

    def spy(states):
        seen.append(digest(states))
        return seen[-1]

    fold_parallel._digest = spy
    mesh = world_mesh(shape)
    try:
        fold_parallel.run_folds_parallel(
            [m for m, _ in inits], [g for _, g in inits],
            [p["train_data"] for p in ps], [p["val_data"] for p in ps],
            [p["test_data"] for p in ps], [p["perms"] for p in ps],
            [p["train_data"]["y"].shape[0] // 8 for p in ps], mcfg, tcfg,
            "sgcn_imgsnp", mesh)
    finally:
        fold_parallel._digest = digest
    coords = meshlib.place(mesh)
    return meshlib.gather_objects(
        None if coords is None else (coords[0], seen[0]))


def run_all(jobs):
    """The ranks' entry: run each (function name, args) of `jobs` in turn
    and return their results. In a rank of the mutation audit it first
    applies `scripts/torch_mutations.py`'s mutation named by
    IGGCN_TORCH_MUTATION, as the audit's pytest plugin applies it in the
    test process."""
    mutation = os.environ.get("IGGCN_TORCH_MUTATION")
    if mutation:
        from torch_mutations import apply_mutation
        apply_mutation(mutation)
    return [globals()[name](*args) for name, args in jobs]
