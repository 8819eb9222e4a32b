"""Device meshes and the data axis (port of `iggcn_tpu/parallel/mesh.py`
and of `fold_mesh` / `stacked_data_specs` in
`iggcn_tpu/train/fold_parallel.py`).

A `Mesh` is a named grid of torch devices. The JAX package runs one
program over its mesh and lets XLA place the collectives; the port runs
one process per mesh position (`launch`), joined by `torch.distributed`
(NCCL across distinct cards; gloo on the CPU, and on a card listed more
than once when the caller names gloo). The rendezvous is a
`torch.distributed.FileStore` in a temporary directory, so that runs side
by side never contend for a port. A mesh of one device is today's
in-process path: nothing spawns and no collective runs. There is no
fallback: a backend that fails to start, a rank that dies or a collective
that fails fails the run.

The `data` axis shards each batch's samples: `shard_batch` gives each
position a contiguous, ordered slice (slices may be unequal, a position
with no rows still joins every collective), and while a `Shard` is active
(`sharded`) every cross-sample reduction of the training step reads the
whole batch: `BatchNorm1d`'s statistics, the weighted means and sums of
the losses and the pairwise terms go through `all_reduce_sum` and
`all_gather_rows`. Both are `torch.autograd.Function`s whose backward is
the same sum over the group and which run under `torch.func.vmap` (the
fold-batched step reduces inside its vmapped function). Each position
computes the global loss G from them; its share of the loss is G on the
axis' first position and 0 elsewhere (`Shard.lead`), so that the sum of
the positions' gradients, all-reduced before the optimiser
(`backward`), is the gradient of G, parameter-only terms counted
once. `all_gather_rows` is an all-reduce of zero-padded slots: gloo on
CUDA tensors has only all-reduce, broadcast and barrier, and adding zeros
is exact, so the gathered rows are bit-equal on every position.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

Device = torch.device
# the axis names: `fold_mesh`'s (fold, data) and `make_mesh`'s (data,)
FOLD, DATA = "fold", "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of torch devices: `devices` in row-major order over
    `shape`, one axis name per dimension. Position (rank) r holds
    `devices[r]`; a device may be listed more than once."""
    devices: tuple
    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")
        if int(np.prod(self.shape)) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, rank: int) -> tuple:
        """Position `rank`'s coordinates, one per axis."""
        return tuple(int(c) for c in np.unravel_index(rank, self.shape))

    def rank_of(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def describe(self) -> str:
        """`fold=1 x data=4 on 4 x NVIDIA H100 80GB HBM3` style."""
        axes = " x ".join(f"{n}={s}" for n, s in zip(self.axis_names,
                                                    self.shape))
        names = sorted({torch.cuda.get_device_name(d) if d.type == "cuda"
                        else str(d) for d in self.devices})
        return f"{axes} on {self.size} x {' + '.join(names)}"


def visible_devices() -> List[Device]:
    """Every CUDA device this process sees; raises without CUDA (the CPU
    is used only when a caller lists it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; list the devices "
                           "(devices=[torch.device('cpu')] * n) to build a "
                           "mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n: Optional[int] = None,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A 1-D `data` mesh of the first `n` of `devices` (default: every
    visible card); raises when `n` exceeds them."""
    avail = list(visible_devices() if devices is None else devices)
    if n is None:
        n = len(avail)
    if n > len(avail):
        raise ValueError(f"requested a {n}-device mesh but only "
                         f"{len(avail)} device(s) are visible")
    return Mesh(tuple(torch.device(d) for d in avail[:n]), (n,), (DATA,))


def fold_mesh(num_folds: int, devices: Optional[Sequence[Device]] = None
              ) -> Mesh:
    """2-D (fold, data) mesh: the fold axis gets the largest divisor of
    `num_folds` that fits the devices; the devices left over extend the
    `data` axis, which shards each fold's samples. When k does not divide
    the device count the remainder idles (5 folds on 8 devices run on 5;
    5 folds on 4 run as fold=1 x data=4)."""
    devs = list(visible_devices() if devices is None else devices)
    n = len(devs)
    fold_size = next(d for d in range(min(num_folds, n), 0, -1)
                     if num_folds % d == 0)
    data_size = max(1, n // fold_size)
    return Mesh(tuple(torch.device(d) for d in devs[:fold_size * data_size]),
                (fold_size, data_size), (FOLD, DATA))


def choose_backend(devices: Sequence[Device],
                   backend: Optional[str] = None) -> str:
    """gloo for CPU devices, NCCL for distinct cards; a card listed more
    than once runs only on gloo, and only when the caller names it."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        if backend not in (None, "gloo"):
            raise ValueError(f"a CPU mesh runs on gloo, not {backend}")
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh is all CPU or all CUDA devices, got "
                         f"{sorted(kinds)}")
    repeated = len(set(devices)) < len(devices)
    if backend is None:
        if repeated:
            raise ValueError(
                "the mesh lists a CUDA device more than once: NCCL needs "
                "one card per process; name backend='gloo' to run it "
                "oversubscribed")
        return "nccl"
    if backend == "nccl" and repeated:
        raise ValueError("NCCL cannot run two positions on one card")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


# ---------------------------------------------------------------- the world

@dataclasses.dataclass
class World:
    """This process's place among the ranks that `launch` started: its
    rank, the mesh launched (every rank's device), the backend, a gloo
    group for host objects and the data groups made so far."""
    rank: int
    mesh: Mesh
    backend: str
    host_group: Any
    groups: Dict[tuple, Any] = dataclasses.field(default_factory=dict)

    @property
    def devices(self) -> tuple:
        return self.mesh.devices

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> Device:
        return self.devices[self.rank]


_WORLD: Optional[World] = None


def world() -> Optional[World]:
    """The world this process joined, or None outside `launch`."""
    return _WORLD


def is_lead() -> bool:
    """True where results are printed and written: outside a world, or on
    its rank 0."""
    return _WORLD is None or _WORLD.rank == 0


def init_world(rank: int, mesh: Mesh, store_path: str,
               backend: Optional[str] = None) -> World:
    """Join the process group of `mesh.size` ranks as `rank`, through the
    FileStore at `store_path`. Sets this rank's card first."""
    global _WORLD
    if _WORLD is not None:
        raise RuntimeError("this process already joined a world")
    devices = mesh.devices
    backend = choose_backend(devices, backend)
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    store = dist.FileStore(store_path, len(devices))
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=len(devices))
    host = (dist.group.WORLD if backend == "gloo"
            else dist.new_group(backend="gloo"))
    _WORLD = World(rank, mesh, backend, host)
    return _WORLD


def shutdown_world() -> None:
    global _WORLD
    if _WORLD is not None:
        _WORLD = None
        dist.destroy_process_group()


def world_devices(default: Device) -> List[Device]:
    """The devices a mesh may take: the world's, else `default` alone (a
    library call outside `launch` stays on its device)."""
    return list(_WORLD.devices) if _WORLD is not None else [default]


def _worker(rank, fn, args, mesh, backend, store_path, out_path, threads):
    # the ranks share one host: keep the rendezvous on the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if threads is not None:
        torch.set_num_threads(threads)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(
            null if rank else sys.stdout):
        init_world(rank, mesh, store_path, backend)
        try:
            result = fn(*args)
            if rank == 0:
                with open(out_path, "wb") as fh:
                    pickle.dump(result, fh)
            dist.barrier(group=_WORLD.host_group)
        finally:
            shutdown_world()


def launch(fn: Callable, args: tuple, mesh: Mesh, *,
           backend: Optional[str] = None,
           threads: Optional[int] = None) -> Any:
    """Run `fn(*args)` in one spawned process per position of `mesh`,
    joined as a world (`init_world`), and return rank 0's result. `fn` is
    pickled by import path. `threads` sets each rank's torch threads. The
    other ranks' stdout goes to /dev/null: rank 0 alone prints. A rank
    that raises or dies fails the launch."""
    choose_backend(mesh.devices, backend)
    tmp = tempfile.mkdtemp(prefix="iggcn_mesh_")
    try:
        out_path = os.path.join(tmp, "result.pkl")
        torch.multiprocessing.start_processes(
            _worker, args=(fn, args, mesh, backend,
                           os.path.join(tmp, "store"), out_path, threads),
            nprocs=mesh.size, join=True, start_method="spawn")
        with open(out_path, "rb") as fh:
            return pickle.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's `obj`, in rank order, on every rank (host pickles
    over the gloo group)."""
    out: List[Any] = [None] * _WORLD.size
    dist.all_gather_object(out, obj, group=_WORLD.host_group)
    return out


# --------------------------------------------------------------- data axis

@dataclasses.dataclass(frozen=True)
class DataAxis:
    """A position's place on one row of a mesh's data axis: the process
    group of the row, its index in it and the row's size."""
    group: Any
    index: int
    size: int

    def bounds(self, rows: int) -> tuple:
        """This position's contiguous slice [lo, hi) of `rows` samples:
        the first `rows % size` positions take one row more."""
        q, r = divmod(rows, self.size)
        lo = self.index * q + min(self.index, r)
        return lo, lo + q + (1 if self.index < r else 0)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A batch's rows [lo, hi) of `total` on this position of `axis`."""
    axis: DataAxis
    lo: int
    hi: int
    total: int

    @property
    def lead(self) -> float:
        """The weight of this position's copy of the global loss."""
        return 1.0 if self.axis.index == 0 else 0.0


def place(mesh: Mesh) -> Optional[tuple]:
    """This rank's coordinates on `mesh`, or None where the mesh leaves
    the rank idle. Needs a world that holds the mesh."""
    if _WORLD is None:
        raise RuntimeError("a mesh of more than one device runs inside "
                           "parallel.mesh.launch")
    if mesh.size > _WORLD.size:
        raise ValueError(f"the mesh has {mesh.size} positions, the world "
                         f"{_WORLD.size} ranks")
    return mesh.coords(_WORLD.rank) if _WORLD.rank < mesh.size else None


def data_axis(mesh: Mesh) -> Optional[DataAxis]:
    """This rank's `DataAxis` on `mesh`'s `data` axis (None on an idle
    rank or a data axis of size 1). Every rank of the world must call it,
    in the same order: it makes the rows' process groups on first use."""
    k = mesh.axis_names.index(DATA)
    size = mesh.shape[k]
    coords = place(mesh)
    if size == 1:
        return None
    rows = []
    for other in np.ndindex(*(s for i, s in enumerate(mesh.shape)
                              if i != k)):
        rows.append(tuple(mesh.rank_of(other[:k] + (j,) + other[k:])
                          for j in range(size)))
    groups = _WORLD.groups
    for row in rows:
        if row not in groups:
            groups[row] = dist.new_group(ranks=list(row))
    if coords is None:
        return None
    mine = next(row for row in rows if _WORLD.rank in row)
    return DataAxis(groups[mine], coords[k], size)


_ACTIVE: Optional[Shard] = None


def active() -> Optional[Shard]:
    """The shard the current step runs on, or None (the whole batch)."""
    return _ACTIVE


@contextlib.contextmanager
def sharded(shard: Optional[Shard]):
    """Make `shard` the active one for the duration (None: unsharded)."""
    global _ACTIVE
    before = _ACTIVE
    _ACTIVE = shard
    try:
        yield shard
    finally:
        _ACTIVE = before


def shard_batch(batch: Dict[str, torch.Tensor], axis: DataAxis,
                dim: int = 0) -> tuple:
    """(this position's rows of every tensor along `dim`, its `Shard`)."""
    total = next(iter(batch.values())).shape[dim]
    lo, hi = axis.bounds(total)
    return ({k: v.narrow(dim, lo, hi - lo) for k, v in batch.items()},
            Shard(axis, lo, hi, total))


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; its backward is the same sum of the
    incoming gradients (every position's loss reads the result)."""

    @staticmethod
    def forward(x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # the physical tensor carries the vmapped dims: the sum is
        # elementwise, so it reduces every vmapped slice at once
        return _AllReduceSum.apply(x, group), in_dims[0]


def all_reduce_sum(*tensors: torch.Tensor, shard: Optional[Shard] = None):
    """Each tensor summed over the active (or given) shard's axis, in one
    collective (several are flattened, cast to the first one's type and
    split back); the tensors themselves when the batch is not sharded.
    One tensor in, one out; several in, a tuple out."""
    shard = shard if shard is not None else _ACTIVE
    if shard is None:
        return tensors[0] if len(tensors) == 1 else tensors
    if len(tensors) == 1:
        return _AllReduceSum.apply(tensors[0], shard.axis.group)
    dtype = tensors[0].dtype
    flat = _AllReduceSum.apply(
        torch.cat([t.reshape(-1).to(dtype) for t in tensors]),
        shard.axis.group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return tuple(out)


def all_gather_rows(x: torch.Tensor, shard: Optional[Shard] = None,
                    dim: int = 0) -> torch.Tensor:
    """The whole batch's rows of `x` (this position's along `dim`), in
    order: each position's rows in its zero-padded slot, summed."""
    shard = shard if shard is not None else _ACTIVE
    if shard is None:
        return x
    before = list(x.shape)
    before[dim] = shard.lo
    after = list(x.shape)
    after[dim] = shard.total - shard.hi
    padded = torch.cat([x.new_zeros(before), x, x.new_zeros(after)], dim=dim)
    return _AllReduceSum.apply(padded, shard.axis.group)


def gather_columns(*tensors: Optional[torch.Tensor]
                   ) -> List[Optional[torch.Tensor]]:
    """`all_gather_rows` of several (B, ...) tensors in one collective:
    each flattened to (B, -1) and cast to the first one's type (exact for
    0/1 weights and small labels), then split back; a None stays None.
    The tensors themselves when the batch is not sharded."""
    shard = _ACTIVE
    if shard is None:
        return list(tensors)
    given = [t for t in tensors if t is not None]
    dtype = given[0].dtype
    flat = [t.reshape(t.shape[0], int(np.prod(t.shape[1:]))).to(dtype)
            for t in given]
    gathered = all_gather_rows(torch.cat(flat, dim=1), shard)
    out, at = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        width = int(np.prod(t.shape[1:]))
        part = gathered[:, at:at + width]
        at += width
        out.append(part.reshape((shard.total,) + tuple(t.shape[1:]))
                   .to(t.dtype))
    return out


def all_reduce_grads(params: Iterable[torch.Tensor],
                     shard: Optional[Shard]) -> None:
    """Sum every parameter's gradient over the shard's axis in one
    collective (a flat buffer)."""
    if shard is None:
        return
    ps = [p for p in params if p.grad is not None]
    if not ps:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in ps])
    dist.all_reduce(flat, group=shard.axis.group)
    at = 0
    for p in ps:
        n = p.grad.numel()
        p.grad.copy_(flat[at:at + n].view_as(p.grad))
        at += n


def backward(loss: torch.Tensor, params: Iterable[torch.Tensor]) -> None:
    """Backpropagate a step's global `loss`: as it is when the batch is
    not sharded; else this position's share of it (`Shard.lead`), then
    the gradients of `params` summed over the axis (`all_reduce_grads`)."""
    shard = _ACTIVE
    if shard is None:
        loss.backward()
        return
    (loss * shard.lead).backward()
    all_reduce_grads(params, shard)


def replicate(tensors: Iterable[torch.Tensor], src: int = 0,
              group: Any = None) -> None:
    """Broadcast each tensor in place from world rank `src` (over `group`,
    default the world)."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def make_dp_train_step(train_step: Callable, mesh: Mesh):
    """Wrap `steps.train_step(state, batch, mcfg, tcfg, generator)` for a
    1-D data mesh: every position is given the whole batch and keeps its
    rows (`shard_batch`), dropout draws the whole batch's uniforms from
    the generator and keeps its rows, the step's reductions read the
    whole batch and its gradients are summed over the axis before the
    optimiser. Returns the global loss * sum(w), as the single step does.
    A one-device mesh returns `train_step` itself."""
    if mesh.size == 1:
        return train_step
    from iggcn_tpu_torch.train import steps
    axis = data_axis(mesh)
    shapes: Dict[tuple, list] = {}     # the draws' shapes per batch shape

    def run(state, batch, mcfg, tcfg, generator):
        key = tuple((k, tuple(v.shape)) for k, v in sorted(batch.items()))
        if key not in shapes:
            shapes[key] = steps.step_noise_shapes(state, batch, mcfg, tcfg)
        noise = steps.draw_noise(shapes[key], generator, batch["w"].device)
        if axis is None:      # a rank the mesh leaves idle
            return train_step(state, batch, mcfg, tcfg, noise)
        local, shard = shard_batch(batch, axis)
        with sharded(shard):
            return train_step(state, local, mcfg, tcfg,
                              None if noise is None
                              else noise.rows(shard.lo, shard.hi, shard.total))
    return run
