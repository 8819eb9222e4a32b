"""Where a `--fold_parallel` run on a gloo mesh parts from the one-device
run: `chip_smoke.py` phase 20's 2-seed x 5-fold flagship (874 subjects,
the 436-node GO DAG, batch 32, 2 epochs, dropout on).

On a card (the default), trained on one device as all 10 entries, as
seed 2's five alone (twice), on a 1 x 2 mesh of those five (the data
axis alone) and on phase 20's 2 x 2 mesh; prints each entry's largest
relative difference of its per-epoch train and eval loss sums for each
pair.

With `--cpu`, the float64 witness on the CPU: entry (seed 2, fold 2)
alone, on one device and on a 1 x 2 mesh of two gloo CPU ranks, in fp32
and in float64 (the default dtype and every floating array of the entry
float64); prints the mesh's departure from the one device in each
dtype. If the float64 runs agree where the fp32 ones part, the parting
is fp32 rounding that training amplifies, not a term the mesh loses.

    python scripts/mesh_drift_torch.py          # on a machine with a card
    python scripts/mesh_drift_torch.py --cpu    # anywhere, ~2 x 3 runs

It imports nothing of JAX.
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from iggcn_tpu_torch.parallel import mesh as meshlib  # noqa: E402
from iggcn_tpu_torch.train import cv as port_cv  # noqa: E402


def loss_sums(setup, entries, dev, mesh=None):
    """{(seed, fold): (epochs, 3) train / val / test loss sums}."""
    _, topo, mcfg, tcfg, kind, _ = setup
    runs = port_cv.fold_parallel_runs(entries, topo, mcfg, tcfg, kind, dev,
                                      mesh=mesh)
    return {(r["seed"], r["fold"]): np.stack([r["per_epoch"][k] for k in (
        "train_loss_sum", "val_loss_sum", "test_loss_sum")], axis=1)
        for r in runs}


def float64_entry(entry):
    """`entry` with every float32 array of its data in float64."""
    def cast(d):
        return {k: v.astype(np.float64) if getattr(v, "dtype", None)
                == np.float32 else v for k, v in d.items()}
    p = dict(entry["p"])
    for part in ("train_data", "val_data", "test_data"):
        if p.get(part) is not None:
            p[part] = cast(p[part])
    return {**entry, "p": p}


def witness_sums(dtype, mesh_shape=None):
    """Entry (2, 2)'s per-epoch loss sums at WITNESS_EPOCHS in `dtype`,
    on the CPU alone (`mesh_shape` None) or, inside a world, on a mesh
    of that shape."""
    torch.set_default_dtype(dtype)
    torch.set_num_threads(1)
    setup = cs.mesh_setup(WITNESS_EPOCHS)
    entry = next(e for e in setup[5][2] if (e["seed"], e["fold"]) == (2, 2))
    if dtype == torch.float64:
        entry = float64_entry(entry)
    mesh = None
    if mesh_shape is not None:
        world = meshlib.world()
        mesh = meshlib.Mesh(world.devices[:mesh_shape[0] * mesh_shape[1]],
                            mesh_shape, (meshlib.FOLD, meshlib.DATA))
    return loss_sums(setup, [entry], torch.device("cpu"), mesh)


WITNESS_EPOCHS = 2


def cpu_witness():
    cpu = torch.device("cpu")
    for dtype in (torch.float32, torch.float64):
        alone = witness_sums(dtype)
        on_mesh = meshlib.launch(witness_sums, (dtype, (1, 2)),
                                 meshlib.make_mesh(devices=[cpu] * 2),
                                 threads=1)
        report(f"{dtype}: 1 x 2 mesh of entry (2, 2) vs the one device",
               on_mesh, alone)
        for key in sorted(alone):
            print(f"{dtype} {key}: one device {alone[key].tolist()}, "
                  f"mesh {on_mesh[key].tolist()}", flush=True)
    return 0


def rank_job(shape, seed2_only):
    """One rank's share of a gloo mesh run (every rank returns all)."""
    setup = cs.mesh_setup()
    world = meshlib.world()
    entries = setup[5][2][5:] if seed2_only else setup[5][2]
    mesh = meshlib.Mesh(world.devices[:shape[0] * shape[1]], shape,
                        (meshlib.FOLD, meshlib.DATA))
    return loss_sums(setup, entries, world.device, mesh)


def report(what, got, want):
    for key in sorted(want):
        rel = np.abs(got[key] - want[key]) / np.abs(want[key])
        print(f"{what} {key}: max rel train {rel[:, 0].max():.3e} "
              f"eval {rel[:, 1:].max():.3e}", flush=True)


def main():
    if "--cpu" in sys.argv[1:]:
        return cpu_witness()
    if not torch.cuda.is_available():
        print("mesh_drift_torch: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs.phase_build()
    setup = cs.mesh_setup()
    all10 = loss_sums(setup, setup[5][2], dev)
    alone = loss_sums(setup, setup[5][2][5:], dev)
    again = loss_sums(setup, setup[5][2][5:], dev)
    report("seed 2 alone vs in the 10-entry batch (one device)", alone,
           {k: all10[k] for k in alone})
    report("seed 2 alone twice (one device)", again, alone)
    mesh12 = meshlib.launch(rank_job, ((1, 2), True), meshlib.make_mesh(
        devices=[dev] * 2), backend="gloo")
    report("1 x 2 mesh of seed 2 vs seed 2 alone", mesh12, alone)
    mesh22 = meshlib.launch(rank_job, ((2, 2), False), meshlib.make_mesh(
        devices=[dev] * 4), backend="gloo")
    report("2 x 2 mesh vs the 10-entry batch", mesh22, all10)
    return 0


if __name__ == "__main__":
    sys.exit(main())
