"""Per-op time histogram of the flagship train step (port of
`iggcn_tpu/tools/profile_step.py`, on torch.profiler).

It builds the flagship `SGCN_GCN_IMGSNP` train step at the real GO scale
(levels 250, 120, 50, 15, 1; default widths L=2, H=16), warms it up,
traces `--steps` steps and prints the top-k ops by total time with their
share of the steps and count, then a category rollup (matmul, reduce,
copy/layout, rng, elementwise, the GCN-stack kernel, other).

On the card (the default) the times are device activity (kernels,
copies, sets); with `--device cpu` they are the host ops' self time and
are labelled so.

Usage:
  python -m iggcn_tpu_torch.tools.profile_step [--batch 256] [--steps 20]
      [--top 20] [--out trace_dir] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import collections
import os
import tempfile

import numpy as np
import torch

from iggcn_tpu_torch.utils import profiling

GO_LEVELS = (250, 120, 50, 15, 1)


def build_step(batch: int, device: torch.device):
    """A function running one flagship train step on one batch of `batch`
    synthetic subjects at the real GO scale, on `device`."""
    from iggcn_tpu_torch.config import ModelConfig, TrainConfig
    from iggcn_tpu_torch.data.adni import synthetic_cohort
    from iggcn_tpu_torch.data.batching import (cohort_batch_arrays,
                                               pad_to_batches)
    from iggcn_tpu_torch.data.go_graph import synthetic_topology
    from iggcn_tpu_torch.train.cv import init_fold_model, to_device
    from iggcn_tpu_torch.train.steps import TrainState, train_step

    rng = np.random.default_rng(0)
    topo = synthetic_topology(rng, level_sizes=list(GO_LEVELS))
    cohort = synthetic_cohort(rng, num_subjects=batch)
    mcfg = ModelConfig(num_layers=2, hidden=16)
    tcfg = TrainConfig(epochs=1, batch_size=batch)
    arrays = cohort_batch_arrays(cohort)
    arrays.pop("sbj_id")
    data = to_device({k: v[:batch] for k, v in
                      pad_to_batches(arrays, batch).items()}, device)
    model, generator = init_fold_model(mcfg, topo, tcfg.seed, 0, device)
    state = TrainState(model, tcfg, 1)
    return lambda: train_step(state, data, mcfg, tcfg, generator)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--out", default=None,
                   help="trace directory (default: a temp dir)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu profiles the host)")
    return p


def main(argv=None):
    from iggcn_tpu_torch.utils.platform import resolve_device

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    step = build_step(args.batch, device)
    loss = step()                      # warm up outside the trace
    float(loss)
    out_dir = args.out or tempfile.mkdtemp(prefix="iggcn_profile_")
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=profiling.activities(device)) as prof:
        for _ in range(args.steps):
            loss = step()
        float(loss)                    # the steps finish inside the trace
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)

    hist, what = profiling.op_histogram(prof, device)
    total = sum(t for t, _ in hist.values()) or 1.0
    print(f"# trace: {trace}  steps={args.steps} batch={args.batch} "
          f"device={device}")
    print(f"# total {what}: {total / 1e3:.2f} ms "
          f"({total / args.steps:.0f} us/step)")
    print(f"{'us/step':>9} {'share':>6} {'count':>6}  name")
    rows = sorted(hist.items(), key=lambda kv: -kv[1][0])
    for name, (t, c) in rows[:args.top]:
        print(f"{t / args.steps:9.1f} {t / total * 100:5.1f}% {c:6d}  "
              f"{name[:90]}")
    cats = collections.defaultdict(float)
    for name, (t, _) in hist.items():
        cats[profiling.categorize(name)] += t
    print("\n# category rollup")
    for label, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"{t / args.steps:9.1f} us/step {t / total * 100:5.1f}%  "
              f"{label}")
    return hist


if __name__ == "__main__":
    main()
