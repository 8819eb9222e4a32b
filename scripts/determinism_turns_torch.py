"""Time two checkouts of the port on one card in turns: serving and the
full-batch training step, the paths where the GO network's edge attention
runs.

For each checkout (this one and `--parent DIR`, e.g. the parent commit
unpacked by `git archive` into the git-ignored `results/parent`), a fresh
process imports that checkout's `iggcn_tpu_torch` (its kernels build into
its own `_build/`) and measures, with the same code from this file and
`chip_smoke.py`:

  * serving: phase 3's bundle model (default ModelConfig, the real-scale
    GO DAG, seeded random weights) over the 874-subject cohort at batch
    256, fp32 and bf16 in turns, the cohort wall (median of 7 each); one
    warm served forward of 256 under torch.profiler: its device ops, the
    device busy time and the idle share;
  * the full-batch flagship step of `chip_smoke.py` phase 18 (120
    planted-signal subjects, the 90 train subjects in one batch, the edge
    attention): host wall (median of 10), device busy per step (the union
    of device ops over 5 profiled steps), the device ops of one step and
    its idle share.

The processes run in the order parent, this, this, parent (`--rounds`
such blocks). Prints one JSON line per process and, last, the medians per
checkout as one JSON object.

Usage, on a machine with a CUDA card, from the repository root:
    python scripts/determinism_turns_torch.py --parent results/parent
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBJECTS, BATCH, WALL_RUNS = 874, 256, 7


def _chip_smoke():
    """This checkout's chip_smoke.py, whatever `iggcn_tpu_torch` is
    imported already."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(root: str) -> dict:
    """The readings of the checkout at `root`, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import iggcn_tpu_torch
    cs = _chip_smoke()
    from iggcn_tpu_torch.config import ModelConfig
    from iggcn_tpu_torch.data.go_graph import synthetic_topology
    from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
    from iggcn_tpu_torch.models.nn_compat import BatchNorm1d
    from iggcn_tpu_torch.predict import batched_forward, cast_floating
    from iggcn_tpu_torch.train import steps

    dev = torch.device("cuda", 0)
    out = {"root": os.path.relpath(os.path.dirname(
        os.path.dirname(iggcn_tpu_torch.__file__)), REPO) or "."}
    topo = synthetic_topology(np.random.default_rng(0),
                              level_sizes=list(cs.REAL_GO_LEVELS),
                              num_snps=54)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = FusedSGCN(ModelConfig(), topo, generator=gen, device=dev).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm1d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    import copy
    bf16_model = cast_floating(copy.deepcopy(model), torch.bfloat16)
    cohort = cs.make_cohort(np.random.default_rng(1), SUBJECTS)
    models = {"fp32": (model, None), "bf16": (bf16_model, torch.bfloat16)}
    walls = {k: [] for k in models}
    for what, (m, dtype) in models.items():      # warm, kernels built
        batched_forward(m, *cohort, batch_size=BATCH, dtype=dtype)
    for order in (("fp32", "bf16"), ("bf16", "fp32")) * ((WALL_RUNS + 1) // 2):
        for what in order:
            m, dtype = models[what]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batched_forward(m, *cohort, batch_size=BATCH, dtype=dtype)
            walls[what].append(time.perf_counter() - t0)
    for what in models:
        out[f"serve_cohort_wall_s_{what}"] = statistics.median(
            walls[what][:WALL_RUNS])
    request = [a[:BATCH] for a in cohort]
    one = cs.summarize_profile(*cs.profiled(
        lambda: batched_forward(model, *request, batch_size=BATCH)))
    out.update(serve_forward_device_ops=one["device_ops"],
               serve_forward_device_busy_us=one["device_busy_us"],
               serve_forward_idle_share=one["idle_share"])

    ab = cs.convergence_ab_torch
    problem = ab.port_problem(subjects=cs.LONG_SUBJECTS, rois=90,
                              go_levels=cs.REAL_GO_LEVELS)
    fields = ab.model_fields("fused", 90)
    net = ab.new_port_model("fused", problem, fields,
                            torch.Generator().manual_seed(18)).to(dev)
    sched = ab.Schedule(epochs=1, lr=cs.LONG_LR, decay_every=cs.LONG_DECAY)
    n_train = len(problem.train_idx)
    mcfg, tcfg = ModelConfig(**fields), ab.train_config("fused", n_train,
                                                        sched)
    state = steps.TrainState(net, tcfg, 1, "sgcn_imgsnp")
    batch = ab._subset(problem, problem.train_idx, dev)
    breakdown = cs.step_breakdown({"step": lambda: steps.train_step(
        state, batch, mcfg, tcfg, None)})
    step = breakdown["profiled_step"]
    out.update(step_wall_ms=breakdown["step_wall_ms"],
               step_device_ms=breakdown["step_device_ms"],
               step_device_ops=step["device_ops"],
               step_idle_share=step["idle_share"], step_batch=n_train)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=False,
                   help="a checkout to time beside this one")
    p.add_argument("--rounds", type=int, default=1,
                   help="blocks of parent, this, this, parent")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(measure(args.worker)), flush=True)
        return 0
    roots = ([args.parent, REPO, REPO, args.parent] if args.parent
             else [REPO]) * args.rounds
    rows = []
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root],
            cwd=REPO, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {}
    for root in dict.fromkeys(r["root"] for r in rows):
        mine = [r for r in rows if r["root"] == root]
        summary[root] = {k: statistics.median(r[k] for r in mine)
                         for k in mine[0] if k != "root"}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
