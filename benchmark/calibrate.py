"""Readings for setting a cell's limits: the program on many seeds, the
control (the reference computed in TF32 in the program's place) and a
planted fault on a few, one process for all.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control 3] [--fault half_batch --fault-seeds 3]

Prints one JSON line per seed and run, then the largest reading of each
number over the program's seeds and the smallest over the control's and
the fault's. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmark import run
    from benchmark.harness import registry
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = registry.cell(args.workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    kind = registry.kind(traffic["kind"])
    seeds = [int(s) for s in args.seeds.split(",")]
    worst = {"program": {}, "control": {}, "fault": {}}
    plan = [(s, None, i < args.control) for i, s in enumerate(seeds)]
    if args.fault:
        plan += [(s, args.fault, False) for s in seeds[:args.fault_seeds]]
    for seed, fault, control in plan:
        t0 = time.perf_counter()
        ctx = run.Context(cell, config, traffic, seed, dev, fault)
        out = kind.calibrate(ctx, control)
        torch.cuda.empty_cache()
        for part, values in out.items():
            part = "fault" if fault else part
            agg = max if part == "program" else min
            for k, v in values.items():
                worst[part][k] = agg(worst[part].get(k, v), v)
        print(json.dumps({"seed": seed, "fault": fault, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max":
                      worst["program"], "control_min": worst["control"],
                      f"fault_min ({args.fault})": worst["fault"],
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
