"""Runs one cell of the port's benchmark once and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Set-up (inputs and weights from the seed, the program's set-up, one
warm-up of every shape the cell uses, every kernel built) is timed from
the process's start; then the cell's window runs for `--seconds`
(`--trace 0`: the end-to-end metrics) or one traced stretch runs under
the profiler (`--trace 1`: the per-layer metrics). Last, the program's
state is freed and its outputs are compared with the plain reference;
each number compared is printed beside its limit, as the last lines of
standard error and under `checks`, the last key of the result. The
result is the last line of standard output, one JSON object.

Exit codes: 0 with a result; 2 without the cards the cell needs; 3 when
JAX or the JAX package was loaded in this process (no result either).
"""
from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Context:
    """What a kind's set-up, window, trace and check read: the run's seed,
    device, configuration, traffic and limits, the fault planted (tests
    and calibration only), and the benchmark's host spans."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device, fault=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits = cell["limits"]
        self.seed, self.device, self.fault = seed, device, fault
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str):
        import torch
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.spans.append((name, t0 - START, time.perf_counter() - START))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             fault=None, overrides=None, start: float = None,
             root: str = ROOT):
    """(result, spans) of one run of cell `name` on `device`, its files
    found under the checkout `root`. `overrides` replace parts of the
    configuration and traffic (the tests' small sizes: {"config": {...},
    "traffic": {...}})."""
    import torch
    from benchmark.harness import checks, device as devlib, registry
    start = START if start is None else start
    cell = registry.cell(name, root)
    config = registry.config(cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root)
    for part, target in (("config", config), ("traffic", traffic)):
        for key, value in (overrides or {}).get(part, {}).items():
            target[key] = ({**target[key], **value}
                           if isinstance(value, dict) else value)
    kind = registry.kind(traffic["kind"], root)
    ctx = Context(cell, config, traffic, seed, device, fault)
    cuda = device.type == "cuda"
    state = kind.setup(ctx)
    setup_s = time.perf_counter() - start
    out_device = {"platform": "gpu" if cuda else "cpu",
                  "kind": (torch.cuda.get_device_name(device) if cuda
                           else "cpu"),
                  "count": cell["chips"]}
    breakdown = None
    if trace:
        t = kind.traced(state)
        _, bandwidth, peak = (devlib.card_spec(out_device["kind"]) if cuda
                              else ("cpu", float("nan"), float("nan")))
        t.update(busy_s=devlib.busy_us(t["device"]) / 1e6,
                 bandwidth=bandwidth, peak_flops=peak)
        metrics = {}
        for m in registry.per_layer(name, root):
            value = registry.metric_reader(m["name"], root).read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out_device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = devlib.breakdown(t["device"])
        attempted, failed = 1, 0
    else:
        res = kind.window(state, seconds)
        units = registry.units(registry.end_to_end(name, root))
        values = {"setup_s": setup_s, **res["metrics"]}
        metrics = {k: {"value": values[k], "unit": u}
                   for k, u in units.items()}
        attempted, failed = res["attempted"], res["failed"]
    out_device["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if cuda else 0)
    with ctx.span("check"):
        readings = kind.check(state)
    ok, judged = checks.judge(readings, cell["limits"])
    result = {"correct": ok and failed == 0, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = judged
    return result, ctx.spans


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import checks, device as devlib, registry
    import torch
    chips = registry.cell(args.workload)["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell {args.workload} needs {chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    result, spans = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    found = checks.forbidden_loaded()
    if found:
        print(f"benchmark: modules of {found} were loaded in this process",
              file=sys.stderr)
        return 3
    print("spans " + json.dumps([[n, round(a, 6), round(b, 6)]
                                 for n, a, b in spans]), file=sys.stderr)
    print(f"card {devlib.power_limit()}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
