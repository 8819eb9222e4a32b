"""How far fp32 training of the flagship parts from float64, and why:
`chip_smoke.py` phase 18's long run (full width, N=90, the real-scale GO
DAG, its planted-signal cohort, seeded random weights, dropout 0) taken
apart, with nothing of JAX.

  * trajectories: one float64 run on the CPU, then fp32 runs on the CPU at
    each thread count of `--threads` (the CPU's sum order changes with
    it), and with `--card` two fp32 runs on the card and two more under
    `torch.use_deterministic_algorithms` (the operations it warns about
    are printed). Each run's relative loss departure from float64 at
    checkpoints and at the end, and the largest difference between
    repeats.
  * the first Adam step from the seeded weights in fp32 and in float64:
    the parameter entries whose updates differ most, as a share of the
    learning rate, with both gradients at that entry. Adam divides each
    gradient by its own size, so an entry whose true gradient is zero but
    whose fp32 gradient is rounding noise takes a full step in fp32.
  * along the float64 trajectory, at epochs `GRAD_EPOCHS`,
    one fp32 gradient from the float64 state beside the float64 one: the
    parameters whose fp32 gradient parts most (||g32 - g64|| / ||g64||).
    Large values name where fp32 rounding enters training.

Usage:
    python scripts/fp32_drift_torch.py [--threads 1,8] [--card]
        [--streamed]

On the CPU alone it takes ~2 minutes at 1 and 4 threads (float64
included); `--card` needs an NVIDIA GPU.

Prints one line per run, per first-step entry and per gradient epoch,
then one JSON line.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import convergence_ab_torch as ab  # noqa: E402
from chip_smoke import (LONG_LR, LONG_RUNS, LONG_SUBJECTS,  # noqa: E402
                        REAL_GO_LEVELS)
from iggcn_tpu_torch.config import ModelConfig  # noqa: E402
from iggcn_tpu_torch.tools.convert import to_flax_variables  # noqa: E402
from iggcn_tpu_torch.train import steps  # noqa: E402

CHECKPOINTS = (0, 1, 2, 3, 5, 10, 20, 30, 40, 60, 80)
GRAD_EPOCHS = (0, 2, 10, 30)
CPU = torch.device("cpu")


def departure(losses: np.ndarray, exact: np.ndarray) -> dict:
    rel = np.abs(losses - exact) / np.abs(exact)
    return {"at": {e: float(rel[e]) for e in CHECKPOINTS if e < len(rel)},
            "early": float(rel[:ab.EARLY_WINDOW].max()),
            "worst": float(rel.max()), "final": float(rel[-1])}


def card_runs(problem, variables, sched, fields) -> dict:
    """Two fp32 runs on the card, then two under deterministic
    algorithms (warn only): their losses and the operations warned of."""
    dev = torch.device("cuda")
    out = {"default": [], "deterministic": []}
    warned = set()
    for mode in out:
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        for _ in range(2):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run = ab.train_port("fused", problem, variables, dev, sched,
                                    fields)
            if mode == "deterministic":
                warned |= {str(w.message).split(". ")[0] for w in caught
                           if "deterministic" in str(w.message)}
            out[mode].append(run.losses)
    torch.use_deterministic_algorithms(False)
    return {"losses": out, "warned": sorted(warned)}


def gradient_errors(problem, variables, sched, fields, epochs, top=6):
    """Per-parameter fp32 gradient departures from float64 along the
    float64 trajectory, at each of `epochs`."""
    mcfg = ModelConfig(**fields)
    tcfg = ab.train_config("fused", len(problem.train_idx), sched)
    out = {}
    with ab.default_dtype(torch.float64):
        model = ab.new_port_model("fused", problem, fields)
        ab.load_flax_variables(model, variables["params"],
                               variables.get("batch_stats"))
        model = model.double()
        state = steps.TrainState(model, tcfg, 1, kind="sgcn_imgsnp")
        batch = ab._subset(problem, problem.train_idx, CPU)
        for epoch in range(max(epochs) + 1):
            if epoch in epochs:
                g64 = _grads(copy.deepcopy(model), problem, mcfg, tcfg,
                             torch.float64)
                g32 = _grads(copy.deepcopy(model).float(), problem, mcfg,
                             tcfg, torch.float32)
                rel = {n: float((g32[n] - g64[n]).norm()
                                / g64[n].norm().clamp_min(1e-30))
                       for n in g64}
                out[epoch] = sorted(rel.items(), key=lambda kv: -kv[1])[:top]
            steps.train_step(state, batch, mcfg, tcfg, None)
    return out


def first_step(problem, variables, sched, fields, top=6):
    """One train step from `variables` in fp32 and in float64: the
    entries whose updates differ most, |d32 - d64| / lr, each with the
    float64 and fp32 gradient there."""
    mcfg = ModelConfig(**fields)
    tcfg = ab.train_config("fused", len(problem.train_idx), sched)
    update, grad = {}, {}
    for dtype in (torch.float32, torch.float64):
        with ab.default_dtype(dtype):
            model = ab.new_port_model("fused", problem, fields)
            ab.load_flax_variables(model, variables["params"],
                                   variables.get("batch_stats"))
            model = model.to(dtype)
            before = {n: q.detach().double().clone()
                      for n, q in model.named_parameters()}
            state = steps.TrainState(model, tcfg, 1, kind="sgcn_imgsnp")
            steps.train_step(state, ab._subset(problem, problem.train_idx,
                                               CPU), mcfg, tcfg, None)
            update[dtype] = {n: q.detach().double() - before[n]
                             for n, q in model.named_parameters()}
            grad[dtype] = {n: q.grad.detach().double()
                           for n, q in model.named_parameters()
                           if q.grad is not None}
    rows = []
    for n, d64 in update[torch.float64].items():
        if n not in grad[torch.float64]:
            continue
        diff = (update[torch.float32][n] - d64).abs().flatten()
        k = int(diff.argmax())
        rows.append({"param": n, "update_diff_over_lr":
                     float(diff[k]) / sched.lr,
                     "g64": float(grad[torch.float64][n].flatten()[k]),
                     "g32": float(grad[torch.float32][n].flatten()[k])})
    return sorted(rows, key=lambda r: -r["update_diff_over_lr"])[:top]


def _grads(model, problem, mcfg, tcfg, dtype):
    with ab.default_dtype(dtype):
        batch = ab._subset(problem, problem.train_idx, CPU)
        loss, _ = steps.fused_objective(model, batch, mcfg, tcfg, train=True)
        loss.backward()
        return {n: p.grad.detach().double() for n, p in
                model.named_parameters() if p.grad is not None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--threads", default="1,8",
                   help="CPU thread counts of the fp32 runs")
    p.add_argument("--card", action="store_true",
                   help="also run fp32 on the card, twice by default and "
                        "twice under deterministic algorithms")
    p.add_argument("--streamed", action="store_true",
                   help="phase 18's second run (--layers 3 --hiddens 128) "
                        "in place of the flagship's L=2 H=16")
    args = p.parse_args(argv)
    if args.card:
        # cuBLAS is deterministic only with a fixed workspace, set before
        # the first CUDA call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    what, overrides, epochs, decay = LONG_RUNS[1 if args.streamed else 0]
    problem = ab.port_problem(subjects=LONG_SUBJECTS, rois=90,
                              go_levels=REAL_GO_LEVELS)
    fields = ab.model_fields("fused", 90, **overrides)
    model = ab.new_port_model("fused", problem, fields,
                              torch.Generator().manual_seed(18))
    variables = to_flax_variables(model)
    sched = ab.Schedule(epochs=epochs, lr=LONG_LR, decay_every=decay)
    exact = ab.train_port("fused", problem, variables, CPU, sched, fields,
                          torch.float64).losses
    result = {"run": what, "cpu": {}}
    runs = {}
    for threads in (int(t) for t in args.threads.split(",")):
        torch.set_num_threads(threads)
        runs[threads] = ab.train_port("fused", problem, variables, CPU,
                                      sched, fields).losses
        result["cpu"][threads] = departure(runs[threads], exact)
        print(f"{what}: CPU fp32, {threads} threads, against float64: "
              f"{result['cpu'][threads]}", flush=True)
    first = next(iter(runs.values()))
    result["cpu_threads_max_abs_diff"] = float(max(
        np.max(np.abs(v - first)) for v in runs.values()))
    if args.card:
        card = card_runs(problem, variables, sched, fields)
        result["card"] = {}
        for mode, series in card["losses"].items():
            result["card"][mode] = {
                "runs": [departure(v, exact) for v in series],
                "repeat_max_abs_diff": float(np.max(np.abs(
                    series[0] - series[1])))}
            print(f"{what}: card fp32 ({mode}) against float64: "
                  f"{result['card'][mode]}", flush=True)
        result["card"]["warned"] = card["warned"]
        print(f"deterministic mode warned of: {card['warned']}")
    result["first_step"] = first_step(problem, variables, sched, fields)
    for row in result["first_step"]:
        print(f"first step: {row['param']} update differs by "
              f"{row['update_diff_over_lr']:.3f} lr (gradient float64 "
              f"{row['g64']:.3e}, fp32 {row['g32']:.3e})")
    result["grads"] = gradient_errors(
        problem, variables, sched, fields,
        [e for e in GRAD_EPOCHS if e < epochs])
    for epoch, worst in result["grads"].items():
        print(f"epoch {epoch}: fp32 gradient departures "
              + ", ".join(f"{n} {r:.2e}" for n, r in worst))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
