"""Traffic kind `score_cohort`: offline scoring of large cohorts with a
trained bundle, one caller in a closed loop.

Each request hands `iggcn_tpu_torch.predict.batched_forward` one
cohort's host arrays (x, adj, snps), as `tools/serve.py --npz` does,
and waits for its host results: the cohort's host -> device copy, its
eval-mode forwards at a fixed batch, and the results' copy back. The
requests cycle over a pool of distinct cohorts. Set-up draws the pool
and the eval-mode weights (batch-norm statistics included) from the
seed, builds the model, and serves one request per cohort of the pool
(the first builds every kernel). The window sends requests until
`--seconds` have passed. The traced run first times `LATENCY_REQUESTS`
requests one by one, each from its call to its host results, then
traces one request per cohort of the pool.

Traffic parameters: `cohort_subjects`, `batch_size`, `pool`.
"""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import data, device as devlib, port, work
from benchmark.reference import fused_sgcn as ref

SAMPLED_REQUESTS = 6
# requests the traced run times one by one: ten lie beyond their 95th
# percentile
LATENCY_REQUESTS = 200
# the families this kind serves, with the reference `reference/fused_sgcn.py`
FAMILIES = ("SGCN_GCN_IMGSNP",)


def setup(ctx) -> dict:
    from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    if cfg.get("family") not in FAMILIES:
        raise ValueError(f"the kind score_cohort serves {list(FAMILIES)}, "
                         f"not {cfg.get('family')!r}")
    m, c = cfg["model"], cfg["cohort"]
    with ctx.span("setup.cohort"):
        dag = data.go_dag(seed, c["go_levels"], m["num_snps"])
        pool = [data.cohort(data.sub_seed(seed, 7, i), tr["cohort_subjects"],
                            m["rois"], m["feat_dim"], m["num_snps"],
                            m["num_classes"], c["knn"], dev)
                for i in range(tr["pool"])]
        pool = [{k: co[k] for k in ("x", "adj", "snps")} for co in pool]
    with ctx.span("setup.model"):
        topo, mcfg = port.topology(dag), port.model_config(m)
        shapes = {k: tuple(t.shape) for k, t in FusedSGCN(
            mcfg, topo, device="cpu").state_dict().items()}
        weights = data.weight_sets(shapes, 1, seed, dev)[0]
        model = FusedSGCN(mcfg, topo, device=dev)
        model.load_state_dict(weights)
        model.eval()
    state = {"ctx": ctx, "model": model, "pool": pool, "dag": dag,
             "weights": weights, "served": []}
    with ctx.span("setup.warm"):
        for i in range(len(pool)):
            _request(state, i, keep=False)
    state["served"] = []
    return state


def _request(state: dict, i: int, keep: bool = True) -> float:
    """Serves cohort `i` of the pool; its latency in s."""
    from iggcn_tpu_torch import predict
    ctx = state["ctx"]
    co = state["pool"][i % len(state["pool"])]
    t0 = time.perf_counter()
    out = predict.batched_forward(state["model"], co["x"], co["adj"],
                                  co["snps"],
                                  batch_size=ctx.traffic["batch_size"],
                                  fixed_batch=True)
    t1 = time.perf_counter()
    if ctx.fault == "altered_answer":
        out["log_probs"][7] = out["log_probs"][7, ::-1].copy()
        out["pred"][7] = 1 - out["pred"][7]
    if keep:
        state["served"].append(out)
    return t1 - t0


def window(state: dict, seconds: float) -> dict:
    """Requests back to back until `seconds` have passed: subjects scored
    over the whole window."""
    n_sub = state["ctx"].traffic["cohort_subjects"]
    with state["ctx"].span("window"):
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            _request(state, i)
            i += 1
        wall = time.perf_counter() - t0
    return {"metrics": {"serve_subjects_per_s": i * n_sub / wall},
            "attempted": i, "failed": 0}


def traced(state: dict) -> dict:
    """`LATENCY_REQUESTS` requests timed one by one, then one request per
    cohort of the pool under the profiler, with the served forwards and
    the stack kernel's calls and shape."""
    from iggcn_tpu_torch.ops.gcn_stack import fused_gcn_stack
    ctx = state["ctx"]
    tr, m = ctx.traffic, ctx.config["model"]
    requests = len(state["pool"])
    with ctx.span("timed_requests"):
        latency = [_request(state, i) for i in range(LATENCY_REQUESTS)]

    def serve_pool():
        for k in ("launches", "launches_backward", "launches_streamed",
                  "launches_bf16"):
            setattr(fused_gcn_stack, k, 0)
        for i in range(requests):
            _request(state, i)
    warm = lambda: torch.ones(1, device=ctx.device).add_(1)  # noqa: E731
    with ctx.span("traced_requests"):
        dev_events, wall, _ = devlib.profiled(
            serve_pool, warm, lambda ev: devlib.stack_kernels_complete(
                ev, fused_gcn_stack))
    b = tr["batch_size"]
    forwards = requests * math.ceil(tr["cohort_subjects"] / b)
    widths = (m["hidden"],) * m["num_layers"]
    levels = ctx.config["cohort"]["go_levels"]
    return {"device": dev_events, "window_s": wall,
            "request_latency_s": latency,
            "work": {"forwards": forwards,
                     "model_flops": requests * tr["cohort_subjects"]
                     * work.pass_flops(m, levels),
                     "stack_calls": {"forward": (
                         fused_gcn_stack.launches,
                         work.stack_work(b, m["rois"], m["feat_dim"],
                                         widths))},
                     "other_stack_calls": fused_gcn_stack.launches_streamed
                     + fused_gcn_stack.launches_bf16
                     + fused_gcn_stack.launches_backward}}


def check(state: dict) -> Dict[str, float]:
    """Frees the model, then scores a sample of the served requests,
    drawn from the seed with the last one always in it, with the
    reference from the same weights and cohorts."""
    ctx = state["ctx"]
    state.pop("model", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    picks = sample(state)
    return readings([state["served"][i] for i in picks],
                    reference(state, picks), ctx.limits)


def sample(state: dict):
    served = len(state["served"])
    rng = np.random.default_rng(data.sub_seed(state["ctx"].seed, 8))
    return sorted(set(rng.choice(served, min(SAMPLED_REQUESTS, served),
                                 replace=False).tolist()) | {served - 1})


def reference(state: dict, picks, exact: bool = True):
    """The reference's outputs for the requests `picks` (`exact=False`:
    computed in TF32, the control), with its classes."""
    ctx = state["ctx"]
    dev, m = ctx.device, ctx.config["model"]
    dag = ref.GoDag(state["dag"]["adj_child_parent"], state["dag"]["go_snps"],
                    state["dag"]["pool"], m["go_n_l"], dev)
    out = []
    ref.exact_matmuls(exact)
    try:
        for i in picks:
            co = state["pool"][i % len(state["pool"])]
            r = ref.serve(state["weights"], m, dag,
                          *(torch.as_tensor(co[k], device=dev)
                            for k in ("x", "adj", "snps")),
                          block=ctx.traffic["batch_size"])
            lp = r["log_probs"].cpu().numpy()
            out.append({"log_probs": lp, "our_reg": r["our_reg"].cpu().numpy(),
                        "pred": lp.argmax(axis=1)})
    finally:
        ref.exact_matmuls(True)
    return out


def readings(got, want, limits) -> Dict[str, float]:
    """The widest gap of a log-probability and of a regression output, and
    the subjects whose class differs from the reference's where the
    reference's two classes lie further apart than twice the
    log-probability limit."""
    tie = 2 * limits.get("log_probs_gap", 0.0)
    out = {"log_probs_gap": 0.0, "our_reg_gap": 0.0, "pred_flips": 0.0}
    for g, w in zip(got, want):
        out["log_probs_gap"] = max(out["log_probs_gap"], float(
            np.max(np.abs(g["log_probs"] - w["log_probs"]))))
        out["our_reg_gap"] = max(out["our_reg_gap"], float(
            np.max(np.abs(g["our_reg"] - w["our_reg"]))))
        top2 = np.sort(w["log_probs"], axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tie
        out["pred_flips"] += float(np.sum((g["pred"] != w["pred"]) & clear))
    return out


def calibrate(ctx, control: bool, seconds: float = 3.0) -> dict:
    """The readings of one seed for setting the limits: a short window's
    sampled requests against the reference, and with `control` the
    reference in TF32 against it on the same requests."""
    state = setup(ctx)
    window(state, seconds)
    state.pop("model")
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    picks = sample(state)
    want = reference(state, picks)
    out = {"program": readings([state["served"][i] for i in picks], want,
                               ctx.limits)}
    if control:
        out["control"] = readings(reference(state, picks, exact=False), want,
                                  ctx.limits)
    return out
