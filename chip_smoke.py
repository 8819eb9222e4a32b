"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package. Phases, in order; any
failure propagates and the script exits non-zero:

  1. card and build: the `nvidia-smi` name/power-limit line, then every
     CUDA source under iggcn_tpu_torch/csrc/ built by nvcc (one process
     per source, all started together), with the build time and ptxas's
     register/shared-memory report;
  2. kernel vs plain on the card: `fused_gcn_stack` against
     `gcn_stack_reference` at every imaging-stack shape of both search
     grids (N=90, F0=3 and N=270, F0=1; B in {1, 7, 32, 256}), each with P
     in both layouts the kernel takes (as `gcn_propagation_matrix` returns
     it, and row-major), one P with isolated nodes, shapes beyond the
     grids at which `plan_launch` picks each other cluster size and K
     split, and transposed P that the bulk copy cannot take (odd N, a
     4-byte-offset view); rtol 1e-4 / atol 1e-5 (fp32, different summation
     order), plus the autograd gradients through both;
  3. the serving slice at full width: the default ModelConfig over a GO
     topology at the real scale, random weights from a seeded
     torch.Generator, written with save_bundle, read back with load_bundle
     and served to an 874-subject cohort at batch 256 on the card; held
     against the same bundle served on the CPU by the plain path
     (log_probs and our_reg within atol 1e-4, pred equal wherever the
     class log-probs differ by more than 1e-4), and the kernel's launch
     count over that run must be ceil(874 / 256) = 4;
  4. the HTTP daemon on the card: /health, three /predict requests of 1, 37
     and 256 subjects checked against phase 3, /stats with the exact
     request count;
  5. times, with CUDA events, median of 25: the kernel, its plain version
     and the same stack in torch.baddbmm/bmm calls at the serving shape,
     the training batch (B=32) and the multi-fusion shape (N=270), each
     warm (back to back, P in L2 where it fits) and cold (L2 flushed by
     writing 256 MB before each call, outside the events), beside its
     bound on this card; the serve-cohort wall time and the request
     latency;
  6. one torch.profiler pass over a warm serving forward of 256 subjects:
     the kernel's share of device time, the device's idle share, the top
     10 device ops; and one over a single `fused_gcn_stack` call, which
     must launch exactly one device kernel.

It prints the `kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`. Everything it measures is also
written to results/chip_smoke/result.json (git-ignored).
"""
from __future__ import annotations

import glob
import http.client
import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.nn_compat import BatchNorm1d
from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.predict import batched_forward
from iggcn_tpu_torch.tools.serve import (build_http_server, load_bundle,
                                         save_bundle)
from iggcn_tpu_torch.utils import cuda_build

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "results", "chip_smoke")
RTOL, ATOL = 1e-4, 1e-5          # kernel vs plain, fp32
SERVE_ATOL = 1e-4                # card vs CPU serving
COHORT, BATCH = 874, 256         # ADNI cohort size, serving batch
# imaging-stack shapes of both search grids (main.py:_combos), (N, F0,
# widths per layer): the default 90-ROI grid, then --isMultiFusion's
STACK_SHAPES = ([(90, 3, (h,) * n) for n, h in
                 zip([2, 3, 2, 3, 4], [16, 16, 10, 10, 5])]
                + [(270, 1, (h,) * n) for n, h in
                   zip([3, 2, 4, 2, 3], [2, 3, 3, 5, 10])])
STACK_BATCHES = (1, 7, 32, 256)
# timed shapes, (name, B, N, F0, widths): serving first, then the training
# batch (TrainConfig.batch_size) and the multi-fusion grid's widest entry
TIMED_SHAPES = [("serving", BATCH, 90, 3, (16, 16)),
                ("training", 32, 90, 3, (16, 16)),
                ("multi-fusion", BATCH, 270, 1, (10, 10, 10))]
# (N, F0, widths) beyond the grids at which plan_launch picks the kernel's
# other branches: (cluster, K split) = (1, 1), (2, 4), (4, 1), (8, 1), (8, 2)
BRANCH_SHAPES = [(90, 3, (64, 64)), (270, 1, (3, 3)), (400, 1, (10, 10)),
                 (500, 1, (10, 10)), (600, 1, (4, 4))]
FLUSH_BYTES = 256 * 2**20        # written between cold calls; L2 is 50 MB

# published peaks, dense (NVIDIA data sheets): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores; matched on torch.cuda.get_device_name
CARD_SPECS = [("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12)]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_spec(name: str):
    for key, bw, flops in CARD_SPECS:
        if key in name:
            return key, bw, flops
    return "H100 (assumed: unknown card)", 3.35e12, 67e12


def stack_work(b, n, f0, widths):
    """(bytes, flops) the stack must move / do: every input read once, the
    output written once; matmuls + bias + relu."""
    dims = [f0] + list(widths)
    params = sum(dims[i] * dims[i + 1] + dims[i + 1] for i in range(len(widths)))
    nbytes = 4 * (b * n * n + b * n * f0 + b * n * sum(widths) + params)
    flops = b * sum(2 * n * dims[i] * dims[i + 1] + 2 * n * n * dims[i + 1]
                    + 2 * n * dims[i + 1] for i in range(len(widths)))
    return nbytes, flops


def stack_inputs(rng, b, n, f0, widths, dev):
    """A realistic propagation matrix (non-negative top-k adjacency with a
    nonzero diagonal, normalised; in the transposed memory layout
    `gcn_propagation_matrix` returns, as on the serving path) and
    glorot-scale weights."""
    adj = np.abs(rng.normal(size=(b, n, n))).astype(np.float32)
    kth = np.partition(adj, n - 10, axis=1)[:, n - 10][:, None, :]
    adj[adj < kth] = 0.0
    adj[:, np.arange(n), np.arange(n)] += 0.5
    prop = gcn_propagation_matrix(torch.from_numpy(adj).to(dev))
    x = torch.from_numpy(rng.normal(size=(b, n, f0)).astype(np.float32)).to(dev)
    dims = [f0] + list(widths)
    ws = [torch.from_numpy(rng.normal(0, (2.0 / (dims[i] + dims[i + 1])) ** 0.5,
                                      (dims[i], dims[i + 1])).astype(np.float32)).to(dev)
          for i in range(len(widths))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, (h,)).astype(np.float32)).to(dev)
          for h in widths]
    return prop, x, ws, bs


def library_stack(prop, x, weights, biases):
    """The same stack as PyTorch library calls (bmm + baddbmm + relu). Used
    only as a yardstick here; the port never calls it."""
    h, feats = x, []
    for w, b in zip(weights, biases):
        h = torch.relu(torch.baddbmm(b, prop, torch.matmul(h, w)))
        feats.append(h)
    return torch.cat(feats, dim=-1)


def device_ms(fn, runs=25, inner=10):
    """Median device time of one call of `fn`, in ms, from CUDA events,
    warm: calls back to back, so inputs that fit stay in L2.

    Each run first queues a sleep kernel, so the host enqueues all `inner`
    calls while the card waits and the card then runs them back to back:
    the events time the device work, not the host's launch rate."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cold_device_ms(fn, flush, runs=25):
    """Median device time of one call of `fn`, in ms, with L2 cold: before
    each call the card writes all of `flush` (outside the events), so the
    call reads its inputs from device memory."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    torch.cuda._sleep(20_000_000)
    for _ in range(runs):
        flush.fill_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def make_cohort(rng, s, rois=90, feat=3, num_snps=54, k=10):
    """ADNI-shaped cohort: non-negative adjacency, sparse by top-k per column,
    with a nonzero diagonal; ROI features; SNPs in [0, 1]."""
    x = rng.normal(size=(s, rois, feat)).astype(np.float32)
    adj = np.abs(rng.normal(size=(s, rois, rois))).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    kth = np.partition(adj, rois - k, axis=1)[:, rois - k][:, None, :]
    adj[adj < kth] = 0.0
    adj[:, np.arange(rois), np.arange(rois)] += 0.5
    snps = rng.random((s, num_snps)).astype(np.float32)
    return x, adj, snps


def compare_predictions(got, want, what):
    for key in ("log_probs", "our_reg"):
        if got[key].shape != want[key].shape or not np.isfinite(got[key]).all():
            raise AssertionError(f"{what}: {key} shape {got[key].shape} vs "
                                 f"{want[key].shape}, or not finite")
        err = float(np.abs(got[key] - want[key]).max()) if got[key].size else 0.0
        if err > SERVE_ATOL:
            raise AssertionError(f"{what}: {key} differs by {err} > {SERVE_ATOL}")
    lp = want["log_probs"]
    decided = np.abs(lp[:, 0] - lp[:, 1]) > 1e-4
    if not np.array_equal(got["pred"][decided], want["pred"][decided]):
        raise AssertionError(f"{what}: pred differs on decided subjects")


def phase_build():
    log("== phase 1: card and build")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    sources = sorted(os.path.basename(p) for p in
                     glob.glob(os.path.join(cuda_build.CSRC_DIR, "*.cu")))
    t0 = time.perf_counter()
    cuda_build.build_all(sources)
    build_s = time.perf_counter() - t0
    for source, text in cuda_build.BUILD_LOGS.items():
        log(f"-- nvcc {source}:\n{text.strip()}")
    log(f"built {sources} in {build_s:.2f} s")
    return card, build_s


def phase_kernel_vs_plain(dev):
    log("== phase 2: kernel vs plain on the card")
    rng = np.random.default_rng(0)
    max_err = 0.0

    def check(what, prop, x, ws, bs):
        nonlocal max_err
        out = gcn_stack.fused_gcn_stack(prop, x, ws, bs)
        ref = gcn_stack.gcn_stack_reference(prop, x, ws, bs)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        max_err = max(max_err, err)
        log(f"{what}: max_abs_err {err:.3e}")

    with torch.inference_mode():
        runs = [(b, *shape) for b in STACK_BATCHES for shape in STACK_SHAPES]
        for b, n, f0, widths in runs + [(7, *shape) for shape in BRANCH_SHAPES]:
            prop, x, ws, bs = stack_inputs(rng, b, n, f0, widths, dev)
            plan = gcn_stack.plan_launch(b, n, (f0, *widths))
            for layout, p in (("transposed", prop),
                              ("row-major", prop.contiguous())):
                check(f"B={b} N={n} F0={f0} H={widths} P {layout} "
                      f"(cluster {plan.cluster}, ksplit {plan.ksplit}, "
                      f"{plan.threads} threads, {plan.smem_bytes} B)",
                      p, x, ws, bs)
        for n, f0 in ((90, 3), (270, 1)):   # isolated nodes: zero rows/cols
            adj = np.abs(rng.normal(size=(7, n, n))).astype(np.float32)
            adj[:, :5, :] = 0.0
            adj[:, :, :5] = 0.0
            prop = gcn_propagation_matrix(torch.from_numpy(adj).to(dev),
                                          add_self_loops=False)
            _, x, ws, bs = stack_inputs(rng, 7, n, f0, (10, 10), dev)
            check(f"B=7 N={n} isolated nodes 0-4", prop, x, ws, bs)
        # transposed P by 4-byte cp.asyncs: odd N (its shared-memory stride
        # is padded to N + 1), and a view 4 bytes past a 16-byte boundary
        for n, f0, widths in ((91, 3, (16, 16)), (271, 1, (10, 10, 10)),
                              (90, 3, (16, 16))):
            prop, x, ws, bs = stack_inputs(rng, 7, n, f0, widths, dev)
            what = f"B=7 N={n} P transposed"
            if n % 2 == 0:
                buf = torch.empty(prop.numel() + 1, device=dev)
                rows = buf[1:].view(prop.shape)
                rows.copy_(prop.transpose(1, 2))
                prop, what = rows.transpose(1, 2), what + ", 4-byte offset"
            plan = gcn_stack.plan_launch(7, n, (f0, *widths))
            if gcn_stack._bulk_copyable(prop, plan):
                raise AssertionError(f"{what}: expected the 4-byte copy path")
            check(f"{what}, 4-byte copies (cluster {plan.cluster})",
                  prop, x, ws, bs)
        prop, x, ws, bs = stack_inputs(rng, 2, 90, 3, (16, 16), dev)
        batch_minor = prop.transpose(0, 1).contiguous().transpose(0, 1)
        try:
            gcn_stack.fused_gcn_stack(batch_minor, x, ws, bs)
        except ValueError as e:
            log(f"other P layout refused: {e}")
        else:
            raise AssertionError("wrapper took a P of another layout")

    grads = []
    for fn in (gcn_stack.fused_gcn_stack, gcn_stack.gcn_stack_reference):
        prop, x, ws, bs = stack_inputs(np.random.default_rng(1), 7, 90, 3,
                                       (16, 16), dev)
        leaves = [prop, x, *ws, *bs]
        for t in leaves:
            t.requires_grad_(True)
        (fn(prop, x, ws, bs) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    log(f"gradients agree; kernel max_abs_err over all shapes {max_err:.3e}")
    return max_err


def phase_serve(dev, cohort):
    log("== phase 3: serving slice at full width")
    cfg = ModelConfig()
    topo = synthetic_topology(np.random.default_rng(0),
                              level_sizes=[250, 120, 50, 15, 1], num_snps=54)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = FusedSGCN(cfg, topo, generator=gen, device=dev).eval()
    with torch.no_grad():   # random running statistics for the eval-mode BNs
        for m in model.modules():
            if isinstance(m, BatchNorm1d):
                m.running_mean.normal_(0.0, 0.3, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    os.makedirs(OUT_DIR, exist_ok=True)
    bundle = os.path.join(OUT_DIR, "bundle.npz")
    save_bundle(bundle, model)
    gpu_model = load_bundle(bundle, device=dev)
    cpu_model = load_bundle(bundle, device="cpu")
    log(f"topology n={topo.n}, params "
        f"{sum(p.numel() for p in gpu_model.parameters())}")

    gcn_stack.fused_gcn_stack.launches = 0
    gpu = batched_forward(gpu_model, *cohort, batch_size=BATCH)
    launches = gcn_stack.fused_gcn_stack.launches
    want_launches = math.ceil(len(cohort[0]) / BATCH)
    if launches != want_launches:
        raise AssertionError(f"serving launched the kernel {launches} times, "
                             f"expected {want_launches}")
    cpu = batched_forward(cpu_model, *cohort, batch_size=BATCH)
    compare_predictions(gpu, cpu, "card vs CPU serving")
    log(f"served {COHORT} subjects on the card: {launches} kernel launches; "
        f"matches the CPU plain path (log_probs max diff "
        f"{np.abs(gpu['log_probs'] - cpu['log_probs']).max():.3e}, our_reg "
        f"{np.abs(gpu['our_reg'] - cpu['our_reg']).max():.3e}); class counts "
        f"{np.bincount(gpu['pred']).tolist()}")
    return gpu_model, gpu, launches


def _post(addr, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    conn = http.client.HTTPConnection(*addr, timeout=120)
    conn.request("POST", "/predict", body=buf.getvalue())
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    if resp.status != 200:
        raise AssertionError(f"/predict answered {resp.status}: {body[:200]}")
    with np.load(io.BytesIO(body)) as zf:
        return {k: zf[k] for k in zf.files}


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return body


def phase_http(dev, model, cohort, want):
    log("== phase 4: HTTP daemon on the card")
    server = build_http_server(model, device=dev, port=0, batch=BATCH)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        log(f"/health {json.dumps(_get(addr, '/health'))}")
        lo = 0
        for n in (1, 37, 256):
            got = _post(addr, {k: v[lo:lo + n] for k, v in
                               zip(("x", "adj", "snps"), cohort)})
            compare_predictions(got, {k: v[lo:lo + n] for k, v in want.items()},
                                f"/predict of {n} subjects")
            lo += n
        request = {k: v[:BATCH] for k, v in zip(("x", "adj", "snps"), cohort)}
        latencies = []
        for _ in range(20):
            t0 = time.perf_counter()
            _post(addr, request)
            latencies.append((time.perf_counter() - t0) * 1e3)
        stats = _get(addr, "/stats")
        log(f"/stats {json.dumps(stats)}")
        if (stats["requests"], stats["errors"]) != (23, 0):
            raise AssertionError(f"/stats counted {stats['requests']} requests "
                                 f"and {stats['errors']} errors; sent 23, "
                                 "all answered")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {"client_p50_ms": statistics.median(latencies),
            "server_p50_ms": stats["latency_ms"]["p50"],
            "requests": stats["requests"]}


def phase_times(dev, card_name, model, cohort):
    log("== phase 5: times")
    spec, bw, peak = card_spec(card_name)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(2)
    shapes = []
    with torch.inference_mode():
        for name, b, n, f0, widths in TIMED_SHAPES:
            args = stack_inputs(rng, b, n, f0, widths, dev)
            fns = {"kernel": lambda: gcn_stack.fused_gcn_stack(*args),
                   "plain": lambda: gcn_stack.gcn_stack_reference(*args),
                   "library": lambda: library_stack(*args)}
            nbytes, flops = stack_work(b, n, f0, widths)
            bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
            row = {"shape": name, "B": b, "N": n, "F0": f0,
                   "widths": list(widths), "bytes": nbytes, "flops": flops,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
            for what, fn in fns.items():
                row[f"{what}_ms"] = device_ms(fn)
                row[f"{what}_cold_ms"] = cold_device_ms(fn, flush)
            shapes.append(row)
            log(f"gcn_stack {name} B={b} N={n} F0={f0} H={widths}: kernel "
                f"{row['kernel_ms']:.5f} ms warm / {row['kernel_cold_ms']:.5f} "
                f"cold, plain {row['plain_ms']:.5f} / {row['plain_cold_ms']:.5f}, "
                f"library {row['library_ms']:.5f} / {row['library_cold_ms']:.5f}, "
                f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}; {nbytes} B, "
                f"{flops} FLOP, {spec} peaks)")
    del flush
    for row in shapes:
        b, n, f0, widths = row["B"], row["N"], row["F0"], tuple(row["widths"])
        plan = gcn_stack.plan_launch(b, n, (f0, *widths))
        row["plan"] = {"cluster": plan.cluster, "ksplit": plan.ksplit,
                       "threads": plan.threads, "smem_bytes": plan.smem_bytes}
    batched_forward(model, *cohort, batch_size=BATCH)   # warm
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        batched_forward(model, *cohort, batch_size=BATCH)
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"serve {COHORT} subjects {wall:.6f} s")
    return {"shapes": shapes, "spec": spec,
            "serve_cohort_s": wall}


def _device_events(prof):
    """(name, start_us, end_us) of every device activity the profiler saw."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def phase_profile(dev, model, cohort):
    log("== phase 6: profiler")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    request = [a[:BATCH] for a in cohort]
    batched_forward(model, *request, batch_size=BATCH)   # warm
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        batched_forward(model, *request, batch_size=BATCH)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    prop, x, ws, bs = stack_inputs(np.random.default_rng(3), BATCH, 90, 3,
                                   (16, 16), dev)
    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=acts) as one:
        gcn_stack.fused_gcn_stack(prop, x, ws, bs)
        torch.cuda.synchronize()
    single = _device_events(one)
    if not events or not single:
        raise AssertionError("the profiler recorded no device activity: the "
                             "one-kernel-per-call check did not run")
    totals = {}
    for name, t0, t1 in events:
        tot, cnt = totals.get(name, (0.0, 0))
        totals[name] = (tot + t1 - t0, cnt + 1)
    busy, end = 0.0, -math.inf
    for _, t0, t1 in sorted(events, key=lambda e: e[1]):   # union of spans
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    device_us = sum(t for t, _ in totals.values())
    kernel_us = sum(t for name, (t, _) in totals.items()
                    if "gcn_stack_kernel" in name)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    out = {"forward_wall_us": wall_us, "device_busy_us": busy,
           "device_op_us": device_us, "device_ops": len(events),
           "idle_share": 1.0 - busy / wall_us,
           "gcn_stack_us": kernel_us, "gcn_stack_share": kernel_us / device_us,
           "top10": [{"name": name, "us": t, "count": c}
                     for name, (t, c) in top],
           "single_call_device_ops": [name for name, _, _ in single]}
    log(f"serving forward of {BATCH} subjects: host wall {wall_us:.1f} us, "
        f"device busy {busy:.1f} us over {len(events)} device ops (idle share "
        f"{out['idle_share']:.3f}); gcn_stack {kernel_us:.1f} us = "
        f"{out['gcn_stack_share']:.4f} of device time")
    for row in out["top10"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<4d} {row['name'][:110]}")
    log(f"one fused_gcn_stack call ran {len(single)} device op(s): "
        f"{out['single_call_device_ops']}")
    if len(single) != 1 or "gcn_stack_kernel" not in single[0][0]:
        raise AssertionError("one fused_gcn_stack call must run exactly one "
                             f"device kernel, its own; ran {single}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card, build_s = phase_build()
    max_err = phase_kernel_vs_plain(dev)
    cohort = make_cohort(np.random.default_rng(1), COHORT)
    model, served, launches = phase_serve(dev, cohort)
    http_times = phase_http(dev, model, cohort, served)
    times = phase_times(dev, torch.cuda.get_device_name(0), model, cohort)
    profile = phase_profile(dev, model, cohort)

    serving, *others = times["shapes"]
    kernels = {"kernels": [{
        "name": "gcn_stack", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:83",
        "launches": launches, "max_abs_err": max_err,
        "ms": serving["kernel_ms"], "kernel_ms": serving["kernel_ms"],
        "cold_ms": serving["kernel_cold_ms"],
        "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"], "library_ms": serving["library_ms"],
        "shapes": [{k: row[k] for k in (
            "shape", "B", "N", "F0", "widths", "kernel_ms", "kernel_cold_ms",
            "plain_ms", "plain_cold_ms", "library_ms", "library_cold_ms",
            "bound_ms", "bound_by")} for row in others]}]}
    serve = {"serve": {"subjects": COHORT, "batch": BATCH,
                       "cohort_wall_s": times["serve_cohort_s"],
                       "request_subjects": BATCH, **http_times}}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, **kernels, **serve,
                   "times": times, "profile": profile, "device": device},
                  fh, indent=1)
    log(card)
    log(json.dumps(serve))
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
