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
     order), plus the autograd gradients through both, and at the training
     shape (B=32, N=90) with P built by `gcn_propagation_matrix` from an
     adjacency that requires grad (the transposed view the training path
     passes), gradients into the adjacency included; rtol/atol 1e-4;
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
     latency; for training at full width (fold 0 of phase 7's cohort, B=32):
     one train step's device time (the union of its device ops from the profiler over five
     steps), its span on the card (CUDA events) and its host wall, the
     kernel's forward against the autograd backward (the recompute
     through the plain version) at B=32, and graphs/s over one epoch;
  6. one torch.profiler pass over a warm serving forward of 256 subjects
     and one over a warm train step: the kernel's share of device time,
     the device's idle share, the top 10 device ops; and one over a single
     `fused_gcn_stack` call, which must launch exactly one device kernel;
     the train step must launch the kernel twice, and so must one eval
     batch (counted);
  7. the training slice at full width: `iggcn_tpu_torch.main.main` on the
     card, default ModelConfig (L=2, H=16), the real-scale GO topology, an
     874-subject synthetic cohort, batch 32, 5 folds with val, 3 epochs,
     --lambda_disease 1.0; every printed loss finite, the `Result -` line
     printed, the experiment's wall time, and the kernel's launches over
     the run equal to what the loop implies (2 per train step and 2 per
     eval batch: sum over folds of epochs x 2 x (train + val + test
     batches)); then six train steps of fold 0 from the same weights at
     dropout 0 on the card, on the CPU and on the CPU in float64:
     per-step losses card vs CPU within rtol 2e-4, the first step's
     gradients and the final params and batch_stats held to float64 as
     `card_vs_cpu_steps` states (the 1e-4 pin, widened only where the
     CPU's own fp32 departs from exact arithmetic).

It prints the `kernels` JSON line before the last line, and as the last
line `{"ok": true, "device": {...}}`. Everything it measures is also
written to results/chip_smoke/result.json (git-ignored).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import glob
import http.client
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from iggcn_tpu_torch import main as port_main
from iggcn_tpu_torch.config import ModelConfig
from iggcn_tpu_torch.data.batching import cohort_batch_arrays
from iggcn_tpu_torch.data.go_graph import synthetic_topology
from iggcn_tpu_torch.data.splits import k_fold
from iggcn_tpu_torch.models.fused_sgcn import FusedSGCN
from iggcn_tpu_torch.models.nn_compat import BatchNorm1d
from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.predict import batched_forward
from iggcn_tpu_torch.tools.serve import (build_http_server, load_bundle,
                                         save_bundle)
from iggcn_tpu_torch.train import fold_loop, steps
from iggcn_tpu_torch.train.cv import init_fold_model, prepare_fold, to_device
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
# phase 7: the training route at full width (default ModelConfig L=2, H=16;
# the real GO graph's scale; batch 32; 5 folds with val; 3 epochs)
TRAIN_EPOCHS, TRAIN_FOLDS, TRAIN_BATCH = 3, 5, 32
GO_LEVELS = "250,120,50,15,1"
TRAIN_ARGV = ["--device", "cuda", "--synthetic", "--synthetic_subjects",
              str(COHORT), "--synthetic_go_levels", GO_LEVELS, "--epochs",
              str(TRAIN_EPOCHS), "--fold", str(TRAIN_FOLDS), "--batch_size",
              str(TRAIN_BATCH), "--no-search", "--layers", "2", "--hiddens",
              "16", "--lambda_disease", "1.0", "--save_appendix",
              "_chip_smoke"]
CARD_CPU_STEPS = 6
EPOCH_LINE = re.compile(r"^Fold: (\d+), epoch:(\d+), train_loss: ([^,]+), "
                        r"val_loss: ([^,]+), test_loss: ([^,]+), acc:", re.M)

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


def stack_inputs(rng, b, n, f0, widths, dev, adjacency=False):
    """A realistic propagation matrix (non-negative top-k adjacency with a
    nonzero diagonal, normalised; in the transposed memory layout
    `gcn_propagation_matrix` returns, as on the serving path; the adjacency
    itself with `adjacency=True`) and glorot-scale weights."""
    adj = np.abs(rng.normal(size=(b, n, n))).astype(np.float32)
    kth = np.partition(adj, n - 10, axis=1)[:, n - 10][:, None, :]
    adj[adj < kth] = 0.0
    adj[:, np.arange(n), np.arange(n)] += 0.5
    prop = torch.from_numpy(adj).to(dev)
    if not adjacency:
        prop = gcn_propagation_matrix(prop)
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


def device_ms(fn, runs=25, inner=10, sleep_cycles=20_000_000):
    """Median device time of one call of `fn`, in ms, from CUDA events,
    warm: calls back to back, so inputs that fit stay in L2.

    Each run first queues a sleep kernel, so the host enqueues all `inner`
    calls while the card waits and the card then runs them back to back:
    the events time the device work, not the host's launch rate. The sleep
    must outlast the enqueueing (a train step enqueues hundreds of ops)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
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
    # the training shape as the train step sees it: P from
    # gcn_propagation_matrix of an adjacency that requires grad (its
    # transposed view), so the gradient reaches the adjacency through P
    rng = np.random.default_rng(4)
    adj0, x0, ws0, bs0 = stack_inputs(rng, TRAIN_BATCH, 90, 3, (16, 16),
                                      "cpu", adjacency=True)
    cot = torch.from_numpy(rng.normal(size=(TRAIN_BATCH, 90, 32)).astype(
        np.float32)).to(dev)
    grads = []
    for fn in (gcn_stack.fused_gcn_stack, gcn_stack.gcn_stack_reference):
        leaves = [t.to(dev).requires_grad_(True)
                  for t in (adj0, x0, *ws0, *bs0)]
        adj, x, ws, bs = leaves[0], leaves[1], leaves[2:4], leaves[4:]
        prop = gcn_propagation_matrix(adj)
        if not gcn_stack._prop_transposed(prop):
            raise AssertionError("expected the transposed P view")
        (fn(prop, x, ws, bs) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    train_grad_err = 0.0
    for name, g, r in zip(("adj", "x", "W0", "W1", "b0", "b1"), *grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        train_grad_err = max(train_grad_err, float((g - r).abs().max()))
        log(f"training-shape gradient of {name}: max_abs_err "
            f"{float((g - r).abs().max()):.3e}")
    log(f"gradients agree; kernel max_abs_err over all shapes {max_err:.3e}")
    return max_err, train_grad_err


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
    """(name, start_us, end_us) of every device activity the profiler saw:
    kernels, copies and sets, not the annotation ranges (such as
    `Optimizer.step#Adam.step`) that span several of them."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def summarize_profile(events, wall_us):
    """Device busy time (union of spans), the kernel's share of device
    time, the idle share of the host wall and the top 10 device ops."""
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
    return {"wall_us": wall_us, "device_busy_us": busy,
            "device_op_us": device_us, "device_ops": len(events),
            "idle_share": 1.0 - busy / wall_us,
            "gcn_stack_us": kernel_us, "gcn_stack_share": kernel_us / device_us,
            "gcn_stack_launches": sum(c for name, (_, c) in totals.items()
                                      if "gcn_stack_kernel" in name),
            "top10": [{"name": name, "us": t, "count": c}
                      for name, (t, c) in top]}


def log_profile(what, out):
    log(f"{what}: host wall {out['wall_us']:.1f} us, device busy "
        f"{out['device_busy_us']:.1f} us over {out['device_ops']} device ops "
        f"(idle share {out['idle_share']:.3f}); gcn_stack "
        f"{out['gcn_stack_us']:.1f} us in {out['gcn_stack_launches']} "
        f"launch(es) = {out['gcn_stack_share']:.4f} of device time")
    for row in out["top10"]:
        log(f"  {row['us']:10.1f} us  x{row['count']:<4d} {row['name'][:110]}")


def profiled(fn, attempts=3):
    """(device events, host wall in us) of one call of `fn`. A profiler
    session over a single short kernel has come back with no device
    records at all on the card; such a session is logged and `fn` is
    profiled again, up to `attempts` sessions."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = _device_events(prof)
        if events:
            return events, wall_us
        log(f"profiler session {attempt} of {attempts} recorded no device "
            "activity")
    raise AssertionError("the profiler recorded no device activity")


def phase_profile(dev, model, cohort, train):
    log("== phase 6: profiler")
    request = [a[:BATCH] for a in cohort]
    batched_forward(model, *request, batch_size=BATCH)   # warm
    events, wall_us = profiled(
        lambda: batched_forward(model, *request, batch_size=BATCH))
    prop, x, ws, bs = stack_inputs(np.random.default_rng(3), BATCH, 90, 3,
                                   (16, 16), dev)
    with torch.inference_mode():
        single, _ = profiled(lambda: gcn_stack.fused_gcn_stack(prop, x, ws, bs))
    train["step"]()                                      # warm
    step_events, step_wall_us = profiled(train["step"])
    out = summarize_profile(events, wall_us)
    out["forward_wall_us"] = wall_us
    out["single_call_device_ops"] = [name for name, _, _ in single]
    log_profile(f"serving forward of {BATCH} subjects", out)
    log(f"one fused_gcn_stack call ran {len(single)} device op(s): "
        f"{out['single_call_device_ops']}")
    if len(single) != 1 or "gcn_stack_kernel" not in single[0][0]:
        raise AssertionError("one fused_gcn_stack call must run exactly one "
                             f"device kernel, its own; ran {single}")
    out["train_step"] = summarize_profile(step_events, step_wall_us)
    log_profile(f"warm train step (B={TRAIN_BATCH}, both passes, backward, "
                "Adam)", out["train_step"])
    if out["train_step"]["gcn_stack_launches"] != 2:
        raise AssertionError("a train step must launch the kernel twice (plain "
                             "and masked pass); the profiler saw "
                             f"{out['train_step']['gcn_stack_launches']}")
    gcn_stack.fused_gcn_stack.launches = 0
    steps.eval_step(train["state"].model, train["eval_batch"], train["mcfg"],
                    train["tcfg"])
    torch.cuda.synchronize()
    out["eval_batch_launches"] = gcn_stack.fused_gcn_stack.launches
    log(f"one eval batch (B={TRAIN_BATCH}, both passes) launched the kernel "
        f"{out['eval_batch_launches']} times")
    if out["eval_batch_launches"] != 2:
        raise AssertionError("an eval batch must launch the kernel twice; it "
                             f"launched {out['eval_batch_launches']}")
    return out


def training_setup(dev):
    """Phase 7's experiment, fold 0, built through the CLI's own helpers
    from TRAIN_ARGV: configs, cohort, splits, fold 0's data on the card and
    a fresh fold-0 train state; `step` runs one train step on the first
    batch, `eval_batch` is fold 0's first test batch."""
    args = port_main.build_parser().parse_args(TRAIN_ARGV)
    dcfg = port_main.DataConfig(disease_id=args.disease_id)
    with contextlib.redirect_stdout(io.StringIO()):
        cohort, topo = port_main.load_cohort(args, dcfg,
                                             np.random.default_rng(args.seed))
    mcfg, tcfg = port_main.fused_cfgs(args, dcfg, args.layers, args.hiddens)
    splits = k_fold(cohort.y, tcfg.folds, tcfg.seed)
    fold0 = prepare_fold(cohort, cohort_batch_arrays(cohort), splits[0], 0,
                         tcfg, tcfg.clinical_score_index)
    model, generator = init_fold_model(mcfg, topo, tcfg.seed, 0, dev)
    spe = fold0["train_data"]["y"].shape[0] // tcfg.batch_size
    state = steps.TrainState(model, tcfg, spe)
    train_dev = to_device(fold0["train_data"], dev)
    batch = {k: v[:tcfg.batch_size] for k, v in train_dev.items()}
    eval_batch = {k: v[:tcfg.batch_size] for k, v in
                  to_device(fold0["test_data"], dev).items()}
    log(f"training setup: GO topology n={topo.n}, {len(cohort)} subjects, "
        f"{sum(p.numel() for p in model.parameters())} parameters, fold 0 "
        f"train {fold0['n_train']} / val {fold0['n_val']} / test "
        f"{fold0['n_test']}")
    return {"args": args, "mcfg": mcfg, "tcfg": tcfg, "topo": topo,
            "splits": splits, "fold0": fold0, "state": state,
            "generator": generator, "train_dev": train_dev,
            "eval_batch": eval_batch,
            "step": lambda: steps.train_step(state, batch, mcfg, tcfg,
                                             generator)}


def expected_launches(splits, tcfg):
    """The kernel's launches over one CV run with a validation split, as
    the loop implies: 2 per train step (plain and masked pass) and 2 per
    eval batch, every epoch, over the train, val and test batches."""
    b = tcfg.batch_size
    return sum(tcfg.epochs * 2 * sum(math.ceil(len(idx) / b) for idx in split)
               for split in splits)


def phase_train_times(dev, train):
    log("== phase 5 (training): train step, forward vs backward, epoch")
    walls = []
    for _ in range(5):
        train["step"]()
    torch.cuda.synchronize()
    for _ in range(25):
        t0 = time.perf_counter()
        train["step"]()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_wall_ms = statistics.median(walls)
    # span of one step on the card's clock (CUDA events around it): it
    # includes the gaps in which the card waits for the host
    spans = []
    for _ in range(25):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        train["step"]()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    step_span_ms = statistics.median(spans)
    # the step's device time: the union of its device ops' spans, from the
    # profiler over 5 steps. A sleep before the step cannot hide the host
    # here: the step's ~2,000 launches overrun the launch queue, so the
    # host paces part of it whatever the card does.
    events, _ = profiled(lambda: [train["step"]() for _ in range(5)])
    step_device_ms = summarize_profile(events, 1.0)["device_busy_us"] / 5e3
    prop, x, ws, bs = stack_inputs(np.random.default_rng(5), TRAIN_BATCH, 90,
                                   3, (16, 16), dev)
    leaves = [t.requires_grad_(True) for t in (prop, x, *ws, *bs)]
    with torch.inference_mode():
        fwd_ms = device_ms(lambda: gcn_stack.fused_gcn_stack(prop, x, ws, bs))
    out = gcn_stack.fused_gcn_stack(prop, x, ws, bs)
    grad_out = torch.randn_like(out)
    def backward():
        return torch.autograd.grad(out, leaves, grad_out, retain_graph=True)

    bwd_ms = device_ms(backward, sleep_cycles=100_000_000)
    bwd_events, _ = profiled(backward)
    bwd = summarize_profile(bwd_events, 1.0)
    bwd_busy_ms = bwd["device_busy_us"] / 1e3
    tcfg, mcfg, fold0 = train["tcfg"], train["mcfg"], train["fold0"]
    perm = torch.as_tensor(fold0["perms"][0], device=dev).long()
    fold_loop.train_epoch(train["state"], train["train_dev"], perm, mcfg,
                          tcfg, train["generator"])           # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fold_loop.train_epoch(train["state"], train["train_dev"], perm, mcfg,
                          tcfg, train["generator"])
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    out = {"step_wall_ms": step_wall_ms, "step_span_ms": step_span_ms,
           "step_device_ms": step_device_ms,
           "fwd_kernel_b32_ms": fwd_ms, "bwd_recompute_b32_ms": bwd_ms,
           "bwd_recompute_b32_busy_ms": bwd_busy_ms,
           "bwd_recompute_b32_ops": bwd["device_ops"],
           "epoch_s": epoch_s, "epoch_graphs": fold0["n_train"],
           "epoch_graphs_per_s": fold0["n_train"] / epoch_s}
    log(f"train step B={TRAIN_BATCH}: device busy {step_device_ms:.4f} ms, "
        f"span on the card {step_span_ms:.4f} ms, host wall "
        f"{step_wall_ms:.4f} ms; gcn_stack at B={TRAIN_BATCH}: forward kernel "
        f"{fwd_ms:.5f} ms, autograd backward (recompute) {bwd_ms:.5f} ms "
        f"(events; profiler busy {bwd_busy_ms:.5f} ms over "
        f"{bwd['device_ops']} device ops); one epoch of fold 0: "
        f"{fold0['n_train']} graphs in "
        f"{epoch_s:.4f} s = {out['epoch_graphs_per_s']:.1f} graphs/s")
    return out


def adam_step_bound(tcfg, steps_per_epoch, t, b1=0.9, b2=0.999):
    """Largest move of a parameter in Adam step t (1-based) from a fresh
    state, whatever its gradients: by Cauchy-Schwarz on the moment sums,
    lr_t (1-b1)/(1-b1^t) sqrt((1-b2^t)/(1-b2)) sqrt(sum_{k<t} (b1^2/b2)^k),
    which stays near lr_t over the first steps."""
    r = b1 * b1 / b2
    return (steps.lr_at_step(tcfg, t - 1, steps_per_epoch)
            * (1 - b1) / (1 - b1 ** t) * math.sqrt((1 - b2 ** t) / (1 - b2))
            * math.sqrt((1 - r ** t) / (1 - r)))


def _floats(model):
    return {n: t.detach().double().cpu().numpy()
            for n, t in model.state_dict().items() if t.is_floating_point()}


def card_vs_cpu_steps(dev, train):
    """Six train steps of fold 0 on the card at dropout 0, each repeated on
    the CPU and on the CPU in float64 from the card's state before it
    (params, batch statistics, Adam's moments and step count), so that each
    step is compared from the same start and device rounding does not
    compound through Adam. Checks, at every step:

      * the loss sum, card vs CPU: rtol 2e-4;
      * the gradients (pre-Adam, before the coupled L2 decay), per leaf
        against float64: |g_card - g64| <= 1e-3 |g64| + 2 |g_cpu - g64|
        (L2 norms), except the leaves whose gradient is zero to rounding
        (|g64| <= |g_cpu - g64|), which are logged;
      * the params and batch statistics after the step, card vs CPU: atol
        1e-4 per entry, except the entries whose gradient is zero to
        rounding (|g64| no larger than the card's or the CPU's rounding of
        it, which is not 0; a constant on every attention key shifts no
        softmax, for one): Adam's step g / (sqrt(v) + eps) is scale-free,
        so each device moves such an entry by up to lr in whatever
        direction its rounding points; card vs CPU within twice
        `adam_step_bound`.

    Returns the readings; every leaf's gradient norms at the first step and
    every leaf with zero-to-rounding entries are logged."""
    mcfg = dataclasses.replace(train["mcfg"], dropout_lin=0.0,
                               dropout_regr=0.0, dropout_go=0.0,
                               dropout_readout=0.0)
    tcfg, fold0 = train["tcfg"], train["fold0"]
    cpu = torch.device("cpu")
    cpu_model, _ = init_fold_model(mcfg, train["topo"], tcfg.seed, 0, cpu)
    perm = fold0["perms"][0]
    shuffled = {k: v[perm] for k, v in fold0["train_data"].items()}
    spe = perm.shape[0] // tcfg.batch_size
    sides = {}
    for side, model, device, dtype in [
            ("card", copy.deepcopy(cpu_model).to(dev), dev, torch.float32),
            ("cpu", cpu_model, cpu, torch.float32),
            ("float64", copy.deepcopy(cpu_model).double(), cpu,
             torch.float64)]:
        data = {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in to_device(shuffled, device).items()}
        sides[side] = (steps.TrainState(model, tcfg, spe), data)
    card = sides["card"][0]
    failures, rows, losses = [], [], {s: [] for s in sides}
    for t in range(1, CARD_CPU_STEPS + 1):
        for side in ("cpu", "float64"):
            state = sides[side][0]
            state.model.load_state_dict(card.model.state_dict())
            state.optimizer.load_state_dict(
                copy.deepcopy(card.optimizer.state_dict()))
            state.step = card.step
        grads, after = {}, {}
        for side, (state, data) in sides.items():
            batch = {k: v[(t - 1) * tcfg.batch_size:t * tcfg.batch_size]
                     for k, v in data.items()}
            losses[side].append(float(steps.train_step(state, batch, mcfg,
                                                       tcfg, None)))
            grads[side] = {n: p.grad.detach().double().cpu().numpy()
                           for n, p in state.model.named_parameters()
                           if p.grad is not None}
            after[side] = _floats(state.model)
        if not math.isclose(losses["card"][-1], losses["cpu"][-1],
                            rel_tol=2e-4):
            failures.append(f"step {t}: loss sum {losses['card'][-1]} on the "
                            f"card, {losses['cpu'][-1]} on the CPU")
        bound = 2 * adam_step_bound(tcfg, spe, t)
        zero = {}
        for n, g64 in grads["float64"].items():
            g_card, g_cpu = grads["card"][n], grads["cpu"][n]
            rounding = np.maximum(np.abs(g_cpu - g64), np.abs(g_card - g64))
            zero[n] = (np.abs(g64) <= rounding) & (rounding > 0)
            norm = float(np.linalg.norm(g64))
            cpu_err = float(np.linalg.norm(g_cpu - g64))
            card_err = float(np.linalg.norm(g_card - g64))
            allowed = 1e-3 * norm + 2 * cpu_err
            leaf_zero = norm <= cpu_err
            rows.append({"step": t, "leaf": n, "norm64": norm,
                         "cpu_err": cpu_err, "card_err": card_err,
                         "allowed": allowed, "leaf_zero": leaf_zero,
                         "zero_entries": int(zero[n].sum()),
                         "entries": int(g64.size)})
            if t == 1 or leaf_zero:
                log(f"step {t} grad {n}: |g64| {norm:.4e}, |cpu - g64| "
                    f"{cpu_err:.4e}, |card - g64| {card_err:.4e} (allowed "
                    f"{allowed:.4e}){' ZERO TO ROUNDING' if leaf_zero else ''}"
                    f", {int(zero[n].sum())}/{g64.size} entries zero to "
                    f"rounding")
            if not leaf_zero and card_err > allowed:
                failures.append(f"step {t} grad {n}: |card - g64| "
                                f"{card_err:.3e} > {allowed:.3e}")
        for n, got in after["card"].items():
            diff = np.abs(got - after["cpu"][n])
            walking = zero.get(n, np.zeros(diff.shape, bool))
            pinned = float(diff[~walking].max(initial=0.0))
            walked = float(diff[walking].max(initial=0.0))
            rows.append({"step": t, "leaf": n, "state_max": pinned,
                         "walking": int(walking.sum()),
                         "walk_max": walked})
            if walking.any():
                log(f"step {t} state {n}: {int(walking.sum())} "
                    f"zero-to-rounding entries moved {walked:.3e} apart "
                    f"(bound {bound:.3e}); the others {pinned:.3e}")
            if pinned > 1e-4:
                failures.append(f"step {t} state {n}: {pinned:.3e} > 1e-4")
            if walked > bound:
                failures.append(f"step {t} state {n}: zero-to-rounding "
                                f"entries {walked:.3e} > {bound:.3e}")
    for side, series in losses.items():
        log(f"loss sums, {side}: {series}")
    if failures:
        raise AssertionError("card vs CPU: " + "; ".join(failures))
    state_rows = [r for r in rows if "state_max" in r]
    grad_rows = [r for r in rows if "norm64" in r and not r["leaf_zero"]]
    out = {"steps": CARD_CPU_STEPS, "loss_sums_card": losses["card"],
           "loss_sums_cpu": losses["cpu"],
           "loss_sums_float64": losses["float64"],
           "loss_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                    zip(losses["card"], losses["cpu"])),
           "state_max_abs_diff": max(r["state_max"] for r in state_rows),
           "walk_max": max(r["walk_max"] for r in state_rows),
           "grad_max_rel_err": max(r["card_err"] / r["norm64"]
                                   for r in grad_rows),
           "grad_cpu_max_rel_err": max(r["cpu_err"] / r["norm64"]
                                       for r in grad_rows),
           "zero_leaves": sorted({f"{r['leaf']}@{r['step']}" for r in rows
                                  if r.get("leaf_zero")}),
           "rows": rows}
    log(f"card vs CPU over {CARD_CPU_STEPS} steps, each from the card's "
        f"state: loss max rel diff {out['loss_max_rel_diff']:.3e}; gradients "
        f"max rel err vs float64 {out['grad_max_rel_err']:.3e} on the card, "
        f"{out['grad_cpu_max_rel_err']:.3e} on the CPU; params/batch_stats "
        f"max abs diff {out['state_max_abs_diff']:.3e} (pin 1e-4), "
        f"zero-to-rounding entries up to {out['walk_max']:.3e}; leaves zero "
        f"to rounding: {out['zero_leaves'] or 'none'}")
    return out


def phase_train(dev, train):
    log("== phase 7: training slice at full width")
    buf = io.StringIO()
    gcn_stack.fused_gcn_stack.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results = port_main.main(TRAIN_ARGV)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = gcn_stack.fused_gcn_stack.launches
    text = buf.getvalue()
    log(text.rstrip())
    epochs = EPOCH_LINE.findall(text)
    if len(epochs) != TRAIN_FOLDS * TRAIN_EPOCHS:
        raise AssertionError(f"expected {TRAIN_FOLDS * TRAIN_EPOCHS} epoch "
                             f"lines, got {len(epochs)}")
    bad = [e for e in epochs if not all(np.isfinite(float(v)) for v in e[2:])]
    if bad:
        raise AssertionError(f"non-finite losses: {bad}")
    result = re.search(r"^Result - .*$", text, re.M)
    if result is None:
        raise AssertionError("no `Result -` line")
    want = expected_launches(train["splits"], train["tcfg"])
    if launches != want:
        raise AssertionError(f"the training run launched the kernel "
                             f"{launches} times; the loop implies {want}")
    steps_run = sum(TRAIN_EPOCHS * math.ceil(len(tr) / TRAIN_BATCH)
                    for tr, _, _ in train["splits"])
    log(f"experiment: {wall_s:.3f} s wall, {launches} kernel launches (= "
        f"{want} implied: {steps_run} train steps x 2 + eval batches x 2), "
        f"{result.group(0)}")
    card_cpu = card_vs_cpu_steps(dev, train)
    res = results[0]
    return {"experiment_wall_s": wall_s, "launches": launches,
            "expected_launches": want, "train_steps": steps_run,
            "result_line": result.group(0),
            "throughput_graphs_per_s": res.throughput_graphs_per_sec,
            "fold_durations_s": res.durations,
            "subjects": COHORT, "folds": TRAIN_FOLDS, "epochs": TRAIN_EPOCHS,
            "batch": TRAIN_BATCH, "card_vs_cpu": card_cpu}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card, build_s = phase_build()
    max_err, train_grad_err = phase_kernel_vs_plain(dev)
    cohort = make_cohort(np.random.default_rng(1), COHORT)
    model, served, launches = phase_serve(dev, cohort)
    http_times = phase_http(dev, model, cohort, served)
    times = phase_times(dev, torch.cuda.get_device_name(0), model, cohort)
    train = training_setup(dev)
    train_times = phase_train_times(dev, train)
    profile = phase_profile(dev, model, cohort, train)
    training = phase_train(dev, train)

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
        "training": {
            "launches_per_train_step":
                profile["train_step"]["gcn_stack_launches"],
            "launches_per_eval_batch": profile["eval_batch_launches"],
            "launches_run": training["launches"],
            "expected_launches_run": training["expected_launches"],
            "step_device_ms": train_times["step_device_ms"],
            "step_span_ms": train_times["step_span_ms"],
            "step_wall_ms": train_times["step_wall_ms"],
            "fwd_kernel_b32_ms": train_times["fwd_kernel_b32_ms"],
            "bwd_recompute_b32_ms": train_times["bwd_recompute_b32_ms"],
            "grad_max_abs_err_b32": train_grad_err,
            "step_gcn_stack_share": profile["train_step"]["gcn_stack_share"],
            "step_idle_share": profile["train_step"]["idle_share"]},
        "shapes": [{k: row[k] for k in (
            "shape", "B", "N", "F0", "widths", "kernel_ms", "kernel_cold_ms",
            "plain_ms", "plain_cold_ms", "library_ms", "library_cold_ms",
            "bound_ms", "bound_by")} for row in others]}]}
    serve = {"serve": {"subjects": COHORT, "batch": BATCH,
                       "cohort_wall_s": times["serve_cohort_s"],
                       "request_subjects": BATCH, **http_times},
             "train": {"experiment_wall_s": training["experiment_wall_s"],
                       "throughput_graphs_per_s":
                           training["throughput_graphs_per_s"],
                       "epoch_graphs_per_s": train_times["epoch_graphs_per_s"],
                       "step_wall_ms": train_times["step_wall_ms"],
                       "step_device_ms": train_times["step_device_ms"],
                       "result_line": training["result_line"],
                       "card_vs_cpu_loss_max_rel_diff":
                           training["card_vs_cpu"]["loss_max_rel_diff"]}}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, **kernels, **serve,
                   "times": times, "train_times": train_times,
                   "profile": profile, "training": training,
                   "device": device}, fh, indent=1, default=float)
    log(card)
    log(json.dumps(serve))
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
