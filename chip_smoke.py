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
     `gcn_stack_reference` at every imaging-stack shape the model family
     uses (N=90, F0=3 and N=270, F0=1; B in {1, 7, 256}), rtol 1e-4 /
     atol 1e-5 (fp32, different summation order), plus the autograd
     gradients through both;
  3. the serving slice at full width: the default ModelConfig over a GO
     topology at the real scale, random weights from a seeded
     torch.Generator, written with save_bundle, read back with load_bundle
     and served to an 874-subject cohort at batch 256 on the card; held
     against the same bundle served on the CPU by the plain path
     (log_probs and our_reg within atol 1e-4, pred equal wherever the
     class log-probs differ by more than 1e-4), and the kernel's launch
     count over that run must be ceil(874 / 256) = 4;
  4. the HTTP daemon on the card: /health, three /predict requests of 1, 37
     and 256 subjects checked against phase 3, /stats;
  5. times, with CUDA events after warm-up, median of 25 runs: the kernel,
     its plain version and the same stack in torch.baddbmm/bmm calls, each
     beside its bound on this card; the serve-cohort wall time and the
     request latency.

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
# imaging-stack shapes of the model family: (N, F0, widths per layer)
STACK_SHAPES = [(90, 3, (16, 16)), (90, 3, (16, 16, 16)), (90, 3, (10, 10)),
                (90, 3, (10, 10, 10)), (90, 3, (5, 5, 5, 5)),
                (270, 1, (10, 10, 10)), (270, 1, (5, 5))]
SERVING_SHAPE = (BATCH, 90, 3, (16, 16))

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
    nonzero diagonal, normalised) and glorot-scale weights."""
    adj = np.abs(rng.normal(size=(b, n, n))).astype(np.float32)
    kth = np.partition(adj, n - 10, axis=1)[:, n - 10][:, None, :]
    adj[adj < kth] = 0.0
    adj[:, np.arange(n), np.arange(n)] += 0.5
    prop = gcn_propagation_matrix(torch.from_numpy(adj).to(dev)).contiguous()
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
    """Median device time of one call of `fn`, in ms, from CUDA events.

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
    with torch.inference_mode():
        for b in (1, 7, 256):
            for n, f0, widths in STACK_SHAPES:
                prop, x, ws, bs = stack_inputs(rng, b, n, f0, widths, dev)
                out = gcn_stack.fused_gcn_stack(prop, x, ws, bs)
                ref = gcn_stack.gcn_stack_reference(prop, x, ws, bs)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
                max_err = max(max_err, err)
                log(f"B={b} N={n} F0={f0} H={widths}: max_abs_err {err:.3e}")
        prop, x, ws, bs = stack_inputs(rng, 2, 90, 3, (16, 16), dev)
        try:
            gcn_stack.fused_gcn_stack(prop.transpose(1, 2), x, ws, bs)
        except ValueError as e:
            log(f"non-contiguous prop refused: {e}")
        else:
            raise AssertionError("wrapper took a non-contiguous prop")

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
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    return {"client_p50_ms": statistics.median(latencies),
            "server_p50_ms": stats["latency_ms"]["p50"],
            "requests": stats["requests"]}


def phase_times(dev, card_name, model, cohort):
    log("== phase 5: times")
    b, n, f0, widths = SERVING_SHAPE
    prop, x, ws, bs = stack_inputs(np.random.default_rng(2), b, n, f0,
                                   widths, dev)
    with torch.inference_mode():
        kernel_ms = device_ms(lambda: gcn_stack.fused_gcn_stack(prop, x, ws, bs))
        plain_ms = device_ms(lambda: gcn_stack.gcn_stack_reference(prop, x, ws, bs))
        library_ms = device_ms(lambda: library_stack(prop, x, ws, bs))
    spec, bw, peak = card_spec(card_name)
    nbytes, flops = stack_work(b, n, f0, widths)
    bytes_ms, flops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    batched_forward(model, *cohort, batch_size=BATCH)   # warm
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        batched_forward(model, *cohort, batch_size=BATCH)
        walls.append(time.perf_counter() - t0)
    times = {"kernel_ms": kernel_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "bound_ms": max(bytes_ms, flops_ms),
             "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
             "bytes": nbytes, "flops": flops, "spec": spec,
             "serve_cohort_s": statistics.median(walls)}
    log(f"gcn_stack at B={b} N={n} F0={f0} H={widths}: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{times['bound_ms']:.4f} ms ({times['bound_by']}; {nbytes} B, "
        f"{flops} FLOP, {spec} peaks); serve {COHORT} subjects "
        f"{times['serve_cohort_s']:.4f} s")
    return times


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

    kernels = {"kernels": [{
        "name": "gcn_stack", "route": "cuda",
        "source": "iggcn_tpu_torch/csrc/gcn_stack.cu",
        "replaces": "iggcn_tpu/ops/pallas_gcn.py:83",
        "launches": launches, "max_abs_err": max_err,
        "ms": times["kernel_ms"], "kernel_ms": times["kernel_ms"],
        "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"], "library_ms": times["library_ms"]}]}
    serve = {"serve": {"subjects": COHORT, "batch": BATCH,
                       "cohort_wall_s": times["serve_cohort_s"],
                       "request_subjects": BATCH, **http_times}}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "result.json"), "w") as fh:
        json.dump({"card": card, "build_s": build_s, **kernels, **serve,
                   "times": times, "device": device}, fh, indent=1)
    log(card)
    log(json.dumps(serve))
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
