"""Where the GCN-stack kernel's time goes, phase by phase, on the card.

The kernel layer's per-phase metric (PERF.md, sections 3 and 6). Builds
`csrc/gcn_stack.cu` and `csrc/gcn_stack_bf16.cu` a second time with
-DGCN_STACK_PHASES, in which thread 0 of every CTA stamps %globaltimer and
clock64 at each phase boundary, runs them (after warm-up, inputs warm in
L2) at the shapes `chip_smoke.py` times, fp32 and (for the serving
shapes) the bf16-operand form, and prints per shape the mean over the
CTAs of each phase's duration, the span of the whole launch and how far
apart the CTAs started (later waves). The persistent bf16 kernel sums
each phase over a CTA's samples: its rows are per sample (layer 0's h W
before the stage's wait, the wait, each layer's P hW and later layers' h W,
the output), beside the prologue's parts per CTA. Last it times the
persistent kernel at each K split its plan may choose, beside the fp32
form (`ksplit_sweep`). Then the backward kernel
(`csrc/gcn_stack_backward.cu`, stamped the same way) at the training
shapes: each phase's mean over the CTAs, from the prologue through the
recompute, each layer's backward steps and dP, with each P-product's FMAs
per SM clock (`run_backward_phases`). Needs a CUDA card:

    python -m iggcn_tpu_torch.tools.gcn_stack_phases
    python -m iggcn_tpu_torch.tools.gcn_stack_phases --backward
    python -m iggcn_tpu_torch.tools.gcn_stack_phases --backward-turns DIR
    python -m iggcn_tpu_torch.tools.gcn_stack_phases --streamed
    python -m iggcn_tpu_torch.tools.gcn_stack_phases --streamed-turns DIR

`--streamed` stamps the streamed form (`csrc/gcn_stack_streamed.cu`,
built with -DGCN_STACK_PHASES) instead, at `STREAMED_SHAPES` (chip_smoke.py's
timed shapes: the flagship at three layers of 128, N=90, and the zoo's GCN
at 620 nodes at 3 x 32, 3 x 16 and 2 x 10), forward and backward at B=32:
for every launch of the list its tile (BM x BN, K split, copy widths of A
and B), CTAs, the mean over its CTAs of
the prologue (copies issued), the main loop and the epilogue, the
launch's span, how far apart its CTAs started, the gap to the next
launch, and for the P-products (z, da, dP) their FMAs per SM clock.
`--streamed-turns DIR` first times the streamed wrappers of the checkout
at DIR (e.g. the parent commit, `git archive` into the git-ignored
`results/`) beside this one's in fresh processes in turns (DIR, this,
this, DIR; warm and cold), then stamps this one as `--streamed` does.
`--streamed-variants NAME=CONST:VALUE,...` then builds the streamed
source with its pipeline constants set otherwise, checks each variant and
times them in turns (`streamed_variants`), e.g.

    python -m iggcn_tpu_torch.tools.gcn_stack_phases --streamed-variants \
        as-is= stages4=kStages:4 chunk64=kChunk:64

`--backward` stamps the backward kernel only. `--backward-turns DIR`
first times the backward wrapper of the checkout unpacked at DIR (an
earlier commit, its sources built there) beside this one's, in turns in
fresh processes (DIR, this, this, DIR; warm and cold), and prints DIR's
own backward stamps, then this one's. `--backward-variants NAME=CONST:
VALUE,... ...` builds variants of the backward kernel with its integer
constants (tiles, K splits) set otherwise (`NAME=@DIR`: DIR's backward
source as it is), checks each against the plain version (and prints its
error against float64), times them in turns and prints their stamps side
by side, e.g.

    python -m iggcn_tpu_torch.tools.gcn_stack_phases --backward-variants \
        as-is= deep64=kDeepK:64 split2=kPSplit:2
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.utils import cuda_build

SLOTS = 32            # kPhaseSlots in csrc/gcn_stack.cu
SHAPES = [("serving", 256, 90, 3, (16, 16)), ("training", 32, 90, 3, (16, 16)),
          ("multi-fusion", 256, 270, 1, (10, 10, 10)),
          ("serving bf16", 256, 90, 3, (16, 16)),
          ("multi-fusion bf16", 256, 270, 1, (10, 10, 10))]


def _inputs(rng, b, n, f0, widths, dev):
    adj = np.abs(rng.normal(size=(b, n, n))).astype(np.float32)
    prop = gcn_propagation_matrix(torch.from_numpy(adj).to(dev))
    x = torch.from_numpy(rng.normal(size=(b, n, f0)).astype(np.float32)).to(dev)
    dims = [f0, *widths]
    ws = [torch.from_numpy(rng.normal(0, 0.3, (dims[i], dims[i + 1]))
                           .astype(np.float32)).to(dev)
          for i in range(len(widths))]
    bs = [torch.from_numpy(rng.normal(0, 0.1, (h,)).astype(np.float32)).to(dev)
          for h in widths]
    return prop, x, ws, bs


def phase_names(layers):
    """(name, start slot, end slot) of each phase the kernel stamps."""
    out = [("prologue: params, x, W, P queued", 0, 1)]
    for l in range(layers):
        start = 1 if l == 0 else 3 * l + 1
        out += [(f"layer {l}: h W", start, 3 * l + 2),
                (f"layer {l}: {'P wait + ' if l == 0 else ''}sync", 3 * l + 2,
                 3 * l + 3),
                (f"layer {l}: P hW (+ cluster sum)", 3 * l + 3, 3 * l + 4)]
    return out + [("output store", 3 * layers + 1, 3 * layers + 2)]


# the persistent bf16 kernel's prologue, once per CTA: (name, slot)
PERSISTENT_PROLOGUE = [("prologue: parameters", 20),
                       ("prologue: loads, copies queued, stores", 21),
                       ("prologue: x + sync", 0)]


def persistent_phase_names(layers):
    """(name, slot) of each phase the persistent bf16 kernel sums per
    sample."""
    out = [("layer 0: h W (before the wait)", 2),
           ("stage wait (or value-by-value copy) + sync", 1),
           ("layer 0: P hW + sync", 4)]
    for l in range(1, layers):
        out += [(f"layer {l}: h W + sync", 3 + 2 * l),
                (f"layer {l}: P hW + sync", 4 + 2 * l)]
    return out + [("output stores", 23),
                  ("next x, edges + sync", 3 + 2 * layers)]


# the backward kernel's stamps: 64 slots (kPhaseSlots of
# csrc/gcn_stack_backward.cu); its timed shapes, (name, B, N, F0, widths)
BACKWARD_SLOTS = 64
BACKWARD_SHAPES = [("training", 32, 90, 3, (16, 16)),
                   ("multi-fusion training", 32, 270, 1, (10, 10, 10))]


def backward_phase_names(layers):
    """The backward kernel's phases, one per pair of consecutive slots, in
    the order it stamps them: P's copy queued first and waited for after
    a_0, each layer's da with db, then its dW and e in one pass."""
    out = ["prologue: P queued; W, x, pads (+ g, one CTA) in",
           "recompute layer 0: a = h W", "prologue: wait on P",
           "recompute layer 0: z = P a + b (+ cluster sum)"]
    for l in range(1, layers):
        out += [f"recompute layer {l}: a = h W", f"recompute layer {l}: "
                "z = P a + b (+ cluster sum)"]
    out.append("g into dz^T, dz of the last layer")
    for l in reversed(range(layers)):
        out += [f"backward layer {l}: gather dz (cluster)",
                f"backward layer {l}: da = P^T dz, db",
                f"backward layer {l}: dW, e = da W^T (dz or dx), one pass"]
    return out + ["dP = DZ A^T", "dP stored", "final cluster barrier"]


def backward_p_products(plan, n, dims):
    """{phase name: FMAs that CTA 0 runs there} for the P-products (the
    design's count: its tiles, pads included)."""
    out = {}
    for spec in gcn_stack.backward_products(plan, n, dims):
        if spec.name == "z":
            out[f"recompute layer {spec.layer}: z = P a + b (+ cluster sum)"] = \
                spec.fmas
        elif spec.name == "da":
            out[f"backward layer {spec.layer}: da = P^T dz, db"] = spec.fmas
        elif spec.name == "dP":
            out["dP = DZ A^T"] = spec.fmas
    return out


def _stamped(source, declare, stamps):
    lib = ctypes.CDLL(cuda_build.build_all(
        [source], extra_flags=("-DGCN_STACK_PHASES",))[source])
    declare(lib)
    getattr(lib, stamps).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int]
    getattr(lib, stamps).restype = ctypes.c_int
    return lib


def _read(lib, stamps, error_string, ctas):
    ns = np.zeros(ctas * SLOTS, np.uint64)
    clk = np.zeros(ctas * SLOTS, np.int64)
    code = getattr(lib, stamps)(ns.ctypes.data, clk.ctypes.data, ctas)
    if code:
        raise RuntimeError(getattr(lib, error_string)(code).decode())
    return ns.reshape(ctas, SLOTS).astype(np.int64), clk.reshape(ctas, SLOTS)


def report_persistent(name, b, n, f0, widths, plan, ns, clk):
    """Per-sample phase means of the persistent bf16 kernel's stamps."""
    samples = ns[:, SLOTS - 3]
    start, end = ns[:, SLOTS - 2], ns[:, SLOTS - 1]
    print(f"{name}: B={b} N={n} F0={f0} H={widths}, persistent "
          f"ksplit {plan.ksplit}, "
          f"{plan.threads} threads x {plan.ctas_per_sm} CTAs per SM "
          f"({plan.warps_per_sm} warps), "
          f"{plan.smem_bytes} B, grid {len(ns)}; launch span "
          f"{(end.max() - start.min()) / 1e3:.2f} us, CTA starts spread over "
          f"{(start.max() - start.min()) / 1e3:.2f} us, per-CTA "
          f"{(end - start).mean() / 1e3:.2f} us (mean), samples per CTA "
          f"{samples.min()}-{samples.max()}")
    for label, slot in PERSISTENT_PROLOGUE:
        print(f"  {label:<40s} {ns[:, slot].mean() / 1e3:8.3f} us "
              f"{clk[:, slot].mean():9.0f} cycles  (per CTA)")
    for label, slot in persistent_phase_names(len(widths)):
        print(f"  {label:<40s} {(ns[:, slot] / samples).mean() / 1e3:8.3f} us "
              f"{(clk[:, slot] / samples).mean():9.0f} cycles  (per sample)")


def _device_ms(fn, runs=25, inner=10):
    """Median device ms of one call of `fn`, warm, from CUDA events around
    `inner` calls queued behind a sleep kernel (chip_smoke.py's method)."""
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
    return float(np.median(times))


def ksplit_sweep(dev):
    """Warm device ms of the persistent bf16 kernel at the bf16 serving
    shapes (B=256, and the whole 874-subject cohort at N=90) with each K
    split the plan may choose, the plan's own choice named, beside the fp32
    form on the upcast inputs; in turns (every split, then again in
    reverse order), each reading the mean of its two."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        for name, b, n, f0, widths in [("serving bf16", 256, 90, 3, (16, 16)),
                                       ("cohort bf16", 874, 90, 3, (16, 16)),
                                       ("multi-fusion bf16", 256, 270, 1,
                                        (10, 10, 10))]:
            prop, x, ws, bs = _inputs(rng, b, n, f0, widths, dev)
            args = (prop.bfloat16(), x.bfloat16(), [w.bfloat16() for w in ws],
                    [v.bfloat16() for v in bs])
            up = (args[0].float(), args[1].float(),
                  [w.float() for w in args[2]], [v.float() for v in args[3]])
            dims = (f0, *widths)
            chosen = gcn_stack.plan_launch(b, n, dims, 2, sms)
            plans = {f"ks {ks}": plan for ks in gcn_stack.BF16_KSPLITS
                     if (plan := gcn_stack.persistent_plan(n, dims, ks, sms))}
            transposed = gcn_stack._prop_transposed(args[0])

            def run(plan):
                out = torch.empty((b, n, sum(widths)), device=dev)
                gcn_stack._launch_persistent(plan, *args, out, list(dims),
                                             transposed, dev.index or 0)
                return out

            times = {}
            order = [*plans, "fp32"]
            for what in order + order[::-1]:
                fn = ((lambda: gcn_stack.fused_gcn_stack(*up)) if what == "fp32"
                      else (lambda p=plans[what]: run(p)))
                times.setdefault(what, []).append(_device_ms(fn))
            print(f"{name}: B={b} N={n} F0={f0} H={widths}, K split sweep "
                  f"(plan: ksplit {chosen.ksplit}): "
                  + ", ".join(
                      f"{'fp32 form' if k == 'fp32' else k} "
                      f"{np.mean(v):.5f} ms" for k, v in times.items()))


def run_phases(dev):
    lib = _stamped(gcn_stack.SOURCE, gcn_stack.declare,
                   "gcn_stack_phase_stamps")
    bf16_lib = _stamped(gcn_stack.BF16_SOURCE, gcn_stack.declare_bf16,
                        "gcn_stack_bf16_phase_stamps")
    for source in (gcn_stack.SOURCE, gcn_stack.BF16_SOURCE):
        print(f"ptxas, {source}:")
        for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("  " + line.strip())
    # the wrapper now launches the stamped builds
    gcn_stack._lib, gcn_stack._bf16_lib = lib, bf16_lib
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for name, b, n, f0, widths in SHAPES:
            args = _inputs(rng, b, n, f0, widths, dev)
            bf16 = name.endswith("bf16")
            if bf16:
                prop, x, ws, bs = args
                args = (prop.bfloat16(), x.bfloat16(),
                        [w.bfloat16() for w in ws], [v.bfloat16() for v in bs])
            plan = gcn_stack.plan_launch(b, n, (f0, *widths),
                                         2 if bf16 else 4, sms)
            for _ in range(4):
                gcn_stack.fused_gcn_stack(*args)
            torch.cuda.synchronize()
            if isinstance(plan, gcn_stack.PersistentPlan):
                ns, clk = _read(bf16_lib, "gcn_stack_bf16_phase_stamps",
                                "gcn_stack_bf16_error_string", plan.grid(b))
                report_persistent(name, b, n, f0, widths, plan, ns, clk)
                continue
            ns, clk = _read(lib, "gcn_stack_phase_stamps",
                            "gcn_stack_error_string", b * plan.cluster)
            last = 3 * len(widths) + 2
            print(f"{name}: B={b} N={n} F0={f0} H={widths}, cluster "
                  f"{plan.cluster}, ksplit {plan.ksplit}, {plan.threads} threads, "
                  f"{plan.smem_bytes} B; launch span "
                  f"{(ns[:, last].max() - ns[:, 0].min()) / 1e3:.2f} us, CTA "
                  f"starts spread over {(ns[:, 0].max() - ns[:, 0].min()) / 1e3:.2f} "
                  f"us, per-CTA {(ns[:, last] - ns[:, 0]).mean() / 1e3:.2f} us "
                  f"(mean)")
            for label, s0, s1 in phase_names(len(widths)):
                print(f"  {label:<40s} {(ns[:, s1] - ns[:, s0]).mean() / 1e3:8.3f} us "
                      f"{(clk[:, s1] - clk[:, s0]).mean():9.0f} cycles")


def _backward_stamps(lib, ctas):
    """(ns, clk), each (ctas, BACKWARD_SLOTS): the stamped backward
    kernel's stamps of its last launch."""
    ns = np.zeros(ctas * BACKWARD_SLOTS, np.uint64)
    clk = np.zeros(ctas * BACKWARD_SLOTS, np.int64)
    code = lib.gcn_stack_backward_phase_stamps(ns.ctypes.data, clk.ctypes.data,
                                               ctas)
    if code:
        raise RuntimeError(lib.gcn_stack_backward_error_string(code).decode())
    return (ns.reshape(ctas, BACKWARD_SLOTS).astype(np.int64),
            clk.reshape(ctas, BACKWARD_SLOTS))


def run_backward_phases(dev):
    """The stamped backward kernel at `BACKWARD_SHAPES`: each phase's mean
    duration over the CTAs, the per-CTA span and the launch's span, and
    for each P-product the FMAs per SM clock (one CTA an SM at B=32: the
    design's FMA count over the phase's mean clock64 cycles)."""
    source = gcn_stack.BACKWARD_SOURCE
    lib = _stamped(source, gcn_stack.declare_backward,
                   "gcn_stack_backward_phase_stamps")
    print(f"ptxas, {source}:")
    for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  " + line.strip())
    gcn_stack._backward_lib = lib
    rng = np.random.default_rng(2)
    for name, b, n, f0, widths in BACKWARD_SHAPES:
        args = _inputs(rng, b, n, f0, widths, dev)
        cot = torch.randn(b, n, sum(widths), device=dev)
        plan = gcn_stack.plan_backward(b, n, (f0, *widths))
        for _ in range(4):
            gcn_stack._launch_backward(*args, cot, (True, True, True))
        torch.cuda.synchronize()
        ns, clk = _backward_stamps(lib, b * plan.cluster)
        names = backward_phase_names(len(widths))
        fmas = backward_p_products(plan, n, (f0, *widths))
        last = len(names)
        print(f"backward {name}: B={b} N={n} F0={f0} H={widths}, cluster "
              f"{plan.cluster}, {plan.threads} threads, {plan.smem_bytes} B; "
              f"launch span {(ns[:, last].max() - ns[:, 0].min()) / 1e3:.2f} "
              f"us, per-CTA {(ns[:, last] - ns[:, 0]).mean() / 1e3:.2f} us "
              "(mean)")
        for k, label in enumerate(names):
            cycles = (clk[:, k + 1] - clk[:, k]).mean()
            rate = (f"  {fmas[label] / cycles:6.1f} FMA/clk ({fmas[label]} FMA)"
                    if label in fmas and cycles > 0 else "")
            print(f"  {label:<56s} "
                  f"{(ns[:, k + 1] - ns[:, k]).mean() / 1e3:8.3f} us "
                  f"{cycles:9.0f} cycles{rate}")


def _cold_ms(fn, flush, runs=25):
    """Median device ms of one call of `fn` with L2 cold: the card writes
    all of `flush` before each call, outside the events."""
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
    return float(np.median([a.elapsed_time(e) for a, e in marks]))


def time_backward(dev):
    """One JSON line per `BACKWARD_SHAPES` shape: the backward wrapper's
    warm and cold device ms (its kernel and the per-set sum), for the
    package this process imports."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)
    for name, b, n, f0, widths in BACKWARD_SHAPES:
        args = _inputs(rng, b, n, f0, widths, dev)
        cot = torch.randn(b, n, sum(widths), device=dev)

        def fn():
            return gcn_stack._launch_backward(*args, cot, (True, True, True))
        print(json.dumps({"shape": name, "B": b, "N": n,
                          "warm_ms": _device_ms(fn),
                          "cold_ms": _cold_ms(fn, flush)}), flush=True)


def _flat(grads):
    """(dprop, dx, dweights, dbiases) as one list."""
    return [grads[0], grads[1], *grads[2], *grads[3]]


def _stamp_means(lib, plan, b, layers):
    """Mean duration (us) over the CTAs of each backward phase of the last
    launch of `lib`, and of the whole CTA."""
    ns, _ = _backward_stamps(lib, b * plan.cluster)
    last = len(backward_phase_names(layers))
    return [(ns[:, k + 1] - ns[:, k]).mean() / 1e3 for k in range(last)] + [
        (ns[:, last] - ns[:, 0]).mean() / 1e3]


def backward_variants(specs, dev):
    """Variants of the backward kernel, each `NAME=CONST:VALUE,...`: the
    integer constants CONST of csrc/gcn_stack_backward.cu set to VALUE
    (none: the source as it is), or `NAME=@DIR`: the backward source of the
    checkout at DIR as it is (same C interface; no stamps). Each is built
    (plain and stamped, into iggcn_tpu_torch/_build/variants), held against
    the plain version at `BACKWARD_SHAPES` (rtol / atol 1e-4, two runs
    bit-equal), its gradients' relative L2 error against the plain version
    in float64 printed, timed warm in turns (every variant, then in reverse
    order; the mean of the two) and stamped; prints ptxas's register and
    spill line of each."""
    text = open(os.path.join(cuda_build.CSRC_DIR,
                             gcn_stack.BACKWARD_SOURCE)).read()
    out = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    procs, other = {}, set()
    for spec in specs:
        name, _, sets = spec.partition("=")
        src = text
        if sets.startswith("@"):
            other.add(name)
            with open(os.path.join(sets[1:], "iggcn_tpu_torch", "csrc",
                                   gcn_stack.BACKWARD_SOURCE)) as fh:
                src, sets = fh.read(), ""
        for item in filter(None, sets.split(",")):
            const, value = item.split(":")
            src, hits = re.subn(rf"constexpr int {const} = -?\d+;",
                                f"constexpr int {const} = {int(value)};", src)
            if hits != 1:
                raise ValueError(f"{name}: no constant {const} in the source")
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        for flags in ((), ("-DGCN_STACK_PHASES",))[:1 if name in other else 2]:
            lib = os.path.join(out, f"{name}{'-stamped' if flags else ''}.so")
            procs[(name, bool(flags))] = (lib, subprocess.Popen(
                [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
                 lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, stamped), (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = gcn_stack.declare_backward(ctypes.CDLL(path))
        if stamped:
            lib.gcn_stack_backward_phase_stamps.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            lib.gcn_stack_backward_phase_stamps.restype = ctypes.c_int
        else:
            print(f"variant {name}: " + "; ".join(
                line.strip() for line in log.splitlines()[-6:]
                if "registers" in line or "spill" in line))
        libs[(name, stamped)] = lib
    names = [spec.partition("=")[0] for spec in specs]
    rng = np.random.default_rng(4)
    for shape, b, n, f0, widths in BACKWARD_SHAPES:
        args = _inputs(rng, b, n, f0, widths, dev)
        cot = torch.randn(b, n, sum(widths), device=dev)
        plan = gcn_stack.plan_backward(b, n, (f0, *widths))
        want = _flat(gcn_stack.gcn_stack_backward_reference(*args, cot))
        prop, x, ws, bs = args
        exact = _flat(gcn_stack.gcn_stack_backward_reference(
            prop.cpu().double(), x.cpu().double(),
            [w.cpu().double() for w in ws], [v.cpu().double() for v in bs],
            cot.cpu().double()))

        def run():
            return gcn_stack._launch_backward(*args, cot, (True, True, True))
        times, stamps = {}, {}
        for name in names + names[::-1]:
            gcn_stack._backward_lib = libs[(name, False)]
            if name not in times:
                got, again = _flat(run()), _flat(run())
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                close = all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                            for g, w in zip(got, want))
                same = all(torch.equal(g, r) for g, r in zip(got, again))
                rel = [float((g.cpu().double() - e).norm() / e.norm())
                       for g, e in zip(got, exact)]
                print(f"variant {name}, backward {shape}: max_abs_err "
                      f"{err:.3e}, within 1e-4 {close}, bit-equal twice "
                      f"{same}; relative L2 error against float64: dP "
                      f"{rel[0]:.3e}, dx {rel[1]:.3e}, dW/db up to "
                      f"{max(rel[2:]):.3e}")
                if not (close and same):
                    raise AssertionError(f"variant {name} is wrong at {shape}")
            times.setdefault(name, []).append(_device_ms(run))
        stamped = [name for name in names if name not in other]
        for name in stamped:
            gcn_stack._backward_lib = libs[(name, True)]
            for _ in range(4):
                run()
            torch.cuda.synchronize()
            stamps[name] = _stamp_means(libs[(name, True)], plan, b,
                                        len(widths))
        print(f"variants, backward {shape}: B={b} N={n} F0={f0} H={widths}, "
              "warm ms (mean of 2 in turns): " + ", ".join(
                  f"{name} {np.mean(times[name]):.5f}" for name in names))
        print("  " + " " * 56 + " ".join(f"{name:>9s}" for name in stamped))
        for k, label in enumerate(backward_phase_names(len(widths))
                                  + ["per CTA"]):
            print(f"  {label:<56s} " + " ".join(
                f"{stamps[name][k]:9.3f}" for name in stamped))


def backward_turns(other):
    """The backward wrapper of the checkout at `other` (its own sources,
    built there) and of this one, timed in turns in fresh processes:
    other, this, this, other; then the stamps of the other's own
    `run_backward_phases` (its phase names). Prints each process's times
    and each side's mean."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(other)
    results = {}
    for root in (other, here, here, other):
        env = dict(os.environ, PYTHONPATH=root)
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time-backward"], cwd=root, env=env,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"timing in {root} failed:\n{out.stderr}")
        side = "this" if root == here else "other"
        for line in out.stdout.splitlines():
            row = json.loads(line)
            print(f"{side} ({root}): backward {row['shape']} B={row['B']} "
                  f"N={row['N']}: {row['warm_ms']:.5f} ms warm, "
                  f"{row['cold_ms']:.5f} cold")
            results.setdefault((row["shape"], side), []).append(row)
    for (shape, side), rows in results.items():
        print(f"mean of {len(rows)}, {side}: backward {shape}: "
              f"{np.mean([r['warm_ms'] for r in rows]):.5f} ms warm, "
              f"{np.mean([r['cold_ms'] for r in rows]):.5f} cold")
    stamps = subprocess.run(
        [sys.executable, "-c", "import torch; from iggcn_tpu_torch.tools."
         "gcn_stack_phases import run_backward_phases; "
         "run_backward_phases(torch.device('cuda', 0))"],
        cwd=other, env=dict(os.environ, PYTHONPATH=other),
        capture_output=True, text=True, timeout=900)
    print(f"stamps of {other}:\n{stamps.stdout}{stamps.stderr}")


# the streamed form's stamps (csrc/gcn_stack_streamed.cu's kPhaseSlots,
# kPhaseCtas, kPhaseLaunches): four per CTA and launch of a list; its
# shapes, (name, B, N, F0, widths): chip_smoke.py's STREAMED_TIMED and two
# points of the zoo's search grid at PROTEINS' 620 nodes
STREAMED_SLOTS, STREAMED_CTAS, STREAMED_LAUNCHES = 4, 8192, 32
STREAMED_SHAPES = [("flagship training --layers 3 --hiddens 128", 32, 90, 3,
                    (128, 128, 128)),
                   ("zoo GCN training, 620 nodes", 32, 620, 3, (32, 32, 32)),
                   ("zoo grid (3, 16), 620 nodes", 32, 620, 3, (16, 16, 16)),
                   ("zoo grid (2, 10), 620 nodes", 32, 620, 3, (10, 10))]


def streamed_labels(steps, layers):
    """A name for each product of a streamed list that takes every
    gradient, in the wrapper's order (`_layer_products`, then
    `_backward_products`)."""
    names, l, back = [], 0, None
    for p in steps:
        if p.epi == gcn_stack.EPI_RELU:
            fused = bool(getattr(p, "w2", None))
            names.append(f"z{l} = P a{l} + b, relu" + (
                f"; a{l + 1} = h{l + 1} W{l + 1}" if fused else ""))
            l += 1
            back = layers if l == layers else None
        elif back is None:
            names.append(f"a{l} = h{l} W{l}")
        elif p.epi == gcn_stack.EPI_DA:
            back -= 1
            names.append(f"da{back} = P^T dz{back} (+ db)")
        elif p.epi == gcn_stack.EPI_GRAD_MASK:
            names.append(f"e{back} = da W^T, dz{back - 1}")
        elif names[-1].startswith("da"):
            names.append(f"dW{back} = h^T da")
        elif back == 0 and names[-1].startswith("dW"):
            names.append("dx = da W^T")
        else:
            names.append("dP = DZ A^T")
    return names


def _tile(p):
    bm, bn = gcn_stack.STREAM_TILES[p.tile]
    return f"{bm}x{bn} ks{p.ksplit} v{p.a_vec}{p.b_vec}"


def report_streamed(what, b, steps, ns, clk, sms):
    """Per launch of one streamed list: each phase's mean over the CTAs
    (prologue, main loop, epilogue), the launch's span, how far apart its
    CTAs started, the gap to the next launch's first CTA, and for the
    P-products (z, da, dP) their FMAs (m n k B) per SM clock over the
    launch's span."""
    labels = streamed_labels(steps, sum(p.epi == gcn_stack.EPI_RELU
                                        for p in steps))
    count = min(len(steps), STREAMED_LAUNCHES)
    blocks = [min(gcn_stack.launch_blocks(p, b), STREAMED_CTAS)
              for p in steps[:count]]
    first = ns[0, :blocks[0], 0].min()
    last = max(ns[i, :blocks[i], 3].max() for i in range(count))
    print(f"{what}: {len(steps)} launches, list span "
          f"{(last - first) / 1e3:.2f} us (first CTA start to last CTA end)")
    print(f"  {'launch':<36s} {'tile':>13s} {'CTAs':>5s} {'prologue':>8s} "
          f"{'loop':>8s} {'epilogue':>8s} {'per CTA':>8s} {'span':>8s} "
          f"{'starts':>8s} {'gap':>7s}  FMA/clk/SM")
    for i in range(count):
        t, c, p = ns[i, :blocks[i]], clk[i, :blocks[i]], steps[i]
        span = t[:, 3].max() - t[:, 0].min()
        gap = ns[i + 1, :blocks[i + 1], 0].min() - t[:, 3].max() \
            if i + 1 < count else None
        gap = "      -" if gap is None else f"{gap / 1e3:7.2f}"
        ghz = float(np.median((c[:, 3] - c[:, 0]) / (t[:, 3] - t[:, 0])))
        rate = ""
        if labels[i].startswith(("z", "da", "dP")):
            rate = f"  {p.m * p.n * p.k * b / (sms * span * ghz):6.1f}"
        print(f"  {labels[i]:<36s} {_tile(p):>13s} {blocks[i]:5d} "
              + " ".join(f"{(t[:, k + 1] - t[:, k]).mean() / 1e3:8.3f}"
                         for k in range(3))
              + f" {(t[:, 3] - t[:, 0]).mean() / 1e3:8.3f} {span / 1e3:8.3f} "
              f"{(t[:, 0].max() - t[:, 0].min()) / 1e3:8.3f} {gap}{rate}")


def run_streamed_phases(dev):
    """The stamped streamed form at `STREAMED_SHAPES`, forward and
    backward, launch by launch (`report_streamed`)."""
    source = gcn_stack.STREAMED_SOURCE
    lib = _stamped(source, gcn_stack.declare_streamed,
                   "gcn_stack_streamed_phase_stamps")
    print(f"ptxas, {source}:")
    for line in cuda_build.BUILD_LOGS.get(source, "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  " + line.strip())
    gcn_stack._streamed_lib = lib
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    captured, run = [], gcn_stack._run_streamed

    def capture(steps, *args, **kwargs):
        captured.append(list(steps))
        return run(steps, *args, **kwargs)

    gcn_stack._run_streamed = capture
    rng = np.random.default_rng(5)
    try:
        for name, b, n, f0, widths in STREAMED_SHAPES:
            args = _inputs(rng, b, n, f0, widths, dev)
            cot = torch.randn(b, n, sum(widths), device=dev)
            dims = (f0, *widths)
            for direction, plan, fn in (
                    ("forward", gcn_stack.plan_launch(b, n, dims, 4, sms),
                     lambda: gcn_stack._launch(*args)),
                    ("backward", gcn_stack.plan_backward(b, n, dims),
                     lambda: gcn_stack._launch_backward(
                         *args, cot, (True, True, True)))):
                what = (f"streamed {direction} {name}: B={b} N={n} F0={f0} "
                        f"H={widths}")
                if not isinstance(plan, gcn_stack.StreamedPlan):
                    print(f"{what}: resident here, not stamped")
                    continue
                for _ in range(4):
                    fn()
                torch.cuda.synchronize()
                steps = captured[-1]
                count = min(len(steps), STREAMED_LAUNCHES)
                size = count * STREAMED_CTAS * STREAMED_SLOTS
                ns, clk = np.zeros(size, np.uint64), np.zeros(size, np.int64)
                code = lib.gcn_stack_streamed_phase_stamps(
                    ns.ctypes.data, clk.ctypes.data, count)
                if code:
                    raise RuntimeError(
                        lib.gcn_stack_streamed_error_string(code).decode())
                shape = (count, STREAMED_CTAS, STREAMED_SLOTS)
                report_streamed(what, b, steps,
                                ns.reshape(shape).astype(np.int64),
                                clk.reshape(shape), sms)
    finally:
        gcn_stack._run_streamed = run


def time_streamed(dev):
    """One JSON line per `STREAMED_SHAPES` shape and direction: the
    streamed wrapper's warm and cold device ms, for the package this
    process imports."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(6)
    for name, b, n, f0, widths in STREAMED_SHAPES:
        args = _inputs(rng, b, n, f0, widths, dev)
        cot = torch.randn(b, n, sum(widths), device=dev)
        for direction, fn in (
                ("forward", lambda: gcn_stack._launch(*args)),
                ("backward", lambda: gcn_stack._launch_backward(
                    *args, cot, (True, True, True)))):
            print(json.dumps({"shape": name, "direction": direction, "B": b,
                              "N": n, "warm_ms": _device_ms(fn),
                              "cold_ms": _cold_ms(fn, flush)}), flush=True)


def streamed_turns(other):
    """The streamed wrappers (forward and backward) of the checkout at
    `other` (its own sources, built there) and of this one, timed in turns
    in fresh processes: other, this, this, other. Prints each process's
    times and each side's mean; the caller then stamps this one."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    other = os.path.abspath(other)
    results = {}
    for root in (other, here, here, other):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--time-streamed"], cwd=root,
                             env=dict(os.environ, PYTHONPATH=root),
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"timing in {root} failed:\n{out.stderr}")
        side = "this" if root == here else "other"
        for line in out.stdout.splitlines():
            row = json.loads(line)
            print(f"{side} ({root}): streamed {row['direction']} "
                  f"{row['shape']} B={row['B']} N={row['N']}: "
                  f"{row['warm_ms']:.5f} ms warm, {row['cold_ms']:.5f} cold")
            results.setdefault((row["shape"], row["direction"], side),
                               []).append(row)
    for (shape, direction, side), rows in results.items():
        print(f"mean of {len(rows)}, {side}: streamed {direction} {shape}: "
              f"{np.mean([r['warm_ms'] for r in rows]):.5f} ms warm, "
              f"{np.mean([r['cold_ms'] for r in rows]):.5f} cold")


def streamed_variants(specs, dev):
    """Variants of the streamed form, each `NAME=CONST:VALUE,...`: the
    integer constants CONST of csrc/gcn_stack_streamed.cu set to VALUE
    (none: the source as it is; `kStages`, or `kChunk` of 32 and more, so
    that every K split the plan picks keeps 4 of K per group). Each is
    built (into iggcn_tpu_torch/_build/variants; ptxas's spills printed),
    held against the plain versions at the zoo's 620-node 3 x 32 (forward
    rtol 1e-4 / atol 1e-5, backward rtol / atol 1e-4, each call bit-equal
    to its repeat) and timed warm at `STREAMED_SHAPES`, forward and
    backward, in turns (every variant, then in reverse order; the mean of
    the two)."""
    text = open(os.path.join(cuda_build.CSRC_DIR,
                             gcn_stack.STREAMED_SOURCE)).read()
    out = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for spec in specs:
        name, _, sets = spec.partition("=")
        src = text
        for item in filter(None, sets.split(",")):
            const, value = item.split(":")
            src, hits = re.subn(rf"constexpr int {const} = \d+;",
                                f"constexpr int {const} = {int(value)};", src)
            if hits != 1:
                raise ValueError(f"{name}: no constant {const} in the source")
        path = os.path.join(out, f"streamed-{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        lib = os.path.join(out, f"streamed-{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        spills = sum(int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log))
        print(f"variant {name}: {spills} bytes of spills")
        libs[name] = gcn_stack.declare_streamed(ctypes.CDLL(path))
    rng = np.random.default_rng(7)
    runs = []
    for shape, b, n, f0, widths in STREAMED_SHAPES:
        args = _inputs(rng, b, n, f0, widths, dev)
        cot = torch.randn(b, n, sum(widths), device=dev)
        runs += [(f"forward {shape}", lambda a=args: gcn_stack._launch(*a)),
                 (f"backward {shape}",
                  lambda a=args, g=cot: gcn_stack._launch_backward(
                      *a, g, (True, True, True)))]
        if widths == (32, 32, 32):
            check = args, cot
    names = list(libs)
    times = {}
    for name in names + names[::-1]:
        gcn_stack._streamed_lib = libs[name]
        if name not in times:
            args, cot = check
            got, again = gcn_stack._launch(*args), gcn_stack._launch(*args)
            grads = _flat(gcn_stack._launch_backward(*args, cot,
                                                     (True, True, True)))
            twice = _flat(gcn_stack._launch_backward(*args, cot,
                                                     (True, True, True)))
            want = _flat(gcn_stack.gcn_stack_backward_reference(*args, cot))
            right = (torch.allclose(got, gcn_stack.gcn_stack_reference(*args),
                                    rtol=1e-4, atol=1e-5)
                     and torch.equal(got, again)
                     and all(torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                             and torch.equal(g, r)
                             for g, r, w in zip(grads, twice, want)))
            if not right:
                raise AssertionError(f"variant {name} is wrong")
        times.setdefault(name, []).append([_device_ms(fn) for _, fn in runs])
    for k, (what, _) in enumerate(runs):
        print(f"variants, streamed {what}: warm ms (mean of 2 in turns): "
              + ", ".join(f"{name} {np.mean([t[k] for t in times[name]]):.5f}"
                          for name in names))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--backward", action="store_true",
                        help="only the backward kernel's stamps")
    parser.add_argument("--backward-turns", metavar="CHECKOUT",
                        help="time the backward beside CHECKOUT's, in turns")
    parser.add_argument("--backward-variants", nargs="+",
                        metavar="NAME=CONST:VALUE,...",
                        help="variants of the backward kernel's constants "
                             "(or NAME=@DIR: DIR's backward source), "
                             "checked, timed in turns and stamped")
    parser.add_argument("--streamed", action="store_true",
                        help="only the streamed form's stamps, per launch")
    parser.add_argument("--streamed-turns", metavar="CHECKOUT",
                        help="time the streamed form beside CHECKOUT's, in "
                             "turns, then stamp this one")
    parser.add_argument("--streamed-variants", nargs="+",
                        metavar="NAME=CONST:VALUE,...",
                        help="variants of the streamed form's constants, "
                             "checked and timed in turns")
    parser.add_argument("--time-backward", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--time-streamed", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gcn_stack_phases: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.time_backward:
        time_backward(dev)
        return 0
    if args.time_streamed:
        time_streamed(dev)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    if args.streamed or args.streamed_turns or args.streamed_variants:
        if args.streamed_turns:
            streamed_turns(args.streamed_turns)
        run_streamed_phases(dev)
        if args.streamed_variants:
            streamed_variants(args.streamed_variants, dev)
        return 0
    if args.backward_turns:
        backward_turns(args.backward_turns)
    if args.backward_variants:
        backward_variants(args.backward_variants, dev)
    if not (args.backward or args.backward_turns or args.backward_variants):
        run_phases(dev)
        ksplit_sweep(dev)
    run_backward_phases(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
