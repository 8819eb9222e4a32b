"""Where the GCN-stack kernel's time goes, phase by phase, on the card.

The kernel layer's per-phase metric (PERF.md, section 3 and the phase
table of section 5). Builds `csrc/gcn_stack.cu` a second time with
-DGCN_STACK_PHASES, in which thread 0 of every CTA stamps %globaltimer and
clock64 at each phase boundary, runs it (after warm-up, inputs warm in L2)
at the shapes `chip_smoke.py` times, and prints per shape the mean over
the CTAs of each phase's duration, the span of the whole launch and how
far apart the CTAs started (later waves). Needs a CUDA card:

    python -m iggcn_tpu_torch.tools.gcn_stack_phases
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from iggcn_tpu_torch.ops import gcn_stack
from iggcn_tpu_torch.ops.gcn import gcn_propagation_matrix
from iggcn_tpu_torch.utils import cuda_build

SLOTS = 32            # kPhaseSlots in csrc/gcn_stack.cu
SHAPES = [("serving", 256, 90, 3, (16, 16)), ("training", 32, 90, 3, (16, 16)),
          ("multi-fusion", 256, 270, 1, (10, 10, 10))]


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


def run_phases(dev):
    lib = ctypes.CDLL(cuda_build.build_all(
        [gcn_stack.SOURCE], extra_flags=("-DGCN_STACK_PHASES",))[gcn_stack.SOURCE])
    gcn_stack.declare(lib)
    lib.gcn_stack_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int]
    lib.gcn_stack_phase_stamps.restype = ctypes.c_int
    gcn_stack._lib = lib   # the wrapper now launches the stamped build
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for name, b, n, f0, widths in SHAPES:
            args = _inputs(rng, b, n, f0, widths, dev)
            plan = gcn_stack.plan_launch(b, n, (f0, *widths))
            for _ in range(4):
                gcn_stack.fused_gcn_stack(*args)
            torch.cuda.synchronize()
            ctas = b * plan.cluster
            ns = np.zeros(ctas * SLOTS, np.uint64)
            clk = np.zeros(ctas * SLOTS, np.int64)
            code = lib.gcn_stack_phase_stamps(ns.ctypes.data, clk.ctypes.data, ctas)
            if code:
                raise RuntimeError(lib.gcn_stack_error_string(code).decode())
            ns = ns.reshape(ctas, SLOTS).astype(np.int64)
            clk = clk.reshape(ctas, SLOTS)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("gcn_stack_phases: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    run_phases(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
