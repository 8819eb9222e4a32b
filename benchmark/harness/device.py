"""The card: its published peaks, and what a profiler trace says it did.

`profiled` and the union-of-spans idle share are frozen from
`chip_smoke.py`; the table of hand-written kernels covers all six device
kernels the port's GCN-stack wrapper launches.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# published dense peaks (NVIDIA data sheets): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores; matched in order on torch.cuda.get_device_name
CARD_SPECS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
              ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))

# the port's hand-written device kernels (`iggcn_tpu_torch/csrc/*.cu`)
HAND_KERNELS = ("gcn_stack_kernel", "gcn_stack_bf16_kernel",
                "gcn_stack_backward_kernel", "sum_weight_slots",
                "gcn_stack_streamed_product", "sum_streamed_slots")

Event = Tuple[str, float, float]        # name, start us, end us

# profiler sessions tried before a trace that drops records is given up
ATTEMPTS = 5


def card_spec(name: str) -> Tuple[str, float, float]:
    """(key, bytes/s, fp32 FLOP/s) of a card by its device name; a card
    the table does not know raises."""
    for key, bw, flops in CARD_SPECS:
        if key in name:
            return key, bw, flops
    raise ValueError(f"no published peaks for the card {name!r}")


def is_hand_kernel(name: str) -> bool:
    return any(k in name for k in HAND_KERNELS)


def _device_events(prof) -> List[Event]:
    """Every device activity of a profiler session: kernels, copies and
    sets, not the annotation ranges that span several of them; read from
    the raw records (building the profiler's event tree takes minutes
    for an epoch's ~100,000 records)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def profiled(fn: Callable[[], object], warm: Callable[[], object],
             complete: Callable[[List[Event]], bool]):
    """(device events, host wall in s, fn's result) of one call of `fn`,
    traced on the device alone (host-side tracing of every op would
    stretch the host's share of the window). Each session first runs
    `warm` (a cheap call) in a warm-up cycle, in which the tracer starts
    and its records are dropped, then records `fn`. A session whose
    events fail `complete` (the tracer dropped records) is run again
    after a second's pause, up to ATTEMPTS sessions; `fn` is then called
    again and has to leave the program as a first call would find it."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for attempt in range(1, ATTEMPTS + 1):
        if attempt > 1:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            warm()
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = _device_events(prof)
        if events and complete(events):
            return events, wall, result
    raise RuntimeError(f"{ATTEMPTS} profiler sessions in a row recorded too "
                       "few device ops")


def stack_kernels_complete(events: Sequence[Event], counters) -> bool:
    """Whether a trace holds every launch of the stack's kernels that the
    port's counters (`fused_gcn_stack.launches*`, reset before the
    traced call) count: one forward kernel per fp32 or bf16 launch, one
    backward kernel per backward launch."""
    seen = {k: sum(k in name for name, _, _ in events)
            for k in ("gcn_stack_kernel", "gcn_stack_bf16_kernel",
                      "gcn_stack_backward_kernel")}
    return seen == {"gcn_stack_kernel": counters.launches,
                    "gcn_stack_bf16_kernel": counters.launches_bf16,
                    "gcn_stack_backward_kernel": counters.launches_backward}


def busy_us(events: Sequence[Event]) -> float:
    """Time in which some device op ran: the union of the spans."""
    busy, end = 0.0, -math.inf
    for _, t0, t1 in sorted(events, key=lambda e: e[1]):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy


def breakdown(device: Sequence[Event], top: int = 10) -> Dict[str, list]:
    """The device ops that took most time (summed by name) and the idle
    gaps summed by the op the device waited for (the host was preparing
    its launch), in seconds, `top` of each."""
    ops: Dict[str, float] = {}
    for name, t0, t1 in device:
        ops[name] = ops.get(name, 0.0) + (t1 - t0)
    order = sorted(device, key=lambda e: e[1])
    waited: Dict[str, float] = {}
    end = None
    for name, t0, t1 in order:
        if end is not None and t0 > end:
            label = "before " + name[:120]
            waited[label] = waited.get(label, 0.0) + (t0 - end)
        end = t1 if end is None else max(end, t1)
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {"device_ops": [[k, v / 1e6] for k, v in rank(ops)],
            "idle_gaps": [[k, v / 1e6] for k, v in rank(waited)]}


def hand_kernel_us(device: Sequence[Event]) -> float:
    return sum(t1 - t0 for name, t0, t1 in device if is_hand_kernel(name))


def op_us(device: Sequence[Event]) -> float:
    return sum(t1 - t0 for _, t0, t1 in device)


def power_limit() -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` reads them, or
    None where it cannot."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None
