"""torch.profiler helpers: the CLI's `--profile_dir` trace and the op
histogram that `tools/profile_step.py` prints.

On the card the histogram is over device activity (kernels, copies,
sets); on the CPU there is no device, so it is over the host ops' self
time and is labelled so: a CPU run's numbers are never device times.
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
from typing import Dict, Iterator, List, Tuple

import torch

# device-op categories, first match wins (kernel names of cuBLAS, CUTLASS,
# PyTorch's elementwise and reduction templates, and the port's kernel)
CATEGORIES = (
    ("gcn_stack kernel", re.compile(r"gcn_stack_kernel")),
    ("matmul (cuBLAS/CUTLASS)",
     re.compile(r"gemm|gemv|cutlass|xmma|matmul|addmm|bmm|mm\b|dot", re.I)),
    ("reduce", re.compile(r"reduce|norm|softmax|sum|mean|max|min", re.I)),
    ("copy/layout", re.compile(r"copy|memcpy|memset|cat|transpose|index|"
                               r"gather|scatter|fill", re.I)),
    ("rng", re.compile(r"philox|rand|bernoulli|distribution", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized|unrolled|pointwise|"
                               r"add|mul|div|sub|relu|sigmoid|tanh|exp|log|"
                               r"where|pow|sqrt", re.I)),
)


def categorize(name: str) -> str:
    for label, pat in CATEGORIES:
        if pat.search(name):
            return label
    return "other"


def activities(device: torch.device) -> List[torch.profiler.ProfilerActivity]:
    """The profiler's activities for a run on `device`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace_to(out_dir: str | None, device: torch.device) -> Iterator[None]:
    """A torch.profiler trace of the block into `out_dir` (a Chrome trace,
    `trace.json`, readable in Perfetto or chrome://tracing; device
    activity included on the card); nothing when `out_dir` is empty."""
    if not out_dir:
        yield
        return
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities(device)) as prof:
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[profile] torch.profiler trace -> {path}")


def op_histogram(prof, device: torch.device
                 ) -> Tuple[Dict[str, List[float]], str]:
    """({name: [total us, count]}, what the times are) of a finished
    profile: device activity on the card; on the CPU the host ops' self
    time (each op's own time, its children's left out, so nothing counts
    twice)."""
    hist: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    on_card = torch.device(device).type == "cuda"
    for e in prof.events():
        if on_card:
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            t = e.time_range.end - e.time_range.start
        else:
            if e.device_type != torch.autograd.DeviceType.CPU:
                continue
            t = e.self_cpu_time_total
        hist[e.name][0] += t
        hist[e.name][1] += 1
    if not hist:
        raise RuntimeError("the profiler recorded no "
                           + ("device activity" if on_card else "host ops"))
    return hist, ("device time" if on_card else "host op self time (CPU run)")
