"""Arithmetic the per-layer metric readers share. A reader gets the traced
stretch `t`: its device events (name, start us, end us), its host wall
(`window_s`), the device's busy seconds (`busy_s`), the card's peaks
(`bandwidth`, `peak_flops`) and the work the cell's kind counted in it
(`work`). A share that has nothing to read returns None, never 0."""
from __future__ import annotations

from typing import Optional

from benchmark.harness import device, work


def idle_share(t) -> Optional[float]:
    if t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(t) -> Optional[float]:
    flops = t["work"].get("model_flops")
    if not flops or t["window_s"] <= 0:
        return None
    return 100.0 * flops / t["window_s"] / t["peak_flops"]


def stack_roofline(t) -> Optional[float]:
    """Σ over the stack's calls of the least time the card could take for
    each, over the device time of the hand-written kernels. None where
    the kernels did not run, or where calls of a form the work table does
    not price ran."""
    kernel_us = device.hand_kernel_us(t["device"])
    if kernel_us <= 0 or t["work"].get("other_stack_calls"):
        return None
    bound = sum(calls * work.bound_s(nbytes, flops, t["bandwidth"],
                                     t["peak_flops"])
                for calls, (nbytes, flops)
                in t["work"]["stack_calls"].values())
    return 100.0 * bound / (kernel_us / 1e6)


def hand_kernel_share(t) -> Optional[float]:
    total = device.op_us(t["device"])
    kernel_us = device.hand_kernel_us(t["device"])
    if total <= 0 or kernel_us <= 0:
        return None
    return 100.0 * kernel_us / total
