"""Model FLOPs of the traced epoch (both passes of every trained graph, its
backward as twice their forward, and both passes of every evaluated
graph) over its host wall and the card's fp32 peak outside the tensor
cores, in %."""
from benchmark.harness.readers import mfu


def read(t):
    return mfu(t) if t["work"].get("train_batches") else None
