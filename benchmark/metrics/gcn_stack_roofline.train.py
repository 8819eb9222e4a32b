"""The GCN stack kernels' share of their roofline over the traced epoch:
the least time the card could take for every stack call (forward and
backward, at the cell's batch plan) over the device time of the six
hand-written kernels, in %."""
from benchmark.harness.readers import stack_roofline


def read(t):
    return stack_roofline(t) if t["work"].get("train_batches") else None
