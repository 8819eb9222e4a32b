"""The GCN stack kernel's share of its roofline over the traced requests:
the least time the card could take for every stack call at the serving
batch over the device time of the six hand-written kernels, in %."""
from benchmark.harness.readers import stack_roofline


def read(t):
    return stack_roofline(t) if t["work"].get("forwards") else None
