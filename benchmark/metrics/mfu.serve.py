"""Model FLOPs of the traced requests (one forward pass per subject) over
their host wall and the card's fp32 peak outside the tensor cores, in %."""
from benchmark.harness.readers import mfu


def read(t):
    return mfu(t) if t["work"].get("forwards") else None
