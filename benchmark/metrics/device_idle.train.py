"""Share of the traced training epoch in which no op ran on the device:
1 - the union of the device spans over the host wall, in %."""
from benchmark.harness.readers import idle_share


def read(t):
    return idle_share(t) if t["work"].get("train_batches") else None
