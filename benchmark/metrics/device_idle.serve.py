"""Share of the traced requests in which no op ran on the device: 1 - the
union of the device spans over the host wall, in %."""
from benchmark.harness.readers import idle_share


def read(t):
    return idle_share(t) if t["work"].get("forwards") else None
