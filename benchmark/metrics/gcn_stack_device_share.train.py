"""The six hand-written kernels' device time over all device op time of
the traced epoch, in %."""
from benchmark.harness.readers import hand_kernel_share


def read(t):
    return hand_kernel_share(t) if t["work"].get("train_batches") else None
