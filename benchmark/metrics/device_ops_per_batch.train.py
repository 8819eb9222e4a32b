"""Device ops of the traced epoch per batched train step in it."""


def read(t):
    batches = t["work"].get("train_batches")
    return len(t["device"]) / batches if batches else None
