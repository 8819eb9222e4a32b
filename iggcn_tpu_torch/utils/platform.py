"""Device choice and numerics for the port.

The port runs on the card: `resolve_device(None)` means CUDA and raises
when there is none. The CPU is used only when a caller asks for it by
name (the tests do), never as a quiet fallback.

fp32 parity numerics are pinned here, once, at import: a float32 matmul
on the card runs in full fp32 only while TF32 is off, and cuDNN's
default is TF32 on. The JAX reference and its parity pins are fp32.
cuDNN is also held to its deterministic algorithms and kept from
benchmarking them (which picks by timing, so per run): the zoo's
convolutions (`CNN_Model`, `SortPool`) then repeat bit for bit on the
card, as every other route does.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """Return the torch device to run on.

    `None` (the default) is `"cuda"`. A CUDA device raises `RuntimeError`
    when CUDA is not available; `"cpu"` is honoured when asked for.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default. Pass device='cpu' (CLI: --device cpu) to run the "
            "plain PyTorch path on the host CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

