"""PyTorch/CUDA port of `iggcn_tpu`, for NVIDIA Hopper (H100).

The subpackage layout mirrors `iggcn_tpu/` module for module, so each
port module's counterpart is found under the same name there. The port
imports torch and numpy (and scipy, lazily, for the `.mat` loaders and
the heat-kernel diffusion): nothing of JAX, nothing of `iggcn_tpu`, no
scikit-learn.

Importing the package pins fp32 matmul numerics (TF32 off) once, in
`utils.platform`.
"""
from iggcn_tpu_torch.utils import platform  # noqa: F401  (pins TF32 off)

__version__ = "0.1.0"
