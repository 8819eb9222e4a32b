"""Fused imaging GCN stack: the hand-written CUDA kernel and its plain version.

Port of `iggcn_tpu/ops/pallas_gcn.py`. The TPU kernel there
(`_stack_kernel`) ran the whole L-layer stack per sample in VMEM; here
`csrc/gcn_stack.cu` does the same on Hopper, one thread block per sample
with every intermediate in shared memory, so P and x are read from device
memory once and only the JK-concat output is written. The source's header
note gives the kernel's bound on an H100 and how the design meets it.

Dispatch is by device, with no switch and no fallback: on CUDA tensors
`fused_gcn_stack` launches the kernel (or raises), on CPU tensors it runs
`gcn_stack_reference`. The backward is autograd through
`gcn_stack_reference`, a recompute, exactly as the JAX custom VJP did; the
JAX package has no backward kernel and neither does the port.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from iggcn_tpu_torch.utils.cuda_build import load_library

SOURCE = "gcn_stack.cu"
MAX_LAYERS = 8


def gcn_stack_reference(prop: torch.Tensor, x: torch.Tensor,
                        weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: h_{l+1} = relu(prop @ (h_l @ W_l) + b_l); returns the
    JK concat of all layer outputs, shape (B, N, sum(H_l))."""
    h = x
    feats = []
    for w, b in zip(weights, biases):
        h = torch.relu(prop @ (h @ w) + b)
        feats.append(h)
    return torch.cat(feats, dim=-1)


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signatures
    declared (pointers and the stream as c_void_p, so none is cut to 32
    bits)."""
    global _lib
    if _lib is None:
        lib = load_library(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gcn_stack_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32,
                                          i32, ctypes.POINTER(i32), i32, ptr]
        lib.gcn_stack_forward.restype = i32
        lib.gcn_stack_shared_bytes.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.gcn_stack_shared_bytes.restype = ctypes.c_size_t
        lib.gcn_stack_error_string.argtypes = [i32]
        lib.gcn_stack_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_inputs(prop, x, weights, biases) -> list[int]:
    """Raise on anything the kernel does not take; return the layer widths
    (F0, H_1, ..., H_L)."""
    if prop.dim() != 3 or prop.shape[1] != prop.shape[2]:
        raise ValueError(f"prop must be (B, N, N); got {tuple(prop.shape)}")
    b, n, _ = prop.shape
    if x.dim() != 3 or x.shape[:2] != (b, n):
        raise ValueError(f"x must be (B, N, F0) = ({b}, {n}, F0); got "
                         f"{tuple(x.shape)}")
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"need 1..{MAX_LAYERS} layers with one bias each; "
                         f"got {len(weights)} weights, {len(biases)} biases")
    dims = [int(x.shape[2])]
    for i, (w, bb) in enumerate(zip(weights, biases)):
        if w.dim() != 2 or w.shape[0] != dims[-1] or bb.shape != w.shape[1:]:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(bb.shape)} do not chain from width "
                             f"{dims[-1]}")
        dims.append(int(w.shape[1]))
    for name, t in [("prop", prop), ("x", x), *(("weight", w) for w in weights),
                    *(("bias", bb) for bb in biases)]:
        if t.device != prop.device:
            raise ValueError(f"{name} is on {t.device}, prop on {prop.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32; got {t.dtype}")
    if not (prop.is_contiguous() and x.is_contiguous()):
        raise ValueError("prop and x must be contiguous (call .contiguous(); "
                         "gcn_propagation_matrix returns a transposed view)")
    return dims


def _launch(prop, x, weights, biases) -> torch.Tensor:
    """Run the CUDA kernel on PyTorch's current stream; no synchronisation."""
    dims = _check_inputs(prop, x, weights, biases)
    lib = _library()
    c_dims = (ctypes.c_int * len(dims))(*dims)
    b, n, _ = prop.shape
    if lib.gcn_stack_shared_bytes(n, len(weights), c_dims) == 0:
        raise ValueError(f"gcn_stack kernel cannot hold N={n} with widths "
                         f"{dims} in one block's shared memory")
    w_packed = torch.cat([w.reshape(-1) for w in weights])
    b_packed = torch.cat([bb.reshape(-1) for bb in biases])
    out = torch.empty((b, n, sum(dims[1:])), device=prop.device,
                      dtype=torch.float32)
    stream = torch.cuda.current_stream(prop.device).cuda_stream
    code = lib.gcn_stack_forward(
        prop.data_ptr(), x.data_ptr(), w_packed.data_ptr(),
        b_packed.data_ptr(), out.data_ptr(), b, n, len(weights), c_dims,
        prop.device.index if prop.device.index is not None
        else torch.cuda.current_device(), stream)
    if code != 0:
        raise RuntimeError("gcn_stack kernel launch failed: "
                           + lib.gcn_stack_error_string(code).decode())
    fused_gcn_stack.launches += 1
    return out


class _GcnStack(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain version on the CPU. Backward:
    autograd of the plain version on the saved inputs (a recompute)."""

    @staticmethod
    def forward(ctx, prop, x, num_layers, *params):
        weights, biases = params[:num_layers], params[num_layers:]
        ctx.num_layers = num_layers
        ctx.save_for_backward(prop, x, *params)
        if prop.device.type == "cuda":
            return _launch(prop, x, weights, biases)
        if prop.device.type == "cpu":
            return gcn_stack_reference(prop, x, weights, biases)
        raise ValueError(f"fused_gcn_stack runs on cuda or cpu tensors, not "
                         f"{prop.device}")

    @staticmethod
    def backward(ctx, grad_out):
        saved = [t.detach().requires_grad_(need) for t, need in
                 zip(ctx.saved_tensors, (ctx.needs_input_grad[:2]
                                         + ctx.needs_input_grad[3:]))]
        prop, x, *params = saved
        nl = ctx.num_layers
        with torch.enable_grad():
            out = gcn_stack_reference(prop, x, params[:nl], params[nl:])
            wanted = [t for t in saved if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        full = [next(grads) if t.requires_grad else None for t in saved]
        return (full[0], full[1], None, *full[2:])


def fused_gcn_stack(prop: torch.Tensor, x: torch.Tensor,
                    weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fused L-layer GCN stack with JK-concat output.

    prop: (B, N, N) propagation matrix, contiguous on CUDA; x: (B, N, F0);
    weights[l]: (F_l, H_l) in the JAX layout; biases[l]: (H_l,). Returns
    (B, N, sum H_l). `fused_gcn_stack.launches` counts kernel launches.
    """
    return _GcnStack.apply(prop, x, len(weights), *weights, *biases)


fused_gcn_stack.launches = 0
