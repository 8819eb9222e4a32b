"""Fused imaging GCN stack: the hand-written CUDA kernel and its plain version.

Port of `iggcn_tpu/ops/pallas_gcn.py`. The TPU kernel there
(`_stack_kernel`) ran the whole L-layer stack per sample in VMEM; here
`csrc/gcn_stack.cu` does the same on Hopper: each sample's P stays
resident in shared memory, across a thread-block cluster where one CTA
cannot hold it, so P and x are read from device memory once and only the
JK-concat output is written. `plan_launch` cuts each call up (cluster,
rows per CTA, threads, shared-memory layout) in Python, where the CPU
tests reach it; the source's header note gives the kernel's bound on an
H100 and how the design meets it.

Dispatch is by device, with no switch and no fallback: on CUDA tensors
`fused_gcn_stack` launches the kernel (or raises), on CPU tensors it runs
`gcn_stack_reference`. The backward is autograd through
`gcn_stack_reference`, a recompute, exactly as the JAX custom VJP did; the
JAX package has no backward kernel and neither does the port.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

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


# Hopper limits the plan is held to: 227 KB of dynamic shared memory per
# block, less room for the kernel's static shared arrays; the kernel's
# __launch_bounds__; the cluster sizes that need no opt-in
SMEM_PER_BLOCK = 232448
STATIC_SMEM = 1024
MAX_THREADS = 512
CLUSTER_SIZES = (1, 2, 4, 8)
TILE_ROWS = 8            # a thread's register tile: 8 rows x 4 columns
KSPLITS = (1, 2, 4)      # lanes that may share one tile, splitting K


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call of the kernel is cut up; offsets and sizes in floats.

    Each sample runs on `cluster` CTAs (a thread-block cluster when > 1).
    CTA k owns P's columns, and h's rows, [k * rows, min(N, (k+1) * rows))
    and keeps those columns resident in shared memory for every layer;
    with a cluster, each CTA's partial P hW is summed across it. A thread
    computes an 8 x 4 register tile of P hW over 1/ksplit of the band."""
    cluster: int
    rows: int
    ksplit: int
    kpad: int                 # rows rounded up: K of the tile loop
    threads: int
    smem_bytes: int
    ps: int                   # column stride of P in shared memory (even)
    n8: int                   # N rounded up to TILE_ROWS
    hs: int                   # widest layer rounded up to 4
    hws: int                  # row strides of hW and h^T, padded so that
    hts: int                  # a warp's lanes reach different banks
    fout_p: Tuple[int, ...]   # each layer's width rounded up to 4
    off_part: int             # P's band first (kpad x ps + 8), then n8 x hs
    off_hw: int               # partial sums (cluster > 1), then kpad x hws hW
    off_h: int                # then h^T (hs x hts)
    off_w: Tuple[int, ...]    # W_l as ceil4(F_l) x fout_p[l], zero-padded
    off_b: Tuple[int, ...]    # b_l as fout_p[l], zero-padded
    off_o: int                # last: the JK output of its rows, rows x sum H


def _plan_for(n: int, dims: Sequence[int], cluster: int) -> LaunchPlan | None:
    """The plan with this cluster size, or None when it cannot run."""
    rows = _ceil(-(-n // cluster), TILE_ROWS)
    if (cluster - 1) * rows >= n:          # a CTA would own no column
        return None
    hs = _ceil(max(dims), 4)
    fout_p = tuple(_ceil(d, 4) for d in dims[1:])
    n8 = _ceil(n, TILE_ROWS)
    tiles = (n8 // TILE_ROWS) * (max(fout_p) // 4)
    # enough lanes for 4 warps, where K allows it
    ksplit = next((k for k in KSPLITS if tiles * k >= 128), KSPLITS[-1])
    kpad = _ceil(rows, max(TILE_ROWS, 4 * ksplit))
    threads = _ceil(tiles * ksplit, 32)
    if threads > MAX_THREADS:
        return None
    ps = _ceil(n, 2)
    # a warp's K-slices read neighbouring hW rows and its lanes store h^T
    # rows at one column: padded strides spread them over the banks
    hws = hs + 8 if ksplit > 1 else hs
    hts = kpad + 2
    off_part = kpad * ps + 8
    off_hw = off_part + (n8 * hs if cluster > 1 else 0)
    off_h = off_hw + kpad * hws
    cur = off_h + hs * hts
    off_w, off_b = [], []
    for fin, fp in zip(dims[:-1], fout_p):
        off_w.append(cur)
        off_b.append(cur + _ceil(fin, 4) * fp)
        cur += _ceil(fin, 4) * fp + fp
    off_o = cur
    smem = 4 * (cur + rows * sum(dims[1:]))
    if smem > SMEM_PER_BLOCK - STATIC_SMEM:
        return None
    return LaunchPlan(cluster, rows, ksplit, kpad, threads, smem, ps, n8, hs,
                      hws, hts, fout_p, off_part, off_hw, off_h,
                      tuple(off_w), tuple(off_b), off_o)


def plan_launch(b: int, n: int, dims: Sequence[int]) -> LaunchPlan:
    """Launch plan for a batch of `b` samples of N nodes with layer widths
    `dims` = (F0, H_1, ..., H_L).

    The cluster is the smallest that holds P resident: one CTA per sample
    where it fits (N=90), two at N=270, which measured 2-3 % faster than
    four on an H100 (PERF.md). The K split is the smallest that gives 4
    warps. Raises ValueError for a shape the kernel cannot hold."""
    plan = _choose_plan(n, tuple(int(d) for d in dims))
    if not 0 <= b * plan.cluster < 2 ** 31:
        raise ValueError(f"a batch of {b} takes {b * plan.cluster} CTAs; one "
                         "launch takes 0 to 2**31 - 1")
    return plan


@functools.lru_cache(maxsize=None)
def _choose_plan(n: int, dims: Tuple[int, ...]) -> LaunchPlan:
    if n < 1 or not 1 <= len(dims) - 1 <= MAX_LAYERS or min(dims) < 1:
        raise ValueError(f"gcn_stack kernel takes N >= 1 and 1..{MAX_LAYERS} "
                         f"layers of width >= 1; got N={n}, dims={dims}")
    plan = next((plan for c in CLUSTER_SIZES
                 if (plan := _plan_for(n, dims, c)) is not None), None)
    if plan is None:
        raise ValueError(f"gcn_stack kernel cannot hold N={n} with widths "
                         f"{list(dims)} resident in shared memory (cluster "
                         f"{CLUSTER_SIZES}, {SMEM_PER_BLOCK} B per CTA)")
    return plan


class _CPlan(ctypes.Structure):
    """`StackPlan` of csrc/gcn_stack.cu, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "num_layers", "cluster", "rows", "ksplit", "kpad", "threads",
        "smem_bytes", "ps", "n8", "hs", "hws", "hts", "total",
        "p_transposed", "copy_bulk",
        "off_part", "off_hw", "off_h", "off_o")] + [
            (name, ctypes.c_int * size) for name, size in (
                ("dims", MAX_LAYERS + 1), ("fout_p", MAX_LAYERS),
                ("off_w", MAX_LAYERS), ("off_b", MAX_LAYERS),
                ("out_off", MAX_LAYERS))]


@functools.lru_cache(maxsize=64)
def _c_plan(plan: LaunchPlan, n: int, dims: Tuple[int, ...], transposed: bool,
            bulk: bool) -> _CPlan:
    def ints(values, size=MAX_LAYERS):
        return (ctypes.c_int * size)(*values)
    return _CPlan(
        n=n, num_layers=len(dims) - 1, cluster=plan.cluster, rows=plan.rows,
        ksplit=plan.ksplit, kpad=plan.kpad, threads=plan.threads,
        smem_bytes=plan.smem_bytes, ps=plan.ps, n8=plan.n8, hs=plan.hs,
        hws=plan.hws, hts=plan.hts, total=sum(dims[1:]),
        p_transposed=int(transposed), copy_bulk=int(bulk),
        off_part=plan.off_part, off_hw=plan.off_hw, off_h=plan.off_h,
        off_o=plan.off_o, dims=ints(dims, MAX_LAYERS + 1),
        fout_p=ints(plan.fout_p), off_w=ints(plan.off_w),
        off_b=ints(plan.off_b),
        out_off=ints([sum(dims[1:1 + i]) for i in range(len(dims) - 1)]))


def _bulk_copyable(prop: torch.Tensor, plan: LaunchPlan) -> bool:
    """True when every CTA's band of P is one block of memory that the
    bulk-copy engine takes: P transposed in memory, with the block's start
    and length multiples of 16 bytes."""
    b, n, _ = prop.shape
    if plan.ps != n or prop.data_ptr() % 16 or (b > 1 and prop.stride(0) % 4):
        return False
    owns = [min(n, (k + 1) * plan.rows) - k * plan.rows
            for k in range(plan.cluster)]
    return all(own * n % 4 == 0 and k * plan.rows * n % 4 == 0
               for k, own in enumerate(owns))


_lib: ctypes.CDLL | None = None


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the kernel library's C signatures (pointers and the stream
    as c_void_p, so none is cut to 32 bits); returns `lib`."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gcn_stack_forward.argtypes = [
        ctypes.POINTER(_CPlan), ptr, ctypes.c_longlong, ptr,
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), ptr, i32, i32, ptr]
    lib.gcn_stack_forward.restype = i32
    lib.gcn_stack_error_string.argtypes = [i32]
    lib.gcn_stack_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    global _lib
    if _lib is None:
        _lib = declare(load_library(SOURCE))
    return _lib


def _prop_transposed(prop: torch.Tensor) -> bool:
    """False for row-major P (strides (N*N, N, 1)); True for P transposed
    in memory (strides (N*N, 1, N)), the layout `gcn_propagation_matrix`
    returns; raises on any other layout."""
    b, n, _ = prop.shape
    s0, s1, s2 = prop.stride()
    if b == 1 or s0 == n * n:
        if n == 1 or (s1, s2) == (n, 1):
            return False
        if (s1, s2) == (1, n):
            return True
    raise ValueError(f"prop must be row-major (strides (N*N, N, 1)) or the "
                     f"transposed layout gcn_propagation_matrix returns "
                     f"((N*N, 1, N)); got strides {prop.stride()} for shape "
                     f"{tuple(prop.shape)}")


def _check_inputs(prop, x, weights, biases) -> Tuple[List[int], bool]:
    """Raise on anything the kernel does not take; return the layer widths
    (F0, H_1, ..., H_L) and whether P is transposed in memory."""
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
        if name != "prop" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dims, _prop_transposed(prop)


def _launch(prop, x, weights, biases) -> torch.Tensor:
    """Run the CUDA kernel on PyTorch's current stream; no synchronisation."""
    dims, transposed = _check_inputs(prop, x, weights, biases)
    b, n, _ = prop.shape
    index = (prop.device.index if prop.device.index is not None
             else torch.cuda.current_device())
    plan = plan_launch(b, n, tuple(dims))
    out = torch.empty((b, n, sum(dims[1:])), device=prop.device,
                      dtype=torch.float32)
    if b == 0:
        return out
    c_plan = _c_plan(plan, n, tuple(dims), transposed,
                     transposed and _bulk_copyable(prop, plan))
    lib = _library()
    layers = len(weights)
    code = lib.gcn_stack_forward(
        ctypes.byref(c_plan), prop.data_ptr(), prop.stride(0), x.data_ptr(),
        (ctypes.c_void_p * layers)(*(w.data_ptr() for w in weights)),
        (ctypes.c_void_p * layers)(*(bb.data_ptr() for bb in biases)),
        out.data_ptr(), b, index,
        torch.cuda.current_stream(prop.device).cuda_stream)
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

    prop: (B, N, N) propagation matrix, row-major or in the transposed
    layout `gcn_propagation_matrix` returns; x: (B, N, F0);
    weights[l]: (F_l, H_l) in the JAX layout; biases[l]: (H_l,). Returns
    (B, N, sum H_l). `fused_gcn_stack.launches` counts kernel launches.
    """
    return _GcnStack.apply(prop, x, len(weights), *weights, *biases)


fused_gcn_stack.launches = 0
