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
`gcn_stack_reference`. The backward computes what the JAX custom VJP's
does (`jax.vjp` of the reference, the forward recomputed from the saved
inputs): on CUDA tensors one hand-written kernel,
`csrc/gcn_stack_backward.cu` (the forward's cluster split, planned by
`plan_backward`), for the shared-weight and the grouped forms; on CPU
tensors autograd of `gcn_stack_reference`. Its plain version step by
step, `gcn_stack_backward_reference`, is the kernel's yardstick.
`fused_gcn_stack.launches_backward` counts its launches.

Under `torch.func.vmap` over a fold axis (the fold-parallel trainer, the
counterpart of the JAX package's vmapped fold program, where the
`pallas_call` is batched with per-fold weights) the wrapper's vmap rule
merges the fold and sample axes and runs the grouped form once: F folds
of B samples in one launch, sample s reading weight set s // B (an
operand without the fold axis is broadcast with a stride of 0). Its plain
version, `gcn_stack_reference_grouped`, is the CPU path and the kernel's
yardstick on the card.

bf16 serving hands the stack bf16 P, x, weights and biases. On CUDA that
runs the kernel's bf16-operand form: the same stack in fp32 FMAs on the
bf16 values, fp32 activations between layers and an fp32 output, as the
JAX package's `gcn_conv` gives with `preferred_element_type=float32`.
Where one CTA holds a sample's bf16 P (N=90 and N=270, the model's sizes)
that is `csrc/gcn_stack_bf16.cu`, a persistent kernel whose CTAs walk
the batch, each sample's P brought into one stage of shared memory by a
bulk copy (`PersistentPlan`, `stage_schedule`); larger N take the fp32
kernel's cluster design on bf16 bands (`csrc/gcn_stack.cu` with
`T = __nv_bfloat16`). On the CPU it is
`gcn_stack_reference` on the fp32 upcasts. The bf16 form serves only: it
has no backward and raises when grad is on and an input requires it, and
it has no grouped form (training is fp32).
`fused_gcn_stack.launches_bf16` counts its launches.

Every shape the resident designs above cannot hold (P and the operands
past a cluster's shared memory, or more than `MAX_LAYERS` layers) runs
the streamed form, `csrc/gcn_stack_streamed.cu`, for each of those forms
and the backward alike: one batched tiled product per step, K streamed
through a ring in shared memory, with scratch in device memory
(`StreamedPlan`; `_layer_products`, `_backward_products` list its
launches). `plan_launch` and `plan_backward` choose apart, by shape: the
resident plan wherever it holds, else the streamed one.
`fused_gcn_stack.launches_streamed` counts its calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

from torch.autograd.function import once_differentiable

from iggcn_tpu_torch.utils.cuda_build import load_library

SOURCE = "gcn_stack.cu"
BF16_SOURCE = "gcn_stack_bf16.cu"
BACKWARD_SOURCE = "gcn_stack_backward.cu"
STREAMED_SOURCE = "gcn_stack_streamed.cu"
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


def gcn_stack_reference_grouped(prop: torch.Tensor, x: torch.Tensor,
                                weights: Sequence[torch.Tensor],
                                biases: Sequence[torch.Tensor]
                                ) -> torch.Tensor:
    """Plain version of the grouped form: prop (G*B, N, N), x (G*B, N, F0),
    weights[l] (G, F_l, H_l), biases[l] (G, H_l); sample s uses weight set
    s // B. Returns (G*B, N, sum(H_l)), the per-group
    `gcn_stack_reference` results stacked."""
    g = weights[0].shape[0]
    s, n, _ = prop.shape
    p = prop.reshape(g, s // g, n, n)
    h = x.reshape(g, s // g, n, x.shape[-1])
    feats = []
    for w, b in zip(weights, biases):
        h = torch.relu(p @ torch.einsum("gbnf,gfh->gbnh", h, w)
                       + b[:, None, None, :])
        feats.append(h)
    return torch.cat(feats, dim=-1).reshape(s, n, sum(w.shape[-1]
                                                        for w in weights))


def gcn_stack_backward_reference(prop: torch.Tensor, x: torch.Tensor,
                                 weights: Sequence[torch.Tensor],
                                 biases: Sequence[torch.Tensor],
                                 grad_out: torch.Tensor,
                                 needs: Tuple[bool, bool, bool] = (True, True,
                                                                   True)):
    """Plain version of the stack's backward: the VJP of
    `gcn_stack_reference` (grouped: `gcn_stack_reference_grouped` where the
    weights are 3-D) for the output gradient `grad_out` (B, N, sum H),
    step by step as the kernel computes it. The recompute: a_l = h_l W_l,
    z_l = P a_l + b_l, h_{l+1} = relu(z_l); then for l = L-1 .. 0 from
    e_L = 0: dz_l = (grad_out's slice of layer l + e_{l+1}) * [z_l > 0],
    db_l = sum over rows of dz_l, da_l = P^T dz_l, dW_l = h_l^T da_l,
    e_l = da_l W_l^T; dx = e_0 and dP = sum_l dz_l a_l^T. Returns
    (dprop, dx, dweights, dbiases), each None where `needs` (prop, x,
    weights and biases) says no; grouped gradients are summed per set."""
    need_p, need_x, need_w = needs
    grouped = _weight_sets(weights) > 0
    ws = [w if grouped else w[None] for w in weights]
    bs = [bb if grouped else bb[None] for bb in biases]
    sets = ws[0].shape[0]
    s, n, _ = prop.shape
    p = prop.reshape(sets, s // sets, n, n)
    hs = [x.reshape(sets, s // sets, n, x.shape[-1])]
    acts, zs = [], []
    for w, bb in zip(ws, bs):
        acts.append(torch.einsum("gbnf,gfh->gbnh", hs[-1], w))
        zs.append(p @ acts[-1] + bb[:, None, None, :])
        hs.append(torch.relu(zs[-1]))
    g = grad_out.reshape(sets, s // sets, n, grad_out.shape[-1])
    dzs, dws, dbs = [None] * len(ws), [None] * len(ws), [None] * len(ws)
    e = torch.zeros_like(hs[-1])
    end = g.shape[-1]
    for layer in reversed(range(len(ws))):
        start = end - ws[layer].shape[-1]
        dz = (g[..., start:end] + e) * (zs[layer] > 0)
        end = start
        dbs[layer] = dz.sum(dim=(1, 2))
        da = p.transpose(-1, -2) @ dz
        dws[layer] = torch.einsum("gbnf,gbnh->gfh", hs[layer], da)
        e = da @ ws[layer].transpose(-1, -2)[:, None]
        dzs[layer] = dz
    dprop = (sum(dz @ a.transpose(-1, -2) for dz, a in zip(dzs, acts))
             .reshape(s, n, n) if need_p else None)
    dx = e.reshape(x.shape) if need_x else None
    if not need_w:
        return dprop, dx, None, None
    if not grouped:
        dws, dbs = [w[0] for w in dws], [bb[0] for bb in dbs]
    return dprop, dx, dws, dbs


# Hopper limits the plan is held to: 227 KB of dynamic shared memory per
# block, less room for the kernel's static shared arrays; the kernel's
# __launch_bounds__; the cluster sizes that need no opt-in
SMEM_PER_BLOCK = 232448
STATIC_SMEM = 1024
MAX_THREADS = 512
CLUSTER_SIZES = (1, 2, 4, 8)
TILE_ROWS = 8            # a thread's register tile: 8 rows x 4 columns
KSPLITS = (1, 2, 4)      # lanes that may share one tile, splitting K
# The bf16 form's persistent kernel: K split 2 or 4. An SM has 228 KB of
# shared memory, of which the runtime reserves 1 KB for each resident CTA.
SMEM_PER_SM = 233472
SMEM_PER_CTA = 1024
BF16_KSPLITS = (2, 4)
# threads a CTA may have, and an SM may hold at the 128 registers a thread
# the kernel's __launch_bounds__(512) allow
BF16_MAX_THREADS = 512
H100_SMS = 132           # SMs of an H100 SXM: plan_launch's default


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
    elem_bytes: int = 4       # bytes of one value of P: 4 fp32, 2 bf16


# bf16 values the band's head may shift it by in shared memory (`band_copy`)
BF16_LEAD = 8


@dataclasses.dataclass(frozen=True)
class PersistentPlan:
    """The bf16 form's launch plan where one CTA holds a sample
    (`csrc/gcn_stack_bf16.cu`); offsets and sizes in floats from the start
    of shared memory.

    `grid(b)` CTAs stay resident, `ctas_per_sm` to an SM, and CTA c takes
    samples c, c + grid, ...; a stage of `stage_vals` bf16 values holds
    their P in turn (the first region of shared memory), which the tile
    loop reads in place. A thread computes an 8 x 4 register tile of P hW
    over 1/ksplit of K."""
    ksplit: int
    kpad: int                 # N rounded up: K of the tile loop
    threads: int
    ctas_per_sm: int
    smem_bytes: int
    ps: int                   # column stride of P in the stage (even)
    n8: int                   # N rounded up to TILE_ROWS
    hs: int                   # widest layer rounded up to 4
    hws: int                  # row stride of hW (hws % 8 == 4: a warp's
    hts: int                  # K-slices on other banks); of h^T
    stage_vals: int           # bf16 values of the stage, a multiple of 8
    fout_p: Tuple[int, ...]   # each layer's width rounded up to 4
    off_hw: int               # after the stage: kpad x hws hW
    off_h: int                # then h^T (hs x hts)
    off_w: Tuple[int, ...]    # W_l as ceil4(F_l) x fout_p[l], zero-padded
    off_b: Tuple[int, ...]    # b_l as fout_p[l], zero-padded
    off_o: int                # last: the JK output, n x sum H
    sms: int                  # SMs of the card the plan is for
    elem_bytes: int = 2
    cluster: int = 1          # one CTA per sample

    @property
    def warps_per_sm(self) -> int:
        return self.ctas_per_sm * self.threads // 32

    def grid(self, b: int) -> int:
        """CTAs of a launch over `b` samples: every resident CTA, or one
        per sample where there are fewer."""
        return min(b, self.sms * self.ctas_per_sm)


def persistent_plan(n: int, dims: Sequence[int], ksplit: int, sms: int
                    ) -> PersistentPlan | None:
    """The persistent plan with this K split, or None when it does not fit
    one CTA."""
    hs = _ceil(max(dims), 4)
    fout_p = tuple(_ceil(d, 4) for d in dims[1:])
    n8 = _ceil(n, TILE_ROWS)
    tiles = (n8 // TILE_ROWS) * (max(fout_p) // 4)
    threads = _ceil(tiles * ksplit, 32)
    if threads > BF16_MAX_THREADS:
        return None
    kpad = _ceil(n, max(TILE_ROWS, 2 * ksplit))
    ps = _ceil(n, 2)
    # a warp's 8 K-slices read 8 rows of hW: a stride of 4 (mod 8) floats
    # puts their 16-byte loads on 32 different banks
    hws = hs + 4 if hs % 8 == 0 else hs
    hts = kpad + 2
    # the tile loop reads up to kpad columns and the pad rows' slack
    stage_vals = _ceil(BF16_LEAD + kpad * ps + 8, 8)
    off_hw = stage_vals // 2
    off_h = off_hw + kpad * hws
    cur = off_h + hs * hts
    off_w, off_b = [], []
    for fin, fp in zip(dims[:-1], fout_p):
        off_w.append(cur)
        off_b.append(cur + _ceil(fin, 4) * fp)
        cur += _ceil(fin, 4) * fp + fp
    smem = 4 * (cur + _ceil(n * sum(dims[1:]), 4))
    if smem > SMEM_PER_BLOCK - STATIC_SMEM:
        return None
    ctas = min(SMEM_PER_SM // (smem + STATIC_SMEM + SMEM_PER_CTA),
               BF16_MAX_THREADS // threads)
    return PersistentPlan(ksplit, kpad, threads, ctas, smem, ps, n8,
                          hs, hws, hts, stage_vals, fout_p, off_hw, off_h,
                          tuple(off_w), tuple(off_b), cur, sms)


def _choose_persistent(n: int, dims: Tuple[int, ...], sms: int
                       ) -> PersistentPlan | None:
    """The widest K split that fits: the most warps a sample gets. It
    measured fastest at N=90 for B=256 and for the 874-subject cohort in
    one launch, and at N=270 for B=256 (PERF.md)."""
    return next((plan for ks in sorted(BF16_KSPLITS, reverse=True)
                 if (plan := persistent_plan(n, dims, ks, sms))), None)


def stage_schedule(b: int, grid: int) -> List[List[Tuple[str, int, int]]]:
    """The persistent bf16 kernel's stage, event by event for each CTA, as
    `csrc/gcn_stack_bf16.cu` runs it: ("fill", sample, use) where thread 0
    issues the copy of `sample` into the stage (its use-th fill), ("wait",
    sample, parity) where the CTA waits for it on the stage's barrier and,
    once every thread is done with it, releases the stage. CTA c takes
    samples c, c + grid, ...; the first is filled before the loop, and
    each release refills the stage with the next."""
    out = []
    for cta in range(min(b, grid)):
        samples = range(cta, b, grid)
        events = [("fill", samples[0], 0)]
        for it, s in enumerate(samples):
            events.append(("wait", s, it & 1))
            if it + 1 < len(samples):
                events.append(("fill", samples[it + 1], it + 1))
        out.append(events)
    return out


def _plan_for(n: int, dims: Sequence[int], cluster: int,
              elem_bytes: int = 4) -> LaunchPlan | None:
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
    if elem_bytes == 4:
        off_part = kpad * ps + 8
    else:   # bf16 band: lead, kpad x ps values and the slack, in floats
        off_part = _ceil((BF16_LEAD + kpad * ps + 8) // 2, 4)
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
                      tuple(off_w), tuple(off_b), off_o, elem_bytes)


def plan_launch(b: int, n: int, dims: Sequence[int], elem_bytes: int = 4,
                sms: int = H100_SMS
                ) -> LaunchPlan | PersistentPlan | StreamedPlan:
    """Launch plan for a batch of `b` samples of N nodes with layer widths
    `dims` = (F0, H_1, ..., H_L), P's values `elem_bytes` wide (4 fp32, 2
    for the bf16 form), on a card of `sms` SMs.

    fp32: the cluster is the smallest that holds P resident, one CTA per
    sample at N=90, two at N=270, which measured 2-3 % faster than four on
    an H100 (PERF.md); the K split is the smallest that gives 4 warps.
    bf16: the persistent kernel's `PersistentPlan` where one CTA holds a
    sample (N=90 and N=270; it does not depend on `b`, whose `grid(b)` is
    the launch's), else the fp32 design's `LaunchPlan` on bf16 bands with
    a cluster of 2 to 8. A shape none of those holds resident (or more
    than `MAX_LAYERS` layers) gets the streamed form's `StreamedPlan`.
    Raises ValueError only for an invalid shape or a grid past the launch
    limits."""
    if elem_bytes not in (2, 4):
        raise ValueError(f"elem_bytes is 4 (fp32) or 2 (bf16); got "
                         f"{elem_bytes}")
    plan = _choose_plan(n, tuple(int(d) for d in dims), elem_bytes, sms)
    _check_grid(b, _ctas_per_sample(plan))
    return plan


@functools.lru_cache(maxsize=None)
def _choose_plan(n: int, dims: Tuple[int, ...], elem_bytes: int, sms: int
                 ) -> LaunchPlan | PersistentPlan | StreamedPlan:
    _check_shape(n, dims)
    if len(dims) - 1 > MAX_LAYERS:
        return streamed_plan(n, dims, elem_bytes)
    if elem_bytes == 2 and (persistent := _choose_persistent(n, dims, sms)):
        return persistent
    clusters = CLUSTER_SIZES if elem_bytes == 4 else CLUSTER_SIZES[1:]
    return next((plan for c in clusters
                 if (plan := _plan_for(n, dims, c, elem_bytes)) is not None),
                None) or streamed_plan(n, dims, elem_bytes)


def _check_shape(n: int, dims: Tuple[int, ...]) -> None:
    if n < 1 or len(dims) < 2 or min(dims) < 1:
        raise ValueError(f"gcn_stack kernel takes N >= 1 and at least one "
                         f"layer, every width >= 1; got N={n}, dims={dims}")


def _check_grid(b: int, ctas: int) -> None:
    if not 0 <= b * ctas < 2 ** 31:
        raise ValueError(f"a batch of {b} takes {b * ctas} CTAs; one launch "
                         "takes 0 to 2**31 - 1")


def _ctas_per_sample(plan) -> int:
    return plan.tiles if isinstance(plan, StreamedPlan) else plan.cluster


# The streamed form (csrc/gcn_stack_streamed.cu): one batched tiled product
# C = A B per sample, a CTA per BM x BN tile of C (one of STREAM_TILES, as
# `choose_tile` picks; each thread a 4 x 4 register tile), K streamed
# through a ring of STREAM_STAGES chunks of STREAM_CHUNK in shared memory
# (staged rows padded by STREAM_PAD floats), split over `ksplit` groups of
# warps where a CTA would have fewer than STREAM_MIN_THREADS threads or the
# batch fewer than STREAM_MIN_CTAS CTAs
STREAM_TILES = ((64, 16), (32, 32), (32, 64), (32, 128))
STREAM_CHUNK = 32
STREAM_STAGES = 3
STREAM_PAD = 4
STREAM_MAX_THREADS = 512
STREAM_MIN_THREADS = 128         # four warps a CTA
STREAM_KSPLITS = (1, 2, 4, 8)
STREAM_MIN_CTAS = 264            # two CTAs per SM on an H100's 132 SMs
STREAM_MAX_SMEM = 227 * 1024     # dynamic shared memory a CTA may take
STREAM_W2_FLOATS = 128 * 128     # W_{l+1} beside the ring: 64 KB at most


def choose_tile(m: int, n: int, batch: int) -> Tuple[int, int]:
    """(index into STREAM_TILES, ksplit) of a product C (m x n) over
    `batch` samples: BN the smallest of 16, 32, 64, 128 that covers n (64
    above 128) and the one BM compiled with it, the narrowest that gives
    four warps (32 rows; 64 at BN = 16), so that the grid has as many CTAs
    as it can; then K split over the fewest groups of warps (up to 8 and
    STREAM_MAX_THREADS threads) that make STREAM_MIN_THREADS threads a CTA
    and, where the grid has fewer than STREAM_MIN_CTAS CTAs, bring their
    warps (2 at least)."""
    bn = next((w for w in (16, 32, 64, 128) if w >= n), 64)
    tile = next(i for i, (_, w) in enumerate(STREAM_TILES) if w == bn)
    bm = STREAM_TILES[tile][0]
    threads = bm * bn // 16
    ctas = -(-m // bm) * -(-n // bn) * batch
    want = (1 if ctas >= STREAM_MIN_CTAS
            else max(2, -(-STREAM_MIN_CTAS // max(ctas, 1))))
    ks = 1
    while (ks < STREAM_KSPLITS[-1] and 2 * ks * threads <= STREAM_MAX_THREADS
           and (ks * threads < STREAM_MIN_THREADS or ks < want)):
        ks *= 2
    return tile, ks


def streamed_smem(tile: int, ksplit: int, a_k: bool, b_k: bool,
                  fused: Tuple[int, int] | None = None) -> int:
    """Bytes of dynamic shared memory one launch takes (the kernel's
    `smem_floats`): the ring of A and B, each staged along K (`a_k`, `b_k`)
    or along m / n, reused after the main loop for each K group's sums (row
    stride BN + 1) and, with `fused` = (H_{l+1}, H_{l+2}), h_{l+1}'s rows;
    then W_{l+1}."""
    bm, bn = STREAM_TILES[tile]
    row = STREAM_CHUNK + STREAM_PAD
    a = bm * row if a_k else STREAM_CHUNK * (bm + STREAM_PAD)
    b = bn * row if b_k else STREAM_CHUNK * (bn + STREAM_PAD)
    sums = ksplit * bm * (bn + 1) + (bn * (bm + STREAM_PAD) if fused else 0)
    return 4 * (max(STREAM_STAGES * (a + b), sums)
                + (fused[0] * _ceil(fused[1], 4) if fused else 0))


def streamed_fuses(h: int, h_next: int) -> bool:
    """Whether layer l's P-product (width h = H_{l+1}) computes a_{l+1} =
    h_{l+1} W_{l+1} (W_{l+1}: h x h_next) in its epilogue: one tile covers
    the width and W_{l+1} fits in shared memory beside the ring."""
    return h <= 128 and h * _ceil(h_next, 4) <= STREAM_W2_FLOATS


def copy_vec(addr: int, elem_bytes: int, contiguous: int, other: int,
             batch: int) -> int:
    """Floats per cp.async of an operand staged along its contiguous
    dimension: 4 (16 bytes) where that stride is 1 and the address, the
    other stride and the batch stride (in values) are 16-byte aligned, 2
    where they are 8-byte aligned, else 1; bf16 operands 1 (plain loads)."""
    if elem_bytes != 4 or contiguous != 1:
        return 1
    return next((v for v in (4, 2) if addr % (4 * v) == 0 and other % v == 0
                 and batch % v == 0), 1)


def staged_along_k(s_r: int, s_k: int, rows: int, depth: int) -> bool:
    """Whether an operand X(r, k) = r * s_r + k * s_k is staged along K:
    where K is its contiguous dimension (both, where both strides are 1 and
    K is the longer)."""
    if s_k == 1 and s_r != 1:
        return True
    return s_k == 1 and s_r == 1 and depth >= rows


@dataclasses.dataclass(frozen=True)
class StreamedPlan:
    """The streamed form's plan, for shapes the resident kernels cannot
    hold (P and the operands past a cluster's shared memory, or more than
    `MAX_LAYERS` layers). Nothing stays resident: the forward is a_0 =
    x W_0, then per layer relu(P a_l + b_l) into the JK output, whose
    epilogue computes a_{l+1} = h_{l+1} W_{l+1} where `fused` says so (else
    a launch of its own); the backward one launch per product of the JAX
    VJP, through scratch in device memory that the wrapper allocates.
    `launches` holds the (m, n, k) of each launch in list order (for the
    backward: every gradient taken), each run on the tile `choose_tile`
    gives it at the call's batch. Sizes of the scratch in floats per
    sample; `tiles` is the most CTAs one sample can take in any of the
    launches (the grid is one dimension, CTAs x samples)."""
    smem_bytes: int           # the most dynamic shared memory a launch takes
    a_floats: int             # every layer's a_l (N x sum H)
    h_floats: int             # backward: the recompute's JK output
    dz_floats: int            # backward: every layer's dz_l (N x sum H)
    da_floats: int            # backward: da_l of one layer (N x max H)
    wsz: int                  # backward: one sample's dW / db slot
    ws_off: Tuple[int, ...]   # dW_l in a slot (F_l x H_l), then db_l
    tiles: int
    launches: Tuple[Tuple[int, int, int], ...]
    fused: Tuple[bool, ...]   # per layer but the last
    backward: bool
    elem_bytes: int = 4


def streamed_plan(n: int, dims: Sequence[int], elem_bytes: int = 4,
                  backward: bool = False) -> StreamedPlan:
    """The streamed plan of N nodes and widths `dims` = (F0, H_1, ...,
    H_L): the forward's (`backward=False`; fp32 or, `elem_bytes=2`, bf16
    operands) or the backward's (fp32)."""
    dims = tuple(int(d) for d in dims)
    _check_shape(n, dims)
    total, hmax = sum(dims[1:]), max(dims[1:])
    layers = len(dims) - 1
    fused = tuple(streamed_fuses(dims[l + 1], dims[l + 2])
                  for l in range(layers - 1))
    launches, w2 = [], []           # w2: (H_{l+1}, H_{l+2}) where fused
    for l in range(layers):
        if l == 0 or not fused[l - 1]:
            launches.append((n, dims[l + 1], dims[l]))          # a_l
            w2.append(None)
        launches.append((n, dims[l + 1], n))                    # z_l
        w2.append(dims[l + 1:l + 3] if l < layers - 1 and fused[l] else None)
    sizes = [fin * fout + fout for fin, fout in zip(dims[:-1], dims[1:])]
    if backward:
        for l in reversed(range(layers)):
            launches += [(n + 1, dims[l + 1], n),               # da_l, db_l
                         (dims[l], dims[l + 1], n),             # dW_l
                         (n, dims[l], dims[l + 1])]             # e_l or dx
        launches.append((n, n, total))                          # dP
        w2 += [None] * (3 * layers + 1)
    # at a batch of 1 each launch takes its widest K split (the most sums)
    tiles = [choose_tile(m, c, 1) for m, c, _ in launches]
    smem = max(streamed_smem(tile, ks, a_k, b_k, fused_w)
               for (tile, ks), fused_w in zip(tiles, w2)
               for a_k in (False, True) for b_k in (False, True))
    return StreamedPlan(
        smem, n * total,
        n * total if backward else 0, n * total if backward else 0,
        n * hmax if backward else 0, sum(sizes) if backward else 0,
        tuple(sum(sizes[:i]) for i in range(len(sizes))),
        max(-(-m // STREAM_TILES[tile][0]) * -(-c // STREAM_TILES[tile][1])
            for (m, c, _), (tile, _) in zip(launches, tiles)),
        tuple(launches), fused, backward, elem_bytes)


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """How one call of the backward kernel (`csrc/gcn_stack_backward.cu`)
    is cut up; offsets and sizes in floats from the start of shared memory.

    As in the forward, sample s runs on `cluster` CTAs and CTA k keeps P's
    columns [k * rows, (k+1) * rows) resident (the band, column-major,
    stride `ps`) and owns those rows of h, a and dz. After the band: dz^T
    of every layer and row (`tot_p` x `dts`; the cluster's partial P a
    during the recompute), a^T and h^T of the CTA's rows (row stride
    `ats`), da of its rows (row stride `das`), then the weights and biases
    zero-padded as in the forward. Each CTA sums its rows' dW_l and db_l
    into its own slot of `wsz` floats (dW_l at `ws_off[l]`, F_l x H_l, then
    db_l), which a second kernel sums per weight set."""
    cluster: int
    rows: int
    threads: int
    smem_bytes: int
    ps: int                   # column stride of P's band (even; read in
    #                           16-byte vectors where it is a multiple of 4)
    tot_p: int                # sum of fout_p: rows of dz^T and a^T
    hmax: int                 # widest fout_p
    dts: int                  # row stride of dz^T: N rounded up to 8, + 4
    ats: int                  # row stride of a^T and h^T: rows + 4
    das: int                  # row stride of da
    wsz: int                  # floats of one CTA's dW / db slot
    fout_p: Tuple[int, ...]   # each layer's width rounded up to 4
    dz_off: Tuple[int, ...]   # row of layer l in dz^T and a^T
    h_off: Tuple[int, ...]    # row of h_l in h^T (ceil4(F_l) rows each)
    ws_off: Tuple[int, ...]   # dW_l's offset in a slot
    off_dz: int
    off_at: int
    off_ht: int
    off_da: int
    off_w: Tuple[int, ...]
    off_b: Tuple[int, ...]
    elem_bytes: int = 4       # fp32 only: the bf16 form has no backward


def _backward_plan_for(n: int, dims: Tuple[int, ...], cluster: int
                       ) -> BackwardPlan | None:
    """The backward plan with this cluster size, or None when it cannot
    run."""
    rows = _ceil(-(-n // cluster), TILE_ROWS)
    if (cluster - 1) * rows >= n:          # a CTA would own no column
        return None
    fout_p = tuple(_ceil(d, 4) for d in dims[1:])
    dz_off = tuple(sum(fout_p[:i]) for i in range(len(fout_p)))
    h_off = tuple(sum(_ceil(d, 4) for d in dims[:i])
                  for i in range(len(fout_p)))
    h_rows = h_off[-1] + _ceil(dims[-2], 4)
    tot_p, hmax = sum(fout_p), max(fout_p)
    ps = _ceil(n, 2)
    # strides of 4 (mod 8) floats: rows 16-byte aligned for the products'
    # vector reads, and two 4-row tiles read by one quarter-warp reach
    # different banks (a K split's lanes read consecutive 16-byte chunks)
    dts, ats = _ceil(n, TILE_ROWS) + 4, rows + 4
    das = hmax + 4 if hmax % 8 == 0 else hmax
    off_dz = rows * ps + 8                 # the band, and slack for pad rows
    off_at = off_dz + tot_p * dts
    off_ht = off_at + tot_p * ats
    off_da = off_ht + h_rows * ats
    cur = off_da + rows * das
    off_w, off_b = [], []
    for fin, fp in zip(dims[:-1], fout_p):
        off_w.append(cur)
        off_b.append(cur + _ceil(fin, 4) * fp)
        cur += _ceil(fin, 4) * fp + fp
    if 4 * cur > SMEM_PER_BLOCK - STATIC_SMEM:
        return None
    sizes = [fin * fout + fout for fin, fout in zip(dims[:-1], dims[1:])]
    ws_off = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    return BackwardPlan(cluster, rows, MAX_THREADS, 4 * cur, ps, tot_p, hmax,
                        dts, ats, das, sum(sizes), fout_p, dz_off, h_off,
                        ws_off, off_dz, off_at, off_ht, off_da, tuple(off_w),
                        tuple(off_b))


@functools.lru_cache(maxsize=None)
def _choose_backward_plan(n: int, dims: Tuple[int, ...]
                          ) -> BackwardPlan | StreamedPlan:
    _check_shape(n, dims)
    if len(dims) - 1 > MAX_LAYERS:
        return streamed_plan(n, dims, backward=True)
    return next((plan for c in CLUSTER_SIZES
                 if (plan := _backward_plan_for(n, dims, c)) is not None),
                None) or streamed_plan(n, dims, backward=True)


def plan_backward(b: int, n: int, dims: Sequence[int]
                  ) -> BackwardPlan | StreamedPlan:
    """Launch plan of the backward for a batch of `b` samples of N nodes
    with layer widths `dims` = (F0, H_1, ..., H_L): the resident kernel's
    smallest cluster whose CTAs hold their band of P and the backward's
    operands in shared memory (the forward's split where both fit: one
    CTA at N=90, two at N=270), else the streamed form's `StreamedPlan`
    (chosen apart from the forward's). Raises ValueError only for an
    invalid shape or a grid past the launch limits."""
    plan = _choose_backward_plan(n, tuple(int(d) for d in dims))
    _check_grid(b, _ctas_per_sample(plan))
    return plan


@dataclasses.dataclass(frozen=True)
class BackwardProduct:
    """One product of the backward kernel as its `product<>` runs it,
    offsets in floats from the start of shared memory: C(m, n) = sum_k
    A(m, k) B(k, n) for m < mn, n < nn, k < kn, in tm x tn register tiles,
    K read in chunks of 4 (so up to the next multiple of 4). A(m, k) is
    smem[a + m * a_stride + k] where `a_k` (contiguous in k), else
    smem[a + k * a_stride + m], read `a_vec` floats at a time along the
    contiguous dimension; B(k, n) is smem[b + n * b_stride + k] where
    `b_k`, else smem[b + k * b_stride + n], `b_vec` at a time. A tile's
    rows past mn (`a_k`) and columns past nn (`b_k`) read row mn - 1 and
    column nn - 1 again; otherwise reads run to the tile's edge."""
    name: str                 # a, z (recompute); da, dW, e (backward); dP
    layer: int                # -1 for dP
    tm: int
    tn: int
    mn: int
    nn: int
    kn: int
    a: int
    a_stride: int
    a_k: bool
    a_vec: int
    b: int
    b_stride: int
    b_k: bool
    b_vec: int

    @property
    def fmas(self) -> int:
        """FMAs its tiles run, pads included."""
        return (_ceil(self.mn, self.tm) * _ceil(self.nn, self.tn)
                * _ceil(self.kn, 4))


# the backward's P-products (z = P a, da = P^T dz) take 8 x 4 register
# tiles where their K is at least this long, else 4 x 4 (kDeepK)
P_DEEP_K = 128


def _p_rows(k: int) -> int:
    return 8 if k >= P_DEEP_K else 4


def backward_products(plan: BackwardPlan, n: int, dims: Sequence[int],
                      rank: int = 0) -> List[BackwardProduct]:
    """The products CTA `rank` of a cluster runs in the backward kernel,
    in the order it runs them: per layer the recompute's a = h W and
    z = P a; per layer, last first, da = P^T dz, dW = h^T da and
    e = da W^T; then dP = A^T DZ. P's band is read 4 floats at a time
    where its column stride allows, else 2; the P-products' tiles have 8
    rows where their K is at least `P_DEEP_K`, else 4."""
    own = min(n, (rank + 1) * plan.rows) - rank * plan.rows
    pv = 4 if plan.ps % 4 == 0 else 2
    ats, dts = plan.ats, plan.dts
    out = []
    for l, fp in enumerate(plan.fout_p):
        at_l = plan.off_at + plan.dz_off[l] * ats
        out += [BackwardProduct("a", l, 4, 4, own, fp, dims[l],
                                plan.off_ht + plan.h_off[l] * ats, ats, False,
                                4, plan.off_w[l], fp, False, 4),
                BackwardProduct("z", l, _p_rows(own), 4, n, fp, own, 0,
                                plan.ps, False, pv, at_l, ats, True, 4)]
    for l in reversed(range(len(plan.fout_p))):
        fin, fout, fp = dims[l], dims[l + 1], plan.fout_p[l]
        out += [BackwardProduct("da", l, _p_rows(n), 4, own, fp, n, 0,
                                plan.ps, True, pv,
                                plan.off_dz + plan.dz_off[l] * dts, dts, True,
                                4),
                BackwardProduct("dW", l, 4, 4, fin, fout, own,
                                plan.off_ht + plan.h_off[l] * ats, ats, True,
                                4, plan.off_da, plan.das, False, 4),
                BackwardProduct("e", l, 4, 4, own, fin, fout, plan.off_da,
                                plan.das, True, 4, plan.off_w[l], fp, True, 4)]
    out.append(BackwardProduct("dP", -1, 8, 4, own, n, plan.tot_p,
                               plan.off_at, ats, False, 4, plan.off_dz, dts,
                               False, 4))
    return out


class _CPlan(ctypes.Structure):
    """`StackPlan` of csrc/gcn_stack.cu, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "num_layers", "cluster", "rows", "ksplit", "kpad", "threads",
        "smem_bytes", "ps", "n8", "hs", "hws", "hts", "total",
        "p_transposed", "copy_bulk", "group", "bf16",
        "off_part", "off_hw", "off_h", "off_o")] + [
            (name, ctypes.c_int * size) for name, size in (
                ("dims", MAX_LAYERS + 1), ("fout_p", MAX_LAYERS),
                ("off_w", MAX_LAYERS), ("off_b", MAX_LAYERS),
                ("out_off", MAX_LAYERS), ("w_stride", MAX_LAYERS),
                ("b_stride", MAX_LAYERS))]


@functools.lru_cache(maxsize=64)
def _c_plan(plan: LaunchPlan, n: int, dims: Tuple[int, ...], transposed: bool,
            bulk: bool, group: int, w_strides: Tuple[int, ...],
            b_strides: Tuple[int, ...]) -> _CPlan:
    def ints(values, size=MAX_LAYERS):
        return (ctypes.c_int * size)(*values)
    return _CPlan(
        n=n, num_layers=len(dims) - 1, cluster=plan.cluster, rows=plan.rows,
        ksplit=plan.ksplit, kpad=plan.kpad, threads=plan.threads,
        smem_bytes=plan.smem_bytes, ps=plan.ps, n8=plan.n8, hs=plan.hs,
        hws=plan.hws, hts=plan.hts, total=sum(dims[1:]),
        p_transposed=int(transposed), copy_bulk=int(bulk), group=group,
        bf16=int(plan.elem_bytes == 2),
        off_part=plan.off_part, off_hw=plan.off_hw, off_h=plan.off_h,
        off_o=plan.off_o, dims=ints(dims, MAX_LAYERS + 1),
        fout_p=ints(plan.fout_p), off_w=ints(plan.off_w),
        off_b=ints(plan.off_b),
        out_off=ints([sum(dims[1:1 + i]) for i in range(len(dims) - 1)]),
        w_stride=ints(w_strides), b_stride=ints(b_strides))


class _CBf16Plan(ctypes.Structure):
    """`Bf16Plan` of csrc/gcn_stack_bf16.cu, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "num_layers", "ksplit", "kpad", "threads", "smem_bytes", "grid",
        "copy_bulk", "p_transposed", "ps", "n8", "hs", "hws", "hts",
        "total", "stage_vals", "off_hw", "off_h", "off_o")] + [
            (name, ctypes.c_int * size) for name, size in (
                ("dims", MAX_LAYERS + 1), ("fout_p", MAX_LAYERS),
                ("off_w", MAX_LAYERS), ("off_b", MAX_LAYERS),
                ("out_off", MAX_LAYERS))]


@functools.lru_cache(maxsize=64)
def _c_bf16_plan(plan: PersistentPlan, n: int, dims: Tuple[int, ...],
                 transposed: bool, bulk: bool, grid: int) -> _CBf16Plan:
    def ints(values, size=MAX_LAYERS):
        return (ctypes.c_int * size)(*values)
    return _CBf16Plan(
        n=n, num_layers=len(dims) - 1, ksplit=plan.ksplit, kpad=plan.kpad,
        threads=plan.threads, smem_bytes=plan.smem_bytes, grid=grid,
        copy_bulk=int(bulk),
        p_transposed=int(transposed), ps=plan.ps, n8=plan.n8, hs=plan.hs,
        hws=plan.hws, hts=plan.hts, total=sum(dims[1:]),
        stage_vals=plan.stage_vals, off_hw=plan.off_hw, off_h=plan.off_h,
        off_o=plan.off_o,
        dims=ints(dims, MAX_LAYERS + 1), fout_p=ints(plan.fout_p),
        off_w=ints(plan.off_w), off_b=ints(plan.off_b),
        out_off=ints([sum(dims[1:1 + i]) for i in range(len(dims) - 1)]))


class _CBackwardPlan(ctypes.Structure):
    """`BackwardPlan` of csrc/gcn_stack_backward.cu, field for field."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "n", "num_layers", "cluster", "rows", "threads", "smem_bytes", "ps",
        "total", "tot_p", "hmax", "dts", "ats", "das", "p_transposed",
        "copy_bulk", "group", "wsz", "off_dz", "off_at", "off_ht",
        "off_da")] + [
            (name, ctypes.c_int * size) for name, size in (
                ("dims", MAX_LAYERS + 1), ("fout_p", MAX_LAYERS),
                ("off_w", MAX_LAYERS), ("off_b", MAX_LAYERS),
                ("out_off", MAX_LAYERS), ("dz_off", MAX_LAYERS),
                ("h_off", MAX_LAYERS), ("ws_off", MAX_LAYERS),
                ("w_stride", MAX_LAYERS), ("b_stride", MAX_LAYERS))]


@functools.lru_cache(maxsize=64)
def _c_backward_plan(plan: BackwardPlan, n: int, dims: Tuple[int, ...],
                     transposed: bool, bulk: bool, group: int,
                     w_strides: Tuple[int, ...], b_strides: Tuple[int, ...]
                     ) -> _CBackwardPlan:
    def ints(values, size=MAX_LAYERS):
        return (ctypes.c_int * size)(*values)
    return _CBackwardPlan(
        n=n, num_layers=len(dims) - 1, cluster=plan.cluster, rows=plan.rows,
        threads=plan.threads, smem_bytes=plan.smem_bytes, ps=plan.ps,
        total=sum(dims[1:]), tot_p=plan.tot_p, hmax=plan.hmax, dts=plan.dts,
        ats=plan.ats, das=plan.das, p_transposed=int(transposed),
        copy_bulk=int(bulk), group=group, wsz=plan.wsz, off_dz=plan.off_dz,
        off_at=plan.off_at, off_ht=plan.off_ht, off_da=plan.off_da,
        dims=ints(dims, MAX_LAYERS + 1), fout_p=ints(plan.fout_p),
        off_w=ints(plan.off_w), off_b=ints(plan.off_b),
        out_off=ints([sum(dims[1:1 + i]) for i in range(len(dims) - 1)]),
        dz_off=ints(plan.dz_off), h_off=ints(plan.h_off),
        ws_off=ints(plan.ws_off), w_stride=ints(w_strides),
        b_stride=ints(b_strides))


def band_copy(addr: int, own: int, n: int, elem_bytes: int
              ) -> Tuple[int, int, int, int]:
    """How the kernels copy a band of P (`own` columns of N values, one
    block of memory at byte address `addr`: one CTA's band in
    `csrc/gcn_stack.cu`, a whole sample, own = N, in the persistent bf16
    kernel's stage) with the bulk copy: (lead, head, body, tail).
    The band starts `lead` values into shared memory; its first `head`
    bytes, up to a 16-byte boundary, and its last `tail` bytes are plain
    loads; the `body` bytes between them, 16-byte aligned at both ends in
    device and in shared memory, are one bulk copy."""
    nbytes = own * n * elem_bytes
    mis = addr % 16
    head = min((16 - mis) % 16, nbytes)
    body = (nbytes - head) // 16 * 16
    return mis // elem_bytes, head, body, nbytes - head - body


def _bulk_copyable(prop: torch.Tensor, plan: LaunchPlan | BackwardPlan
                   ) -> bool:
    """True when every CTA's band of P is one block of memory that the
    bulk-copy engine takes: P transposed in memory; in fp32, with the
    block's start and length multiples of 16 bytes; in bf16, with the
    block's start 4-byte aligned (`band_copy` splits off the head and
    tail), so that P's value pairs stay 4-byte aligned in shared memory."""
    b, n, _ = prop.shape
    if plan.elem_bytes == 2:
        return (plan.ps == n and prop.data_ptr() % 4 == 0
                and (b == 1 or prop.stride(0) % 2 == 0))
    if plan.ps != n or prop.data_ptr() % 16 or (b > 1 and prop.stride(0) % 4):
        return False
    owns = [min(n, (k + 1) * plan.rows) - k * plan.rows
            for k in range(plan.cluster)]
    return all(own * n % 4 == 0 and k * plan.rows * n % 4 == 0
               for k, own in enumerate(owns))


# the streamed product's epilogues (`Product.epi`) and operand types
EPI_STORE, EPI_RELU, EPI_DA, EPI_GRAD_MASK = range(4)
F32, BF16 = 0, 1


class _CProduct(ctypes.Structure):
    """`Product` of csrc/gcn_stack_streamed.cu, field for field: one
    launch of the streamed form's tiled product, C(s, i, j) = sum_k
    A(s, i, k) B(s, k, j) for i < m, j < n, k < k, then its epilogue.
    Operand X's element (s, i, j) is X + (s // x_div) * x_bs + i * x_s0 +
    j * x_s1 values in (`x_type`: F32 or BF16); rows of A from `a_rows` on
    read 0, except the row `a_rows` itself, which reads 1 where `ones` (so
    that row of C sums B's rows). Epilogues on each C(s, i, j) = v:
    EPI_STORE c = v; EPI_RELU z = v + bias(s, j), c = relu(z), where `d`
    is set d(s, i, j) = g(s, i, j) * [z > 0], and where `w2` is set
    c2(s, i, :) = relu(z)(s, i, :) W2(s) over the n columns in order
    (W2: n x n2, rows contiguous; one tile covers the n columns); EPI_DA
    c = v for i < a_rows, d(s, j) = v in the ones row; EPI_GRAD_MASK c =
    (g(s, i, j) + v) * [mask(s, i, j) > 0]. c's element is c + s * c_bs +
    i * c_s0 + j * c_s1; d's, g's, mask's and c2's the same with a column
    stride of 1 (and bias(s, j) = bias + (s // bias_div) * bias_bs + j).
    The launch: `tile` (STREAM_TILES) and `ksplit` from `choose_tile`,
    each operand staged along K where `a_k` / `b_k` (`staged_along_k`) in
    copies of `a_vec` / `b_vec` / `w2_vec` floats (`copy_vec`)."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "a", "b", "bias", "w2", "g", "mask", "c", "d", "c2")]
        + [(name, ctypes.c_longlong) for name in (
            "a_bs", "a_s0", "a_s1", "b_bs", "b_s0", "b_s1", "bias_bs",
            "w2_bs", "g_bs", "g_s0", "mask_bs", "mask_s0", "c_bs", "c_s0",
            "c_s1", "d_bs", "d_s0", "c2_bs", "c2_s0")]
        + [(name, ctypes.c_int) for name in (
            "m", "n", "k", "a_rows", "ones", "epi", "n2", "a_div", "b_div",
            "bias_div", "w2_div", "a_type", "b_type", "bias_type", "w2_type",
            "tile", "ksplit", "a_k", "b_k", "a_vec", "b_vec", "w2_vec")])


def _product(batch: int, m: int, n: int, k: int, **fields) -> _CProduct:
    """A `_CProduct` over `batch` samples with A's rows `a_rows` = m and
    every divisor 1 unless `fields` says otherwise, its tile, K split,
    staging and copy widths chosen from its shape, strides and addresses."""
    fields.setdefault("a_rows", m)
    for div in ("a_div", "b_div", "bias_div", "w2_div"):
        fields.setdefault(div, 1)
    tile, ksplit = choose_tile(m, n, batch)
    a_k = staged_along_k(fields["a_s0"], fields["a_s1"], m, k)
    b_k = staged_along_k(fields["b_s1"], fields["b_s0"], n, k)

    def vec(x, s_r, s_k, along_k):
        contiguous, other = (s_k, s_r) if along_k else (s_r, s_k)
        return copy_vec(fields[x], 2 if fields.get(f"{x}_type") == BF16
                        else 4, contiguous, other, fields.get(f"{x}_bs", 0))
    fields.update(
        tile=tile, ksplit=ksplit, a_k=int(a_k), b_k=int(b_k),
        a_vec=vec("a", fields["a_s0"], fields["a_s1"], a_k),
        b_vec=vec("b", fields["b_s1"], fields["b_s0"], b_k))
    if fields.get("w2"):
        fields["w2_vec"] = vec("w2", 1, fields["n2"], False)
    return _CProduct(m=m, n=n, k=k, **fields)


def launch_blocks(p: _CProduct, batch: int) -> int:
    """CTAs of one launch of the streamed product over `batch` samples (the
    kernel's `product_blocks`)."""
    bm, bn = STREAM_TILES[p.tile]
    return -(-p.m // bm) * -(-p.n // bn) * batch


def _elem(t: torch.Tensor) -> int:
    return BF16 if t.dtype == torch.bfloat16 else F32


def _at(t: torch.Tensor, offset: int = 0) -> int:
    """The address of `t`'s element `offset` (in its own values)."""
    return t.data_ptr() + offset * t.element_size()


def _layer_products(prop, x, weights, biases, out, acts, group: int,
                    grad_out=None, dz=None) -> List[_CProduct]:
    """The streamed forward's launches: a_0 = x W_0 into `acts` (B, N x
    sum H), then per layer relu(P a_l + b_l) into layer l's slice of the
    JK output `out` (B, N, sum H, fp32), which is h_{l+1}; its epilogue
    also writes a_{l+1} = h_{l+1} W_{l+1} into `acts` where
    `streamed_fuses` says so, else a_{l+1} is a launch of its own. With
    `grad_out` and `dz` (the backward's recompute) the last layer's
    epilogue also writes dz_{L-1} = g_{L-1} * [z > 0] into `dz`."""
    b, n, _ = prop.shape
    dims = [int(x.shape[2])] + [int(w.shape[-1]) for w in weights]
    total, layers = sum(dims[1:]), len(weights)
    offs = [sum(dims[1:1 + i]) for i in range(layers)]
    grouped = _weight_sets(weights) > 0
    fused = [streamed_fuses(dims[l + 1], dims[l + 2])
             for l in range(layers - 1)] + [False]
    jk = dict(c_bs=n * total, c_s0=total, c_s1=1)

    def weight(w):
        return dict(bs=w.stride(0) if grouped else 0, div=group,
                    type=_elem(w))
    steps = []
    for l, (w, bias) in enumerate(zip(weights, biases)):
        fin, h, off = dims[l], dims[l + 1], offs[l]
        if l == 0 or not fused[l - 1]:
            h_in = (dict(a=_at(x), a_bs=n * fin, a_s0=fin, a_s1=1,
                         a_type=_elem(x)) if l == 0 else
                    dict(a=_at(out, offs[l - 1]), a_bs=n * total, a_s0=total,
                         a_s1=1, a_type=F32))
            wl = weight(w)
            steps.append(_product(
                b, n, h, fin, **h_in, b=_at(w), b_bs=wl["bs"], b_s0=h,
                b_s1=1, b_div=wl["div"], b_type=wl["type"], c=_at(acts, off),
                **jk, epi=EPI_STORE))
        extra = {}
        if fused[l]:
            wn = weight(weights[l + 1])
            extra.update(w2=_at(weights[l + 1]), w2_bs=wn["bs"],
                         w2_div=wn["div"], w2_type=wn["type"],
                         n2=dims[l + 2], c2=_at(acts, offs[l + 1]),
                         c2_bs=n * total, c2_s0=total)
        if l == layers - 1 and dz is not None:
            extra.update(d=_at(dz, off), d_bs=n * total, d_s0=total,
                         g=_at(grad_out, off), g_bs=n * total, g_s0=total)
        steps.append(_product(
            b, n, h, n, a=_at(prop), a_bs=prop.stride(0), a_s0=prop.stride(1),
            a_s1=prop.stride(2), a_type=_elem(prop),
            b=_at(acts, off), b_bs=n * total, b_s0=total, b_s1=1, b_type=F32,
            bias=_at(bias), bias_bs=bias.stride(0) if grouped else 0,
            bias_div=group, bias_type=_elem(bias), c=_at(out, off), **jk,
            epi=EPI_RELU, **extra))
    return steps


def _backward_products(prop, x, weights, biases, grad_out, needs, plan,
                       scratch, dprop, dx, ws, group: int
                       ) -> List[_CProduct]:
    """The streamed backward's launches: the recompute (`_layer_products`
    into `scratch["h"]`, keeping every a_l in `scratch["a"]` and forming
    dz_{L-1}), then for l = L-1 .. 0: da_l = P^T dz_l into `scratch["da"]`
    with db_l in the ones row (where the weights need it); dW_l = h_l^T
    da_l into sample s's slot of `ws`; e_l = da_l W_l^T, whose epilogue
    forms dz_{l-1} = (g_{l-1} + e_l) * [h_l > 0] (dx = e_0 where wanted);
    then dP = [dz_0 .. dz_{L-1}] [a_0 .. a_{L-1}]^T, one product of depth
    sum H, written in P's layout."""
    need_p, need_x, need_w = needs
    b, n, _ = prop.shape
    dims = [int(x.shape[2])] + [int(w.shape[-1]) for w in weights]
    total, hmax = sum(dims[1:]), max(dims[1:])
    offs = [sum(dims[1:1 + i]) for i in range(len(weights))]
    grouped = _weight_sets(weights) > 0
    hb, acts, dz, da = (scratch[k] for k in ("h", "a", "dz", "da"))
    steps = _layer_products(prop, x, weights, biases, hb, acts, group,
                            grad_out, dz)
    jk = dict(c_bs=n * total, c_s0=total, c_s1=1)
    for l in reversed(range(len(weights))):
        if not (need_w or need_x or l > 0):
            continue
        w, fin, h, off = weights[l], dims[l], dims[l + 1], offs[l]
        steps.append(_product(
            b, n + int(need_w), h, n, a_rows=n, ones=int(need_w),
            a=_at(prop), a_bs=prop.stride(0), a_s0=prop.stride(2),
            a_s1=prop.stride(1), b=_at(dz, off), b_bs=n * total, b_s0=total,
            b_s1=1, c=_at(da), c_bs=n * hmax, c_s0=hmax, c_s1=1, epi=EPI_DA,
            **(dict(d=_at(ws, plan.ws_off[l] + fin * h), d_bs=plan.wsz)
               if need_w else {})))
        if need_w:
            h_l = (dict(a=_at(x), a_bs=n * fin, a_s0=1, a_s1=fin) if l == 0
                   else dict(a=_at(hb, offs[l - 1]), a_bs=n * total, a_s0=1,
                             a_s1=total))
            steps.append(_product(
                b, fin, h, n, **h_l, b=_at(da), b_bs=n * hmax, b_s0=hmax,
                b_s1=1, c=_at(ws, plan.ws_off[l]), c_bs=plan.wsz, c_s0=h,
                c_s1=1, epi=EPI_STORE))
        e_l = dict(a=_at(da), a_bs=n * hmax, a_s0=hmax, a_s1=1, b=_at(w),
                   b_bs=w.stride(0) if grouped else 0, b_div=group, b_s0=1,
                   b_s1=h)
        if l > 0:
            prev = offs[l - 1]
            steps.append(_product(
                b, n, fin, h, **e_l, c=_at(dz, prev), **jk,
                g=_at(grad_out, prev), g_bs=n * total, g_s0=total,
                mask=_at(hb, prev), mask_bs=n * total, mask_s0=total,
                epi=EPI_GRAD_MASK))
        elif need_x:
            steps.append(_product(b, n, fin, h, **e_l, c=_at(dx), c_bs=n * fin,
                                  c_s0=fin, c_s1=1, epi=EPI_STORE))
    if need_p:
        transposed = _prop_transposed(prop)
        steps.append(_product(
            b, n, n, total, a=_at(dz), a_bs=n * total, a_s0=total, a_s1=1,
            b=_at(acts), b_bs=n * total, b_s0=1, b_s1=total,
            c=_at(dprop), c_bs=n * n, c_s0=1 if transposed else n,
            c_s1=n if transposed else 1, epi=EPI_STORE))
    return steps


_lib: ctypes.CDLL | None = None
_bf16_lib: ctypes.CDLL | None = None
_backward_lib: ctypes.CDLL | None = None
_streamed_lib: ctypes.CDLL | None = None


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


def declare_bf16(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`declare` for the persistent bf16 kernel's library."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gcn_stack_bf16_forward.argtypes = [
        ctypes.POINTER(_CBf16Plan), ptr, i64, ptr, ctypes.POINTER(ptr),
        ctypes.POINTER(ptr), ptr, i64, i32, ptr]
    lib.gcn_stack_bf16_forward.restype = i32
    lib.gcn_stack_bf16_error_string.argtypes = [i32]
    lib.gcn_stack_bf16_error_string.restype = ctypes.c_char_p
    return lib


def declare_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`declare` for the backward kernel's library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gcn_stack_backward.argtypes = [
        ctypes.POINTER(_CBackwardPlan), ptr, ctypes.c_longlong, ptr,
        ctypes.POINTER(ptr), ctypes.POINTER(ptr), ptr, ptr, ptr, ptr, ptr,
        i32, i32, ptr]
    lib.gcn_stack_backward.restype = i32
    lib.gcn_stack_backward_error_string.argtypes = [i32]
    lib.gcn_stack_backward_error_string.restype = ctypes.c_char_p
    return lib


def declare_streamed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`declare` for the streamed form's library."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gcn_stack_streamed.argtypes = [
        ctypes.POINTER(_CProduct), i32, i32, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.gcn_stack_streamed.restype = i32
    lib.gcn_stack_streamed_error_string.argtypes = [i32]
    lib.gcn_stack_streamed_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use."""
    global _lib
    if _lib is None:
        _lib = declare(load_library(SOURCE))
    return _lib


def _bf16_library() -> ctypes.CDLL:
    """The persistent bf16 kernel's library, built at first use."""
    global _bf16_lib
    if _bf16_lib is None:
        _bf16_lib = declare_bf16(load_library(BF16_SOURCE))
    return _bf16_lib


def _backward_library() -> ctypes.CDLL:
    """The backward kernel's library, built at first use."""
    global _backward_lib
    if _backward_lib is None:
        _backward_lib = declare_backward(load_library(BACKWARD_SOURCE))
    return _backward_lib


def _streamed_library() -> ctypes.CDLL:
    """The streamed form's library, built at first use."""
    global _streamed_lib
    if _streamed_lib is None:
        _streamed_lib = declare_streamed(load_library(STREAMED_SOURCE))
    return _streamed_lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _weight_sets(weights) -> int:
    """The number of weight sets G of the grouped form (weights
    (G, F_l, H_l)); 0 for shared weights (F_l, H_l)."""
    return int(weights[0].shape[0]) if weights[0].dim() == 3 else 0


def _check_inputs(prop, x, weights, biases) -> Tuple[List[int], bool]:
    """Raise on anything the kernel does not take; return the layer widths
    (F0, H_1, ..., H_L) and whether P is transposed in memory. Weights are
    shared, (F_l, H_l) and (H_l,), or grouped: every weight (G, F_l, H_l)
    and every bias (G, H_l), each set contiguous, any stride between sets
    (0 included), and G dividing B. Every input is float32, or every one
    bfloat16 with shared weights."""
    if prop.dim() != 3 or prop.shape[1] != prop.shape[2]:
        raise ValueError(f"prop must be (B, N, N); got {tuple(prop.shape)}")
    b, n, _ = prop.shape
    if x.dim() != 3 or x.shape[:2] != (b, n):
        raise ValueError(f"x must be (B, N, F0) = ({b}, {n}, F0); got "
                         f"{tuple(x.shape)}")
    if not weights or len(biases) != len(weights):
        raise ValueError(f"need at least one layer with one bias each; got "
                         f"{len(weights)} weights, {len(biases)} biases")
    groups = _weight_sets(weights)
    lead = (groups,) if groups else ()
    if groups and b % groups:
        raise ValueError(f"{b} samples do not split into {groups} weight "
                         "sets")
    dims = [int(x.shape[2])]
    for i, (w, bb) in enumerate(zip(weights, biases)):
        if (w.dim() != 2 + len(lead) or tuple(w.shape[:-2]) != lead
                or w.shape[-2] != dims[-1]
                or tuple(bb.shape) != lead + (w.shape[-1],)):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} / bias "
                             f"{tuple(bb.shape)} do not chain from width "
                             f"{dims[-1]}" + (f" in {groups} sets" if groups
                                              else ""))
        dims.append(int(w.shape[-1]))
    if prop.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"prop must be float32 or bfloat16; got {prop.dtype}")
    if prop.dtype == torch.bfloat16 and groups:
        raise ValueError("the grouped form takes float32 only (training is "
                         "fp32; bf16 is for serving)")
    for name, t in [("prop", prop), ("x", x), *(("weight", w) for w in weights),
                    *(("bias", bb) for bb in biases)]:
        if t.device != prop.device:
            raise ValueError(f"{name} is on {t.device}, prop on {prop.device}")
        if t.dtype != prop.dtype:
            raise ValueError(f"{name} must be {prop.dtype} like prop; got "
                             f"{t.dtype}")
        one_set = t[0] if groups and name in ("weight", "bias") else t
        if name != "prop" and not one_set.is_contiguous():
            raise ValueError(f"{name} must be contiguous" + (
                " within each weight set" if one_set is not t else ""))
    return dims, _prop_transposed(prop)


def _launch(prop, x, weights, biases) -> torch.Tensor:
    """Run the CUDA kernel on PyTorch's current stream; no synchronisation."""
    dims, transposed = _check_inputs(prop, x, weights, biases)
    groups = _weight_sets(weights)
    b, n, _ = prop.shape
    index = (prop.device.index if prop.device.index is not None
             else torch.cuda.current_device())
    bf16 = prop.dtype == torch.bfloat16
    plan = plan_launch(b, n, tuple(dims), 2 if bf16 else 4, _sm_count(index))
    out = torch.empty((b, n, sum(dims[1:])), device=prop.device,
                      dtype=torch.float32)
    if b == 0:
        return out
    if isinstance(plan, PersistentPlan):
        _launch_persistent(plan, prop, x, weights, biases, out, dims,
                           transposed, index)
        fused_gcn_stack.launches_bf16 += 1
        return out
    if isinstance(plan, StreamedPlan):
        acts = _scratch((b, plan.a_floats), prop.device)
        _run_streamed(_layer_products(prop, x, weights, biases, out, acts,
                                      b // (groups or 1)), prop, index)
        return out
    layers = len(weights)
    # shared weights: one set, strides 0, so one code path takes both forms
    w_strides = tuple(w.stride(0) if groups else 0 for w in weights)
    b_strides = tuple(bb.stride(0) if groups else 0 for bb in biases)
    c_plan = _c_plan(plan, n, tuple(dims), transposed,
                     transposed and _bulk_copyable(prop, plan),
                     b // groups if groups else b,
                     w_strides + (0,) * (MAX_LAYERS - layers),
                     b_strides + (0,) * (MAX_LAYERS - layers))
    lib = _library()
    code = lib.gcn_stack_forward(
        ctypes.byref(c_plan), prop.data_ptr(), prop.stride(0), x.data_ptr(),
        (ctypes.c_void_p * layers)(*(w.data_ptr() for w in weights)),
        (ctypes.c_void_p * layers)(*(bb.data_ptr() for bb in biases)),
        out.data_ptr(), b, index,
        torch.cuda.current_stream(prop.device).cuda_stream)
    if code != 0:
        raise RuntimeError("gcn_stack kernel launch failed: "
                           + lib.gcn_stack_error_string(code).decode())
    if bf16:
        fused_gcn_stack.launches_bf16 += 1
    else:
        fused_gcn_stack.launches += 1
    return out


def _scratch(shape, device) -> torch.Tensor:
    """Scratch of the streamed form, uninitialised: the schedule writes
    every value it reads."""
    return torch.empty(shape, device=device, dtype=torch.float32)


def _run_streamed(steps: List[_CProduct], prop, index: int, ws=None,
                  wgrad=None, slots: int = 0) -> None:
    """Launch the streamed form's products in order on PyTorch's current
    stream, then (with `ws`) the per-set sum of the samples' dW / db slots
    into `wgrad` (sets x wsz), `slots` samples to a set; no
    synchronisation. Counts one launch of the streamed form."""
    lib = _streamed_library()
    sets, wsz = wgrad.shape if wgrad is not None else (0, 0)
    code = lib.gcn_stack_streamed(
        (_CProduct * len(steps))(*steps), len(steps), prop.shape[0],
        None if ws is None else ws.data_ptr(),
        None if wgrad is None else wgrad.data_ptr(), slots, wsz, sets, index,
        torch.cuda.current_stream(prop.device).cuda_stream)
    if code != 0:
        raise RuntimeError("gcn_stack streamed kernel launch failed: "
                           + lib.gcn_stack_streamed_error_string(code).decode())
    fused_gcn_stack.launches_streamed += 1


def _launch_persistent(plan: PersistentPlan, prop, x, weights, biases, out,
                       dims, transposed: bool, index: int) -> None:
    """The persistent bf16 kernel on PyTorch's current stream. Samples come
    by bulk copies where P is transposed and its value pairs are
    4-byte aligned (`_bulk_copyable`), else value by value."""
    b, n, _ = prop.shape
    bulk = transposed and _bulk_copyable(prop, plan)
    c_plan = _c_bf16_plan(plan, n, tuple(dims), transposed, bulk,
                          plan.grid(b))
    lib = _bf16_library()
    layers = len(weights)
    code = lib.gcn_stack_bf16_forward(
        ctypes.byref(c_plan), prop.data_ptr(), prop.stride(0), x.data_ptr(),
        (ctypes.c_void_p * layers)(*(w.data_ptr() for w in weights)),
        (ctypes.c_void_p * layers)(*(bb.data_ptr() for bb in biases)),
        out.data_ptr(), b, index,
        torch.cuda.current_stream(prop.device).cuda_stream)
    if code != 0:
        raise RuntimeError("gcn_stack bf16 kernel launch failed: "
                           + lib.gcn_stack_bf16_error_string(code).decode())


def _launch_backward(prop, x, weights, biases, grad_out,
                     needs: Tuple[bool, bool, bool]):
    """The backward kernel (and its per-set sum of dW, db) on PyTorch's
    current stream, no synchronisation: (dprop, dx, dweights, dbiases),
    each None where `needs` (prop, x, weights and biases) says no. dprop
    comes in P's layout."""
    dims, transposed = _check_inputs(prop, x, weights, biases)
    if prop.dtype != torch.float32:
        raise ValueError("the backward kernel takes float32; the bf16 form "
                         "serves only")
    b, n, _ = prop.shape
    if (tuple(grad_out.shape) != (b, n, sum(dims[1:]))
            or grad_out.dtype != torch.float32
            or grad_out.device != prop.device):
        raise ValueError(f"grad_out must be float32 ({b}, {n}, "
                         f"{sum(dims[1:])}) on {prop.device}; got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device}")
    need_p, need_x, need_w = needs
    plan = plan_backward(b, n, tuple(dims))
    groups = _weight_sets(weights)
    sets = groups or 1
    g = grad_out.contiguous()

    def empty(*shape):
        return _scratch(shape, prop.device)

    streamed = isinstance(plan, StreamedPlan)
    dprop = empty(b, n, n) if need_p else None
    dx = torch.empty_like(x) if need_x else None
    # a slot of dW / db per CTA of the resident kernel, per sample streamed
    slots = 1 if streamed else plan.cluster
    ws = empty(b * slots * plan.wsz) if need_w else None
    wgrad = empty(sets, plan.wsz) if need_w else None
    index = (prop.device.index if prop.device.index is not None
             else torch.cuda.current_device()) if b > 0 else 0
    if b > 0 and streamed:
        scratch = {k: empty(b, size) for k, size in (
            ("h", plan.h_floats), ("a", plan.a_floats),
            ("dz", plan.dz_floats), ("da", plan.da_floats))}
        _run_streamed(_backward_products(prop, x, weights, biases, g, needs,
                                         plan, scratch, dprop, dx, ws,
                                         b // sets),
                      prop, index, ws, wgrad, b // sets)
    elif b > 0:
        layers = len(weights)
        w_strides = tuple(w.stride(0) if groups else 0 for w in weights)
        b_strides = tuple(bb.stride(0) if groups else 0 for bb in biases)
        c_plan = _c_backward_plan(
            plan, n, tuple(dims), transposed,
            transposed and _bulk_copyable(prop, plan),
            b // sets, w_strides + (0,) * (MAX_LAYERS - layers),
            b_strides + (0,) * (MAX_LAYERS - layers))
        lib = _backward_library()

        def ptr(t):
            return None if t is None else t.data_ptr()

        code = lib.gcn_stack_backward(
            ctypes.byref(c_plan), prop.data_ptr(), prop.stride(0),
            x.data_ptr(),
            (ctypes.c_void_p * layers)(*(w.data_ptr() for w in weights)),
            (ctypes.c_void_p * layers)(*(bb.data_ptr() for bb in biases)),
            g.data_ptr(), ptr(dprop), ptr(dx), ptr(ws), ptr(wgrad), b, index,
            torch.cuda.current_stream(prop.device).cuda_stream)
        if code != 0:
            raise RuntimeError(
                "gcn_stack backward kernel launch failed: "
                + lib.gcn_stack_backward_error_string(code).decode())
        fused_gcn_stack.launches_backward += 1
    elif need_w:
        wgrad.zero_()
    if need_p and transposed:
        dprop = dprop.transpose(1, 2)     # memory [s, j, i] holds dP[i, j]
    if not need_w:
        return dprop, dx, None, None
    dweights, dbiases = [], []
    for off, fin, fout in zip(plan.ws_off, dims[:-1], dims[1:]):
        dw = wgrad[:, off:off + fin * fout].view(sets, fin, fout)
        db = wgrad[:, off + fin * fout:off + fin * fout + fout]
        dweights.append(dw if groups else dw[0])
        dbiases.append(db if groups else db[0])
    return dprop, dx, dweights, dbiases


def _plain(prop, x, weights, biases) -> torch.Tensor:
    """The plain version of either form: grouped when the weights are 3-D;
    bf16 inputs upcast to fp32 first, as the bf16 form computes."""
    if prop.dtype == torch.bfloat16:
        prop, x = prop.float(), x.float()
        weights = [w.float() for w in weights]
        biases = [bb.float() for bb in biases]
    if _weight_sets(weights):
        return gcn_stack_reference_grouped(prop, x, weights, biases)
    return gcn_stack_reference(prop, x, weights, biases)


def _to_front(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """`t` with its vmapped dim first; an operand without one is broadcast
    over the `size` folds with a stride of 0 (a view, nothing copied)."""
    if dim is None:
        return t.expand(size, *t.shape)
    return t.movedim(dim, 0)


class _GcnStack(torch.autograd.Function):
    """Forward: the kernel on CUDA (resident or streamed, as the plan
    says), the plain version on the CPU; weights
    (F_l, H_l) shared by every sample, or the grouped form (G, F_l, H_l).
    Backward, from the saved inputs (a recompute, as the JAX VJP): the
    backward kernel on CUDA, for either form; on the CPU autograd of the
    plain version. Once differentiable: the port never differentiates it
    twice. Under `torch.func.vmap` the `vmap` rule below runs the grouped
    form once for every fold."""

    @staticmethod
    def forward(prop, x, num_layers, *params):
        weights, biases = params[:num_layers], params[num_layers:]
        if prop.device.type == "cuda":
            return _launch(prop, x, weights, biases)
        if prop.device.type == "cpu":
            return _plain(prop, x, weights, biases)
        raise ValueError(f"fused_gcn_stack runs on cuda or cpu tensors, not "
                         f"{prop.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        prop, x, num_layers, *params = inputs
        ctx.num_layers = num_layers
        ctx.save_for_backward(prop, x, *params)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:2] + ctx.needs_input_grad[3:]
        nl = ctx.num_layers
        if ctx.saved_tensors[0].device.type == "cuda":
            prop, x, *params = ctx.saved_tensors
            dprop, dx, dws, dbs = _launch_backward(
                prop, x, params[:nl], params[nl:], grad_out,
                (needs[0], needs[1], any(needs[2:])))
            grads = [*(dws or [None] * nl), *(dbs or [None] * nl)]
            return (dprop, dx, None,
                    *(d if need else None for d, need in zip(grads,
                                                             needs[2:])))
        saved = [t.detach().requires_grad_(need) for t, need in
                 zip(ctx.saved_tensors, needs)]
        prop, x, *params = saved
        with torch.enable_grad():
            out = _plain(prop, x, params[:nl], params[nl:])
            wanted = [t for t in saved if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        full = [next(grads) if t.requires_grad else None for t in saved]
        return (full[0], full[1], None, *full[2:])

    @staticmethod
    def vmap(info, in_dims, prop, x, num_layers, *params):
        """F folds of B samples each as one grouped call: the fold and
        sample axes merged (P stays a view in its layout where the merge
        allows, else it is copied row-major, a layout the kernel takes),
        every weight and bias with the fold axis first, then the output
        split back into (F, B, N, sum H)."""
        f = info.batch_size
        prop_f = _to_front(prop, in_dims[0], f)
        x_f = _to_front(x, in_dims[1], f)
        b, n = prop_f.shape[1], prop_f.shape[2]
        merged_prop = prop_f.reshape(f * b, n, n)
        merged_x = x_f.reshape(f * b, n, x_f.shape[-1]).contiguous()
        grouped = [_to_front(t, d, f)
                   for t, d in zip(params, in_dims[3:])]
        out = _GcnStack.apply(merged_prop, merged_x, num_layers, *grouped)
        return out.reshape(f, b, n, out.shape[-1]), 0


def fused_gcn_stack(prop: torch.Tensor, x: torch.Tensor,
                    weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fused L-layer GCN stack with JK-concat output.

    prop: (B, N, N) propagation matrix, row-major or in the transposed
    layout `gcn_propagation_matrix` returns; x: (B, N, F0);
    weights[l]: (F_l, H_l) in the JAX layout; biases[l]: (H_l,). Returns
    (B, N, sum H_l). The grouped form takes weights[l] (G, F_l, H_l) and
    biases[l] (G, H_l), sample s reading set s // (B / G); `torch.func.vmap`
    of this function over a fold axis calls it once for all folds.
    bf16 P, x, weights and biases run the bf16-operand form (shared weights
    only, no backward) and give a float32 output.
    `fused_gcn_stack.launches` counts kernel launches of the fp32 forms,
    `fused_gcn_stack.launches_bf16` those of the bf16 form and
    `fused_gcn_stack.launches_backward` those of the backward kernel (one
    per backward call on CUDA tensors), each where the shape is held
    resident; `fused_gcn_stack.launches_streamed` counts the calls, forward
    or backward and of any form, that run the streamed form instead.
    """
    if prop.dtype == torch.bfloat16:
        # the CPU path checks what the kernel's wrapper checks on CUDA
        if any(t.dtype != torch.bfloat16 for t in (x, *weights, *biases)):
            raise ValueError("bf16 prop needs bf16 x, weights and biases")
        if _weight_sets(weights):
            raise ValueError("the grouped form takes float32 only (training "
                             "is fp32; bf16 is for serving)")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (prop, x, *weights, *biases)):
            raise ValueError("the bf16 form of fused_gcn_stack serves only "
                             "and has no backward; call it under "
                             "torch.no_grad() or torch.inference_mode()")
    return _GcnStack.apply(prop, x, len(weights), *weights, *biases)


fused_gcn_stack.launches = 0
fused_gcn_stack.launches_bf16 = 0
fused_gcn_stack.launches_backward = 0
fused_gcn_stack.launches_streamed = 0
