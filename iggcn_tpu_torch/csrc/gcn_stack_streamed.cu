// Streamed form of the fused L-layer dense GCN stack and of its backward,
// for sm_90a: every shape the resident kernels (gcn_stack.cu,
// gcn_stack_bf16.cu, gcn_stack_backward.cu) cannot hold in shared memory.
//
// Replaces, for those shapes, the TPU kernel _stack_kernel
// (iggcn_tpu/ops/pallas_gcn.py:43), launched by _gcn_stack_pallas (:61,
// pallas_call at :83), in its fp32, grouped and bf16-operand forms, and the
// backward of its custom VJP (_bwd, :116-119: jax.vjp of the jnp reference,
// the forward recomputed from the saved inputs). Per sample:
//   forward: h_0 = x; a_l = h_l W_l; h_{l+1} = relu(P a_l + b_l); the JK
//   concat of h_1 .. h_L is the output
//   backward, with g the output's gradient: the recompute, then for
//   l = L-1 .. 0: dz_l = (g_l + e_{l+1}) * [h_{l+1} > 0]; da_l = P^T dz_l;
//   db_l = sum over rows of dz_l; dW_l = h_l^T da_l; e_l = da_l W_l^T;
//   dx = e_0; dP = sum_l dz_l a_l^T.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores;
// each input read once, each output written once; chip_smoke.py counts
// them): at the flagship's widest training shape, B=32 N=90 F0=3 (128,
// 128, 128), the forward's 392 MFLOP take 5.9 us and its 5.6 MB 1.7 us:
// the operations bound it; the zoo's GCN at N=620, B=32 F0=3 (32, 32,
// 32), 2.45 GFLOP take 36.6 us against 57 MB in 17 us. The backward does
// three times the forward's products: 1.18 and 7.35 GFLOP, 17.6 and 110
// us. At the zoo's narrower grid widths (16, 10) the bytes bound it.
//
// Design, against that bound:
// - One batched tiled product, C = A B per sample, with every operand
//   addressed by its own strides: P in either layout (as
//   gcn_propagation_matrix returns it, or row-major) and P^T are the same
//   operand with its strides swapped; the grouped form's weights are set
//   s / group at a stride (0 for shared weights).
// - Tiles sized to the product: the plan (ops/gcn_stack.py:choose_tile)
//   picks one of four compiled BM x BN tiles (kTileM, kTileN): BN the
//   smallest of 16, 32, 64, 128 that covers C's width (64 above 128), so
//   that at the layer widths the search grids give (10, 16, 32, 128) at
//   most 3/8 of a tile's columns idle (64 x 64 left up to 84 % idle), and
//   BM the narrowest that gives four warps (32; 64 at BN = 16), for the
//   most CTAs. Each thread holds a 4 x 4 register tile of fp32 FMAs on the
//   CUDA cores (no TF32, no tensor cores). A CTA is one tile of one sample
//   (a 1-D grid: tile rows fastest, then tile columns, then samples).
//   `ksplit` groups of warps split each chunk of K where a CTA would have
//   fewer than four warps or the batch fewer than two CTAs per SM.
// - K streams through a ring of 3 stages of 32 in shared memory, each
//   operand staged along its own contiguous dimension (A as [k][m] or
//   [m][k], B as [k][n] or [n][k]; template flags AK, BK) by cp.async of
//   16 bytes (.cg) where the contiguous stride is 1 and base, strides and
//   batch stride are 16-byte aligned, 8 bytes where they are 8-byte
//   aligned, 4 otherwise (`a_vec`, `b_vec`, chosen in Python from the
//   addresses). Edges are zero-filled through cp.async's src-size, so the
//   main loop needs no masks; bf16 values and the ones row are written by
//   plain loads and stores. Register tiles read the stage as float4 along
//   the staged dimension; where that is K, a thread's rows (columns) are
//   BM/4 (BN/4) apart so that one warp's reads fall on distinct banks.
//   K is summed in order within a group.
// - Epilogues: each K group's sums go through shared memory, where the
//   groups' sums are added in group order and all threads take C's
//   elements in turn along C's contiguous dimension (coalesced stores).
//   The forward's relu(z + b) is written straight into layer l's slice of
//   the JK output, where the next layer reads h_{l+1} in place; where the
//   tile covers the layer's width and W_{l+1} fits beside the ring (`w2`),
//   the same epilogue stages h_{l+1}'s rows in shared memory and computes
//   a_{l+1} = h_{l+1} W_{l+1} for them (summed over H_{l+1} in order), so a
//   forward is L + 1 launches (x W_0, then one per layer) instead of 2L.
//   The backward's da with db in an extra row of ones in P^T (one more row
//   of C), dz formed in the epilogue of e_{l+1} (or of the recompute's last
//   z) from g and the relu mask of h_{l+1} (= [z_l > 0]).
// - Launches: the backward's recompute as the forward, then up to 3L + 1
//   (da, dW, e per layer; dP over the concatenated dz and a, depth sum H,
//   written in P's layout) and one per-set sum of the dW / db slots.
// - dW_l and db_l go to one slot per sample, summed per weight set in a
//   fixed order by sum_streamed_slots (gcn_stack_backward.cu's
//   sum_weight_slots, copied: tools/gcn_stack_phases.py builds that
//   source from copies, so it includes no header). No atomics: a result
//   is bit-equal to its repeat.
//
// What it costs against the resident design: nothing stays on chip across
// layers. P is read from device memory (or L2) once a layer in the forward
// and twice a layer in the backward, a_l and h_l go through device memory,
// and every step is a launch of its own.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/gcn_stack_phases.py
// --streamed-turns, warm, B=32): the N=620 3 x 32 forward 0.153 ms (4.2x
// its bound), backward 0.538 ms (4.9x); the flagship's 3 x 128 at N=90
// 0.053 and 0.179 ms (9.0x, 10.2x). The P-products' main loops run at
// 31-36 FMA per SM clock at N=620 (a quarter of the CUDA cores' rate);
// neither deeper rings nor chunks of 64 read faster, and taking K in
// reverse on every other P-product (to find P in L2) changed nothing, so
// they wait on the copies' latency rather than on device memory.
//
// The launches are listed in Python (ops/gcn_stack.py:_layer_products,
// _backward_products) as Product records, one per launch. C interface
// (bound with ctypes): gcn_stack_streamed launches them in order on the
// caller's stream, never synchronises, allocates nothing (scratch and
// outputs come from the caller), and returns the cudaError_t (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kChunk = 32;      // K per stage
constexpr int kStages = 3;
constexpr int kPad = 4;         // floats after each staged row
constexpr int kMaxThreads = 512;
constexpr int kTiles = 4;       // compiled tiles, BM x BN
constexpr int kTileM[kTiles] = {64, 32, 32, 32};
constexpr int kTileN[kTiles] = {16, 32, 64, 128};
constexpr int kReduceThreads = 256;
// every launch's dynamic shared memory stays under this (the plan keeps it)
constexpr int kMaxSmemBytes = 227 * 1024;

enum Epilogue { kStore = 0, kRelu = 1, kDa = 2, kGradMask = 3 };
enum Elem { kF32 = 0, kBf16 = 1 };

// Field for field the ctypes structure _CProduct in ops/gcn_stack.py.
// Operand X's element (s, i, j) is X + (s / x_div) * x_bs + i * x_s0 +
// j * x_s1, in values of its type (x_type); c's is c + s * c_bs + i * c_s0
// + j * c_s1, and d's, g's, mask's and c2's the same with a column stride
// of 1; w2's (s, i, j) is w2 + (s / w2_div) * w2_bs + i * n2 + j.
struct Product {
  const void* a;      // A (m x k): rows from a_rows on read 0 (1: the ones row)
  const void* b;      // B (k x n)
  const void* bias;   // kRelu: bias(s, j) = bias + (s / bias_div) * bias_bs + j
  const void* w2;     // kRelu: W_{l+1} (n x n2) for a_{l+1}, or null
  const float* g;     // kRelu (with d), kGradMask: the output's gradient
  const float* mask;  // kGradMask: h, whose [h > 0] masks
  float* c;
  float* d;           // kRelu: dz (or null); kDa: db, one row per sample
  float* c2;          // with w2: a_{l+1} (m x n2)
  long long a_bs, a_s0, a_s1, b_bs, b_s0, b_s1, bias_bs, w2_bs, g_bs, g_s0,
      mask_bs, mask_s0, c_bs, c_s0, c_s1, d_bs, d_s0, c2_bs, c2_s0;
  int m, n, k;
  int a_rows;         // rows of A read from memory
  int ones;           // row a_rows of A is ones over k
  int epi;
  int n2;             // with w2: columns of a_{l+1}
  int a_div, b_div, bias_div, w2_div;
  int a_type, b_type, bias_type, w2_type;
  int tile;           // index into kTileM / kTileN
  int ksplit;         // groups of warps that split K: 1, 2, 4 or 8
  int a_k, b_k;       // the operand is staged along K (else along m / n)
  int a_vec, b_vec, w2_vec;   // floats per copy: 4, 2 or 1
};

namespace {

// Built with -DGCN_STACK_PHASES (tools/gcn_stack_phases.py --streamed does),
// thread 0 of every CTA records %globaltimer and clock64 at four points of
// launch `step` of a list: its start, the prologue's copies issued, the
// main loop's end and the epilogue's end; otherwise phase() compiles to
// nothing.
#ifdef GCN_STACK_PHASES
constexpr int kPhaseSlots = 4;
constexpr int kPhaseCtas = 8192;
constexpr int kPhaseLaunches = 32;
__device__ unsigned long long
    g_phase_ns[kPhaseLaunches * kPhaseCtas * kPhaseSlots];
__device__ long long g_phase_clk[kPhaseLaunches * kPhaseCtas * kPhaseSlots];
__device__ __forceinline__ void phase(int step, int slot) {
  if (threadIdx.x == 0 && blockIdx.x < kPhaseCtas && step < kPhaseLaunches) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    const long long at =
        (static_cast<long long>(step) * kPhaseCtas + blockIdx.x) * kPhaseSlots +
        slot;
    g_phase_ns[at] = ns;
    g_phase_clk[at] = clock64();
  }
}
#else
__device__ __forceinline__ void phase(int, int) {}
#endif

__device__ __forceinline__ float load_value(const void* base, int type,
                                            long long at) {
  return type == kBf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[at])
             : static_cast<const float*>(base)[at];
}

// cp.async of V floats that writes zeros past the first `valid` of them
template <int V>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
                 "l"(src), "r"(valid * 4));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(addr),
                 "l"(src), "n"(V * 4), "r"(valid * 4));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An operand as the loader sees it: X(r, k) = base + r * s_r + k * s_k
// for r < rows (m of A, n of B) and k < depth, zero elsewhere, and the
// ones row `ones` (-1: none) reading 1 for k < depth.
struct Operand {
  const void* base;
  long long s_r, s_k;
  int rows, depth, ones, type, vec;
};

// Stage chunk k0 .. k0 + kChunk of X's rows r0 .. r0 + R into `xs`: as
// xs[r][k] (row stride kChunk + kPad) where XK, else xs[k][r] (row stride
// R + kPad), in copies of V values along the staged dimension (zero-filled
// past the edge). Vectors wholly outside X are zeros stored, those that
// meet the ones row and bf16 values plain loads and stores.
template <int R, bool XK, int V>
__device__ __forceinline__ void stage_vectors(float* xs, const Operand& x,
                                              int r0, int k0, int tid,
                                              int nthreads) {
  constexpr int kLd = XK ? kChunk + kPad : R + kPad;
  constexpr int kPer = (XK ? kChunk : R) / V;   // vectors along a line
  constexpr int kCount = (XK ? R : kChunk) * kPer;
  const bool plain = x.type == kBf16;
  for (int e = tid; e < kCount; e += nthreads) {
    const int line = e / kPer, at = e % kPer * V;
    const int r = XK ? line : at, kk = XK ? at : line;
    float* dst = xs + (XK ? r * kLd + kk : kk * kLd + r);
    const int gr = r0 + r, gk = k0 + kk;
    const bool meets_ones =
        x.ones >= 0 && (XK ? gr == x.ones : gr <= x.ones && x.ones < gr + V);
    if (plain || meets_ones) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int rr = XK ? gr : gr + q, kq = XK ? gk + q : gk;
        float v = 0.f;
        if (kq < x.depth) {
          if (rr == x.ones) {
            v = 1.f;
          } else if (rr < x.rows) {
            v = load_value(x.base, x.type, rr * x.s_r + kq * x.s_k);
          }
        }
        dst[q] = v;
      }
      continue;
    }
    int valid = XK ? (gr < x.rows ? x.depth - gk : 0)
                   : (gk < x.depth ? x.rows - gr : 0);
    if (valid <= 0) {            // wholly outside: zeros without a copy
#pragma unroll
      for (int q = 0; q < V; ++q) dst[q] = 0.f;
      continue;
    }
    copy_async<V>(dst, static_cast<const float*>(x.base) + gr * x.s_r +
                           gk * x.s_k,
                  valid > V ? V : valid);
  }
}

template <int R, bool XK>
__device__ __forceinline__ void stage(float* xs, const Operand& x, int r0,
                                      int k0, int tid, int nthreads) {
  if (x.vec == 4) {
    stage_vectors<R, XK, 4>(xs, x, r0, k0, tid, nthreads);
  } else if (x.vec == 2) {
    stage_vectors<R, XK, 2>(xs, x, r0, k0, tid, nthreads);
  } else {
    stage_vectors<R, XK, 1>(xs, x, r0, k0, tid, nthreads);
  }
}

// W_{l+1} (rows x cols, row stride cols in memory) into ws (row stride ld)
__device__ __forceinline__ void stage_weight(float* ws, int ld,
                                             const void* base, int type,
                                             int rows, int cols, int vec,
                                             int tid, int nthreads) {
  const int per = (cols + vec - 1) / vec;
  for (int e = tid; e < rows * per; e += nthreads) {
    const int r = e / per, c = e % per * vec;
    float* dst = ws + r * ld + c;
    const long long at = static_cast<long long>(r) * cols + c;
    const int valid = cols - c < vec ? cols - c : vec;
    if (type == kBf16 || vec == 1) {
      for (int q = 0; q < valid; ++q) dst[q] = load_value(base, type, at + q);
    } else if (vec == 4) {
      copy_async<4>(dst, static_cast<const float*>(base) + at, valid);
    } else {
      copy_async<2>(dst, static_cast<const float*>(base) + at, valid);
    }
  }
}

template <int BM, int BN, bool AK, bool BK>
struct Tile {
  static constexpr int kAStage =
      AK ? BM * (kChunk + kPad) : kChunk * (BM + kPad);
  static constexpr int kBStage =
      BK ? BN * (kChunk + kPad) : kChunk * (BN + kPad);
  static constexpr int kRing = kStages * (kAStage + kBStage);
  static constexpr int kGroup = BM / 4 * (BN / 4);   // threads of a K group
  static constexpr int kWarpX = BN / 4 < 8 ? BN / 4 : 8;  // lanes along n
  static constexpr int kWarpY = 32 / kWarpX;
  static constexpr int kWarpsX = BN / 4 / kWarpX;
};

// floats of dynamic shared memory one launch of the tile takes: the ring,
// reused after the main loop for each K group's sums (row stride BN + 1)
// and h_{l+1}'s rows (transposed), then W_{l+1}
template <int BM, int BN, bool AK, bool BK>
__host__ __device__ inline int smem_floats(const Product& p) {
  const int ring = Tile<BM, BN, AK, BK>::kRing;
  const int sums = p.ksplit * BM * (BN + 1) +
                   (p.w2 != nullptr ? BN * (BM + kPad) : 0);
  return (ring > sums ? ring : sums) +
         (p.w2 != nullptr ? p.n * ((p.n2 + 3) / 4 * 4) : 0);
}

// (a minimum of 1 CTA an SM: with the maximum alone, ptxas held the
// instantiations with both operands staged along m / n to 64 registers,
// with spills)
template <int BM, int BN, bool AK, bool BK>
__global__ void __launch_bounds__(kMaxThreads, 1)
gcn_stack_streamed_product(const Product p, int step) {
  phase(step, 0);
  using T = Tile<BM, BN, AK, BK>;
  extern __shared__ __align__(16) float smem[];
  const int m_tiles = (p.m + BM - 1) / BM;
  const int n_tiles = (p.n + BN - 1) / BN;
  const int block = static_cast<int>(blockIdx.x);
  const int m0 = block % m_tiles * BM;
  const int n0 = block / m_tiles % n_tiles * BN;
  const int s = block / m_tiles / n_tiles;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int group = tid / T::kGroup, t = tid % T::kGroup;
  const int lane = t % 32, warp = t / 32;
  const int tx = warp % T::kWarpsX * T::kWarpX + lane % T::kWarpX;
  const int ty = warp / T::kWarpsX * T::kWarpY + lane / T::kWarpX;
  const int sub = kChunk / p.ksplit;            // K per group per chunk

  const Operand a{static_cast<const char*>(p.a) +
                      static_cast<long long>(s / p.a_div) * p.a_bs *
                          (p.a_type == kBf16 ? 2 : 4),
                  p.a_s0, p.a_s1, p.a_rows, p.k, p.ones ? p.a_rows : -1,
                  p.a_type, p.a_vec};
  const Operand b{static_cast<const char*>(p.b) +
                      static_cast<long long>(s / p.b_div) * p.b_bs *
                          (p.b_type == kBf16 ? 2 : 4),
                  p.b_s1, p.b_s0, p.n, p.k, -1, p.b_type, p.b_vec};
  const int w2_ld = (p.n2 + 3) / 4 * 4;
  float* w2s = smem + smem_floats<BM, BN, AK, BK>(p) -
               (p.w2 != nullptr ? p.n * w2_ld : 0);

  float acc[4][4] = {};
  const int chunks = (p.k + kChunk - 1) / kChunk;
  if (p.w2 != nullptr) {
    stage_weight(w2s, w2_ld,
                 static_cast<const char*>(p.w2) +
                     static_cast<long long>(s / p.w2_div) * p.w2_bs *
                         (p.w2_type == kBf16 ? 2 : 4),
                 p.w2_type, p.n, p.n2, p.w2_vec, tid, nthreads);
  }
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) {
      float* st = smem + c * (T::kAStage + T::kBStage);
      stage<BM, AK>(st, a, m0, c * kChunk, tid, nthreads);
      stage<BN, BK>(st + T::kAStage, b, n0, c * kChunk, tid, nthreads);
    }
    commit();
  }
  phase(step, 1);
  for (int c = 0; c < chunks; ++c) {
    wait_pending<kStages - 2>();   // chunk c is in (this thread's copies)
    __syncthreads();               // everyone's; and chunk c - 1 is done
    const int next = c + kStages - 1;
    if (next < chunks) {
      float* st = smem + next % kStages * (T::kAStage + T::kBStage);
      stage<BM, AK>(st, a, m0, next * kChunk, tid, nthreads);
      stage<BN, BK>(st + T::kAStage, b, n0, next * kChunk, tid, nthreads);
    }
    commit();
    const float* as = smem + c % kStages * (T::kAStage + T::kBStage);
    const float* bs = as + T::kAStage;
    const int k_lo = group * sub;
    const int k_hi = min(k_lo + sub, p.k - c * kChunk);
    if constexpr (!AK && !BK) {   // both staged along m / n: a k at a time
#pragma unroll 4
      for (int k = k_lo; k < k_hi; ++k) {
        const float4 x =
            *reinterpret_cast<const float4*>(&as[k * (BM + kPad) + ty * 4]);
        const float4 y =
            *reinterpret_cast<const float4*>(&bs[k * (BN + kPad) + tx * 4]);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(xs[i], ys[j], acc[i][j]);
          }
        }
      }
      continue;
    }
#pragma unroll 2
    for (int k = k_lo; k < k_hi; k += 4) {
      float av[4][4], bv[4][4];     // av[i][q] = A(i, k + q), bv[q][j]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(
            AK ? &as[(ty + u * (BM / 4)) * (kChunk + kPad) + k]
               : &as[(k + u) * (BM + kPad) + ty * 4]);
        const float4 y = *reinterpret_cast<const float4*>(
            BK ? &bs[(tx + u * (BN / 4)) * (kChunk + kPad) + k]
               : &bs[(k + u) * (BN + kPad) + tx * 4]);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (AK) {
            av[u][v] = xs[v];
          } else {
            av[v][u] = xs[v];
          }
          if (BK) {
            bv[v][u] = ys[v];
          } else {
            bv[u][v] = ys[v];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(av[i][q], bv[q][j], acc[i][j]);
          }
        }
      }
    }
  }
  wait_pending<0>();
  __syncthreads();               // the ring is free
  phase(step, 2);

  // Each group's sums into shared memory, sums[group][row][col] (row
  // stride BN + 1); then every thread takes elements of C in turn, rows
  // fastest where C's rows are contiguous, else columns, adds the groups'
  // sums in group order and applies the epilogue.
  constexpr int kLd = BN + 1;
  float* sums = smem + group * BM * kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sums[(AK ? ty + i * (BM / 4) : ty * 4 + i) * kLd +
           (BK ? tx + j * (BN / 4) : tx * 4 + j)] = acc[i][j];
    }
  }
  float* hs = smem + p.ksplit * BM * kLd;   // with w2: hs[col][row]
  const long long ss = s;
  const int bias_at = s / p.bias_div;
  __syncthreads();
  const bool rows_fast = p.c_s0 == 1 && p.c_s1 != 1;
  for (int e = tid; e < BM * BN; e += nthreads) {
    const int r = rows_fast ? e % BM : e / BN;
    const int cl = rows_fast ? e / BM : e % BN;
    float v = smem[r * kLd + cl];
    for (int g = 1; g < p.ksplit; ++g) v += smem[(g * BM + r) * kLd + cl];
    const int row = m0 + r, col = n0 + cl;
    if (p.epi == kRelu) {
      float h = 0.f;
      if (col < p.n) {
        const float z = v + load_value(p.bias, p.bias_type,
                                       bias_at * p.bias_bs + col);
        h = z > 0.f ? z : 0.f;
        if (row < p.m) {
          p.c[ss * p.c_bs + row * p.c_s0 + col * p.c_s1] = h;
          if (p.d != nullptr) {
            p.d[ss * p.d_bs + row * p.d_s0 + col] =
                p.g[ss * p.g_bs + row * p.g_s0 + col] * (z > 0.f ? 1.f : 0.f);
          }
        }
      }
      if (p.w2 != nullptr) hs[cl * (BM + kPad) + r] = h;
      continue;
    }
    if (row >= p.m || col >= p.n) continue;
    float* c = p.c + ss * p.c_bs + row * p.c_s0 + col * p.c_s1;
    if (p.epi == kDa) {
      if (row < p.a_rows) {
        *c = v;
      } else {
        p.d[ss * p.d_bs + col] = v;
      }
    } else if (p.epi == kGradMask) {
      const float gv = p.g[ss * p.g_bs + row * p.g_s0 + col];
      const float hm = p.mask[ss * p.mask_bs + row * p.mask_s0 + col];
      *c = (gv + v) * (hm > 0.f ? 1.f : 0.f);
    } else {
      *c = v;
    }
  }
  if (p.w2 != nullptr) {
    // a_{l+1} = h_{l+1} W_{l+1} for the tile's rows, in 4 x 4 tiles over
    // every thread, summed over H_{l+1} in order
    __syncthreads();
    const int row_tiles = BM / 4, tiles = row_tiles * ((p.n2 + 3) / 4);
    for (int u = tid; u < tiles; u += nthreads) {
      const int tr = u % row_tiles * 4, tc = u / row_tiles * 4;
      float out[4][4] = {};
      for (int k = 0; k < p.n; ++k) {
        const float4 hv =
            *reinterpret_cast<const float4*>(&hs[k * (BM + kPad) + tr]);
        const float4 wv =
            *reinterpret_cast<const float4*>(&w2s[k * w2_ld + tc]);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
        const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            out[i][j] = fmaf(hr[i], wr[j], out[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + tr + i;
        if (row >= p.m) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (tc + j < p.n2) {
            p.c2[ss * p.c2_bs + row * p.c2_s0 + tc + j] = out[i][j];
          }
        }
      }
    }
  }
  phase(step, 3);
}

// out[s][e] = sum over the `slots` slots of set s (in order) of ws[.][e]
__global__ void __launch_bounds__(kReduceThreads)
sum_streamed_slots(const float* __restrict__ ws, float* __restrict__ out,
                   int slots, int wsz) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= wsz) return;
  const float* src = ws + static_cast<long long>(blockIdx.y) * slots * wsz + e;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < slots; ++q) s += src[static_cast<long long>(q) * wsz];
  out[static_cast<long long>(blockIdx.y) * wsz + e] = s;
}

template <int BM, int BN, bool AK, bool BK>
cudaError_t launch_tile(const Product& p, int step, unsigned blocks,
                        int device, cudaStream_t stream) {
  auto kernel = gcn_stack_streamed_product<BM, BN, AK, BK>;
  static unsigned long long ready = 0;   // devices whose limit is raised
  if (device >= 64 || !(ready >> device & 1ULL)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    if (device < 64) ready |= 1ULL << device;
  }
  kernel<<<blocks, BM / 4 * (BN / 4) * p.ksplit,
           4 * smem_floats<BM, BN, AK, BK>(p), stream>>>(p, step);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_layout(const Product& p, int step, unsigned blocks,
                          int device, cudaStream_t stream) {
  if (p.a_k) {
    return p.b_k ? launch_tile<BM, BN, true, true>(p, step, blocks, device,
                                                   stream)
                 : launch_tile<BM, BN, true, false>(p, step, blocks, device,
                                                    stream);
  }
  return p.b_k ? launch_tile<BM, BN, false, true>(p, step, blocks, device,
                                                  stream)
               : launch_tile<BM, BN, false, false>(p, step, blocks, device,
                                                   stream);
}

cudaError_t launch(const Product& p, int step, unsigned blocks, int device,
                   cudaStream_t stream) {
#define GCN_STACK_TILE(T)                                                 \
  case T:                                                                 \
    return launch_layout<kTileM[T], kTileN[T]>(p, step, blocks, device,   \
                                               stream);
  switch (p.tile) {
    GCN_STACK_TILE(0) GCN_STACK_TILE(1) GCN_STACK_TILE(2) GCN_STACK_TILE(3)
    default: return cudaErrorInvalidValue;
  }
#undef GCN_STACK_TILE
}

int smem_bytes(const Product& p) {
#define GCN_STACK_SMEM(T)                                                     \
  case 4 * T: return 4 * smem_floats<kTileM[T], kTileN[T], false, false>(p);  \
  case 4 * T + 1: return 4 * smem_floats<kTileM[T], kTileN[T], false, true>(p); \
  case 4 * T + 2: return 4 * smem_floats<kTileM[T], kTileN[T], true, false>(p); \
  case 4 * T + 3: return 4 * smem_floats<kTileM[T], kTileN[T], true, true>(p);
  switch (p.tile * 4 + (p.a_k ? 2 : 0) + (p.b_k ? 1 : 0)) {
    GCN_STACK_SMEM(0) GCN_STACK_SMEM(1) GCN_STACK_SMEM(2) GCN_STACK_SMEM(3)
    default: return kMaxSmemBytes + 1;
  }
#undef GCN_STACK_SMEM
}

// A copy of `vec` floats along the staged dimension needs a stride of 1
// there and the base, the other stride and the batch stride aligned to it.
bool copies_fit(const void* base, int type, int vec, long long contiguous,
                long long other, long long batch) {
  if (vec == 1) return true;
  if ((vec != 2 && vec != 4) || type != kF32 || contiguous != 1) return false;
  return reinterpret_cast<unsigned long long>(base) % (4 * vec) == 0 &&
         other % vec == 0 && batch % vec == 0;
}

// CTAs of one launch over `batch` samples; -1 for a tile that does not
// exist or a grid past the launch limit
long long product_blocks(const Product& p, int batch) {
  if (p.tile < 0 || p.tile >= kTiles || p.m < 1 || p.n < 1) return -1;
  const long long blocks =
      static_cast<long long>((p.m + kTileM[p.tile] - 1) / kTileM[p.tile]) *
      ((p.n + kTileN[p.tile] - 1) / kTileN[p.tile]) * batch;
  return blocks < (1LL << 31) ? blocks : -1;
}

bool product_valid(const Product& p, int batch) {
  const int ks = p.ksplit;
  if (product_blocks(p, batch) < 0 ||
      (ks != 1 && ks != 2 && ks != 4 && ks != 8) ||
      kTileM[p.tile] / 4 * (kTileN[p.tile] / 4) * ks > kMaxThreads) {
    return false;
  }
  const bool fused = p.w2 != nullptr;
  return p.k >= 1 && p.a_rows >= 0 && p.a_rows <= p.m &&
         (!p.ones || p.a_rows + 1 == p.m) && p.a_div >= 1 && p.b_div >= 1 &&
         p.bias_div >= 1 && p.w2_div >= 1 && p.a != nullptr &&
         p.b != nullptr && p.c != nullptr &&
         (p.epi == kRelu || p.epi == kStore || p.epi == kDa ||
          p.epi == kGradMask) &&
         (p.epi != kRelu || p.bias != nullptr) &&
         (p.epi != kDa || !p.ones || p.d != nullptr) &&
         (p.epi != kGradMask || (p.g != nullptr && p.mask != nullptr)) &&
         (!fused || (p.epi == kRelu && p.n <= kTileN[p.tile] &&
                     p.c2 != nullptr && p.n2 >= 1 &&
                     copies_fit(p.w2, p.w2_type, p.w2_vec, 1, p.n2,
                                p.w2_bs))) &&
         copies_fit(p.a, p.a_type, p.a_vec, p.a_k ? p.a_s1 : p.a_s0,
                    p.a_k ? p.a_s0 : p.a_s1, p.a_bs) &&
         copies_fit(p.b, p.b_type, p.b_vec, p.b_k ? p.b_s0 : p.b_s1,
                    p.b_k ? p.b_s1 : p.b_s0, p.b_bs) &&
         smem_bytes(p) <= kMaxSmemBytes;
}

}  // namespace

extern "C" {

// steps: `count` products over `batch` samples, launched in order; then,
// where ws is not null, wgrad (sets x wsz) = the per-set sums of ws's
// slots (`slots` consecutive slots of wsz floats to a set, slots * sets =
// batch). All on `device`, on `stream`.
int gcn_stack_streamed(const Product* steps, int count, int batch,
                       const float* ws, float* wgrad, int slots, int wsz,
                       int sets, int device, void* stream) {
  if (count < 0 || batch < 0 || (ws == nullptr) != (wgrad == nullptr) ||
      (ws != nullptr && (slots < 1 || wsz < 1 || sets < 1 || sets > 65535 ||
                         static_cast<long long>(slots) * sets != batch))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < count; ++i) {
    if (!product_valid(steps[i], batch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (batch == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < count && err == cudaSuccess; ++i) {
    err = launch(steps[i], i,
                 static_cast<unsigned>(product_blocks(steps[i], batch)),
                 device, s);
  }
  if (err == cudaSuccess && ws != nullptr) {
    const dim3 grid((wsz + kReduceThreads - 1) / kReduceThreads, sets);
    sum_streamed_slots<<<grid, kReduceThreads, 0, s>>>(ws, wgrad, slots, wsz);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) cudaGetLastError();   // clear it for the caller
  return static_cast<int>(err);
}

const char* gcn_stack_streamed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef GCN_STACK_PHASES
// Copies the phase stamps of the last list's first `launches` launches:
// ns and clk hold launches * kPhaseCtas * kPhaseSlots values each (launch,
// then CTA, then slot); returns the cudaError_t.
int gcn_stack_streamed_phase_stamps(unsigned long long* ns, long long* clk,
                                    int launches) {
  const size_t count = sizeof(long long) * kPhaseCtas * kPhaseSlots *
                       static_cast<size_t>(launches < kPhaseLaunches
                                               ? launches : kPhaseLaunches);
  cudaError_t err = cudaMemcpyFromSymbol(ns, g_phase_ns, count);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clk, g_phase_clk, count);
  return static_cast<int>(err);
}
#endif

}  // extern "C"
