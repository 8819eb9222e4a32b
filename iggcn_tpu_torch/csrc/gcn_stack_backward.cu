// Backward of the fused L-layer dense GCN stack (fp32), for sm_90a.
//
// Replaces the backward of the JAX custom VJP of
// iggcn_tpu/ops/pallas_gcn.py:fused_gcn_stack (_bwd, :116-119), which runs
// jax.vjp of the jnp reference: the forward recomputed from the saved
// inputs, then its gradients, compiled by XLA. There is no pallas_call
// there; this kernel computes the same function. Per sample, with g the
// gradient of the JK output (N x sum H):
//   recompute: h_0 = x; a_l = h_l W_l; z_l = P a_l + b_l; h_{l+1} = relu(z_l)
//   for l = L-1 .. 0, from e_L = 0:
//     dz_l = (g[:, JK slice of l] + e_{l+1}) * [z_l > 0]   (strict: 0 at a tie)
//     db_l += sum over rows of dz_l;  da_l = P^T dz_l;  dW_l += h_l^T da_l
//     e_l = da_l W_l^T;  dx = e_0
//   dP = sum_l dz_l a_l^T, one product of depth sum H, written once.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32; each input read once, each
// output written once) at the training batch, B=32 N=90 F0=3 (16,16): P
// 1.04 MB and g 0.37 MB read, dP 1.04 MB written, 2.5 MB = 0.75 us; 55.5
// MFLOP (recompute 2 P-products, P^T dz 2, DZ A^T 1) = 0.83 us. The
// operations bound it, barely, and at B=32 N=270 (10,10,10) too: 19.8 MB
// = 5.9 us against 432 MFLOP = 6.5 us.
//
// Design, against that bound:
// - The forward's cluster split, reused: sample s runs on a cluster of C
//   CTAs (1 at N=90, 2 at N=270; the plan takes the smallest that holds
//   this kernel's shared memory). CTA k keeps P's column band
//   [k R, (k+1) R) resident, P read from device memory once (one
//   cp.async.bulk from the transposed layout, 4-byte cp.asyncs otherwise),
//   and owns rows [k R, (k+1) R) of h, a, z and dz.
// - P's copy is issued first, and all that needs no P runs behind it: the
//   weights, x into h^T, the pads zeroed, g's rows into dz^T (one CTA; with
//   a cluster dz^T holds the partial P a until the recompute ends) and
//   a_0 = h_0 W_0. Only then does the CTA wait for P.
// - The recompute sums each CTA's partial P a through distributed shared
//   memory, as csrc/gcn_stack.cu does, and keeps a_l for every layer (a^T,
//   for dP) and h_l (h^T, for dW and the relu masks) for its rows; the last
//   layer's output only gives the mask of dz_{L-1}, applied to g's slice
//   in z's epilogue (one CTA) or when g is written (a cluster).
// - dz is kept for every row and layer (dz^T, sum H x N): its CTA's rows
//   start as g's (read once, all loads in flight), a CTA finishes its rows
//   of a layer, then gathers the other CTAs' rows of it through
//   distributed shared memory after one cluster barrier. da_l = P^T dz_l
//   for the CTA's rows then needs only its own band, and so does dP's
//   block of columns, staged in the band's space once P is read for the
//   last time and written once with coalesced stores (in the transposed
//   layout one contiguous block per CTA). A layer takes two passes, each
//   behind one barrier: da_l with db_l on the warps past da's tiles, then
//   dW_l and e_l side by side on two ranges of threads.
// - dW_l and db_l are summed over each CTA's rows into its own slot of a
//   workspace; a second small kernel sums the slots of each weight set in
//   a fixed order. No float atomics: two runs give bit-equal gradients.
// - Grouped weights (the fold-parallel trainer): sample s reads weight set
//   s / group at w_stride / b_stride floats per set (0: shared), and the
//   second kernel sums per set.
// - Arithmetic: plain fp32 FMAs (no TF32, no tensor cores) in register
//   tiles through one routine (product): 4 x 4 in the P-products (z = P a,
//   da = P^T dz) where their K is short (N=90), 8 x 4 where it is long
//   (N=270), 8 x 4 in dP, 4 x 4 in the small steps (a, dW, e). Every
//   operand is read in vectors along the dimension it is contiguous in:
//   16 bytes, or 8 for P's band where its column stride is only even
//   (N=90, 270); K in chunks of 4, split over up to 4 adjacent lanes in
//   the P-products (chunk s, s + ks, ... to lane s) and summed by a
//   shuffle butterfly in a fixed order. Reads past K's end meet exact
//   zeros in one operand and finite values in the other: the band's pads
//   and a^T, h^T, da and dz^T are zeroed before use, and only in-range
//   values are written there.
//
// The launch plan (cluster, band, shared-memory offsets) is computed in
// Python (ops/gcn_stack.py:plan_backward) and passed as a BackwardPlan.
// C interface (bound with ctypes): gcn_stack_backward launches both
// kernels on the caller's stream, never synchronises, allocates nothing
// (the workspace and outputs come from the caller), and returns the
// cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxLayers = 8;
constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kMaxCluster = 8;
constexpr int kReduceThreads = 256;
constexpr int kGather = 8;     // global loads a thread keeps in flight

// Field for field the ctypes structure _CBackwardPlan in ops/gcn_stack.py.
// Offsets are in floats from the start of dynamic shared memory, where
// P's band of columns starts: pt[j * ps + i] = P[i][k R + j].
struct BackwardPlan {
  int n, num_layers, cluster;
  int rows;          // R: P columns (= rows of h, a, dz) per CTA
  int threads, smem_bytes;
  int ps;            // column stride of P's band (N, even)
  int total;         // JK width sum H_l: the row stride of g
  int tot_p;         // sum of fout_p: rows of dz^T and a^T
  int hmax;          // widest fout_p
  int dts;           // row stride of dz^T (N rounded up to 8, + 4)
  int ats;           // row stride of a^T and h^T (R + 4)
  int das;           // row stride of da (hmax, + 4 where hmax % 8 == 0)
  int p_transposed;  // P's memory holds P^T row by row
  int copy_bulk;     // the band is one 16-byte-aligned block: bulk copy
  int group;         // samples per weight set: sample s reads set s / group
  int wsz;           // floats of one CTA's dW/db slot
  int off_dz;        // tot_p x dts: dz^T (the cluster's partial P a first)
  int off_at;        // tot_p x ats: a^T of this CTA's rows
  int off_ht;        // h_off[L-1] + ceil4(F_{L-1}) rows of ats: h^T
  int off_da;        // R x das: da_l of this CTA's rows
  int dims[kMaxLayers + 1];
  int fout_p[kMaxLayers];
  int off_w[kMaxLayers];     // W_l as ceil4(F_l) x fout_p[l], zero-padded
  int off_b[kMaxLayers];     // b_l as fout_p[l], zero-padded
  int out_off[kMaxLayers];   // column of layer l in g
  int dz_off[kMaxLayers];    // row of layer l in dz^T and a^T
  int h_off[kMaxLayers];     // row of h_l in h^T
  int ws_off[kMaxLayers];    // dW_l in a slot (F_l x H_l), then db_l (H_l)
  int w_stride[kMaxLayers];  // floats between weight sets (0: shared)
  int b_stride[kMaxLayers];  // floats between bias sets (0: shared)
};

// A null dprop, dx or ws: that gradient is not wanted (ws: none of the
// weights' and biases').
struct BackwardArgs {
  BackwardPlan plan;
  const float* prop;
  long long p_batch_stride;
  const float* x;
  const float* g;
  float* dprop;   // (B, N, N), batch stride N * N, in P's layout
  float* dx;      // (B, N, F0)
  float* ws;      // B * cluster slots of wsz floats
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

namespace {

// Built with -DGCN_STACK_PHASES (tools/gcn_stack_phases.py does), thread 0
// of every CTA records %globaltimer and clock64 at the phase boundaries
// below, slot by slot in the order they are passed; otherwise phase()
// compiles to nothing.
#ifdef GCN_STACK_PHASES
constexpr int kPhaseSlots = 64;
constexpr int kPhaseCtas = 4096;
__device__ unsigned long long g_phase_ns[kPhaseCtas * kPhaseSlots];
__device__ long long g_phase_clk[kPhaseCtas * kPhaseSlots];
__device__ __forceinline__ void phase(int slot) {
  if (threadIdx.x == 0 && blockIdx.x < kPhaseCtas && slot < kPhaseSlots) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_phase_ns[blockIdx.x * kPhaseSlots + slot] = ns;
    g_phase_clk[blockIdx.x * kPhaseSlots + slot] = clock64();
  }
}
#else
__device__ __forceinline__ void phase(int) {}
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's latest cp.async groups
// are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// One thread: copy `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory with the bulk-copy engine; `bar` completes
// its phase 0 when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n"
      :: "r"(smem_addr(bar)), "r"(bytes), "r"(smem_addr(dst)), "l"(src)
      : "memory");
}

__device__ __forceinline__ void mbar_wait_phase0(unsigned long long* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)) : "memory");
  }
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of every CTA in the cluster arrives; shared-memory writes
// before it are visible to all of them after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Generic address of `p`'s counterpart in CTA `rank` of the cluster
// (distributed shared memory); plain loads through it read the peer.
__device__ __forceinline__ const float* peer_ptr(const float* p, int rank) {
  unsigned long long out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out) : "l"(reinterpret_cast<unsigned long long>(p)), "r"(rank));
  return reinterpret_cast<const float*>(out);
}

// V consecutive floats of shared memory at p (4 V-byte aligned) in one
// load.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  static_assert(V == 2 || V == 4, "vectors of 2 or 4 floats");
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// log2 of the lanes that share one tile of a product of `tiles` tiles and
// `chunks` chunks of K over `span` threads: the most, up to `ksw`, that
// fit in `span` with at least one chunk each.
__device__ __forceinline__ int ksplit_log2(int tiles, int chunks, int span,
                                           int ksw) {
  int lg = 0;
  while (lg < 5 && (2 << lg) <= ksw && (tiles << (lg + 1)) <= span &&
         (2 << lg) <= chunks) {
    ++lg;
  }
  return lg;
}

// C(m, n) = sum_{k < kn} A(m, k) B(k, n) for m < mn, n < nn, in TM x TN
// register tiles over the threads [t0, t0 + span) of the CTA (both
// multiples of 32; the others skip it). A(m, k) = a[m * as + k] where AK
// (contiguous in k), else a[k * as + m]; B(k, n) = b[n * bs + k] where BK,
// else b[k * bs + n]. Each operand is read in VA- / VB-float vectors along
// the dimension it is contiguous in, every vector aligned to its size, and
// K in chunks of 4: k up to the next multiple of 4 is read, so there one
// operand must hold exact zeros and the other finite values. A tile's
// rows past mn (AK) or columns past nn (BK) read row mn - 1 or column
// nn - 1 again; otherwise m and n up to the tile's edge must stay in
// shared memory. What they find reaches only outputs that are not stored
// (epi stores m < mn, n < nn). ks adjacent lanes share a tile
// (ksplit_log2, at most ksw); lane s of them sums chunks s, s + ks, ... in
// ascending order (k in order within a chunk), a shuffle butterfly in a
// fixed order gives every lane the tile's sums, and lane 0 of the tile
// hands them to epi(m0, n0, acc). A warp with a lane in the work runs the
// same rounds as the others, so the shuffles see full warps.
template <int TM, int TN, int VA, bool AK, int VB, bool BK, typename Epi>
__device__ __forceinline__ void product(int mn, int nn, int kn,
                                        const float* a, int as,
                                        const float* b, int bs,
                                        int t0, int span, int ksw, Epi epi) {
  // A is read a group of RG rows at a time (one row where it is
  // contiguous in k, VA rows where in m), B a whole chunk at a time: the
  // registers hold the tile, B's chunk and RG rows of A's.
  constexpr int RG = AK ? 1 : VA;
  const int t = static_cast<int>(threadIdx.x) - t0;
  if (t < 0 || t >= span) return;
  const int nt = (nn + TN - 1) / TN;
  const int tiles = (mn + TM - 1) / TM * nt;
  const int lg = ksplit_log2(tiles, (kn + 3) >> 2, span, ksw);
  const int ks = 1 << lg;
  const int work = tiles << lg;
  for (int base = 0; base + (t & ~31) < work; base += span) {
    const int u = base + t;
    const bool active = u < work;
    const int tile = u >> lg;
    const int slice = u & (ks - 1);
    const int m0 = tile / nt * TM;
    const int n0 = tile % nt * TN;
    float acc[TM][TN] = {};
    if (active) {
#pragma unroll 1
      for (int k0 = slice * 4; k0 < kn; k0 += ks * 4) {
        float bv[4][TN];
        if constexpr (BK) {
#pragma unroll
          for (int c = 0; c < TN; ++c) {
#pragma unroll
            for (int v = 0; v < 4; v += VB) {
              float w[VB];
              load_vec<VB>(b + min(n0 + c, nn - 1) * bs + k0 + v, w);
#pragma unroll
              for (int q = 0; q < VB; ++q) bv[v + q][c] = w[q];
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int v = 0; v < TN; v += VB) {
              load_vec<VB>(b + (k0 + kk) * bs + n0 + v, &bv[kk][v]);
            }
          }
        }
#pragma unroll
        for (int r0 = 0; r0 < TM; r0 += RG) {
          float av[RG][4];
          if constexpr (AK) {
#pragma unroll
            for (int v = 0; v < 4; v += VA) {
              load_vec<VA>(a + min(m0 + r0, mn - 1) * as + k0 + v, &av[0][v]);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              float w[VA];
              load_vec<VA>(a + (k0 + kk) * as + m0 + r0, w);
#pragma unroll
              for (int q = 0; q < VA; ++q) av[q][kk] = w[q];
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int r = 0; r < RG; ++r) {
#pragma unroll
              for (int c = 0; c < TN; ++c) {
                acc[r0 + r][c] = fmaf(av[r][kk], bv[kk][c], acc[r0 + r][c]);
              }
            }
          }
        }
      }
    }
    for (int m = ks >> 1; m >= 1; m >>= 1) {
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], m);
        }
      }
    }
    if (active && slice == 0) epi(m0, n0, acc);
  }
}

// The P-products (z = P a, da = P^T dz) read P's band in 16-byte vectors
// where its column stride is a multiple of 4 floats, else in 8-byte ones
// (ps is even), the other operand in 16-byte vectors along K, in 4 x 4
// tiles, 8 x 4 from a K of kDeepK on. dP: 8 x 4 tiles; the small steps
// (a, dW, e): 4 x 4. The tiles and the K splits below (the most lanes a
// tile may take) are the fastest an H100 read at N=90 and N=270
// (tools/gcn_stack_phases.py --backward-variants); 4 x 8 tiles, whose
// loads feed 8 FMAs each, read slower there (PERF.md section 6). dW's and
// e's splits also keep dW's and dx's error against float64 at the level
// of a deeper split (longer sequential sums round more).
constexpr int kDeepK = 128;
constexpr int kPSplit = 4;     // z and da
constexpr int kASplit = 1;     // a = h W
constexpr int kWSplit = 8;     // dW
constexpr int kESplit = 4;     // e = da W^T
constexpr int kDSplit = 32;    // dP

// One P-product: A is P's band (contiguous in k where AK, else in m), B
// is contiguous in k; epi(m0, n0, acc) gets acc[TM][4].
template <bool AK, typename Epi>
__device__ __forceinline__ void p_product(bool vec4, int mn, int nn, int kn,
                                          const float* pt, int ps,
                                          const float* b, int bs, int nthr,
                                          Epi epi) {
  if (kn < kDeepK && vec4) {
    product<4, 4, 4, AK, 4, true>(mn, nn, kn, pt, ps, b, bs, 0, nthr, kPSplit, epi);
  } else if (kn < kDeepK) {
    product<4, 4, 2, AK, 4, true>(mn, nn, kn, pt, ps, b, bs, 0, nthr, kPSplit, epi);
  } else if (vec4) {
    product<8, 4, 4, AK, 4, true>(mn, nn, kn, pt, ps, b, bs, 0, nthr, kPSplit, epi);
  } else {
    product<8, 4, 2, AK, 4, true>(mn, nn, kn, pt, ps, b, bs, 0, nthr, kPSplit, epi);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
gcn_stack_backward_kernel(const __grid_constant__ BackwardArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ BackwardArgs sa;
  __shared__ alignas(8) unsigned long long p_ready;
  int stamp = 0;
  phase(stamp++);                             // start
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // The parameters into shared memory, one word per thread.
  for (int w = tid; w < static_cast<int>(sizeof(BackwardArgs) / 4); w += nthr) {
    reinterpret_cast<int*>(&sa)[w] = reinterpret_cast<const int*>(&a)[w];
  }
  if (tid == 0) mbar_init(&p_ready);
  __syncthreads();
  const BackwardPlan& p = sa.plan;
  const int n = p.n, rows = p.rows, ps = p.ps, L = p.num_layers;
  const int dts = p.dts, ats = p.ats, das = p.das, hmax = p.hmax;
  const int cl = p.cluster;
  const bool p_vec4 = ps % 4 == 0;
  const int rank = cl > 1 ? cluster_rank() : 0;
  const long long sample = blockIdx.x / cl;
  const int r0 = rank * rows;                 // first column of P it owns
  const int own = min(n, r0 + rows) - r0;     // >= 1, by the plan
  const float* prop_s = sa.prop + sample * sa.p_batch_stride;
  const float* band = prop_s + static_cast<long long>(r0) * n;
  const float* g_s = sa.g + (sample * n + r0) * p.total;   // g's rows of this CTA
  const long long wset = sample / p.group;
  float* pt = smem;                           // pt[j * ps + i] = P[i][r0 + j]
  float* dzt = smem + p.off_dz;               // dzt[c * dts + i] = dz[i][c]
  float* part = dzt;                          // recompute: part[i * hmax + c]
  float* at = smem + p.off_at;                // at[c * ats + j] = a[r0 + j][c]
  float* ht = smem + p.off_ht;                // ht[(h_off + f) * ats + j] = h[r0 + j][f]
  float* da = smem + p.off_da;                // da[j * das + c] = da[r0 + j][c]

  // `count` floats from `from` zeroed (16-byte stores where `from` and
  // `count` allow: every region below but the band's tail)
  auto zero = [&](float* from, int count) {
    if (reinterpret_cast<unsigned long long>(from) % 16 == 0 && count % 4 == 0) {
      for (int idx = 4 * tid; idx < count; idx += 4 * nthr) {
        *reinterpret_cast<float4*>(from + idx) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int idx = tid; idx < count; idx += nthr) from[idx] = 0.f;
    }
  };
  // dz^T zeroed, then this CTA's rows of g set in it, kGather of each
  // thread's loads in flight together (the first ones before the zeros);
  // with mask_last, dz_{L-1} is g's slice where z_{L-1} > 0 (h_L staged
  // in da). Holds one barrier.
  auto fill_dz = [&](bool mask_last) {
    const int count = own * p.total;
    float v[kGather];
    auto load = [&](int base) {
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int e = base + k * nthr + tid;
        v[k] = e < count ? g_s[e] : 0.f;
      }
    };
    load(0);
    zero(dzt, p.tot_p * dts);
    __syncthreads();
    for (int base = 0; base < count; base += kGather * nthr) {
      if (base > 0) load(base);
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int e = base + k * nthr + tid;
        if (e >= count) continue;
        const int j = e / p.total;
        const int col = e - j * p.total;
        int l = 0;
        while (l + 1 < L && col >= p.out_off[l + 1]) ++l;
        const int c = col - p.out_off[l];
        const bool off = mask_last && l == L - 1 && !(da[j * das + c] > 0.f);
        dzt[(p.dz_off[l] + c) * dts + r0 + j] = off ? 0.f : v[k];
      }
    }
  };

  // 1. P's band first, so that its copy runs behind all that needs no P:
  //    one bulk copy where it is one aligned block (thread 0). Then the
  //    weights and biases of this sample's set, zero-padded, and x's rows
  //    of this CTA into h^T (zeros elsewhere, so that h^T's pads stay exact
  //    zeros), as 4-byte cp.asyncs in one group; else P's band as 4-byte
  //    cp.asyncs in a second group.
  if (p.copy_bulk && tid == 0) {
    bulk_load(pt, band, static_cast<unsigned>(own * n * 4), &p_ready);
  }
  for (int l = 0; l < L; ++l) {
    const int fin = p.dims[l], fout = p.dims[l + 1], fp = p.fout_p[l];
    float* ws = smem + p.off_w[l];
    const float* wg = sa.w[l] + wset * p.w_stride[l];
    for (int idx = tid; idx < ((fin + 3) & ~3) * fp; idx += nthr) {
      const int f = idx / fp;
      const int c = idx - f * fp;
      if (f < fin && c < fout) cp_async_4(ws + idx, wg + f * fout + c);
      else ws[idx] = 0.f;
    }
    float* bs = smem + p.off_b[l];
    const float* bg = sa.b[l] + wset * p.b_stride[l];
    for (int c = tid; c < fp; c += nthr) {
      if (c < fout) cp_async_4(bs + c, bg + c);
      else bs[c] = 0.f;
    }
  }
  {
    const int f0 = p.dims[0];
    const float* x_s = sa.x + (sample * n + r0) * f0;
    for (int idx = tid; idx < f0 * ats; idx += nthr) {
      const int f = idx / ats;
      const int j = idx - f * ats;
      if (j < own) cp_async_4(ht + idx, x_s + j * f0 + f);
      else ht[idx] = 0.f;
    }
    zero(ht + f0 * ats, p.off_da - p.off_ht - f0 * ats);
  }
  cp_async_commit();
  if (!p.copy_bulk && p.p_transposed) {
    for (int idx = tid; idx < own * n; idx += nthr) {
      const int j = idx / n;
      cp_async_4(pt + j * ps + (idx - j * n), band + idx);
    }
  } else if (!p.copy_bulk) {
    // row-major: coalesced reads along P's rows, transposed into place
    for (int idx = tid; idx < n * own; idx += nthr) {
      const int i = idx / own;
      const int j = idx - i * own;
      cp_async_4(pt + j * ps + i, prop_s + static_cast<long long>(i) * n + r0 + j);
    }
  }
  cp_async_commit();

  // 2. While they land: the band's pads (n <= i < ps in each column, and
  //    the tail from column `own` to the slack's end) zeroed, since the
  //    products read K and M there and must find finite values; a^T and da
  //    zeroed, so that their pads stay exact zeros; with one CTA, dz^T
  //    (with a cluster the partial P a lives there until the recompute
  //    ends). Then a_0 = h_0 W_0, and only then the wait for P.
  if (ps > n) {
    for (int idx = tid; idx < own * (ps - n); idx += nthr) {
      const int j = idx / (ps - n);
      pt[j * ps + n + idx - j * (ps - n)] = 0.f;
    }
  }
  zero(pt + own * ps, p.off_dz - own * ps);
  zero(at, p.off_ht - p.off_at);
  zero(da, rows * das);
  if (cl == 1) fill_dz(false);
  cp_async_wait<1>();                         // the weights and x, not P
  __syncthreads();
  phase(stamp++);                             // prologue: P queued; W, x, pads, g in

  // 3. The recompute, layer by layer: a_l = h_l W_l for this CTA's rows
  //    (into a^T), then z_l = P a_l + b_l. A relu'd z is h_{l+1} (into h^T);
  //    the last layer's gives only the mask of dz_{L-1}: applied to g's
  //    slice in dz^T at once with one CTA, else staged in da.
  const int last = L - 1;
  for (int l = 0; l < L; ++l) {
    const int fp = p.fout_p[l];
    const float* wl = smem + p.off_w[l];
    const float* bl = smem + p.off_b[l];
    float* at_l = at + p.dz_off[l] * ats;
    product<4, 4, 4, false, 4, false>(
        own, fp, p.dims[l], ht + p.h_off[l] * ats, ats, wl, fp, 0, nthr,
        kASplit, [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (m0 + r >= own) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) at_l[(n0 + c) * ats + m0 + r] = acc[r][c];
      }
    });
    __syncthreads();
    phase(stamp++);                           // recompute: a_l
    if (l == 0) {
      cp_async_wait<0>();
      if (p.copy_bulk) mbar_wait_phase0(&p_ready);
      __syncthreads();
      phase(stamp++);                         // wait on P
    }
    float* h_next = l == last ? nullptr : ht + p.h_off[l + 1] * ats;
    float* dz_last = dzt + p.dz_off[last] * dts;
    const int fout = p.dims[l + 1];
    auto store_h = [&](int j, int c, float z) {
      const float h = fmaxf(z + bl[c], 0.f);
      if (l == last) da[j * das + c] = h;
      else h_next[c * ats + j] = h;
    };
    auto z_epi = [&](int m0, int n0, auto& acc) {
#pragma unroll
      for (int r = 0; r < static_cast<int>(sizeof(acc) / sizeof(acc[0])); ++r) {
        const int i = m0 + r;
        if (i >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = n0 + c;
          if (col >= fout) continue;
          if (cl > 1) {
            part[i * hmax + col] = acc[r][c];
          } else if (l == last) {
            if (!(acc[r][c] + bl[col] > 0.f)) dz_last[col * dts + i] = 0.f;
          } else {
            store_h(i, col, acc[r][c]);
          }
        }
      }
    };
    p_product<false>(p_vec4, n, fp, own, pt, ps, at_l, ats, nthr, z_epi);
    if (cl > 1) {
      // h_{l+1} of this CTA's rows: every CTA's partial for them, summed
      // in rank order through distributed shared memory, kGather values
      // of a thread read before any is stored
      cluster_sync();
      const int count = own * fout;
      for (int base = 0; base < count; base += kGather * nthr) {
        float z[kGather];
#pragma unroll
        for (int k = 0; k < kGather; ++k) {
          const int idx = base + k * nthr + tid;
          z[k] = 0.f;
          if (idx >= count) continue;
          const int at_i = (r0 + idx / fout) * hmax + idx % fout;
          for (int q = 0; q < cl; ++q) {
            z[k] += (q == rank ? part : peer_ptr(part, q))[at_i];
          }
        }
#pragma unroll
        for (int k = 0; k < kGather; ++k) {
          const int idx = base + k * nthr + tid;
          if (idx < count) store_h(idx / fout, idx % fout, z[k]);
        }
      }
      cluster_sync();   // no CTA reads a peer's partial after this
    } else {
      __syncthreads();
    }
    phase(stamp++);                           // recompute: z_l, h_{l+1}
  }
  // With a cluster, dz^T is free only now.
  if (cl > 1) {
    fill_dz(true);
    __syncthreads();
  }
  phase(stamp++);                             // g into dz^T, dz_{L-1}

  // 4. Layer by layer, last first: da_l (and db_l) in one pass, dW_l and
  //    e_l in the next.
  float* slot = sa.ws ? sa.ws + (sample * cl + rank) * p.wsz : nullptr;
  for (int l = L - 1; l >= 0; --l) {
    const int fin = p.dims[l], fout = p.dims[l + 1], fp = p.fout_p[l];
    float* dz_l = dzt + p.dz_off[l] * dts;
    if (cl > 1) {
      // the other CTAs' rows of dz_l, through distributed shared memory,
      // kGather values of a thread read before any is stored
      cluster_sync();
      const int count = fout * n;
      for (int base = 0; base < count; base += kGather * nthr) {
        float v[kGather];
#pragma unroll
        for (int k = 0; k < kGather; ++k) {
          const int idx = base + k * nthr + tid;
          const int at_i = idx / n * dts + idx % n;
          const int q = idx % n / rows;
          v[k] = idx < count && q != rank ? peer_ptr(dz_l, q)[at_i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kGather; ++k) {
          const int idx = base + k * nthr + tid;
          if (idx < count && idx % n / rows != rank) {
            dz_l[idx / n * dts + idx % n] = v[k];
          }
        }
      }
      __syncthreads();
    }
    phase(stamp++);                           // gather dz_l
    // da_l = P^T dz_l for this CTA's rows (da's pad columns get 0: dz^T's
    // pad rows are zeros)
    auto da_epi = [&](int m0, int n0, auto& acc) {
#pragma unroll
      for (int r = 0; r < static_cast<int>(sizeof(acc) / sizeof(acc[0])); ++r) {
        if (m0 + r >= own) continue;
        *reinterpret_cast<float4*>(da + (m0 + r) * das + n0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    };
    p_product<true>(p_vec4, own, fp, n, pt, ps, dz_l, dts, nthr, da_epi);
    if (slot) {
      // db_l over this CTA's rows, a warp a column, from the last warp
      // down: the warps past da's tiles take it at once
      const int lane = tid & 31;
      const int warps = nthr >> 5;
      for (int c = warps - 1 - (tid >> 5); c < fout; c += warps) {
        float s = 0.f;
        for (int j = lane; j < own; j += 32) s += dz_l[c * dts + r0 + j];
#pragma unroll
        for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (lane == 0) slot[p.ws_off[l] + fin * fout + c] = s;
      }
    }
    __syncthreads();
    phase(stamp++);                           // da_l, db_l
    // One pass: dW_l = h_l^T da_l over this CTA's rows on the first
    // threads, as many warps as its tiles and K split take (at most half),
    // and on the rest e_l = da_l W_l^T: dx for l = 0; else, with g's slice
    // of layer l - 1 (in dz^T) and h_l's mask, dz_{l-1} of this CTA's rows.
    const float* h_l = ht + p.h_off[l] * ats;
    const bool want_e = l > 0 || sa.dx;
    int span_w = 0;
    if (slot) {
      span_w = nthr;
      if (want_e) {
        const int tiles = ((fin + 3) >> 2) * ((fout + 3) >> 2);
        const int work =
            tiles << ksplit_log2(tiles, (own + 3) >> 2, nthr >> 1, kWSplit);
        span_w = min(nthr >> 1, (work + 31) & ~31);
      }
      float* dw = slot + p.ws_off[l];
      product<4, 4, 4, true, 4, false>(
          fin, fout, own, h_l, ats, da, das, 0, span_w, kWSplit,
                                       [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (m0 + r < fin && n0 + c < fout) {
              dw[(m0 + r) * fout + n0 + c] = acc[r][c];
            }
          }
        }
      });
    }
    if (want_e) {
      const float* wl = smem + p.off_w[l];
      float* dz_prev = dzt + p.dz_off[l > 0 ? l - 1 : 0] * dts + r0;
      float* dx_s = l > 0 ? nullptr : sa.dx + (sample * n + r0) * fin;
      product<4, 4, 4, true, 4, true>(
          own, fin, fout, da, das, wl, fp, span_w, nthr - span_w, kESplit,
                                      [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = m0 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int f = n0 + c;
            if (j >= own || f >= fin) continue;
            if (dx_s) {
              dx_s[j * fin + f] = acc[r][c];
            } else {
              float& dz = dz_prev[f * dts + j];
              dz = h_l[f * ats + j] > 0.f ? dz + acc[r][c] : 0.f;
            }
          }
        }
      });
    }
    __syncthreads();
    phase(stamp++);                           // dW_l and e_l: dz_{l-1} or dx
  }

  // 5. dP's columns of this CTA's band: dP[i][r0 + j] = sum_c a[r0 + j][c]
  //    dz[i][c], over every layer's columns at once (the pad rows of a^T
  //    and dz^T are zeros), staged in the band's space (P is not read
  //    again: stage[j * n + i]), then written with coalesced stores: in the
  //    transposed layout one block of own * n values, 16 bytes a store
  //    where it is aligned.
  if (sa.dprop) {
    float* stage = pt;
    product<8, 4, 4, false, 4, false>(
        own, n, p.tot_p, at, ats, dzt, dts, 0, nthr, kDSplit,
        [&](int m0, int n0, float (&acc)[8][4]) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (m0 + r < own && n0 + c < n) {
            stage[(m0 + r) * n + n0 + c] = acc[r][c];
          }
        }
      }
    });
    __syncthreads();
  }
  phase(stamp++);                             // dP
  if (sa.dprop) {
    float* stage = pt;
    const long long at_v = (sample * n + r0) * n;
    const int count = own * n;
    if (!p.p_transposed) {
      float* dp_s = sa.dprop + sample * n * n + r0;
      for (int e = tid; e < count; e += nthr) {
        const int i = e / own;
        const int j = e - i * own;
        dp_s[static_cast<long long>(i) * n + j] = stage[j * n + i];
      }
    } else if (at_v % 4 == 0 && count % 4 == 0) {
      float4* dst = reinterpret_cast<float4*>(sa.dprop + at_v);
      for (int v = tid; v < count / 4; v += nthr) {
        dst[v] = reinterpret_cast<const float4*>(stage)[v];
      }
    } else {
      for (int v = tid; v < count; v += nthr) sa.dprop[at_v + v] = stage[v];
    }
  }
  phase(stamp++);                             // dP stored
  if (cl > 1) cluster_sync();   // peers may still read this CTA's dz^T
  phase(stamp++);                             // end
}

// out[s][e] = sum over the `slots` slots of set s (in order) of ws[.][e]
__global__ void __launch_bounds__(kReduceThreads)
sum_weight_slots(const float* __restrict__ ws, float* __restrict__ out,
                 int slots, int wsz) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= wsz) return;
  const float* src = ws + static_cast<long long>(blockIdx.y) * slots * wsz + e;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < slots; ++q) s += src[static_cast<long long>(q) * wsz];
  out[static_cast<long long>(blockIdx.y) * wsz + e] = s;
}

// Sets the kernel's dynamic shared-memory limit on `device` the first
// time a launch needs more than was set before.
cudaError_t reserve_shared(int device, int bytes) {
  static std::mutex mu;
  static int reserved[kMaxDevices] = {};
  std::lock_guard<std::mutex> guard(mu);
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && bytes <= reserved[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess && known) reserved[device] = bytes;
  return err;
}

}  // namespace

extern "C" {

// plan: from plan_backward; prop (B, N, N) with batch stride
// p_batch_stride floats, row-major or transposed as plan->p_transposed
// says; x (B, N, dims[0]) contiguous; weights[l] B / group sets of
// (dims[l], dims[l+1]), each contiguous, plan->w_stride[l] floats apart,
// biases[l] sets of (dims[l+1]) plan->b_stride[l] apart; g (B, N, total)
// contiguous. Writes dprop (B, N, N) in P's layout with batch stride N*N,
// dx (B, N, dims[0]) and wgrad (B / group sets of wsz floats: per layer
// dW_l (dims[l] x dims[l+1]) at ws_off[l], db_l after it), each only
// where its pointer is not null; ws is B * cluster slots of wsz floats
// (null exactly when wgrad is). All fp32, on `device`.
int gcn_stack_backward(const BackwardPlan* plan, const float* prop,
                       long long p_batch_stride, const float* x,
                       const float* const* weights, const float* const* biases,
                       const float* g, float* dprop, float* dx, float* ws,
                       float* wgrad, int batch, int device, void* stream) {
  const BackwardPlan& p = *plan;
  if (batch < 0 || p.num_layers < 1 || p.num_layers > kMaxLayers ||
      p.threads < 64 || p.threads > kMaxThreads || p.threads % 64 != 0 ||
      p.cluster < 1 || p.cluster > kMaxCluster || p.ps % 2 != 0 ||
      p.group < 1 || batch % p.group != 0 || (ws == nullptr) != (wgrad == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  BackwardArgs args = {};
  args.plan = p;
  args.prop = prop;
  args.p_batch_stride = p_batch_stride;
  args.x = x;
  args.g = g;
  args.dprop = dprop;
  args.dx = dx;
  args.ws = ws;
  for (int l = 0; l < p.num_layers; ++l) {
    args.w[l] = weights[l];
    args.b[l] = biases[l];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = reserve_shared(device, p.smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch) * p.cluster);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem_bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = p.cluster > 1 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, gcn_stack_backward_kernel, args);
  }
  if (err == cudaSuccess && ws != nullptr) {
    const dim3 grid((p.wsz + kReduceThreads - 1) / kReduceThreads,
                    batch / p.group);
    sum_weight_slots<<<grid, kReduceThreads, 0, s>>>(ws, wgrad,
                                                     p.group * p.cluster, p.wsz);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) cudaGetLastError();   // clear it for the caller
  return static_cast<int>(err);
}

const char* gcn_stack_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef GCN_STACK_PHASES
// Copies the phase stamps of the last launch: ns and clk hold
// ctas * kPhaseSlots values each; returns the cudaError_t.
int gcn_stack_backward_phase_stamps(unsigned long long* ns, long long* clk,
                                    int ctas) {
  const size_t count = sizeof(long long) * kPhaseSlots *
                       static_cast<size_t>(ctas < kPhaseCtas ? ctas : kPhaseCtas);
  cudaError_t err = cudaMemcpyFromSymbol(ns, g_phase_ns, count);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clk, g_phase_clk, count);
  return static_cast<int>(err);
}
#endif

}  // extern "C"
