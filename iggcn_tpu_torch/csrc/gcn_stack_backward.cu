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
// - The recompute sums each CTA's partial P a through distributed shared
//   memory, as csrc/gcn_stack.cu does, and keeps a_l for every layer (a^T,
//   for dP) and h_l (h^T, for dW and the relu masks) for its rows; the last
//   layer's output only gives the mask of dz_{L-1}, formed at once from g.
// - dz is kept for every row and layer (dz^T, sum H x N): its CTA's rows
//   start as g's (read once, all loads in flight), a CTA finishes its rows
//   of a layer, then gathers the other CTAs' rows of it through
//   distributed shared memory after one cluster barrier. da_l = P^T dz_l
//   for the CTA's rows then needs only its own band, and so does dP's
//   block of columns, staged in the band's space once P is read for the
//   last time and written once with coalesced stores (in the transposed
//   layout one contiguous block per CTA).
// - dW_l and db_l are summed over each CTA's rows into its own slot of a
//   workspace; a second small kernel sums the slots of each weight set in
//   a fixed order. No float atomics: two runs give bit-equal gradients.
// - Grouped weights (the fold-parallel trainer): sample s reads weight set
//   s / group at w_stride / b_stride floats per set (0: shared), and the
//   second kernel sums per set.
// - Arithmetic: plain fp32 FMAs (no TF32, no tensor cores) in 4 x 4
//   register tiles, the reduction dimension split over up to 32 adjacent
//   lanes and summed by a shuffle butterfly where the tiles are too few to
//   occupy the CTA. Operands are laid out (P's band column-major, a^T,
//   h^T, dz^T with padded strides) so that each product's inner loop reads
//   one operand as 8- or 16-byte vectors.
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// C(m, n) = sum_{k < kn} A(m, k) B(k, n) for m < mn, n < nn, in 4 x 4
// register tiles, with A(m, k) = a[m * am + k * ak] and B(k, n) =
// b[k * bk + n * bn]. AVec: am == 1 and pairs 8-byte aligned, so A's four
// values come in two 8-byte loads; BVec: bn == 1 and b + k * bk + n0
// 16-byte aligned, one 16-byte load. Reads of m and n up to the next
// multiple of 4 must stay in shared memory: what they find reaches only
// outputs that are not stored (epi checks m < mn, n < nn). ks adjacent
// lanes share a tile, lane s summing k = s, s + ks, ... in ascending
// order, then a shuffle butterfly gives every lane the full sums and
// lane 0 of the tile hands them to epi(m0, n0, acc). Every thread runs
// the same rounds, so the shuffles see full warps.
template <bool AVec, bool BVec, typename Epi>
__device__ __forceinline__ void product(int mn, int nn, int kn,
                                        const float* a, int am, int ak,
                                        const float* b, int bk, int bn,
                                        Epi epi) {
  const int nt = (nn + 3) >> 2;
  const int tiles = ((mn + 3) >> 2) * nt;
  const int nthr = blockDim.x;
  int lg = 0;   // ks = 2^lg: enough lanes to occupy the CTA, >= 2 steps each
  while (lg < 5 && (tiles << (lg + 1)) <= nthr && (4 << lg) <= kn) ++lg;
  const int ks = 1 << lg;
  const int work = tiles << lg;
  for (int base = 0; base < work; base += nthr) {
    const int t = base + static_cast<int>(threadIdx.x);
    const bool active = t < work;
    const int tile = t >> lg;
    const int slice = t & (ks - 1);
    const int m0 = (tile / nt) * 4;
    const int n0 = (tile % nt) * 4;
    float acc[4][4] = {};
    if (active) {
      const float* ap = a + m0 * am;
      const float* bp = b + n0 * bn;
#pragma unroll 2
      for (int k = slice; k < kn; k += ks) {
        float av[4], bv[4];
        if constexpr (AVec) {
          const float2 lo = *reinterpret_cast<const float2*>(ap + k * ak);
          const float2 hi = *reinterpret_cast<const float2*>(ap + k * ak + 2);
          av[0] = lo.x; av[1] = lo.y; av[2] = hi.x; av[3] = hi.y;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) av[r] = ap[r * am + k * ak];
        }
        if constexpr (BVec) {
          const float4 v = *reinterpret_cast<const float4*>(bp + k * bk);
          bv[0] = v.x; bv[1] = v.y; bv[2] = v.z; bv[3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bp[k * bk + c * bn];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
      }
    }
    for (int m = ks >> 1; m >= 1; m >>= 1) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], m);
        }
      }
    }
    if (active && slice == 0) epi(m0, n0, acc);
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

  // 1. The weights and biases of this sample's set, zero-padded, as 4-byte
  //    cp.asyncs; x's rows of this CTA into h^T; then P's band: one bulk
  //    copy where it is one aligned block, else 4-byte cp.asyncs.
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
    for (int e = tid; e < own * f0; e += nthr) {
      ht[(e % f0) * ats + e / f0] = x_s[e];
    }
  }
  if (p.copy_bulk) {
    if (tid == 0) {
      bulk_load(pt, band, static_cast<unsigned>(own * n * 4), &p_ready);
    }
  } else if (p.p_transposed) {
    for (int idx = tid; idx < own * n; idx += nthr) {
      const int j = idx / n;
      cp_async_4(pt + j * ps + (idx - j * n), band + idx);
    }
  } else {
    // row-major: coalesced reads along P's rows, transposed into place
    for (int idx = tid; idx < n * own; idx += nthr) {
      const int i = idx / own;
      const int j = idx - i * own;
      cp_async_4(pt + j * ps + i, prop_s + static_cast<long long>(i) * n + r0 + j);
    }
  }
  cp_async_wait_all();
  if (p.copy_bulk) mbar_wait_phase0(&p_ready);
  __syncthreads();
  phase(stamp++);                             // prologue: P, x, W in

  // 2. The recompute, layer by layer: a_l = h_l W_l for this CTA's rows
  //    (into a^T), then z_l = P a_l + b_l. A relu'd z is h_{l+1} (into h^T);
  //    the last layer's goes to da's space, where it waits for the mask of
  //    dz_{L-1}.
  for (int l = 0; l < L; ++l) {
    const int fp = p.fout_p[l];
    const float* wl = smem + p.off_w[l];
    const float* bl = smem + p.off_b[l];
    float* at_l = at + p.dz_off[l] * ats;
    product<true, true>(own, fp, p.dims[l], ht + p.h_off[l] * ats, 1, ats,
                        wl, fp, 1, [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (m0 + r >= own) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) at_l[(n0 + c) * ats + m0 + r] = acc[r][c];
      }
    });
    __syncthreads();
    phase(stamp++);                           // recompute: a_l
    const bool last = l == L - 1;
    float* h_next = last ? nullptr : ht + p.h_off[l + 1] * ats;
    const int fout = p.dims[l + 1];
    auto store_h = [&](int j, int c, float z) {
      const float h = fmaxf(z + bl[c], 0.f);
      if (last) da[j * das + c] = h;
      else h_next[c * ats + j] = h;
    };
    product<true, false>(n, fp, own, pt, 1, ps, at_l, 1, ats,
                         [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (m0 + r >= n) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cl > 1) part[(m0 + r) * hmax + n0 + c] = acc[r][c];
          else if (n0 + c < fout) store_h(m0 + r, n0 + c, acc[r][c]);
        }
      }
    });
    if (cl > 1) {
      // h_{l+1} of this CTA's rows: every CTA's partial for them, summed
      // in rank order through distributed shared memory
      cluster_sync();
      for (int idx = tid; idx < own * fout; idx += nthr) {
        const int j = idx / fout;
        const int c = idx - j * fout;
        const int at_i = (r0 + j) * hmax + c;
        float z = 0.f;
        for (int q = 0; q < cl; ++q) {
          z += (q == rank ? part : peer_ptr(part, q))[at_i];
        }
        store_h(j, c, z);
      }
      cluster_sync();   // no CTA reads a peer's partial after this
    } else {
      __syncthreads();
    }
    phase(stamp++);                           // recompute: z_l, h_{l+1}
  }

  // 3. dz^T zeroed (its pad rows stay 0: dP's product runs over them),
  //    then this CTA's rows of every layer set to g's slice of that layer:
  //    g's rows of this CTA are one block, read once with kGather loads of
  //    each thread in flight together (the epilogues below read it from
  //    here). dz_{L-1} is that slice where z_{L-1} > 0.
  for (int idx = tid; idx < p.tot_p * dts; idx += nthr) dzt[idx] = 0.f;
  __syncthreads();
  {
    const int count = own * p.total;
    for (int base = 0; base < count; base += kGather * nthr) {
      float v[kGather];
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int e = base + k * nthr + tid;
        v[k] = e < count ? g_s[e] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int e = base + k * nthr + tid;
        if (e >= count) continue;
        const int j = e / p.total;
        const int col = e - j * p.total;
        int l = 0;
        while (l + 1 < L && col >= p.out_off[l + 1]) ++l;
        dzt[(p.dz_off[l] + col - p.out_off[l]) * dts + r0 + j] = v[k];
      }
    }
  }
  __syncthreads();
  {
    const int hl = p.dims[L];
    float* dz_l = dzt + p.dz_off[L - 1] * dts + r0;
    for (int idx = tid; idx < own * hl; idx += nthr) {
      const int j = idx / hl;
      const int c = idx - j * hl;
      if (!(da[j * das + c] > 0.f)) dz_l[c * dts + j] = 0.f;
    }
  }
  phase(stamp++);                             // g into dz^T, dz_{L-1}

  // 4. Layer by layer, last first.
  float* slot = sa.ws ? sa.ws + (sample * cl + rank) * p.wsz : nullptr;
  for (int l = L - 1; l >= 0; --l) {
    const int fin = p.dims[l], fout = p.dims[l + 1], fp = p.fout_p[l];
    float* dz_l = dzt + p.dz_off[l] * dts;
    if (cl > 1) {
      // the other CTAs' rows of dz_l, through distributed shared memory
      cluster_sync();
      for (int idx = tid; idx < fout * n; idx += nthr) {
        const int c = idx / n;
        const int i = idx - c * n;
        const int q = i / rows;
        if (q != rank) dz_l[c * dts + i] = peer_ptr(dz_l, q)[c * dts + i];
      }
    }
    __syncthreads();
    if (slot) {   // db_l: this CTA's rows, a warp a column
      const int lane = tid & 31;
      for (int c = tid >> 5; c < fout; c += nthr >> 5) {
        float s = 0.f;
        for (int j = lane; j < own; j += 32) s += dz_l[c * dts + r0 + j];
#pragma unroll
        for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
        if (lane == 0) slot[p.ws_off[l] + fin * fout + c] = s;
      }
    }
    phase(stamp++);                           // gather dz_l, db_l
    // da_l = P^T dz_l for this CTA's rows
    product<false, false>(own, fp, n, pt, ps, 1, dz_l, 1, dts,
                          [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (m0 + r >= own) continue;
        *reinterpret_cast<float4*>(da + (m0 + r) * das + n0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    });
    __syncthreads();
    phase(stamp++);                           // da_l
    const float* h_l = ht + p.h_off[l] * ats;
    if (slot) {   // dW_l = h_l^T da_l over this CTA's rows
      float* dw = slot + p.ws_off[l];
      product<false, true>(fin, fout, own, h_l, ats, 1, da, das, 1,
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
    phase(stamp++);                           // dW_l
    // e_l = da_l W_l^T: dx for l = 0; else, with g's slice of layer l - 1
    // (in dz^T since step 3) and h_l's mask, dz_{l-1} of this CTA's rows
    if (l > 0 || sa.dx) {
      const float* wl = smem + p.off_w[l];
      float* dz_prev = dzt + p.dz_off[l > 0 ? l - 1 : 0] * dts + r0;
      float* dx_s = l > 0 ? nullptr : sa.dx + (sample * n + r0) * fin;
      product<false, false>(own, fin, fout, da, das, 1, wl, 1, fp,
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
    phase(stamp++);                           // e_l: dz_{l-1} or dx
  }

  // 5. dP's columns of this CTA's band: dP[i][r0 + j] = sum_c a[r0 + j][c]
  //    dz[i][c], over every layer's columns at once, staged in the band's
  //    space (P is not read again: stage[j * n + i]), then written with
  //    coalesced stores: in the transposed layout one block of own * n
  //    values, 16 bytes a store where it is aligned.
  if (sa.dprop) {
    float* stage = pt;
    product<true, true>(own, n, p.tot_p, at, 1, ats, dzt, dts, 1,
                        [&](int m0, int n0, float (&acc)[4][4]) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (m0 + r < own && n0 + c < n) {
            stage[(m0 + r) * n + n0 + c] = acc[r][c];
          }
        }
      }
    });
    __syncthreads();
    phase(stamp++);                           // dP
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
      p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 != 0 ||
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
