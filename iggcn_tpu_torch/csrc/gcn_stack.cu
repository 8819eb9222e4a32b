// Fused L-layer dense GCN stack with jumping-knowledge concat, for sm_90a.
//
// Replaces the TPU kernel iggcn_tpu/ops/pallas_gcn.py:_stack_kernel
// (launched by _gcn_stack_pallas, public as fused_gcn_stack). Per sample b:
//   h_0 = x[b];  h_{l+1} = relu(P[b] @ (h_l @ W_l) + b_l);
//   out[b] = concat(h_1, ..., h_L) along the feature axis.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32; each input read once, the
// output written once). The stack is bytes-bound at every shape it runs:
//   serving      B=256 N=90  F0=3 (16,16):    11.52 MB = 3.44 us; 148 MFLOP = 2.2 us
//   training     B=32  N=90  F0=3 (16,16):     1.44 MB = 0.43 us
//   multi-fusion B=256 N=270 F0=1 (10,10,10): 83.2 MB = 24.8 us; 1.12 GFLOP = 16.7 us
// P is nearly all of the bytes, and the fp32 FMAs are within 2x of them.
//
// Design, part by part, against that bound:
// - P is read from device memory once. Each sample runs on a cluster of C
//   CTAs: C = 1 at N=90; C = 2 at N=270, where P is 291 KB against 227 KB
//   per CTA (the smallest cluster that holds P; 4 measured 2-3 % slower).
//   CTA k keeps P's columns [k R, (k+1) R) resident in shared memory
//   for every layer and owns h's rows [k R, (k+1) R), so it computes hW for
//   exactly the rows its columns multiply. With C > 1 each CTA's partial
//   P hW is summed once per layer through distributed shared memory,
//   between two cluster barriers.
// - P is read in the layout the caller has. gcn_propagation_matrix returns
//   P transposed in memory, where a band of P's columns is one block: one
//   cp.async.bulk per CTA, completing on an mbarrier. x, the weights and
//   the biases are queued before it, and h_0 W_0, which needs no P, runs
//   while it lands. A row-major P comes in by 4-byte cp.asyncs.
// - Register-tiled outer products: a thread owns an 8 x 4 tile of P hW; per
//   step four 8-byte loads of P's column and one 16-byte load of hW's row
//   feed 32 FMAs. K is split over KS = 1, 2 or 4 adjacent lanes (steps
//   interleaved, so the lanes of a warp hit different banks) to give the
//   SM enough warps, and a shuffle reduce-scatter leaves each lane 8/KS
//   finished rows. h is kept transposed, so h W_l runs the same loop.
//   N, K and widths are zero-padded in shared memory: no inner branches.
// - The JK output is staged in shared memory and written once at the end,
//   as one coalesced block per CTA.
// - Nothing is packed per call: the weight and bias pointers travel in the
//   kernel's parameters (copied to shared memory by all threads at once),
//   and the shared-memory attribute is set once per device and size.
// Accumulation is plain fp32 FMA (no TF32, no tensor cores) in the order
// h @ W first, then P @ (h W), as the TPU kernel did.
//
// The launch plan (cluster, band width, K split, threads, shared-memory
// offsets) is computed in Python (ops/gcn_stack.py:plan_launch) and passed
// as a StackPlan. C interface (bound with ctypes): gcn_stack_forward
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns the cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxLayers = 8;
constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kTileRows = 8;   // a thread's register tile: 8 rows x 4 columns
constexpr int kGather = 4;     // x values a thread loads in one round
constexpr int kMaxCluster = 8;

// Outside the anonymous namespace: the C entry point takes a StackPlan,
// and a type with internal linkage would give it internal linkage too.
// Field for field the ctypes structure _CPlan in ops/gcn_stack.py. Offsets
// are in floats from the start of dynamic shared memory, where P's band
// of columns starts.
struct StackPlan {
  int n, num_layers, cluster;
  int rows;          // P columns (= h rows) per CTA: [rank * rows, ...)
  int ksplit;        // lanes that share a tile, each summing a slice of K
  int kpad;          // rows rounded up: K of the tile loop, zero-padded
  int threads, smem_bytes;
  int ps;            // column stride of P in shared memory (N, even)
  int n8;            // N rounded up to kTileRows: rows of the tile loop
  int hs;            // widest layer rounded up to 4; row stride of part
  int hws;           // row stride of hW (padded: K-slices on other banks)
  int hts;           // row stride of h^T (kpad + 2: rows on other banks)
  int total;         // JK output width, sum of H_l
  int p_transposed;  // P's memory holds P^T row by row
  int copy_bulk;     // the band is one 16-byte-aligned block: bulk copy
  int off_part;      // n8 x hs: this CTA's partial P hW (cluster > 1)
  int off_hw;        // kpad x hws: hW of this CTA's rows
  int off_h;         // hs x hts: this CTA's rows of h, transposed
  int off_o;         // rows x total: this CTA's rows of the JK output
  int dims[kMaxLayers + 1];
  int fout_p[kMaxLayers];
  int off_w[kMaxLayers];
  int off_b[kMaxLayers];
  int out_off[kMaxLayers];
};

struct StackArgs {
  StackPlan plan;
  const float* prop;
  long long p_batch_stride;
  const float* x;
  float* out;
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
};

namespace {

// Built with -DGCN_STACK_PHASES (tools/gcn_stack_phases.py does), thread 0
// of every CTA records %globaltimer and clock64 at the phase boundaries
// below; otherwise phase() compiles to nothing.
#ifdef GCN_STACK_PHASES
constexpr int kPhaseSlots = 32;
constexpr int kPhaseCtas = 4096;
__device__ unsigned long long g_phase_ns[kPhaseCtas * kPhaseSlots];
__device__ long long g_phase_clk[kPhaseCtas * kPhaseSlots];
__device__ __forceinline__ void phase(int slot) {
  if (threadIdx.x == 0 && blockIdx.x < kPhaseCtas) {
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
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
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

// acc[r][c] += sum_{j < k} a[j * a_stride + r] * b[j * b_stride + c], in
// ascending j, for a TR x 4 register tile: per step, TR/2 8-byte loads of
// a and one 16-byte load of b feed 4 TR FMAs. a is 8-byte, b 16-byte
// aligned; k is a multiple of 4 (the operands are zero-padded). The plain
// unrolled loop lets the compiler keep the next steps' loads in flight
// (hand-written double buffering measured slower; PERF.md).
template <int TR>
__device__ __forceinline__ void mac_tile(const float* a, int a_stride,
                                         const float* b, int b_stride, int k,
                                         float (&acc)[TR][4]) {
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float4 bv = *reinterpret_cast<const float4*>(b + j * b_stride);
    float av[TR];
#pragma unroll
    for (int h = 0; h < TR; h += 2) {
      const float2 v = *reinterpret_cast<const float2*>(a + j * a_stride + h);
      av[h] = v.x;
      av[h + 1] = v.y;
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      acc[r][0] = fmaf(av[r], bv.x, acc[r][0]);
      acc[r][1] = fmaf(av[r], bv.y, acc[r][1]);
      acc[r][2] = fmaf(av[r], bv.z, acc[r][2]);
      acc[r][3] = fmaf(av[r], bv.w, acc[r][3]);
    }
  }
}

// The KS lanes of a tile (lane % KS = slice) hold partial sums of all its
// rows; afterwards lane `slice` holds in acc[0, 8/KS) the full sums of
// rows [slice * 8/KS, (slice + 1) * 8/KS). Each round trades half the live
// rows with the partner lane: 16 + 8 shuffles for KS = 4, not 64.
template <int KS>
__device__ __forceinline__ void reduce_scatter(float (&acc)[kTileRows][4],
                                               int slice) {
  int live = kTileRows;
#pragma unroll
  for (int m = KS / 2; m >= 1; m /= 2) {
    const bool upper = (slice & m) != 0;
    live /= 2;
#pragma unroll
    for (int r = 0; r < kTileRows / 2; ++r) {
      if (r >= live) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float send = upper ? acc[r][c] : acc[live + r][c];
        const float keep = upper ? acc[live + r][c] : acc[r][c];
        acc[r][c] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
    }
  }
}

template <int KS>
__global__ void __launch_bounds__(kMaxThreads)
gcn_stack_kernel(const __grid_constant__ StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ StackArgs sa;
  __shared__ alignas(8) unsigned long long p_ready;
  phase(0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // The parameters into shared memory, one word per thread: their loads
  // miss the constant cache together instead of one after another.
  for (int w = tid; w < static_cast<int>(sizeof(StackArgs) / 4); w += nthr) {
    reinterpret_cast<int*>(&sa)[w] = reinterpret_cast<const int*>(&a)[w];
  }
  if (tid == 0) mbar_init(&p_ready);
  __syncthreads();
  const StackPlan& p = sa.plan;
  const int n = p.n, rows = p.rows, kpad = p.kpad, ps = p.ps, hs = p.hs;
  const int hws = p.hws, hts = p.hts;
  const int cl = p.cluster;
  const int rank = cl > 1 ? cluster_rank() : 0;
  const long long sample = blockIdx.x / cl;
  const int r0 = rank * rows;                 // first column of P it owns
  const int own = min(n, r0 + rows) - r0;     // >= 1, by the plan
  float* pt = smem;                           // pt[j * ps + i] = P[i][r0 + j]
  float* part = smem + p.off_part;            // part[i * hs + c]
  float* hw = smem + p.off_hw;                // hw[j * hws + c] = (hW)[r0 + j][c]
  float* ht = smem + p.off_h;                 // ht[f * hts + j] = h[r0 + j][f]
  float* os = smem + p.off_o;                 // os[j * total + c] = out[r0 + j][c]
  const float* prop_s = sa.prop + sample * sa.p_batch_stride;

  // 1. Queued first, so that they do not wait behind P: the weights and
  //    biases, zero-padded to multiples of 4, as 4-byte cp.asyncs, and
  //    h_0 = x for this CTA's rows into registers (all of a thread's loads
  //    in flight together), then into h^T.
  {
    for (int l = 0; l < p.num_layers; ++l) {
      const int fin = p.dims[l], fout = p.dims[l + 1], fp = p.fout_p[l];
      float* ws = smem + p.off_w[l];
      for (int idx = tid; idx < ((fin + 3) & ~3) * fp; idx += nthr) {
        const int f = idx / fp;
        const int c = idx - f * fp;
        if (f < fin && c < fout) cp_async_4(ws + idx, sa.w[l] + f * fout + c);
        else ws[idx] = 0.f;
      }
      float* bs = smem + p.off_b[l];
      for (int c = tid; c < fp; c += nthr) {
        if (c < fout) cp_async_4(bs + c, sa.b[l] + c);
        else bs[c] = 0.f;
      }
    }
    const int f0 = p.dims[0];
    const int nx = own * f0;                  // x's rows are contiguous
    const float* x_s = sa.x + (sample * n + r0) * f0;
    float v[kGather];
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int e = k * nthr + tid;
      v[k] = e < nx ? x_s[e] : 0.f;
    }
    // 2. P's columns [r0, r0 + own). In the transposed layout they are
    //    one block of memory: one bulk copy.
    if (p.copy_bulk && tid == 0) {
      bulk_load(pt, prop_s + static_cast<long long>(r0) * n,
                static_cast<unsigned>(own * n * 4), &p_ready);
    }
    for (int idx = tid; idx < hs * hts; idx += nthr) {
      const int f = idx / hts;
      if (f >= f0 || idx - f * hts >= own) ht[idx] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kGather; ++k) {
      const int e = k * nthr + tid;
      if (e < nx) ht[(e % f0) * hts + e / f0] = v[k];
    }
    for (int e = kGather * nthr + tid; e < nx; e += nthr) {
      ht[(e % f0) * hts + e / f0] = x_s[e];
    }
  }
  cp_async_wait_all();

  //    Otherwise P comes as 4-byte cp.asyncs, queued now that the weights
  //    have landed; they complete while h_0 W_0 runs.
  if (!p.copy_bulk && p.p_transposed) {
    for (int idx = tid; idx < own * n; idx += nthr) {
      const int j = idx / n;
      const int i = idx - j * n;
      cp_async_4(pt + j * ps + i, prop_s + static_cast<long long>(r0 + j) * n + i);
    }
  } else if (!p.copy_bulk) {
    // row-major: coalesced reads along P's rows, transposed into place
    for (int idx = tid; idx < n * own; idx += nthr) {
      const int i = idx / own;
      const int j = idx - i * own;
      cp_async_4(pt + j * ps + i, prop_s + static_cast<long long>(i) * n + r0 + j);
    }
  }
  // zero columns [own, kpad) of the band, and the slack the tile loop's
  // pad rows read past the last column
  for (int idx = own * ps + tid; idx < kpad * ps + 8; idx += nthr) pt[idx] = 0.f;

  __syncthreads();
  phase(1);                                   // x and the weights are in

  const int kq = kpad / KS;
  for (int l = 0; l < p.num_layers; ++l) {
    const int fin4 = (p.dims[l] + 3) & ~3;
    const int fout = p.dims[l + 1];
    const int col_tiles = p.fout_p[l] / 4;
    const float* wl = smem + p.off_w[l];
    const float* bl = smem + p.off_b[l];
    float* os_l = os + p.out_off[l];

    // 3. hW for this CTA's rows (its pad rows of h are zero, so theirs
    //    is), in 2 x 4 tiles: K is short, so many small tiles keep every
    //    thread busy
    for (int t = tid; t < (kpad / 2) * col_tiles; t += nthr) {
      const int i0 = (t / col_tiles) * 2;
      const int c0 = (t % col_tiles) * 4;
      float acc[2][4] = {};
      mac_tile<2>(ht + i0, hts, wl + c0, p.fout_p[l], fin4, acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float4*>(hw + (i0 + r) * hws + c0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    phase(2 + 3 * l);                         // hW done
    if (l == 0) {
      cp_async_wait_all();
      if (p.copy_bulk) mbar_wait_phase0(&p_ready);
    }
    __syncthreads();
    phase(3 + 3 * l);                         // P in (layer 0)

    // 4. P[:, band] hW for every row: KS adjacent lanes share an 8 x 4
    //    tile, lane s summing the band's steps j = s (mod KS), then a
    //    shuffle reduce-scatter leaves each lane 8/KS finished rows.
    //    Interleaved steps put the lanes of a warp on neighbouring rows of
    //    hW and columns of P, clear of each other's banks. Every thread
    //    runs the same number of rounds, so the shuffles see full warps.
    const int work = (p.n8 / kTileRows) * col_tiles * KS;
    for (int base = 0; base < work; base += nthr) {
      const int t = base + tid;
      const bool active = t < work;
      const int tile = t / KS;
      const int slice = t % KS;
      const int i0 = (tile / col_tiles) * kTileRows;
      const int c0 = (tile % col_tiles) * 4;
      float acc[kTileRows][4] = {};
      if (active) {
        mac_tile<kTileRows>(pt + i0 + slice * ps, ps * KS,
                            hw + c0 + slice * hws, hws * KS, kq, acc);
      }
      reduce_scatter<KS>(acc, slice);
      if (!active) continue;
#pragma unroll
      for (int r = 0; r < kTileRows / KS; ++r) {
        const int i = i0 + slice * (kTileRows / KS) + r;
        if (i >= n) continue;
        if (cl > 1) {   // this CTA's share of row i
          *reinterpret_cast<float4*>(part + i * hs + c0) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
          continue;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // the whole sum: h_{l+1} row i
          const float v = fmaxf(acc[r][c] + bl[c0 + c], 0.f);
          ht[(c0 + c) * hts + i] = v;
          if (c0 + c < fout) os_l[i * p.total + c0 + c] = v;
        }
      }
    }

    // 5. cluster: h_{l+1} for this CTA's rows is the sum, in rank order, of
    //    every CTA's partial for those rows, read once through distributed
    //    shared memory.
    if (cl > 1) {
      cluster_sync();           // every partial is written
      for (int idx = tid; idx < own * col_tiles; idx += nthr) {
        const int j = idx / col_tiles;
        const int c0 = (idx % col_tiles) * 4;
        const int at = (r0 + j) * hs + c0;
        float4 got[kMaxCluster];   // all loads in flight, then the sum
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          if (q < cl) {
            got[q] = *reinterpret_cast<const float4*>(
                (q == rank ? part : peer_ptr(part, q)) + at);
          }
        }
        float4 sum = got[0];
#pragma unroll
        for (int q = 1; q < kMaxCluster; ++q) {
          if (q < cl) {
            sum.x += got[q].x; sum.y += got[q].y;
            sum.z += got[q].z; sum.w += got[q].w;
          }
        }
        const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = fmaxf(s4[c] + bl[c0 + c], 0.f);
          ht[(c0 + c) * hts + j] = v;
          if (c0 + c < fout) os_l[j * p.total + c0 + c] = v;
        }
      }
      cluster_sync();           // no CTA reads a peer's partial after this
    } else {
      __syncthreads();
    }
    phase(4 + 3 * l);                         // h_{l+1} done
  }

  // 6. This CTA's rows of the JK output are one block of memory: write it
  //    with coalesced stores, 16 bytes each where it is aligned.
  const long long at = (sample * n + r0) * p.total;
  const int count = own * p.total;
  float* dst = sa.out + at;
  if (at % 4 == 0 && count % 4 == 0) {
    for (int v = tid; v < count / 4; v += nthr) {
      reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(os)[v];
    }
  } else {
    for (int v = tid; v < count; v += nthr) dst[v] = os[v];
  }
  phase(2 + 3 * p.num_layers);                // output written
}

// Sets the kernel's dynamic shared-memory limit on `device` the first
// time a launch needs more than was set before.
template <int KS>
cudaError_t reserve_shared(int device, int bytes) {
  static std::mutex mu;
  static int reserved[kMaxDevices] = {};
  std::lock_guard<std::mutex> guard(mu);
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && bytes <= reserved[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) reserved[device] = bytes;
  return err;
}

template <int KS>
cudaError_t launch(const StackArgs& args, int batch, int device,
                   cudaStream_t stream) {
  const StackPlan& p = args.plan;
  const cudaError_t err = reserve_shared<KS>(device, p.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * p.cluster);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, gcn_stack_kernel<KS>, args);
}

}  // namespace

extern "C" {

// plan: from plan_launch; prop (B, N, N) fp32 with batch stride
// p_batch_stride floats, row-major or transposed as plan->p_transposed
// says; x (B, N, dims[0]) contiguous; weights[l] (dims[l], dims[l+1]) and
// biases[l] (dims[l+1]) contiguous; out (B, N, total) contiguous; all on
// `device`.
int gcn_stack_forward(const StackPlan* plan, const float* prop,
                      long long p_batch_stride, const float* x,
                      const float* const* weights, const float* const* biases,
                      float* out, int batch, int device, void* stream) {
  const StackPlan& p = *plan;
  if (batch < 0 || p.num_layers < 1 || p.num_layers > kMaxLayers ||
      p.threads < 32 || p.threads > kMaxThreads || p.cluster < 1 ||
      p.cluster > kMaxCluster || p.rows % kTileRows != 0 || p.n8 % kTileRows != 0 ||
      (p.ksplit != 1 && p.ksplit != 2 && p.ksplit != 4) ||
      p.kpad % (4 * p.ksplit) != 0 || p.ps % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  StackArgs args = {};
  args.plan = p;
  args.prop = prop;
  args.p_batch_stride = p_batch_stride;
  args.x = x;
  args.out = out;
  for (int l = 0; l < p.num_layers; ++l) {
    args.w[l] = weights[l];
    args.b[l] = biases[l];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = p.ksplit == 4   ? launch<4>(args, batch, device, s)
          : p.ksplit == 2 ? launch<2>(args, batch, device, s)
                          : launch<1>(args, batch, device, s);
  }
  if (err != cudaSuccess) cudaGetLastError();   // clear it for the caller
  return static_cast<int>(err);
}

const char* gcn_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef GCN_STACK_PHASES
// Copies the phase stamps of the last launch: ns and clk hold
// ctas * kPhaseSlots values each; returns the cudaError_t.
int gcn_stack_phase_stamps(unsigned long long* ns, long long* clk, int ctas) {
  const size_t count = sizeof(long long) * kPhaseSlots *
                       static_cast<size_t>(ctas < kPhaseCtas ? ctas : kPhaseCtas);
  cudaError_t err = cudaMemcpyFromSymbol(ns, g_phase_ns, count);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clk, g_phase_clk, count);
  return static_cast<int>(err);
}
#endif

}  // extern "C"
