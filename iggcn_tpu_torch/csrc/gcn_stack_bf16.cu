// The GCN stack's bf16-operand form: persistent CTAs, each taking its
// samples one after another through a stage filled by bulk copies, for
// sm_90a.
//
// Replaces the TPU kernel iggcn_tpu/ops/pallas_gcn.py:_stack_kernel under
// bf16 serving (iggcn_tpu/predict.py cast_floating: bf16 P, x, W_l and b_l,
// products with preferred_element_type=float32). Per sample b:
//   h_0 = x[b];  h_{l+1} = relu(P[b] @ (h_l @ W_l) + b_l);
//   out[b] = concat(h_1, ..., h_L) along the feature axis,
// in fp32 FMAs on the bf16 values (h W first, then P (h W), as the TPU
// kernel did), with fp32 activations between layers and an fp32 output.
// No tensor cores: the second layer's h is fp32, and an MMA would round it.
//
// Bound on an H100 (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s;
// bf16 inputs read once, the fp32 output written once). The FMAs bound it:
//   serving      B=256 N=90  F0=3 (16,16):    148 MFLOP = 2.21 us; 7.24 MB = 2.16 us
//   multi-fusion B=256 N=270 F0=1 (10,10,10): 1.15 GFLOP = 17.2 us; 45.8 MB = 13.7 us
// A sample is 0.3 M FMAs at N=90 and 2.3-2.7 M at N=270: 1.2 and 10-11 us of
// one SM's 128 FMAs per cycle, about two samples per SM at B=256.
//
// Design, part by part, against that bound (ops/gcn_stack.py:plan_launch
// computes the plan; csrc/gcn_stack.cu, the fp32 form, also takes bf16 N
// too large for one CTA, on a cluster):
// - Loads overlapped with compute. The grid is persistent: CTAs = SMs x
//   CTAs per SM (or B, if fewer); CTA c widens the weights once and takes
//   samples c, c + grid, ... One stage holds a sample's bf16 P; thread 0
//   fills it with cp.async.bulk, completing on one mbarrier whose parity
//   flips with every use (the CTA's sample u waits on parity u & 1). The
//   stage is refilled with the CTA's next sample once every thread is done
//   with it (after the last layer, behind a __syncthreads), and the next
//   sample's x is loaded into registers at that point and stored after the
//   output; that copy is in flight while the output is stored and the next
//   h_0 W_0 (which needs no P) runs, and at N=90 the SM's other CTA
//   computes meanwhile. A ring of 2-4 stages (N=90; at N=270 a stage is 147 KB and
//   only one fits) was built and measured no faster at B=256 and at the
//   874-subject cohort in one launch (PERF.md), so the kernel has one.
//   The first sample of each CTA is the only load that nothing hides; at
//   B=256 and N=90 (264 resident CTAs) that is every CTA's only sample.
// - P read in place, as bf16. The tile loop reads P's bf16 value pairs (one
//   4-byte load for two values, two integer ops to widen them) and hW's
//   rows as 16-byte loads: per step of a thread's 8 x 4 register tile, four
//   pair loads and one 16-byte load feed 32 FMAs. Widening each sample once
//   into an fp32 band (96 x 90 x 4 = 34.6 KB at N=90; 291.6 KB does not fit
//   at N=270), so that the loop reads fp32 pairs, was built and measured
//   slower at N=90, B=256 and B=874, at 64 registers a thread (PERF.md), so
//   the kernel has no such band.
// - Registers before warps. K is split over KS = 2 or 4 adjacent lanes (a
//   shuffle reduce-scatter joins them), the widest split that fits: 4 at
//   both serving shapes, 2 at wider layers (N=90 at widths 64). A CTA has
//   at most 512 threads, so the compiler may use 128 registers a thread
//   and keep the next steps' loads in flight: at 64 (1024 threads, K split
//   8, twice the warps) the same loop measured 6 % slower at N=90, B=256,
//   and within 2 % at N=270 (PERF.md). ptxas (sm_90a; chip_smoke.py prints
//   its report) gives both instances 93 registers and no spills.
//   N=90 runs CTAs of 6 warps, two to an SM at B=256; N=270 one CTA of 13.
// - A sample's P is only 2-byte aligned in bf16 (16,200 bytes at N=90).
//   In the transposed layout the sample's N x N values are the band itself,
//   one block of memory, so the bulk copy takes its 16-byte-aligned
//   interior, and up to 7 values on either side (the head and tail) are
//   plain loads by threads, stored into the stage before a __syncthreads
//   that precedes its use; the stage holds the sample `lead` values in, so
//   that the interior lands 16-byte aligned (and value pairs 4-byte aligned
//   where the sample starts 4-byte aligned). Nothing outside the sample is
//   read. K's pad columns read the stage's slack after the sample, times
//   zero rows of hW: it holds zeros (the prologue zeroes it, and a refill
//   zeroes the 8 values after its sample, where one of another lead left
//   values), so that no earlier sample's value, finite or not, reaches a
//   sum. Threads that write a stage (zeros, edges) fence the async proxy
//   before the barrier after which thread 0 may copy into it.
// - Row-major P, odd N and samples 2 bytes off come value by value into
//   the stage, transposed into place (no bulk copy).
// - The JK output of a sample is staged in shared memory and written once,
//   with coalesced 16-byte stores.
// Accumulation is plain fp32 FMA in the order h @ W first, then P @ (h W),
// ascending in K within each of the KS slices.
//
// C interface (bound with ctypes): gcn_stack_bf16_forward launches on the
// caller's stream, never synchronises, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxLayers = 8;
// at most 512 threads, so that the compiler may spend 128 registers a
// thread on keeping the tile loop's next loads in flight
constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kTileRows = 8;  // a thread's register tile: 8 rows x 4 columns
// values after a sample that a refill zeroes (lead < 8); with a sample's
// head and tail (under 16 bytes each: at most 14 values) 22 threads, fewer
// than a CTA's 32
constexpr int kSlackVals = 8;
constexpr int kXCarry = 2;    // x values a thread carries to the next sample
constexpr int kGather = 4;    // parameter values a thread loads at once

// Outside the anonymous namespace: the C entry point takes a Bf16Plan.
// Field for field the ctypes structure _CBf16Plan in ops/gcn_stack.py.
// Offsets are in floats from the start of dynamic shared memory, where the
// stage starts.
struct Bf16Plan {
  int n, num_layers;
  int ksplit;        // lanes that share a tile, each summing a slice of K
  int kpad;          // N rounded up: K of the tile loop, zero-padded
  int threads, smem_bytes;
  int grid;          // persistent CTAs: CTA c takes samples c, c + grid, ...
  int copy_bulk;     // 1: samples come by bulk copy; 0: value by value
  int p_transposed;  // P's memory holds P^T row by row
  int ps;            // column stride of P in a stage (even)
  int n8;            // N rounded up to kTileRows: rows of the tile loop
  int hs;            // widest layer rounded up to 4
  int hws;           // row stride of hW (K-slices on other banks)
  int hts;           // row stride of h^T
  int total;         // JK output width, sum of H_l
  int stage_vals;    // bf16 values per stage (a multiple of 8)
  int off_hw;        // kpad x hws: hW
  int off_h;         // hs x hts: h, transposed
  int off_o;         // n x total: the JK output
  int dims[kMaxLayers + 1];
  int fout_p[kMaxLayers];
  int off_w[kMaxLayers];
  int off_b[kMaxLayers];
  int out_off[kMaxLayers];
};

struct Bf16Args {
  Bf16Plan plan;
  const __nv_bfloat16* prop;
  long long p_batch_stride;
  const __nv_bfloat16* x;
  float* out;
  long long batch;
  const __nv_bfloat16* w[kMaxLayers];
  const __nv_bfloat16* b[kMaxLayers];
};

namespace {

// Built with -DGCN_STACK_PHASES (tools/gcn_stack_phases.py does), thread 0
// of every CTA adds each phase's %globaltimer and clock64 time to a slot,
// summed over the CTA's samples; slot kSamples holds their count and the
// last two slots the CTA's first and last stamp. Otherwise the calls
// compile to nothing.
#ifdef GCN_STACK_PHASES
constexpr int kPhaseSlots = 32;
constexpr int kPhaseCtas = 4096;
constexpr int kSamples = kPhaseSlots - 3;
__device__ unsigned long long g_phase_ns[kPhaseCtas * kPhaseSlots];
__device__ long long g_phase_clk[kPhaseCtas * kPhaseSlots];
__shared__ unsigned long long s_phase_ns[kPhaseSlots];
__shared__ long long s_phase_clk[kPhaseSlots];

struct PhaseClock {
  unsigned long long last_ns = 0;
  long long last_clk = 0;
  __device__ static unsigned long long now() {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return ns;
  }
  __device__ void start() {
    if (threadIdx.x != 0) return;
    for (int k = 0; k < kPhaseSlots; ++k) s_phase_ns[k] = s_phase_clk[k] = 0;
    last_ns = s_phase_ns[kPhaseSlots - 2] = now();
    last_clk = s_phase_clk[kPhaseSlots - 2] = clock64();
  }
  __device__ void mark(int slot) {
    if (threadIdx.x != 0) return;
    const unsigned long long ns = now();
    const long long clk = clock64();
    s_phase_ns[slot] += ns - last_ns;
    s_phase_clk[slot] += clk - last_clk;
    last_ns = ns;
    last_clk = clk;
  }
  __device__ void sample() {
    if (threadIdx.x == 0) ++s_phase_ns[kSamples];
  }
  __device__ void finish() {
    if (threadIdx.x != 0 || blockIdx.x >= kPhaseCtas) return;
    s_phase_ns[kPhaseSlots - 1] = now();
    s_phase_clk[kPhaseSlots - 1] = clock64();
    for (int k = 0; k < kPhaseSlots; ++k) {
      g_phase_ns[blockIdx.x * kPhaseSlots + k] = s_phase_ns[k];
      g_phase_clk[blockIdx.x * kPhaseSlots + k] = s_phase_clk[k];
    }
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void sample() {}
  __device__ void finish() {}
};
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {   // the value at the lower address
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Two adjacent values (8-byte aligned in fp32, 4-byte in bf16) as floats.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(bf16_lo(w), bf16_hi(w));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Blocks until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// How one sample's N x N bf16 values at `src` come into a stage: the
// sample sits `lead` values into the stage; its first `head` bytes (up to
// a 16-byte boundary) and the values from `tail_0` on are plain loads, the
// `body` bytes between are one bulk copy, 16-byte aligned at both ends.
// ops/gcn_stack.py:band_copy mirrors it.
struct SampleCopy {
  int lead, head, body, tail_0, edges;
};

__device__ __forceinline__ SampleCopy sample_copy(const __nv_bfloat16* src,
                                                  int nn) {
  const int bytes = 2 * nn;
  const int mis = static_cast<int>(reinterpret_cast<unsigned long long>(src) & 15);
  SampleCopy c;
  c.lead = mis / 2;
  c.head = min((16 - mis) & 15, bytes);
  c.body = (bytes - c.head) & ~15;
  c.tail_0 = (c.head + c.body) / 2;
  c.edges = c.head / 2 + nn - c.tail_0;   // at most 7 + 7
  return c;
}

// Index in the sample of plain-loaded value e < c.edges.
__device__ __forceinline__ int edge_index(const SampleCopy& c, int e) {
  return e < c.head / 2 ? e : c.tail_0 + e - c.head / 2;
}

// Orders this thread's generic shared-memory accesses before later
// accesses of the async proxy (the bulk copies): a thread that writes a
// stage (zeroing it, an edge of a sample) fences before the barrier after
// which thread 0 may copy into it.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One thread: the bulk part of a sample into its stage; `bar` completes
// its current phase when those bytes have landed (at once if there are
// none).
__device__ __forceinline__ void issue_copy(const __nv_bfloat16* src,
                                           __nv_bfloat16* stage, int nn,
                                           unsigned long long* bar) {
  const SampleCopy c = sample_copy(src, nn);
  fence_async();
  if (c.body > 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%2], [%3], %1, [%0];\n"
        :: "r"(smem_addr(bar)), "r"(static_cast<unsigned>(c.body)),
           "r"(smem_addr(reinterpret_cast<char*>(stage + c.lead) + c.head)),
           "l"(reinterpret_cast<const char*>(src) + c.head)
        : "memory");
  } else {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
  }
}

// Value i of the parameter area of shared memory (every layer's W_l, then
// b_l, zero-padded as the plan lays them out from off_w[0] to off_o),
// read from global memory and widened to fp32.
__device__ __forceinline__ float param_value(const Bf16Args& a, int i) {
  const Bf16Plan& p = a.plan;
  int l = 0;
  while (l + 1 < p.num_layers && i >= p.off_w[l + 1]) ++l;
  const int fout = p.dims[l + 1];
  if (i >= p.off_b[l]) {
    const int c = i - p.off_b[l];
    return c < fout ? __bfloat162float(a.b[l][c]) : 0.f;
  }
  const int idx = i - p.off_w[l];
  const int f = idx / p.fout_p[l];
  const int c = idx - f * p.fout_p[l];
  return f < p.dims[l] && c < fout ? __bfloat162float(a.w[l][f * fout + c])
                                   : 0.f;
}

// acc[r][c] += sum_{j < k} a[j * a_stride + r] * b[j * b_stride + c], in
// ascending j, for a TR x 4 register tile: per step TR/2 pair loads of a
// (fp32 pairs, or bf16 pairs widened) and one 16-byte load of b feed 4 TR
// FMAs.
template <int TR, typename TA>
__device__ __forceinline__ void mac_tile(const TA* a, int a_stride,
                                         const float* b, int b_stride, int k,
                                         float (&acc)[TR][4]) {
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float4 bv = *reinterpret_cast<const float4*>(b + j * b_stride);
    float av[TR];
#pragma unroll
    for (int h = 0; h < TR; h += 2) {
      const float2 v = load_pair(a + j * a_stride + h);
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
// rows; afterwards lane `slice` holds in acc[0, 8/KS) the full sums of rows
// [slice * 8/KS, (slice + 1) * 8/KS). Each round trades half the live rows
// with the partner lane.
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
gcn_stack_bf16_kernel(const __grid_constant__ Bf16Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Bf16Args sa;
  __shared__ alignas(8) unsigned long long full;   // the stage's barrier
  PhaseClock clock;
  clock.start();
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // 1. The parameters into shared memory, one word per thread: their
  //    loads miss the constant cache together instead of one after another.
  if (tid == 0) mbar_init(&full);
  for (int w = tid; w < static_cast<int>(sizeof(Bf16Args) / 4); w += nthr) {
    reinterpret_cast<int*>(&sa)[w] = reinterpret_cast<const int*>(&a)[w];
  }
  __syncthreads();
  clock.mark(20);                              // prologue: parameters
  const Bf16Plan& p = sa.plan;
  const int n = p.n, nn = n * n, ps = p.ps, hws = p.hws, hts = p.hts;
  const int kpad = p.kpad, f0 = p.dims[0], nx = n * f0;
  const int total = p.total;
  const long long batch = sa.batch, grid = p.grid;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem);
  float* hw = smem + p.off_hw;        // hw[j * hws + c] = (h W)[j][c]
  float* ht = smem + p.off_h;         // ht[f * hts + j] = h[j][f]
  float* os = smem + p.off_o;         // os[i * total + c] = out[i][c]
  auto sample_p = [&](long long s) {
    return sa.prop + s * sa.p_batch_stride;
  };

  // 2. Plain loads, all in flight together: the weights and biases
  //    (widened, zero-padded to multiples of 4, gathered kGather a thread
  //    at a time), the first sample's x and its edges; then thread 0
  //    queues its bulk copy behind them. Meanwhile h^T and the stage's
  //    slack after the sample are zeroed (the tile loop reads K's pad
  //    columns there, times zero rows of hW), and the loaded values stored.
  const int p0 = p.off_w[0], p1 = p.off_o;
  float wv[kGather];
#pragma unroll
  for (int k = 0; k < kGather; ++k) {
    const int i = p0 + k * nthr + tid;
    wv[k] = i < p1 ? param_value(sa, i) : 0.f;
  }
  float xv[kXCarry];
  auto load_x = [&](long long s) {
    const __nv_bfloat16* xs = sa.x + s * nx;
#pragma unroll
    for (int k = 0; k < kXCarry; ++k) {
      const int e = k * nthr + tid;
      xv[k] = e < nx ? __bfloat162float(xs[e]) : 0.f;
    }
  };
  // The first threads' part of bringing sample s into the stage: its edge
  // values (plain loads) and the zeros after it (where a sample of another
  // lead left values), into registers, stored before the next barrier.
  __nv_bfloat16 edge = __float2bfloat16(0.f);
  int edge_at = -1;                            // in the stage
  auto load_edge = [&](long long s) {
    const SampleCopy c = sample_copy(sample_p(s), nn);
    if (tid < c.edges) {
      const int at = edge_index(c, tid);
      edge = sample_p(s)[at];
      edge_at = c.lead + at;
    } else if (tid < c.edges + kSlackVals) {
      edge = __float2bfloat16(0.f);
      edge_at = c.lead + nn + tid - c.edges;
    }
  };
  load_x(blockIdx.x);
  if (p.copy_bulk) {
    load_edge(blockIdx.x);
    __syncthreads();   // every plain load issued, not queued behind the copy
    if (tid == 0) issue_copy(sample_p(blockIdx.x), stage, nn, &full);
    const int from = sample_copy(sample_p(blockIdx.x), nn).lead + nn;
    for (int i = from + tid; i < p.stage_vals; i += nthr) {
      stage[i] = __float2bfloat16(0.f);
    }
  } else {                  // value by value: the pads
    for (int i = tid; i < p.stage_vals; i += nthr) {
      stage[i] = __float2bfloat16(0.f);
    }
  }
  for (int i = tid; i < p0 - p.off_h; i += nthr) ht[i] = 0.f;
#pragma unroll
  for (int k = 0; k < kGather; ++k) {
    const int i = p0 + k * nthr + tid;
    if (i < p1) smem[i] = wv[k];
  }
  for (int i = p0 + kGather * nthr + tid; i < p1; i += nthr) {
    smem[i] = param_value(sa, i);
  }
  if (edge_at >= 0) stage[edge_at] = edge;
  fence_async();   // the stage's zeros and edges before later bulk copies
  clock.mark(21);                              // prologue: loads stored
  // h_0 = x into rows [0, f0) of h^T, rows [f0, 4) of the padding zeroed
  // (a previous sample's layers wrote there)
  auto store_x = [&](long long s) {
#pragma unroll
    for (int k = 0; k < kXCarry; ++k) {
      const int e = k * nthr + tid;
      if (e < nx) ht[(e % f0) * hts + e / f0] = xv[k];
    }
    const __nv_bfloat16* xs = sa.x + s * nx;
    for (int e = kXCarry * nthr + tid; e < nx; e += nthr) {
      ht[(e % f0) * hts + e / f0] = __bfloat162float(xs[e]);
    }
    const int pad = ((f0 + 3) & ~3) - f0;
    for (int idx = tid; idx < pad * n; idx += nthr) {
      ht[(f0 + idx / n) * hts + idx % n] = 0.f;
    }
  };
  __syncthreads();                             // ht zeroed before x lands
  store_x(blockIdx.x);
  __syncthreads();
  clock.mark(0);                               // prologue

  // hW of layer l for every row (pad rows of h are zero, so theirs is),
  // in 2 x 4 tiles
  auto h_times_w = [&](int l) {
    const int fin4 = (p.dims[l] + 3) & ~3;
    const float* wl = smem + p.off_w[l];
    const int tiles = p.fout_p[l] / 4;
    for (int t = tid; t < (kpad / 2) * tiles; t += nthr) {
      const int i0 = (t / tiles) * 2;
      const int c0 = (t % tiles) * 4;
      float acc[2][4] = {};
      mac_tile<2>(ht + i0, hts, wl + c0, p.fout_p[l], fin4, acc);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float4*>(hw + (i0 + r) * hws + c0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  };

  int it = 0;
  for (long long s = blockIdx.x; s < batch; s += grid, ++it) {
    const __nv_bfloat16* src = sample_p(s);
    // 3. h_0 W_0 needs no P: it runs while the sample's P may still be in
    //    flight. Then the wait for P (or its copy value by value,
    //    transposed into place where P is row-major).
    h_times_w(0);
    clock.mark(2);                             // h_0 W_0
    int lead = 0;
    if (p.copy_bulk) {
      lead = sample_copy(src, nn).lead;
      mbar_wait(&full, static_cast<unsigned>(it) & 1u);
    } else {
      for (int idx = tid; idx < nn; idx += nthr) {
        const int q = idx / n;
        const int r = idx - q * n;
        const int j = p.p_transposed ? q : r;
        stage[j * ps + (p.p_transposed ? r : q)] = src[idx];
      }
    }
    const __nv_bfloat16* pt = stage + lead;    // pt[j * ps + i] = P[i][j]
    __syncthreads();
    clock.mark(1);                             // P in

    for (int l = 0; l < p.num_layers; ++l) {
      if (l > 0) {
        h_times_w(l);
        __syncthreads();
        clock.mark(3 + 2 * l);                 // h W
      }
      const int fout = p.dims[l + 1];
      const float* bl = smem + p.off_b[l];
      float* os_l = os + p.out_off[l];

      // 4. P hW: KS adjacent lanes share an 8 x 4 tile, lane `slice`
      //    summing the steps j = slice (mod KS); a shuffle reduce-scatter
      //    leaves each lane 8/KS finished rows. Every thread runs the same
      //    number of rounds, so the shuffles see full warps.
      const int col_tiles = p.fout_p[l] / 4;
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
                              hw + c0 + slice * hws, hws * KS, kpad / KS, acc);
        }
        reduce_scatter<KS>(acc, slice);
        if (!active) continue;
#pragma unroll
        for (int r = 0; r < kTileRows / KS; ++r) {
          const int i = i0 + slice * (kTileRows / KS) + r;
          if (i >= n) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {   // h_{l+1} row i
            const float v = fmaxf(acc[r][c] + bl[c0 + c], 0.f);
            ht[(c0 + c) * hts + i] = v;
            if (c0 + c < fout) os_l[i * total + c0 + c] = v;
          }
        }
      }
      __syncthreads();
      clock.mark(4 + 2 * l);                   // P hW
    }

    // 5. The stage is free: thread 0 refills it with the CTA's next sample
    //    (its edges, and the zeros after it, by the first threads, into
    //    registers); the next sample's x into registers. The sample's JK
    //    output is one block of memory: coalesced stores, 16 bytes each
    //    where it is aligned. Then the next x, the edges and the zeros into
    //    place before the closing barrier.
    const long long next = s + grid;
    edge_at = -1;
    if (next < batch) {
      if (p.copy_bulk) {
        if (tid == 0) issue_copy(sample_p(next), stage, nn, &full);
        load_edge(next);
      }
      load_x(next);
    }
    const long long at = s * n * total;
    const int count = n * total;
    float* dst = sa.out + at;
    if (at % 4 == 0 && count % 4 == 0) {
      for (int v = tid; v < count / 4; v += nthr) {
        reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(os)[v];
      }
    } else {
      for (int v = tid; v < count; v += nthr) dst[v] = os[v];
    }
    clock.mark(23);                            // output stores issued
    if (next < batch) store_x(next);
    if (edge_at >= 0) {
      stage[edge_at] = edge;
      fence_async();
    }
    __syncthreads();
    clock.sample();
    clock.mark(3 + 2 * p.num_layers);          // next x, edges
  }
  clock.finish();
}

// Sets the kernel's dynamic shared-memory limit on `device` the first time
// a launch needs more than was set before.
template <int KS>
cudaError_t reserve_shared(int device, int bytes) {
  static std::mutex mu;
  static int reserved[kMaxDevices] = {};
  std::lock_guard<std::mutex> guard(mu);
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && bytes <= reserved[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gcn_stack_bf16_kernel<KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) reserved[device] = bytes;
  return err;
}

template <int KS>
cudaError_t launch(const Bf16Args& args, int device, cudaStream_t stream) {
  const Bf16Plan& p = args.plan;
  const cudaError_t err = reserve_shared<KS>(device, p.smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.grid));
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  return cudaLaunchKernelEx(&cfg, gcn_stack_bf16_kernel<KS>, args);
}

}  // namespace

extern "C" {

// plan: from plan_launch (elem_bytes=2) with the grid for this batch;
// prop (B, N, N) bf16 with batch stride p_batch_stride values, each
// sample's N x N values one block of memory, row-major or transposed as
// plan->p_transposed says; x (B, N, dims[0]) bf16 contiguous; weights[l]
// (dims[l], dims[l+1]) and biases[l] (dims[l+1]) bf16 contiguous; out
// (B, N, total) fp32 contiguous; all on `device`.
int gcn_stack_bf16_forward(const Bf16Plan* plan, const void* prop,
                           long long p_batch_stride, const void* x,
                           const void* const* weights,
                           const void* const* biases, float* out,
                           long long batch, int device, void* stream) {
  const Bf16Plan& p = *plan;
  if (batch < 0 || p.num_layers < 1 || p.num_layers > kMaxLayers ||
      p.threads < 32 || p.threads > kMaxThreads || p.threads % 32 != 0 ||
      (p.ksplit != 2 && p.ksplit != 4) ||
      p.kpad % (2 * p.ksplit) != 0 ||
      p.ps % 2 != 0 ||
      p.n8 % kTileRows != 0 ||
      p.stage_vals % 8 != 0 || p.smem_bytes % 16 != 0 ||
      (batch > 0 && (p.grid < 1 || p.grid > batch))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Bf16Args args = {};
  args.plan = p;
  args.prop = static_cast<const __nv_bfloat16*>(prop);
  args.p_batch_stride = p_batch_stride;
  args.x = static_cast<const __nv_bfloat16*>(x);
  args.out = out;
  args.batch = batch;
  for (int l = 0; l < p.num_layers; ++l) {
    args.w[l] = static_cast<const __nv_bfloat16*>(weights[l]);
    args.b[l] = static_cast<const __nv_bfloat16*>(biases[l]);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = p.ksplit == 4 ? launch<4>(args, device, s)
                        : launch<2>(args, device, s);
  }
  if (err != cudaSuccess) cudaGetLastError();   // clear it for the caller
  return static_cast<int>(err);
}

const char* gcn_stack_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef GCN_STACK_PHASES
// Copies the phase slots of the last launch: ns and clk hold
// ctas * kPhaseSlots values each; returns the cudaError_t.
int gcn_stack_bf16_phase_stamps(unsigned long long* ns, long long* clk,
                                int ctas) {
  const size_t count = sizeof(long long) * kPhaseSlots *
                       static_cast<size_t>(ctas < kPhaseCtas ? ctas : kPhaseCtas);
  cudaError_t err = cudaMemcpyFromSymbol(ns, g_phase_ns, count);
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clk, g_phase_clk, count);
  return static_cast<int>(err);
}
#endif

}  // extern "C"
