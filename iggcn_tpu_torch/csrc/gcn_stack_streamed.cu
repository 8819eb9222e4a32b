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
// us.
//
// Design, against that bound (right and simple first):
// - One templated batched tiled product, C = A B per sample, with every
//   operand addressed by its own strides: P in either layout (as
//   gcn_propagation_matrix returns it, or row-major) and P^T are the same
//   operand with its strides swapped; the grouped form's weights are
//   set s / group at a stride (0 for shared weights).
// - A CTA computes one 64 x 64 block of C for one sample (a 1-D grid:
//   block rows fastest, then block columns, then samples, so the CTAs of a
//   sample run together and share its operands in L2). 256 threads, each
//   a 4 x 4 register tile; fp32 FMAs on the CUDA cores, no TF32, no tensor
//   cores, K summed in order.
// - K streams through a ring of 3 stages of 16 in shared memory: fp32
//   values by 4-byte cp.async (zero-filled past an edge), bf16 values
//   widened to fp32 on their way in (a plain load: no overlap for them).
//   Reads past an edge meet zeros, so the tiles need no masks in the loop;
//   the epilogue writes only values inside C.
// - Epilogues: the forward's relu(z + b) written straight into layer l's
//   slice of the JK output, where the next layer reads h_{l+1} in place;
//   the backward's da with db in an extra row of ones in P^T (one more row
//   of C), dz formed in the epilogue of e_{l+1} (or of the recompute's
//   last z) from g and the relu mask of h_{l+1} (= [z_l > 0]).
// - Launches: 2 per layer in the forward (a_l, then z_l), so 2L; the
//   backward 2L + up to 3L + 1 (da, dW, e per layer; dP over the
//   concatenated dz and a, depth sum H, written in P's layout) and one
//   per-set sum of the dW / db slots.
// - dW_l and db_l go to one slot per sample, summed per weight set in a
//   fixed order by sum_streamed_slots (gcn_stack_backward.cu's
//   sum_weight_slots, copied: tools/gcn_stack_phases.py builds that
//   source from copies, so it includes no header). No atomics: a result
//   is bit-equal to its repeat.
//
// What it costs against the resident design: nothing stays on chip across
// layers. The resident kernels read P once a call; this design reads it
// once per layer (L times P's share of the bound's bytes; the backward
// 2L times), a_l and h_l go through device memory, and every step is a
// launch of its own. At the shapes above it remains operations-bound in
// principle, but a 64 x 64 tile leaves half of its columns or more idle
// at widths of 32 and below.
//
// The launches are listed in Python (ops/gcn_stack.py:_layer_products,
// _backward_products) as Product records, one per launch. C interface
// (bound with ctypes): gcn_stack_streamed launches them in order on the
// caller's stream, never synchronises, allocates nothing (scratch and
// outputs come from the caller), and returns the cudaError_t (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kTile = 64;       // rows and columns of C per CTA
constexpr int kChunk = 16;      // K per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int kStride = kTile + 4;  // floats per K row of a stage
constexpr int kReduceThreads = 256;

enum Epilogue { kStore = 0, kRelu = 1, kDa = 2, kGradMask = 3 };
enum Elem { kF32 = 0, kBf16 = 1 };

// Field for field the ctypes structure _CProduct in ops/gcn_stack.py.
// Operand X's element (s, i, j) is X + (s / x_div) * x_bs + i * x_s0 +
// j * x_s1, in values of its type (x_type); c's is c + s * c_bs + i * c_s0
// + j * c_s1, and d's, g's and mask's the same with a column stride of 1.
struct Product {
  const void* a;      // A (m x k): rows from a_rows on read 0 (1: the ones row)
  const void* b;      // B (k x n)
  const void* bias;   // kRelu: bias(s, j) = bias + (s / bias_div) * bias_bs + j
  const float* g;     // kRelu (with d), kGradMask: the output's gradient
  const float* mask;  // kGradMask: h, whose [h > 0] masks
  float* c;
  float* d;           // kRelu: dz (or null); kDa: db, one row per sample
  long long a_bs, a_s0, a_s1, b_bs, b_s0, b_s1, bias_bs, g_bs, g_s0, mask_bs,
      mask_s0, c_bs, c_s0, c_s1, d_bs, d_s0;
  int m, n, k;
  int a_rows;         // rows of A read from memory
  int ones;           // row a_rows of A is ones over k
  int epi;
  int a_div, b_div, bias_div;
  int a_type, b_type, bias_type;
};

namespace {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One value into a stage: fp32 by a 4-byte cp.async that writes 0 where
// the value is outside its operand (src-size 0); bf16 widened by a load.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.f;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage chunk `c` of K: as[kk][mm] = A(m0 + mm, c * kChunk + kk) and
// bs[kk][nn] = B(c * kChunk + kk, n0 + nn). Each operand's threads walk
// its contiguous dimension fastest, so that a warp's loads coalesce.
template <typename TA, typename TB>
__device__ __forceinline__ void load_chunk(const Product& p, const TA* a,
                                           const TB* b, int m0, int n0, int c,
                                           float (*as)[kStride],
                                           float (*bs)[kStride]) {
  const int k0 = c * kChunk;
  const bool a_m_fast = p.a_s0 == 1;
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int mm = a_m_fast ? e % kTile : e / kChunk;
    const int kk = a_m_fast ? e / kTile : e % kChunk;
    const int m = m0 + mm, k = k0 + kk;
    if (p.ones && m == p.a_rows) {
      as[kk][mm] = k < p.k ? 1.f : 0.f;
    } else {
      const bool valid = m < p.a_rows && k < p.k;
      stage(&as[kk][mm], valid ? a + m * p.a_s0 + k * p.a_s1 : a, valid);
    }
  }
  const bool b_n_fast = p.b_s1 == 1;
  for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
    const int nn = b_n_fast ? e % kTile : e / kChunk;
    const int kk = b_n_fast ? e / kTile : e % kChunk;
    const int n = n0 + nn, k = k0 + kk;
    const bool valid = n < p.n && k < p.k;
    stage(&bs[kk][nn], valid ? b + k * p.b_s0 + n * p.b_s1 : b, valid);
  }
}

template <typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
gcn_stack_streamed_product(const Product p) {
  __shared__ __align__(16) float as[kStages][kChunk][kStride];
  __shared__ __align__(16) float bs[kStages][kChunk][kStride];
  const int m_tiles = (p.m + kTile - 1) / kTile;
  const int n_tiles = (p.n + kTile - 1) / kTile;
  const int block = static_cast<int>(blockIdx.x);
  const int m0 = block % m_tiles * kTile;
  const int n0 = block / m_tiles % n_tiles * kTile;
  const int s = block / m_tiles / n_tiles;
  const TA* a = static_cast<const TA*>(p.a) + (s / p.a_div) * p.a_bs;
  const TB* b = static_cast<const TB*>(p.b) + (s / p.b_div) * p.b_bs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  const int chunks = (p.k + kChunk - 1) / kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < chunks) load_chunk(p, a, b, m0, n0, c, as[c], bs[c]);
    commit();
  }
  for (int c = 0; c < chunks; ++c) {
    wait_pending<kStages - 2>();   // chunk c is in (this thread's copies)
    __syncthreads();               // everyone's; and chunk c - 1 is done
    const int next = c + kStages - 1;
    if (next < chunks) {
      load_chunk(p, a, b, m0, n0, next, as[next % kStages], bs[next % kStages]);
    }
    commit();
    const int st = c % kStages;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[st][kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[st][kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
  }
  wait_pending<0>();

  const long long ss = s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= p.m) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= p.n) break;
      const float v = acc[i][j];
      float* c = p.c + ss * p.c_bs + row * p.c_s0 + col * p.c_s1;
      if (p.epi == kRelu) {
        const TC* bias = static_cast<const TC*>(p.bias) +
                         (s / p.bias_div) * p.bias_bs;
        const float z = v + widen(bias[col]);
        *c = z > 0.f ? z : 0.f;
        if (p.d != nullptr) {
          const float gv = p.g[ss * p.g_bs + row * p.g_s0 + col];
          p.d[ss * p.d_bs + row * p.d_s0 + col] = gv * (z > 0.f ? 1.f : 0.f);
        }
      } else if (p.epi == kDa) {
        if (row < p.a_rows) {
          *c = v;
        } else {
          p.d[ss * p.d_bs + col] = v;
        }
      } else if (p.epi == kGradMask) {
        const float gv = p.g[ss * p.g_bs + row * p.g_s0 + col];
        const float h = p.mask[ss * p.mask_bs + row * p.mask_s0 + col];
        *c = (gv + v) * (h > 0.f ? 1.f : 0.f);
      } else {
        *c = v;
      }
    }
  }
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

template <typename TA, typename TB, typename TC>
cudaError_t launch(const Product& p, unsigned blocks, cudaStream_t stream) {
  gcn_stack_streamed_product<TA, TB, TC><<<blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TA, typename TB>
cudaError_t launch_c(const Product& p, unsigned blocks, cudaStream_t stream) {
  return p.bias_type == kBf16 ? launch<TA, TB, __nv_bfloat16>(p, blocks, stream)
                              : launch<TA, TB, float>(p, blocks, stream);
}

template <typename TA>
cudaError_t launch_b(const Product& p, unsigned blocks, cudaStream_t stream) {
  return p.b_type == kBf16 ? launch_c<TA, __nv_bfloat16>(p, blocks, stream)
                           : launch_c<TA, float>(p, blocks, stream);
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
    const Product& p = steps[i];
    const long long blocks = static_cast<long long>((p.m + kTile - 1) / kTile) *
                             ((p.n + kTile - 1) / kTile) * batch;
    if (p.m < 1 || p.n < 1 || p.k < 1 || p.a_rows < 0 || p.a_rows > p.m ||
        (p.ones && p.a_rows + 1 != p.m) || p.a_div < 1 || p.b_div < 1 ||
        p.bias_div < 1 || p.a == nullptr || p.b == nullptr ||
        p.c == nullptr || (p.epi == kRelu && p.bias == nullptr) ||
        (p.epi == kDa && p.ones && p.d == nullptr) ||
        (p.epi == kGradMask && (p.g == nullptr || p.mask == nullptr)) ||
        blocks >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (batch == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < count && err == cudaSuccess; ++i) {
    const Product& p = steps[i];
    const unsigned blocks = static_cast<unsigned>(
        ((p.m + kTile - 1) / kTile) * ((p.n + kTile - 1) / kTile) * batch);
    err = p.a_type == kBf16 ? launch_b<__nv_bfloat16>(p, blocks, s)
                            : launch_b<float>(p, blocks, s);
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

}  // extern "C"
