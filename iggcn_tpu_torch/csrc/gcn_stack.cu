// Fused L-layer dense GCN stack with jumping-knowledge concat, for sm_90a.
//
// Replaces the TPU kernel iggcn_tpu/ops/pallas_gcn.py:_stack_kernel
// (launched by _gcn_stack_pallas, public as fused_gcn_stack). Per sample b:
//   h_0 = x[b];  h_{l+1} = relu(P[b] @ (h_l @ W_l) + b_l);
//   out[b] = concat(h_1, ..., h_L) along the feature axis.
//
// Bound on an H100: the stack is memory-bound. At the serving shape
// (B=256, N=90, F0=3, L=2, H=16) it must move 4*B*(N*N + N*F0 + N*sum H)
// = 11.5 MB (P dominates) and do about 147 MFLOP of fp32 work: ~3.4 us of
// HBM time at 3.35 TB/s against ~2.2 us of fp32 math at 67 TFLOP/s.
//
// Design: one thread block per sample. The block copies its sample's P into
// shared memory once and keeps every intermediate h_l and h_l @ W_l there,
// so only P and x are read from device memory and only the JK output is
// written: every layer after the first costs no device-memory traffic.
// When P does not fit (N=270: 291 KB against 227 KB per block) its rows
// are streamed through a 64 KB shared-memory window instead, once per
// layer, from L2. Accumulation is plain fp32 FMA (no TF32, no tensor
// cores) in the order h @ W first, then P @ (h W), as the TPU kernel did.
//
// C interface (bound with ctypes): gcn_stack_forward launches on the
// caller's stream, never synchronises, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kThreads = 256;
constexpr int kPropWindowFloats = 16384;   // 64 KB of P rows per pass
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB opt-in per block

struct StackShape {
  int n;                        // nodes per sample
  int num_layers;
  int dims[kMaxLayers + 1];     // dims[0] = F0, dims[l + 1] = H_l
  int w_off[kMaxLayers];        // offset of W_l in the packed weights
  int b_off[kMaxLayers];        // offset of b_l in the packed biases
  int out_off[kMaxLayers];      // column of h_{l+1} in the JK output
  int total;                    // JK output width, sum of H_l
  int wmax;                     // max(dims)
  int window_rows;              // rows of P held in shared memory at once
};

__global__ void __launch_bounds__(kThreads)
gcn_stack_kernel(const float* __restrict__ prop, const float* __restrict__ x,
                 const float* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ out, StackShape s) {
  extern __shared__ float smem[];
  const int n = s.n;
  float* h = smem;                    // n * wmax: layer input, then output
  float* hw = h + n * s.wmax;         // n * wmax: h @ W_l
  float* p = hw + n * s.wmax;         // window_rows * n rows of P
  const int tid = threadIdx.x;
  const size_t sample = blockIdx.x;
  const float* prop_s = prop + sample * n * n;
  const float* x_s = x + sample * n * s.dims[0];
  float* out_s = out + sample * n * s.total;
  const bool resident = s.window_rows >= n;

  for (int i = tid; i < n * s.dims[0]; i += kThreads) h[i] = x_s[i];
  if (resident) {
    for (int i = tid; i < n * n; i += kThreads) p[i] = prop_s[i];
  }
  __syncthreads();

  for (int l = 0; l < s.num_layers; ++l) {
    const int fin = s.dims[l];
    const int fout = s.dims[l + 1];
    const float* wl = w + s.w_off[l];
    const float* bl = bias + s.b_off[l];
    const int col = s.out_off[l];

    // hw = h @ W_l  (n x fin) @ (fin x fout)
    for (int idx = tid; idx < n * fout; idx += kThreads) {
      const int i = idx / fout;
      const int k = idx - i * fout;
      float acc = 0.f;
      for (int f = 0; f < fin; ++f) {
        acc = fmaf(h[i * fin + f], __ldg(wl + f * fout + k), acc);
      }
      hw[idx] = acc;
    }
    __syncthreads();

    // h = relu(P @ hw + b_l), one window of P rows at a time. h is free to
    // overwrite: this layer reads only hw and P from here on.
    for (int r0 = 0; r0 < n; r0 += s.window_rows) {
      const int rows = min(s.window_rows, n - r0);
      if (!resident) {
        const float* src = prop_s + static_cast<size_t>(r0) * n;
        for (int i = tid; i < rows * n; i += kThreads) p[i] = src[i];
        __syncthreads();
      }
      for (int idx = tid; idx < rows * fout; idx += kThreads) {
        const int i = idx / fout;
        const int k = idx - i * fout;
        const float* prow = p + i * n;
        float acc = 0.f;
        for (int j = 0; j < n; ++j) acc = fmaf(prow[j], hw[j * fout + k], acc);
        const float v = fmaxf(acc + __ldg(bl + k), 0.f);
        h[(r0 + i) * fout + k] = v;
        out_s[static_cast<size_t>(r0 + i) * s.total + col + k] = v;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// Shared memory, in bytes, that one block needs for this shape; 0 when the
// shape cannot run (too many layers, or too wide for 227 KB).
size_t gcn_stack_shared_bytes(int n, int num_layers, const int* dims) {
  if (n < 1 || num_layers < 1 || num_layers > kMaxLayers) return 0;
  int wmax = 0;
  for (int l = 0; l <= num_layers; ++l) {
    if (dims[l] < 1) return 0;
    wmax = dims[l] > wmax ? dims[l] : wmax;
  }
  const int window = n * n <= kPropWindowFloats
                         ? n
                         : (kPropWindowFloats / n > 0 ? kPropWindowFloats / n : 1);
  const size_t bytes = sizeof(float) *
                       (2 * static_cast<size_t>(n) * wmax +
                        static_cast<size_t>(window) * n);
  return bytes <= kMaxSharedBytes ? bytes : 0;
}

// prop (B, N, N), x (B, N, dims[0]), w = concat of W_l (dims[l] x dims[l+1],
// row-major), bias = concat of b_l, out (B, N, sum dims[1..L]); all fp32,
// contiguous, on `device`. dims is a host array of num_layers + 1 ints.
int gcn_stack_forward(const float* prop, const float* x, const float* w,
                      const float* bias, float* out, int batch, int n,
                      int num_layers, const int* dims, int device,
                      void* stream) {
  const size_t smem = gcn_stack_shared_bytes(n, num_layers, dims);
  if (smem == 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  StackShape s{};
  s.n = n;
  s.num_layers = num_layers;
  int w_off = 0, b_off = 0, wmax = 0;
  for (int l = 0; l <= num_layers; ++l) {
    s.dims[l] = dims[l];
    wmax = dims[l] > wmax ? dims[l] : wmax;
  }
  for (int l = 0; l < num_layers; ++l) {
    s.w_off[l] = w_off;
    s.b_off[l] = b_off;
    s.out_off[l] = b_off;
    w_off += dims[l] * dims[l + 1];
    b_off += dims[l + 1];
  }
  s.total = b_off;
  s.wmax = wmax;
  s.window_rows = n * n <= kPropWindowFloats
                      ? n
                      : (kPropWindowFloats / n > 0 ? kPropWindowFloats / n : 1);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(gcn_stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gcn_stack_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prop, x, w, bias, out, s);
  return static_cast<int>(cudaGetLastError());
}

const char* gcn_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
