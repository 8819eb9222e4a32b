// Batched graph-diffusion preprocessing: personalized PageRank + column
// top-k sparsify + column normalize, on the host.
//
// The port's copy of iggcn_tpu/native/gdc_native.cpp, the `auto` backend of
// `iggcn_tpu_torch.data.diffusion.preprocess_diffusion` (parity target:
// the reference's per-subject NumPy loop, util_gdc.py:7-31,71-101 — dense
// inverse + argsort top-k). Design notes:
//   * inverse: Gauss-Jordan with partial pivoting on an augmented [M | I]
//     row block; the inner loop starts at the pivot column (the left part is
//     structurally zero before it), saving ~25% of the flops of naive GJ.
//   * top-k: O(n) per column via nth_element threshold + tie quota instead
//     of a full argsort — reproduces NumPy's stable-argsort tie-breaking
//     exactly (among entries equal to the k-th value, HIGHER indices are
//     kept, because stable ascending sort zeroes lower indices first).
//   * OpenMP across the batch when cores are available.
//
// Built by the host C++ compiler into iggcn_tpu_torch/_build/ at first use
// as a plain shared library, bound with ctypes (data/diffusion.py).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

extern "C" {

// adjs: (b, n, n) row-major float64, out: (b, n, n). Returns 0 on success,
// -1 if a pivot underflows (singular I - (1-a)H; cannot happen for a proper
// PPR operator but guarded anyway), -2 on bad arguments.
int ppr_topk_batch(const double* adjs, long long b, long long n,
                   double alpha, long long k, double* out) {
    if (b < 0 || n <= 0 || k <= 0) return -2;
    if (k > n) k = n;
    const long long w = 2 * n;  // augmented row width
    int status = 0;

#pragma omp parallel
    {
        std::vector<double> aug(n * w), dinv(n), col(n), vals(n);
#pragma omp for schedule(dynamic)
        for (long long s = 0; s < b; ++s) {
            const double* a = adjs + s * n * n;
            double* o = out + s * n * n;

            // D^-1/2 A D^-1/2 with D = row sums (util_gdc.py:9-12)
            for (long long i = 0; i < n; ++i) {
                double rs = 0.0;
                for (long long j = 0; j < n; ++j) rs += a[i * n + j];
                dinv[i] = 1.0 / std::sqrt(rs);
            }
            // aug = [I - (1-alpha) H | I]
            for (long long i = 0; i < n; ++i) {
                double* row = &aug[i * w];
                for (long long j = 0; j < n; ++j)
                    row[j] = ((i == j) ? 1.0 : 0.0)
                        - (1.0 - alpha) * dinv[i] * a[i * n + j] * dinv[j];
                std::memset(row + n, 0, n * sizeof(double));
                row[n + i] = 1.0;
            }
            for (long long c = 0; c < n; ++c) {
                long long piv = c;
                double best = std::fabs(aug[c * w + c]);
                for (long long r = c + 1; r < n; ++r) {
                    double v = std::fabs(aug[r * w + c]);
                    if (v > best) { best = v; piv = r; }
                }
                if (best < 1e-300) {
#pragma omp atomic write
                    status = -1;
                    continue;
                }
                if (piv != c)
                    std::swap_ranges(&aug[piv * w], &aug[piv * w] + w,
                                     &aug[c * w]);
                double* __restrict prow = &aug[c * w];
                const double pinv = 1.0 / prow[c];
                for (long long j = c; j < w; ++j) prow[j] *= pinv;
                for (long long r = 0; r < n; ++r) {
                    if (r == c) continue;
                    double* __restrict row = &aug[r * w];
                    const double f = row[c];
                    if (f == 0.0) continue;
                    for (long long j = c; j < w; ++j) row[j] -= f * prow[j];
                }
            }
            // ppr = alpha * inv (util_gdc.py:13-14)
            for (long long i = 0; i < n; ++i)
                for (long long j = 0; j < n; ++j)
                    o[i * n + j] = alpha * aug[i * w + n + j];

            // column top-k + column-normalize (util_gdc.py:25-31)
            for (long long j = 0; j < n; ++j) {
                for (long long i = 0; i < n; ++i) col[i] = o[i * n + j];
                std::copy(col.begin(), col.end(), vals.begin());
                std::nth_element(vals.begin(), vals.begin() + (n - k),
                                 vals.end());
                const double kth = vals[n - k];   // k-th largest value
                long long gt = 0;
                for (long long i = 0; i < n; ++i) gt += (col[i] > kth);
                long long eq_quota = k - gt;      // ties kept, high idx first
                double norm = 0.0;
                for (long long i = n - 1; i >= 0; --i) {
                    double v = col[i];
                    bool keep = v > kth || (v == kth && eq_quota > 0);
                    if (v == kth && eq_quota > 0) --eq_quota;
                    col[i] = keep ? v : 0.0;
                    norm += col[i];
                }
                if (norm <= 0.0) norm = 1.0;
                const double ninv = 1.0 / norm;
                for (long long i = 0; i < n; ++i) o[i * n + j] = col[i] * ninv;
            }
        }
    }
    return status;
}

}  // extern "C"
