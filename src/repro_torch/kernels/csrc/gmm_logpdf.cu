// Per-component Gaussian-mixture log densities (the EM E-step), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gmm_logpdf.py::_gmm_kernel (the
// E-step that repro/core/gmm.py's docstring assigns to it; in the port,
// every E-step of core/gmm.py's EM reaches it). Same function:
//
//   x [N, D], means [K, D], inv_chol [K, D, D] (inverse lower Cholesky
//   factors), log_w [K], all f32; K <= 64, D <= 128
//   out[n, k] = log_w[k] - 0.5 (sum_i y_i^2 + D log 2pi) - logdet[k]
//   y = inv_chol[k] (x[n] - means[k])          (the full D x D product)
//   logdet[k] = -sum_i log |inv_chol[k, i, i]| (as the reference wrapper)
//
// Design (a first, simple kernel): one block of 128 threads per tile of
// 128 rows, one thread per row. The TPU's loop over components inside the
// kernel stays a loop inside the block. The x tile is staged once in
// dynamic shared memory, transposed to [D][129], so the 32 threads of a
// warp read 32 neighbouring words for each column. The components' means
// and inverse factors are staged in shared memory (every thread reads the
// same factor entry: a broadcast), and each thread runs the D x D product
// for its row, component after component. The [rows, K] output tile is
// buffered in shared memory with a row stride of K + 1 (an odd stride: the
// threads writing one component's column hit 32 different banks) and
// stored at the end as one contiguous, coalesced run, since the tile's
// rows are contiguous in out. A ragged last tile is masked, not padded. The log weights and
// log-determinants of all components are computed once per block.
// Components are staged in chunks that fit a 64 KB budget (all 50 of the
// asset GMM at D = 3; one at D = 128), so a block waits for the factors'
// global loads once per chunk, not once per component. At D = 128, K = 64
// shared memory is 162 KB, past the 48 KB static limit, so it is dynamic
// and the launcher raises the kernel's limit first.
// Products are FMAs: this is a float kernel held to a tolerance.
//
// What bounds it on an H100: the function reads x, the factors and the
// weights once and writes N K floats; it does about N K (2 D^2 + 3 D + 4)
// operations. On the EM's inputs (D = 1 or 3, K <= 50, N ~ 28,000) that is
// a few MB and a few tens of MFLOP: about 2 us of memory traffic at
// 3.35 TB/s, bytes-bound, and far below a launch's own latency. The kernel
// is launch-bound there; the design does nothing clever about it beyond
// staying one launch per E-step.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;     // rows per block, one thread each
constexpr int kMaxK = 64;      // the reference kernel's stated limits
constexpr int kMaxD = 128;
constexpr double kLog2Pi = 1.8378770664093453;
constexpr int kChunkFloats = 16384;   // 64 KB of factors and means

// components staged per chunk: as many as fit the budget, at least one
inline int chunk_components(int d, int k) {
  const int fit = kChunkFloats / (d * d + d);
  return fit < 1 ? 1 : (fit > k ? k : fit);
}

inline size_t smem_floats(int d, int k, int kc) {
  return (size_t)d * (kRows + 1)         // x tile, transposed
         + (size_t)kc * (d * d + d)      // a chunk's factors and means
         + 2 * (size_t)k                 // log weights, log-determinants
         + (size_t)kRows * (k + 1);      // output tile
}

__global__ void __launch_bounds__(kRows)
gmm_logpdf_kernel(const float* __restrict__ x, const float* __restrict__ means,
                  const float* __restrict__ inv_chol,
                  const float* __restrict__ log_w, float* __restrict__ out,
                  int n, int d, int k, int kc, float d_log2pi) {
  extern __shared__ float smem[];
  const int ldx = kRows + 1;
  const int ldo = k + 1;
  const int dd = d * d;
  float* xs = smem;              // [d][ldx]
  float* il = xs + d * ldx;      // [kc][d][d]
  float* mu = il + kc * dd;      // [kc][d]
  float* lw = mu + kc * d;       // [k]
  float* ld = lw + k;            // [k]
  float* os = ld + k;            // [kRows][ldo]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)n - row0);

  // the tile's rows are rows * d contiguous floats of x
  const float* xb = x + row0 * d;
  for (int e = tid; e < rows * d; e += kRows) {
    const int r = e / d;
    xs[(e - r * d) * ldx + r] = xb[e];
  }
  for (int c = tid; c < k; c += kRows) {
    const float* ic = inv_chol + (long long)c * d * d;
    float s = 0.f;
    for (int i = 0; i < d; ++i) s += logf(fabsf(ic[i * d + i]));
    ld[c] = -s;
    lw[c] = log_w[c];
  }

  for (int c0 = 0; c0 < k; c0 += kc) {
    const int nc = min(kc, k - c0);
    __syncthreads();   // the staging above, or the last chunk's reads
    // a chunk's factors and means are contiguous in global memory
    const float* ic = inv_chol + (long long)c0 * dd;
    const float* mc = means + (long long)c0 * d;
    for (int e = tid; e < nc * dd; e += kRows) il[e] = ic[e];
    for (int e = tid; e < nc * d; e += kRows) mu[e] = mc[e];
    __syncthreads();
    if (tid < rows) {
      const float* xr = xs + tid;
      for (int c = 0; c < nc; ++c) {
        const float* lc = il + c * dd;
        const float* mv = mu + c * d;
        float maha = 0.f;
        for (int i = 0; i < d; ++i) {
          const float* li = lc + i * d;
          float y = 0.f;
          for (int j = 0; j < d; ++j) y += li[j] * (xr[j * ldx] - mv[j]);
          maha += y * y;
        }
        os[tid * ldo + c0 + c] =
            lw[c0 + c] - 0.5f * (maha + d_log2pi) - ld[c0 + c];
      }
    }
  }
  __syncthreads();

  float* ob = out + row0 * k;
  for (int e = tid; e < rows * k; e += kRows) {
    const int r = e / k;
    ob[e] = os[r * ldo + (e - r * k)];
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit): a refused launch never runs,
// so the caller must check it. All pointers are contiguous f32; out must
// hold n * k floats. Allocates nothing.
extern "C" int gmm_logpdf_launch(const void* x, const void* means,
                                 const void* inv_chol, const void* log_w,
                                 void* out, int n, int d, int k,
                                 void* stream) {
  if (n < 1 || d < 1 || k < 1 || d > kMaxD || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int kc = chunk_components(d, k);
  const size_t smem = smem_floats(d, k, kc) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_logpdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // D log 2pi in double, rounded once to f32, as the reference's d * _LOG2PI
  const float d_log2pi = (float)(d * kLog2Pi);
  const unsigned grid = (unsigned)((n + kRows - 1) / kRows);
  gmm_logpdf_kernel<<<grid, kRows, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)means, (const float*)inv_chol,
      (const float*)log_w, (float*)out, n, d, k, kc, d_log2pi);
  return (int)cudaGetLastError();
}
