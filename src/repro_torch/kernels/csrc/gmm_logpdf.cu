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
// What bounds it on an H100: the function reads x, the factors and the
// weights once and writes N K floats; it does about N K (2 D^2 + 3 D + 4)
// operations. On the EM's inputs (D = 1 or 3, K <= 50, N ~ 28,000) that is
// a few MB and a few tens of MFLOP: about 2 us of memory traffic at
// 3.35 TB/s, bytes-bound, and below a launch's own latency.
//
// Design: the (row, component) pairs spread across the threads, the
// component fastest. The first version gave each thread one row and walked
// all K components in series (a chain of about K (D^2 + 3 D) dependent
// operations; 219 blocks at N = 27,948), and restaged the output tile in
// shared memory; it measured 26 us on the device alone for the asset
// E-step (NVIDIA H100 80GB HBM3, 700 W), 15x its bound.
//   - A block of 256 threads takes a tile of rows and a chunk of kc
//     components: all K where their factors fit a 32 KB budget (every
//     component of the EM's D = 1 and 3 GMMs), down to one at D = 128; the
//     grid's second axis walks the chunks. Thread t owns component
//     t % kc and rows t / kc + p (256 / kc) for the tile's kPass passes, so
//     the threads of a pass write 256 / kc whole rows of out, a contiguous
//     run when kc = K, with no restaging.
//   - The chunk's factors and means are staged component-fastest
//     ([i][j][kc]), so a warp's 32 components read 32 neighbouring words;
//     the row tile is staged transposed ([D][rows + 1]).
//   - Each thread runs its passes together, each factor entry read once
//     for all of them: independent chains of D^2 + 3 D operations, not
//     one of K (D^2 + 3 D). At the asset E-step that is 1,398 blocks.
//   - D is a template constant for D <= 3, the EM's GMMs (asset D = 3,
//     the others D = 1), so their loops unroll with fixed offsets; other
//     D run the same code with D read at run time.
//   - Products are FMAs in the first version's order (y += L_ij (x_j -
//     mu_j) over j, then maha += y^2): a float kernel held to a tolerance.
// Shared memory reaches 197 KB at D = 128 (a 256-row tile and one factor),
// past the 48 KB static limit: it is dynamic and the launcher raises the
// kernel's limit first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 64;      // the reference kernel's stated limits
constexpr int kMaxD = 128;
constexpr double kLog2Pi = 1.8378770664093453;
constexpr int kFactorFloats = 8192;   // 32 KB of a chunk's factors and means

// components per chunk: as many as fit the budget, at least one
inline int chunk_components(int d, int k) {
  const int fit = kFactorFloats / (d * d + d);
  return fit < 1 ? 1 : (fit > k ? k : fit);
}

// rows per pass and passes per tile: four passes of small rows, one of the
// 256 rows a lone component takes at large D
inline int passes(int d) { return d <= 8 ? 4 : 1; }

inline size_t smem_floats(int d, int kc, int rows) {
  return (size_t)d * (rows + 1)            // row tile, transposed
         + (size_t)kc * (d * d + d)        // the chunk's factors and means
         + 2 * (size_t)kc;                 // log weights, log-determinants
}

template <int kPass, int kD>
__global__ void __launch_bounds__(kThreads)
gmm_logpdf_kernel(const float* __restrict__ x, const float* __restrict__ means,
                  const float* __restrict__ inv_chol,
                  const float* __restrict__ log_w, float* __restrict__ out,
                  int n, int d_any, int k, int kc, float d_log2pi) {
  extern __shared__ float smem[];
  const int d = kD ? kD : d_any;
  const int c0 = blockIdx.y * kc;
  const int nc = min(kc, k - c0);          // components of this chunk
  const int rpp = kThreads / kc;           // rows per pass (every chunk)
  const int rows_tile = rpp * kPass;
  const int ldx = rows_tile + 1;
  const int dd = d * d;
  float* xs = smem;                  // [d][ldx]
  float* il = xs + d * ldx;          // [d][d][nc]
  float* mu = il + dd * nc;          // [d][nc]
  float* lw = mu + d * nc;           // [nc]
  float* ld = lw + nc;               // [nc]

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * rows_tile;
  const int rows = (int)min((long long)rows_tile, (long long)n - row0);

  // the tile's rows are rows * d contiguous floats of x
  const float* xb = x + row0 * d;
  for (int e = tid; e < rows * d; e += kThreads) {
    const int r = e / d;
    xs[(e - r * d) * ldx + r] = xb[e];
  }
  // the chunk's factors and means are contiguous in global memory
  const float* ic = inv_chol + (long long)c0 * dd;
  for (int e = tid; e < nc * dd; e += kThreads) {
    const int c = e / dd;
    il[(e - c * dd) * nc + c] = ic[e];
  }
  const float* mc = means + (long long)c0 * d;
  for (int e = tid; e < nc * d; e += kThreads) {
    const int c = e / d;
    mu[(e - c * d) * nc + c] = mc[e];
  }
  for (int c = tid; c < nc; c += kThreads) {
    const float* f = inv_chol + (long long)(c0 + c) * dd;
    float s = 0.f;
    for (int i = 0; i < d; ++i) s += logf(fabsf(f[i * d + i]));
    ld[c] = -s;
    lw[c] = log_w[c0 + c];
  }
  __syncthreads();

  const int kl = tid % kc;
  const int r0 = tid / kc;
  if (r0 >= rpp || kl >= nc) return;
  float maha[kPass];
#pragma unroll
  for (int p = 0; p < kPass; ++p) maha[p] = 0.f;
#pragma unroll
  for (int i = 0; i < d; ++i) {
    float y[kPass];
#pragma unroll
    for (int p = 0; p < kPass; ++p) y[p] = 0.f;
#pragma unroll
    for (int j = 0; j < d; ++j) {
      const float f = il[(i * d + j) * nc + kl];
      const float m = mu[j * nc + kl];
      const float* xj = xs + j * ldx + r0;
#pragma unroll
      for (int p = 0; p < kPass; ++p) y[p] += f * (xj[p * rpp] - m);
    }
#pragma unroll
    for (int p = 0; p < kPass; ++p) maha[p] += y[p] * y[p];
  }
  const float base = lw[kl];
  const float ldk = ld[kl];
#pragma unroll
  for (int p = 0; p < kPass; ++p) {
    const int r = r0 + p * rpp;
    if (r < rows)
      out[(row0 + r) * k + c0 + kl] = base - 0.5f * (maha[p] + d_log2pi) - ldk;
  }
}

template <int kPass, int kD>
int launch(const float* x, const float* means, const float* inv_chol,
           const float* log_w, float* out, int n, int d, int k,
           cudaStream_t stream) {
  const int kc = chunk_components(d, k);
  const int rows_tile = (kThreads / kc) * kPass;
  const size_t smem = smem_floats(d, kc, rows_tile) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_logpdf_kernel<kPass, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // D log 2pi in double, rounded once to f32, as the reference's d * _LOG2PI
  const float d_log2pi = (float)(d * kLog2Pi);
  const dim3 grid((unsigned)((n + rows_tile - 1) / rows_tile),
                  (unsigned)((k + kc - 1) / kc));
  gmm_logpdf_kernel<kPass, kD><<<grid, kThreads, smem, stream>>>(
      x, means, inv_chol, log_w, out, n, d, k, kc, d_log2pi);
  return (int)cudaGetLastError();
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
  const cudaStream_t st = (cudaStream_t)stream;
  const float *xf = (const float*)x, *mf = (const float*)means,
              *cf = (const float*)inv_chol, *wf = (const float*)log_w;
  float* o = (float*)out;
  switch (d) {   // the EM's dimensions, unrolled
    case 1: return launch<4, 1>(xf, mf, cf, wf, o, n, d, k, st);
    case 2: return launch<4, 2>(xf, mf, cf, wf, o, n, d, k, st);
    case 3: return launch<4, 3>(xf, mf, cf, wf, o, n, d, k, st);
  }
  return passes(d) == 4 ? launch<4, 0>(xf, mf, cf, wf, o, n, d, k, st)
                        : launch<1, 0>(xf, mf, cf, wf, o, n, d, k, st);
}
