// One admission round of the batched wave loop, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/queue_scan.py::_admission_kernel
// (called through fused_admission, reached from repro/core/vdes.py under
// admission_sort="pallas"). The TPU kernel handled one replica per call and
// got the replica axis from vmap; this one takes the batch directly:
//
//   res_q [R, N] i32  resource of each job; the sentinel nres marks a row
//                     that is not queued
//   pkey  [R, N] f32  policy key (0 FIFO, -priority, or service for SJF)
//   wave  [R, N] i32  enqueue wave
//   free  [R, nres] i32  free slots per resource, negative after a
//                     capacity decrease (drain semantics)
//   out   [R, N] u8   admitted_i = 0 <= res_i < nres && seat_i < free[res_i]
//
// seat_i counts the jobs j of the same replica and resource whose key
// (pkey, wave, j) is lexicographically smaller than (pkey_i, wave_i, i):
// its place under the stable sort. Comparisons and integer counts only,
// no float arithmetic, so the mask is exact and equal to the plain version
// (repro_torch/kernels/ref.py::admission_mask_dense).
//
// Design: grid (ceil(N / 256), R), one thread per row i. The block walks
// the replica's columns in 256-wide shared-memory tiles of (res, pkey,
// wave); a thread whose row is queued counts over each tile. Most rows of
// a wave are not queued, and a block with no queued row skips the walk, so
// the work is about Q * N pair tests per replica (Q queued rows) rather
// than N^2.
//
// What bounds it on an H100: the bytes are tiny (12 B in per row, 1 B out;
// about 1.1 MB at R = 32, N = 2700, a third of a microsecond at 3.35 TB/s),
// so the bound is the pair tests on the CUDA cores, and at the wave loop's
// sizes launch latency dominates both. Later versions may tile the queued
// rows only, or sort per resource segment, where Q grows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_admission_kernel(const int* __restrict__ res_q,
                       const float* __restrict__ pkey,
                       const int* __restrict__ enq_wave,
                       const int* __restrict__ free_slots,
                       uint8_t* __restrict__ out, int n, int nres) {
  __shared__ int s_res[kThreads];
  __shared__ float s_pk[kThreads];
  __shared__ int s_wv[kThreads];

  const long long base = (long long)blockIdx.y * n;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int ri = nres;
  float pi = 0.0f;
  int wi = 0;
  if (i < n) {
    ri = res_q[base + i];
    pi = pkey[base + i];
    wi = enq_wave[base + i];
  }
  const bool queued = i < n && ri >= 0 && ri < nres;

  int seat = 0;
  // every thread reaches the barrier; the whole block skips the walk when
  // none of its rows is queued
  if (__syncthreads_or(queued)) {
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      const int j = j0 + threadIdx.x;
      if (j < n) {
        s_res[threadIdx.x] = res_q[base + j];
        s_pk[threadIdx.x] = pkey[base + j];
        s_wv[threadIdx.x] = enq_wave[base + j];
      }
      __syncthreads();
      if (queued) {
        const int m = min(kThreads, n - j0);
        for (int t = 0; t < m; ++t) {
          if (s_res[t] == ri) {
            const float pj = s_pk[t];
            const int wj = s_wv[t];
            const bool lt = pj < pi ||
                (pj == pi && (wj < wi || (wj == wi && j0 + t < i)));
            seat += lt;
          }
        }
      }
      __syncthreads();
    }
  }
  if (i < n) {
    const bool adm =
        queued && seat < free_slots[(long long)blockIdx.y * nres + ri];
    out[base + i] = adm ? 1 : 0;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, so the caller must check it. Allocates nothing.
extern "C" int fused_admission_launch(const void* res_q, const void* pkey,
                                      const void* enq_wave,
                                      const void* free_slots, void* out,
                                      int r, int n, int nres, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, r);
  fused_admission_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)res_q, (const float*)pkey, (const int*)enq_wave,
      (const int*)free_slots, (uint8_t*)out, n, nres);
  return (int)cudaGetLastError();
}
