// Exact c-server FIFO stations, one per row, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/queue_scan.py::_queue_kernel (called
// through queue_scan, public in repro/kernels/ops.py). Same function:
//
//   ready, service [R, N] f32, each row's jobs sorted by ready time;
//   per row, slots[capacity] = 0, then for each job j in order:
//     k = argmin(slots), start_j = max(ready_j, slots[k]),
//     finish_j = start_j + service_j, slots[k] = finish_j
//   start, finish [R, N] f32.
//
// Comparisons and one f32 add per job: the result is exact, and equal bit
// for bit to the plain version (repro_torch/kernels/ref.py::queue_scan_ref)
// and to the TPU kernel. Which of several equal slots is taken changes no
// start or finish (the chosen value and the multiset of slots are the
// same); ties go to the lowest slot, as argmin does. The one add is
// __fadd_rn, which the compiler never contracts into an FMA.
//
// Design: one warp per station. Lane l holds slots l, l + 32, ... (K per
// lane) in registers; slots past the capacity hold +inf and, on ties, lose
// to every real slot (lower index). Per job, each lane takes its own
// minimum and a shuffle reduction finds the warp's (over as many rounds as
// the capacity needs: none for c = 1); the owner lane updates its slot. The
// warp loads 32 jobs at a time, one per lane, broadcasts them by shuffles,
// and stores the 32 starts and finishes as one coalesced row segment.
//
// What bounds it on an H100: the bytes (ready and service read once, start
// and finish written once: 16 B per job; chip_smoke.py puts them at
// 0.0801 ms for R = N = 4096 on an NVIDIA H100 80GB HBM3, 700 W); the
// operations are a few compares per job. The job loop is a dependent chain
// per station (each job needs the previous job's update), so the kernel is
// bound by that chain's latency: a dozen instructions and up to ten
// dependent shuffles per job, hidden only by the other stations' warps on
// the same SM (measured 0.29 ms at c = 1 to 2.31 ms at c = 64 there).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;   // stations per block
constexpr unsigned kFull = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
queue_scan_kernel(const float* __restrict__ ready,
                  const float* __restrict__ service,
                  float* __restrict__ start, float* __restrict__ finish,
                  int R, int N, int capacity, int levels) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp leaves together
  float slots[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    slots[k] = lane + 32 * k < capacity ? 0.0f : INFINITY;
  const long long base = (long long)row * N;

  for (int j0 = 0; j0 < N; j0 += 32) {
    const int jl = j0 + lane;
    const float r_l = jl < N ? ready[base + jl] : 0.0f;
    const float s_l = jl < N ? service[base + jl] : 0.0f;
    float st_l = 0.0f, fi_l = 0.0f;
    const int m = min(32, N - j0);
    for (int t = 0; t < m; ++t) {
      float v = slots[0];
      int id = lane;
#pragma unroll
      for (int k = 1; k < K; ++k)
        if (slots[k] < v) {
          v = slots[k];
          id = lane + 32 * k;
        }
      for (int l = 0; l < levels; ++l) {
        const float ov = __shfl_xor_sync(kFull, v, 1 << l);
        const int oid = __shfl_xor_sync(kFull, id, 1 << l);
        if (ov < v || (ov == v && oid < id)) {
          v = ov;
          id = oid;
        }
      }
      if (levels < 5) {  // the real slots are in lanes [0, 2^levels)
        v = __shfl_sync(kFull, v, 0);
        id = __shfl_sync(kFull, id, 0);
      }
      const float r = __shfl_sync(kFull, r_l, t);
      const float sv = __shfl_sync(kFull, s_l, t);
      const float s = fmaxf(r, v);
      const float f = __fadd_rn(s, sv);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (id == lane + 32 * k) slots[k] = f;
      if (lane == t) {
        st_l = s;
        fi_l = f;
      }
    }
    if (jl < N) {
      start[base + jl] = st_l;
      finish[base + jl] = fi_l;
    }
  }
}

template <int K>
int launch(const float* ready, const float* service, float* start,
           float* finish, int R, int N, int capacity, cudaStream_t stream) {
  int levels = 0;
  while ((1 << levels) < capacity && levels < 5) ++levels;
  const int blocks = (R + kWarps - 1) / kWarps;
  queue_scan_kernel<K><<<blocks, kWarps * 32, 0, stream>>>(
      ready, service, start, finish, R, N, capacity, levels);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, so the caller must check it. Allocates nothing; start and
// finish hold R * N floats. Takes 1 <= capacity <= 256.
extern "C" int queue_scan_launch(const void* ready, const void* service,
                                 void* start, void* finish, int R, int N,
                                 int capacity, void* stream) {
  if (R < 1 || N < 1 || capacity < 1 || capacity > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* rd = (const float*)ready;
  const float* sv = (const float*)service;
  float* s = (float*)start;
  float* f = (float*)finish;
  if (capacity <= 32) return launch<1>(rd, sv, s, f, R, N, capacity, st);
  if (capacity <= 64) return launch<2>(rd, sv, s, f, R, N, capacity, st);
  if (capacity <= 128) return launch<4>(rd, sv, s, f, R, N, capacity, st);
  return launch<8>(rd, sv, s, f, R, N, capacity, st);
}
