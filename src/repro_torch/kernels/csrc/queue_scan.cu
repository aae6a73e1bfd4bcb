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
// Sorted slots instead of an arg-min. Each station keeps its c slots in
// ascending order, a[0..W) with a[c..W) = +inf and a[W] = +inf past the end
// (W, the route's width, is S * G >= c). The earliest free slot is a[0], so
//   start = fmaxf(ready, a[0]), finish = __fadd_rn(start, service),
// and the step drops a[0] and inserts finish:
//   a'[0] = min(a[1], finish), a'[k] = max(a[k], min(a[k+1], finish)),
// one min and one max per slot, independent of each other: no arg-min and
// no owner search. The value taken is the minimum, whichever of several
// equal slots the plain version takes, and the multiset of slots after the
// step is the arg-min update's, so every start and finish equals the plain
// version's (repro_torch/kernels/ref.py::queue_scan_ref) bit for bit. The
// one add is __fadd_rn, which the compiler never contracts into an FMA.
//
// Routes (S, G): a station's sorted list is split over G lanes of S slots
// each, held in registers, so a warp serves 32 / G stations. At G = 1 a job
// costs no shuffle; at G > 1 two within the group: the group's a[0] from
// its first lane, and the next lane's first slot (the a[k+1] of a lane's
// last slot), which does not depend on the job. queue_scan_route picks the
// route from the capacity (the table in route_for, set by measurement on
// the card with tools/bench_queue_scan.py). The parent design, a warp per
// station with a shuffle arg-min, measured slower at every capacity and
// is gone.
//
// Jobs staged through shared memory. A block owns ROWS stations: CW
// consumer warps walk them, one producer warp moves the data. The producer
// copies [ROWS x kT jobs] tiles of ready and service into a ring of kStages
// stages by cp.async (16 bytes a thread where N % 4 == 0 and the pointers
// are 16-byte aligned, else 4), each stage's copies completing on its
// mbarrier; the consumers read a job's ready and service time four at a
// time from their row, write its start and finish over them, and release
// the stage; the producer stores the stage as coalesced row segments and
// refills it. Rows are padded by 4 floats so that the rows of one warp's
// float4 reads fall on different banks.
//
// What bounds it on an H100: the bytes (ready and service read once, start
// and finish written once: 16 B per job; chip_smoke.py puts them at
// 0.0801 ms for R = N = 4096 on an NVIDIA H100 80GB HBM3, 700 W); the
// operations are a few per job. The job loop is a dependent chain per
// station, and 4,096 stations at G = 1 are 128 warps on 132 SMs, so the
// time is one warp's chain and issue slots over the row's jobs, or, with
// more lanes a station, the SM's issue slots for the min/max of every
// slot. At c <= 8 a job is a max, an add, 2S - 1 min/max and a quarter of
// each of four shared-memory accesses, with no shuffle and no memory on
// the chain, under the time the copies take: the kernel runs at the rate
// the producer warps stream (about 0.099 ms there). Above 8 slots the
// min/max set the time (about 0.15 ms at c = 32 and 0.22 ms at c = 64;
// tools/bench_queue_scan.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;           // jobs per tile
constexpr int kStride = kT + 4;   // a tile row in shared memory, in floats
constexpr int kStages = 6;        // ring depth
constexpr unsigned kFull = 0xffffffffu;

// consumer warps of a block: rows per block = CW * 32 / G (32 up to G = 8)
__host__ __device__ constexpr int consumer_warps(int G) {
  return G < 8 ? G : 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The thread's arrival on `bar` once all its earlier cp.async have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  if (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src) : "memory");
}

// One job of a station whose sorted slots are x (this lane's S of them);
// gl is the lane's place in its group of G. Returns the start, sets f.
template <int S, int G>
__device__ __forceinline__ float step(float (&x)[S], float r, float sv,
                                      float& f, int gl) {
  float a0 = x[0], nx = INFINITY;
  if (G > 1) {
    a0 = __shfl_sync(kFull, x[0], 0, G);
    const float up = __shfl_down_sync(kFull, x[0], 1, G);
    nx = gl == G - 1 ? INFINITY : up;
  }
  const float s = fmaxf(r, a0);
  f = __fadd_rn(s, sv);
  // a'[0] of the group has no max: finish may lie below the slot it frees
  const float lo = gl == 0 ? -INFINITY : x[0];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    // (the inner index only keeps the untaken branch in bounds)
    const float hi = k + 1 < S ? x[k + 1 < S ? k + 1 : 0] : nx;
    const float m = (G == 1 && k == S - 1) ? f : fminf(hi, f);
    if (G == 1 && k == 0)
      x[0] = m;
    else
      x[k] = fmaxf(k == 0 ? lo : x[k], m);
  }
  return s;
}

template <int S, int G, int VEC>
__global__ void __launch_bounds__((consumer_warps(G) + 1) * 32)
queue_scan_kernel(const float* __restrict__ ready,
                  const float* __restrict__ service,
                  float* __restrict__ start, float* __restrict__ finish,
                  int R, int N, int capacity) {
  constexpr int CW = consumer_warps(G);
  constexpr int ROWS = CW * 32 / G;
  constexpr int TILE = ROWS * kStride;      // floats of one array's tile
  extern __shared__ __align__(16) float tiles[];  // [stage][ready|service]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, R - row0);
  const int n_tiles = (N + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 32);
      mbar_init(smem_u32(&empty[s]), CW * 32);
    }
  }
  __syncthreads();

  if (warp == CW) {
    // producer: store tile t - kStages, then load tile t into its stage;
    // a lane copies and stores the same words, so it overwrites only what
    // it has itself read
    constexpr int PER = VEC == 4 ? kT / 4 : kT;   // copies per tile row
    for (int t = 0; t < n_tiles + kStages; ++t) {
      const int s = t % kStages;
      float* rd = tiles + 2 * s * TILE;
      float* sv = rd + TILE;
      if (t >= kStages) {
        const int u = t - kStages;
        mbar_wait(smem_u32(&empty[s]), (u / kStages) & 1);
        const int j0 = u * kT, m = min(kT, N - j0);
#pragma unroll 4
        for (int c = lane; c < ROWS * PER; c += 32) {
          const int r = c / PER, j = (c % PER) * VEC;
          if (r < rows && j < m) {
            const long long g = (long long)(row0 + r) * N + j0 + j;
            if (VEC == 4) {
              *reinterpret_cast<float4*>(start + g) =
                  *reinterpret_cast<const float4*>(rd + r * kStride + j);
              *reinterpret_cast<float4*>(finish + g) =
                  *reinterpret_cast<const float4*>(sv + r * kStride + j);
            } else {
              start[g] = rd[r * kStride + j];
              finish[g] = sv[r * kStride + j];
            }
          }
        }
      }
      if (t < n_tiles) {
        const int j0 = t * kT, m = min(kT, N - j0);
#pragma unroll 4
        for (int c = lane; c < ROWS * PER; c += 32) {
          const int r = c / PER, j = (c % PER) * VEC;
          if (r < rows && j < m) {
            const long long g = (long long)(row0 + r) * N + j0 + j;
            cp_async<VEC>(smem_u32(rd + r * kStride + j), ready + g);
            cp_async<VEC>(smem_u32(sv + r * kStride + j), service + g);
          }
        }
        cp_async_arrive(smem_u32(&full[s]));
      }
    }
    return;
  }

  // consumers: lane `lane` of warp `warp` holds slots [gl S, gl S + S) of
  // row rloc (rows past R compute on stale words and are never stored)
  const int gl = lane % G;
  const int rloc = warp * (32 / G) + lane / G;
  float x[S];
#pragma unroll
  for (int k = 0; k < S; ++k) x[k] = gl * S + k < capacity ? 0.0f : INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(smem_u32(&full[s]), (t / kStages) & 1);
    float* rd = tiles + 2 * s * TILE + rloc * kStride;
    float* sv = rd + TILE;
    const int m = min(kT, N - t * kT);
    if (m == kT) {
      // four jobs at a time; the next four are read before these are
      // walked (the last read falls in the row's padding)
      float4 r4 = *reinterpret_cast<const float4*>(rd);
      float4 s4 = *reinterpret_cast<const float4*>(sv);
#pragma unroll 2
      for (int q = 0; q < kT; q += 4) {
        const float4 rn = *reinterpret_cast<const float4*>(rd + q + 4);
        const float4 sn = *reinterpret_cast<const float4*>(sv + q + 4);
        float4 st4, fi4;
        st4.x = step<S, G>(x, r4.x, s4.x, fi4.x, gl);
        st4.y = step<S, G>(x, r4.y, s4.y, fi4.y, gl);
        st4.z = step<S, G>(x, r4.z, s4.z, fi4.z, gl);
        st4.w = step<S, G>(x, r4.w, s4.w, fi4.w, gl);
        *reinterpret_cast<float4*>(rd + q) = st4;
        *reinterpret_cast<float4*>(sv + q) = fi4;
        r4 = rn;
        s4 = sn;
      }
    } else {
      for (int j = 0; j < m; ++j) {
        float f;
        const float st = step<S, G>(x, rd[j], sv[j], f, gl);
        rd[j] = st;
        sv[j] = f;
      }
    }
    mbar_arrive(smem_u32(&empty[s]));
  }
}

template <int S, int G, int VEC>
int launch(const float* ready, const float* service, float* start,
           float* finish, int R, int N, int capacity, cudaStream_t stream) {
  constexpr int CW = consumer_warps(G);
  constexpr int ROWS = CW * 32 / G;
  const int smem = kStages * 2 * ROWS * kStride * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_scan_kernel<S, G, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  queue_scan_kernel<S, G, VEC><<<(R + ROWS - 1) / ROWS, (CW + 1) * 32, smem,
                                 stream>>>(ready, service, start, finish, R,
                                           N, capacity);
  return (int)cudaGetLastError();
}

template <int S, int G>
int launch_vec(const float* ready, const float* service, float* start,
               float* finish, int R, int N, int capacity,
               cudaStream_t stream) {
  const uintptr_t any = (uintptr_t)ready | (uintptr_t)service |
                        (uintptr_t)start | (uintptr_t)finish;
  if (N % 4 == 0 && any % 16 == 0)
    return launch<S, G, 4>(ready, service, start, finish, R, N, capacity,
                           stream);
  return launch<S, G, 1>(ready, service, start, finish, R, N, capacity,
                         stream);
}

// The route of a capacity: slots per lane S, lanes per station G. Set by
// tools/bench_queue_scan.py on an H100: up to 8 slots one lane holds them
// all (S = 2 and 4 were slower there than 8); from 65 slots 16 a lane
// beat 8 on twice the lanes.
void route_for(int capacity, int* S, int* G) {
  *S = capacity <= 1 ? 1 : capacity <= 64 ? 8 : 16;
  *G = capacity <= 8 ? 1 : capacity <= 16 ? 2 : capacity <= 32 ? 4
       : capacity <= 128 ? 8 : 16;
}

}  // namespace

// The route queue_scan_launch takes at this capacity (1 <= capacity <=
// 256): S slots per lane, G lanes per station. Returns 0, or
// cudaErrorInvalidValue for a capacity out of range.
extern "C" int queue_scan_route(int capacity, int* S, int* G) {
  if (capacity < 1 || capacity > 256) return (int)cudaErrorInvalidValue;
  route_for(capacity, S, G);
  return 0;
}

// Launches route (S, G) on `stream` and returns cudaGetLastError() (or the
// error of raising the kernel's shared-memory limit): a refused launch
// never runs, so the caller must check it. The routes are (1, 1), S = 8 at
// G in {1, 2, 4, 8} and S = 16 at G in {8, 16}; S * G must hold the
// capacity. Allocates nothing; start and finish hold R * N floats.
extern "C" int queue_scan_launch_route(const void* ready, const void* service,
                                       void* start, void* finish, int R,
                                       int N, int capacity, int S, int G,
                                       void* stream) {
  if (R < 1 || N < 1 || capacity < 1 || capacity > 256 || S * G < capacity)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* rd = (const float*)ready;
  const float* sv = (const float*)service;
  float* s = (float*)start;
  float* f = (float*)finish;
#define QS_ROUTE(SS, GG)                                              \
  if (S == SS && G == GG)                                             \
    return launch_vec<SS, GG>(rd, sv, s, f, R, N, capacity, st);
  QS_ROUTE(1, 1)
  QS_ROUTE(8, 1) QS_ROUTE(8, 2) QS_ROUTE(8, 4) QS_ROUTE(8, 8)
  QS_ROUTE(16, 8) QS_ROUTE(16, 16)
#undef QS_ROUTE
  return (int)cudaErrorInvalidValue;
}

// Launches on `stream` and returns cudaGetLastError(): a refused launch
// never runs, so the caller must check it. Allocates nothing; start and
// finish hold R * N floats. Takes 1 <= capacity <= 256, on the route
// queue_scan_route gives.
extern "C" int queue_scan_launch(const void* ready, const void* service,
                                 void* start, void* finish, int R, int N,
                                 int capacity, void* stream) {
  if (R < 1 || N < 1 || capacity < 1 || capacity > 256)
    return (int)cudaErrorInvalidValue;
  int S, G;
  route_for(capacity, &S, &G);
  return queue_scan_launch_route(ready, service, start, finish, R, N,
                                 capacity, S, G, stream);
}
