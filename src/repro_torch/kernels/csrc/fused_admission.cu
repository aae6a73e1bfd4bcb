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
// What bounds it on an H100: the bytes are tiny (12 B in per row, 1 B out;
// about 1.1 MB at R = 32, N = 2,673, a third of a microsecond at 3.35 TB/s)
// and the function's work is one test per ordered pair of queued rows on a
// resource: on the wave loop's inputs about 30 queued rows per replica, so
// launch latency and a few dependent global reads are the floor. The first
// version gave each row a thread that walked all N columns in series, and a
// block with one queued row waited for all 256 threads' walks: 90.7 us per
// launch on the main path, for a few hundred useful tests per replica.
//
// Design: grid (ceil(N / 64), R), 256 threads; the first 64 threads own
// one row of the block's chunk each.
//   1. The block votes whether its chunk holds a queued row; if none does,
//      it writes zeros and exits.
//   2. It compacts its own queued rows into shared memory (their keys and
//      a zero seat), in row order, by __ballot_sync / __popc offsets.
//   3. All 256 threads read the replica's res column, 8 passes of 256 at a
//      time (the loads of the 8 passes in flight together), then pkey and
//      wave of the queued columns only, and append the queued columns,
//      stably, to a shared tile of up to kCap entries (res, pkey, wave, id
//      as one int4: one 16-byte shared load per test).
//   4. Whenever the tile could overflow, and at the end, each queued row of
//      the chunk gets a warp: the lanes stride over the tile, each testing
//      same resource and a lexicographically smaller (pkey, wave, id), and
//      __reduce_add_sync sums their counts into the row's seat. So any N
//      works, and a replica whose queued rows outnumber kCap takes several
//      tiles.
//   5. Each owning thread tests its row's seat against free[res] and
//      writes the mask.
// One launch, no global scratch. The work is Q_chunk x Q_replica pair
// tests per block plus one coalesced read of the replica's res; 64-row
// chunks spread a replica's queue, which is skewed (0 to 2,128 queued rows
// per input on the main path), over 4x more blocks than 256-row ones.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                // rows per block
constexpr int kThreads = 256;            // columns per pass
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 8;               // passes whose loads fly together
constexpr int kCap = 2048;               // compacted columns per shared tile

// 1 if column c = (res, pkey bits, wave, id) is on resource r and its key
// is lexicographically smaller than (p, w, i): float compares, as the
// reference (-0.0 == 0.0)
__device__ __forceinline__ unsigned counts(int4 c, int r, float p, int w,
                                           int i) {
  const float pc = __int_as_float(c.y);
  return c.x == r &&
         (pc < p || (pc == p && (c.z < w || (c.z == w && c.w < i))));
}

__global__ void __launch_bounds__(kThreads)
fused_admission_kernel(const int* __restrict__ res_q,
                       const float* __restrict__ pkey,
                       const int* __restrict__ enq_wave,
                       const int* __restrict__ free_slots,
                       uint8_t* __restrict__ out, int n, int nres) {
  __shared__ int4 tile[kCap];       // (res, pkey bits, wave, id)
  __shared__ int4 q_key[kRows];     // the chunk's queued rows, likewise
  __shared__ int q_seat[kRows];
  __shared__ int w_cnt[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.y * n;
  // thread tid < kRows owns row i of the chunk
  const int i = blockIdx.x * kRows + tid;
  const bool own = tid < kRows && i < n;

  int ri = nres;
  if (own) ri = res_q[base + i];
  const bool queued = own && ri >= 0 && ri < nres;
  // 1. a chunk without a queued row admits nothing
  if (!__syncthreads_or(queued)) {
    if (own) out[base + i] = 0;
    return;
  }

  // 2. the chunk's queued rows, in row order
  unsigned ballot = __ballot_sync(0xffffffffu, queued);
  if (lane == 0) w_cnt[warp] = __popc(ballot);
  __syncthreads();
  int qi = __popc(ballot & lt_mask);
  int nq = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    qi += w < warp ? w_cnt[w] : 0;
    nq += w_cnt[w];
  }
  if (queued) {
    q_key[qi] = make_int4(ri, __float_as_int(pkey[base + i]),
                          enq_wave[base + i], i);
    q_seat[qi] = 0;
  }

  // 3. the replica's queued columns, appended stably to the tile; 4. each
  // queued row of the chunk counted against the tile by one warp
  int cnt = 0;   // entries in the tile (the same in every thread)
  auto count_tile = [&]() {
    __syncthreads();   // the tile (and the q_ lists) are written
    for (int r = warp; r < nq; r += kWarps) {
      const int4 k = q_key[r];
      const float pr = __int_as_float(k.y);
      unsigned c = 0;
      for (int t = lane; t < cnt; t += 32)
        c += counts(tile[t], k.x, pr, k.z, k.w);
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0) q_seat[r] += (int)c;
    }
    __syncthreads();   // the tile may be overwritten
    cnt = 0;
  };

  for (int g0 = 0; g0 < n; g0 += kThreads * kPasses) {
    int rj[kPasses];
    float pj[kPasses];
    int wj[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int j = g0 + u * kThreads + tid;
      pj[u] = 0.0f;
      wj[u] = 0;
      rj[u] = j < n ? res_q[base + j] : nres;
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int j = g0 + u * kThreads + tid;
      if (rj[u] >= 0 && rj[u] < nres) {
        pj[u] = pkey[base + j];
        wj[u] = enq_wave[base + j];
      }
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int j = g0 + u * kThreads + tid;
      if (g0 + u * kThreads >= n) break;   // the same in every thread
      if (cnt > kCap - kThreads) count_tile();
      const bool qj = rj[u] >= 0 && rj[u] < nres;
      ballot = __ballot_sync(0xffffffffu, qj);
      __syncthreads();   // the previous pass has read w_cnt
      if (lane == 0) w_cnt[warp] = __popc(ballot);
      __syncthreads();
      int off = cnt + __popc(ballot & lt_mask);
      int added = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        off += w < warp ? w_cnt[w] : 0;
        added += w_cnt[w];
      }
      if (qj) tile[off] = make_int4(rj[u], __float_as_int(pj[u]), wj[u], j);
      cnt += added;
    }
  }
  count_tile();

  // 5. the mask
  if (own) {
    const bool adm =
        queued && q_seat[qi] < free_slots[(long long)blockIdx.y * nres + ri];
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
  const dim3 grid((n + kRows - 1) / kRows, r);
  fused_admission_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)res_q, (const float*)pkey, (const int*)enq_wave,
      (const int*)free_slots, (uint8_t*)out, n, nres);
  return (int)cudaGetLastError();
}
