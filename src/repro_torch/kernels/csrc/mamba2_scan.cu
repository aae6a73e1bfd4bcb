// Mamba-2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba2_scan.py::_ssd_kernel (reached
// from repro/models/ssm.py::apply_mamba2 under impl="mamba_kernel" with no
// incoming state: every Mamba layer of the hybrid model's full-sequence
// forward). Same function:
//
//   x [B, S, H, P], dt [B, S, H], B/C [B, S, N] (shared by all heads), all
//   f32 or all bf16; A [H] f32; S % Q == 0 (Q = chunk).
//   For each (b, h), the chunks in order, state [P, N] f32 from zero:
//     cum_i   = sum_{k <= i} dt_k A               (within the chunk)
//     M[i,j]  = (C_i . B_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//     y_i     = sum_j M[i,j] x_j + exp(cum_i) state C_i
//     state  <- exp(cum_last) state + sum_j x_j (B_j exp(cum_last - cum_j) dt_j)
//   y [B, S, H, P] f32 and h_last [B, H, P, N] f32 (the state after the last
//   chunk). The readout uses the state before this chunk's update.
//
// What bounds it on an H100: per (b, h, chunk), the products C Bᵀ and M x
// over the pairs j <= i (N and P multiply-adds each), C stateᵀ and xᵀ(B w)
// (Q P N each), against x, dt, B, C read once and y, h_last written once.
// At the hybrid model's shapes (B = 2, S = 4096, H = 64, P = N = 64,
// Q = 128) chip_smoke.py puts the bytes at 0.0617 ms (the f32 y is most of
// them) and the operations at 0.0174 ms on the bf16 tensor cores: the bound
// is bytes.
//
// Two routes, chosen by the wrapper from the type and the shapes:
//
// bf16 with Q in {64, 128} and P, N multiples of 16 up to 64
// (mamba2_tc_kernel, every Mamba layer of the hybrid forward): the tensor
// cores, fed by TMA. The intra-chunk term has attention's shape (S = C Bᵀ
// like Q Kᵀ, then an elementwise weight, then a product with x like P V),
// so the kernel is built like the flash kernel's bf16 path.
//   - One block per (b, h) walks the chunks in order: Q / 64 consumer
//     warpgroups, each owning 64 rows of the chunk, and a producer
//     warpgroup. Its first thread keeps TMA loads of the next chunk's
//     x [Q, P] (a 3-D map over [B S, H, P]), B and C [Q, N] in a 2-stage
//     ring (128-byte swizzle; P and N below 64 are zero-filled by the
//     hardware to one 64-wide row). Its first warp reads the chunk's dt
//     column, runs the cum scan (dt_k A rounded before the add, as the
//     reference) and writes exp(cum_i), w_j = exp(cum_last - cum_j) dt_j
//     and exp(cum_last) once per chunk; then all four warps write B w as
//     bf16 hi + lo beside the stage, off the consumers' path. At Q = 128
//     it gives its registers to the consumers (setmaxnreg 56 / 224).
//   - S = C Bᵀ by wgmma m64nQk16, both operands the bf16 inputs, K-major:
//     the products are exact and the sums f32.
//   - y = C stateᵀ by wgmma from the state's bf16 hi + lo terms in shared
//     memory (zeros before the first chunk), scaled by exp(cum_i) per row
//     in registers.
//   - M = S exp(cum_i - cum_j) dt_j in the accumulator's fragment, zero for
//     j > i (never the exp of a positive difference), split into bf16
//     hi + lo and packed from registers as the A operand; y += M x by
//     wgmma m64n64k16 with x MN-major (the transpose bit). y is stored as
//     f32.
//   - The state [P, N] stays in f32 registers across the chunks, its
//     columns split between the warpgroups (m64n32 each at Q = 128):
//     state <- exp(cum_last) state, then += xᵀ (B w) by wgmma with x
//     MN-major as the A operand and B w's terms MN-major as B, the
//     descriptor starting at the warpgroup's columns inside the swizzled
//     row. Each warpgroup writes its columns' terms for the next chunk's
//     readout.
//   - Every warpgroup issues the same wgmma sequence, with no branch around
//     one (ptxas serializes wgmma in a divergent path): M x runs over all
//     Q columns in both warpgroups, M being zero past a warpgroup's rows.
//   - Why hi + lo: one bf16 rounding of M, the state or B w (2^-9
//     relative) breaks the gate of 2e-4 + 1e-4 |y|; hi + lo keeps about
//     16 bits, and the other operand (x, B, C) is an exact bf16 input.
//     tests/test_torch_mamba2_scan.py emulates this arithmetic on the CPU:
//     within 2 % of the gate, where one term misses it by 4-12x.
//   - Shared memory at Q = 128: 2 stages of x, B, C and B w (160 KB), the
//     state terms (16 KB), the chunk's scalars: dynamic, the limit raised
//     by the launcher. Tensor maps are built on the host per call, as the
//     flash kernel's.
//   - What is left: a chunk takes about 6 us, of which the tensor cores'
//     work is about 1.4 us at their peak; the chunks of one (b, h) run in
//     series and the 128 blocks of the hybrid's shape fill 128 of the 132
//     SMs once. The SSD block decomposition (chunk states in parallel, a
//     serial pass over the [P, N] states, the readout in parallel) is the
//     next step.
//
// Every other input (f32, which TF32 cannot hold to the gate, and small
// or odd shapes: P, N or Q of 4-16 or not a multiple of 16) takes
// mamba2_scan_kernel, the CUDA cores: one block of 256 threads per (b, h);
// the TPU's sequential grid axis over chunks becomes a loop inside the
// block, with the state in shared memory between chunks (stored
// transposed, [N][P], so a thread reads four p as one 16-byte load). Each
// chunk's x, B, C and dt are staged in shared memory as f32; the
// cumulative decay is a warp scan; M is computed only for j <= i and kept
// in shared memory for the product with x. Every product is f32 FMAs, each
// thread holding a 4 x 4 register tile. B and C rows are padded by 4
// floats so the M tile's 32 threads read 32 rows without bank conflicts
// (the rows are interleaved with stride Q/4 for that reason). Shared
// memory at Q = 128, P = N = 64 is 185 KB. It measured 1.20 ms on the
// hybrid's layer-0 inputs in bf16 (NVIDIA H100 80GB HBM3, 700 W), 19.5x
// the bound.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;   // floats of padding per row of B, C, M and state

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared memory in floats for (Q, P, N); every region starts 16-byte
// aligned because Q, P and N are multiples of 4.
__host__ __forceinline__ int smem_floats(int Q, int P, int N) {
  return Q * P + 2 * Q * (N + kPad) + Q * (Q + kPad) + N * (P + kPad) + 4 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, float* __restrict__ y,
                   float* __restrict__ h_last, int S, int H, int P, int N,
                   int Q) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + kPad, QP = Q + kPad, PP = P + kPad;
  float* xs = smem;                 // [Q][P]
  float* bs = xs + Q * P;           // [Q][NP]
  float* cs = bs + Q * NP;          // [Q][NP]
  float* ms = cs + Q * NP;          // [Q][QP]  M, zero above the diagonal
  float* st = ms + Q * QP;          // [N][PP]  the state, transposed
  float* cum = st + N * PP;         // [Q]
  float* ecum = cum + Q;            // [Q]      exp(cum_i)
  float* wj = ecum + Q;             // [Q]      exp(cum_last - cum_j) dt_j
  float* dts = wj + Q;              // [Q]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const float a = A[h];
  const int q4 = Q / 4, p4 = P / 4, n4 = N / 4;

  for (int i = tid; i < N * PP; i += kThreads) st[i] = 0.0f;

  for (int c = 0; c < S / Q; ++c) {
    const long long row0 = (long long)b * S + (long long)c * Q;
    __syncthreads();  // the previous chunk is done with xs, bs, dts, st

    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      xs[idx] = to_f32(x[((row0 + j) * H + h) * P + p]);
    }
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      bs[j * NP + n] = to_f32(Bm[(row0 + j) * N + n]);
      cs[j * NP + n] = to_f32(Cm[(row0 + j) * N + n]);
    }
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = to_f32(dt[(row0 + j) * H + h]);
    __syncthreads();

    // cum: warp 0, each lane a run of consecutive steps, then a shuffle
    // scan of the runs. dt_k A is rounded before the add, as the reference's
    // dA = dt * A is.
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int j0 = min(tid * per, Q), j1 = min(j0 + per, Q);
      float run = 0.0f;
      for (int j = j0; j < j1; ++j) run += __fmul_rn(dts[j], a);
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) acc = 0.0f;
      for (int j = j0; j < j1; ++j) {
        acc += __fmul_rn(dts[j], a);
        cum[j] = acc;
      }
    }
    __syncthreads();
    const float cum_last = cum[Q - 1];
    for (int j = tid; j < Q; j += kThreads) {
      ecum[j] = expf(cum[j]);
      wj[j] = expf(cum_last - cum[j]) * dts[j];
    }

    // M: rows i = ti + q4 r, columns j = tj + q4 s. For s > r every j > i,
    // so those tiles are only zeroed; for s == r the mask is per entry.
    for (int item = tid; item < q4 * q4; item += kThreads) {
      const int ti = item / q4, tj = item - ti * q4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = ld4(cs + (ti + q4 * r) * NP + n);
          bv[r] = ld4(bs + (tj + q4 * r) * NP + n);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s <= r; ++s) {
            float t = acc[r][s];
            t = fmaf(cv[r].x, bv[s].x, t);
            t = fmaf(cv[r].y, bv[s].y, t);
            t = fmaf(cv[r].z, bv[s].z, t);
            t = fmaf(cv[r].w, bv[s].w, t);
            acc[r][s] = t;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + q4 * r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = tj + q4 * s;
          float m = 0.0f;
          if (s <= r && j <= i)
            m = acc[r][s] * expf(cum[i] - cum[j]) * dts[j];
          ms[i * QP + j] = m;
        }
      }
    }
    __syncthreads();

    // y: rows i0..i0+3, columns p0..p0+3. M is zero above the diagonal, so
    // the intra-chunk sum stops at j = i0 + 3.
    for (int item = tid; item < q4 * p4; item += kThreads) {
      const int ti = item / p4, tp = item - ti * p4;
      const int i0 = 4 * ti, p0 = 4 * tp;
      float yi[4][4], yo[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) yi[r][s] = yo[r][s] = 0.0f;
      for (int j = 0; j < i0 + 4; ++j) {
        const float4 xv = ld4(xs + j * P + p0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float m = ms[(i0 + r) * QP + j];
          yi[r][0] = fmaf(m, xv.x, yi[r][0]);
          yi[r][1] = fmaf(m, xv.y, yi[r][1]);
          yi[r][2] = fmaf(m, xv.z, yi[r][2]);
          yi[r][3] = fmaf(m, xv.w, yi[r][3]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 sv = ld4(st + n * PP + p0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cval = cs[(i0 + r) * NP + n];
          yo[r][0] = fmaf(cval, sv.x, yo[r][0]);
          yo[r][1] = fmaf(cval, sv.y, yo[r][1]);
          yo[r][2] = fmaf(cval, sv.z, yo[r][2]);
          yo[r][3] = fmaf(cval, sv.w, yo[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecum[i0 + r];
        float4 out;
        out.x = yi[r][0] + yo[r][0] * e;
        out.y = yi[r][1] + yo[r][1] * e;
        out.z = yi[r][2] + yo[r][2] * e;
        out.w = yi[r][3] + yo[r][3] * e;
        *reinterpret_cast<float4*>(y + ((row0 + i0 + r) * H + h) * P + p0) =
            out;
      }
    }
    __syncthreads();  // every readout of the old state is done

    // state: rows n0..n0+3, columns p0..p0+3 of the transposed state.
    const float decay = expf(cum_last);
    for (int item = tid; item < n4 * p4; item += kThreads) {
      const int tn = item / p4, tp = item - tn * p4;
      const int n0 = 4 * tn, p0 = 4 * tp;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
      for (int j = 0; j < Q; ++j) {
        const float w = wj[j];
        const float4 bv = ld4(bs + j * NP + n0);
        const float4 xv = ld4(xs + j * P + p0);
        const float bw[4] = {bv.x * w, bv.y * w, bv.z * w, bv.w * w};
        const float xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(bw[r], xw[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* row = st + (n0 + r) * PP + p0;
        float4 v = ld4(row);
        v.x = v.x * decay + acc[r][0];
        v.y = v.y * decay + acc[r][1];
        v.z = v.z * decay + acc[r][2];
        v.w = v.w * decay + acc[r][3];
        *reinterpret_cast<float4*>(row) = v;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    const int p = idx / N, n = idx - p * N;
    h_last[((long long)bh * P + p) * N + n] = st[n * PP + p];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* h_last, int B, int S, int H, int P,
           int N, int Q, cudaStream_t stream) {
  const int smem = smem_floats(Q, P, N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  mamba2_scan_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)x, (const T*)dt, (const float*)A, (const T*)Bm, (const T*)Cm,
      (float*)y, (float*)h_last, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 on the tensor cores

constexpr int kW = 64;           // P and N padded to one 128-byte swizzled row
constexpr int kTileRowBytes = kW * 2;
constexpr int kStagesTC = 2;     // ring depth of the chunk loads
constexpr int kTerms = 2;        // bf16 terms of an f32 operand: hi, lo
// setmaxnreg at Q = 128: the producer warpgroup's registers and the
// consumers' (the 384 threads start at 168: 128 x 56 + 256 x 224 = 384 x
// 168); at Q = 64 the 256 threads have room without it
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase differs from `parity`.
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

// One box {64 columns, 1 head, Q rows} of the [B S, H, P] view of x.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar) : "memory");
}

// One box {64 columns, Q rows} of the [B S, N] view of B or C.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// 8-row groups lie 1,024 B apart (as the flash kernel's): K-major tiles
// advance along K by 32 B inside the row, MN-major tiles by 16 rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (the B w and state terms) made
// visible to the tensor cores' (async proxy) reads after the next barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroups' own barrier (id 1; __syncthreads uses 0).
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}
// The producer warpgroup's (id 2).
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, f32) {=, +=} A (64 x 16) . B (128 x 16)^T, both K-major in
// shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) {=, +=} A (64 x 16) . B (16 x 64), both in shared
// memory; TA / TB = 1 for an MN-major operand (the transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 32, f32) {=, +=} A (64 x 16) . B (16 x 32), as wgmma_ss_n64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15 }, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// An f32 pair split into bf16 hi = bf16(v) and lo = bf16(v - hi), each
// packed as two bf16 (the first value in the low half).
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int Q>
struct alignas(1024) SmemSSD {
  __nv_bfloat16 x[kStagesTC][Q * kW];   // [j][p] (TMA, 128-byte swizzle)
  __nv_bfloat16 b[kStagesTC][Q * kW];   // [j][n]
  __nv_bfloat16 c[kStagesTC][Q * kW];   // [i][n]
  __nv_bfloat16 bw[kStagesTC][kTerms][Q * kW];  // B_j w_j, b's layout
  __nv_bfloat16 st[kTerms][kW * kW];    // the state as bf16 terms, [p][n]
  float cum[kStagesTC][Q];
  float ecum[kStagesTC][Q];             // exp(cum_i)
  float w[kStagesTC][Q];                // exp(cum_last - cum_j) dt_j
  float dt[kStagesTC][Q];
  float decay[kStagesTC];               // exp(cum_last)
  uint64_t full[kStagesTC];
  uint64_t empty[kStagesTC];
  uint64_t loaded[kStagesTC];           // the stage's TMA bytes
};

// One block per (b, h): Q / 64 consumer warpgroups (warpgroup g owns the
// chunk's rows [64 g, 64 g + 64)) and a producer warpgroup.
template <int Q>
__global__ void __launch_bounds__(Q * 2 + 128, 1)
mamba2_tc_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const __nv_bfloat16* __restrict__ dt,
                 const float* __restrict__ A, float* __restrict__ y,
                 float* __restrict__ h_last, int S, int H, int P, int N) {
  constexpr int kCons = Q * 2;          // consumer threads
  constexpr int kJ = Q / 8;             // 8-column groups of a score row
  constexpr int kTileBytes = Q * kTileRowBytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms (8 rows x 128 B) must sit on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  SmemSSD<Q>& sm = *reinterpret_cast<SmemSSD<Q>*>(
      smem_raw + ((1024 - (raw & 1023)) & 1023));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int n_chunks = S / Q;

  if (tid == 0) {
    for (int s = 0; s < kStagesTC; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 128);      // the producer warpgroup
      mbar_init(smem_u32(&sm.empty[s]), kCons);
      mbar_init(smem_u32(&sm.loaded[s]), 1);      // the tx arrive
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the first chunk reads a zero state
  for (int e = tid; e < kTerms * kW * kW / 8; e += blockDim.x)
    reinterpret_cast<uint4*>(sm.st)[e] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  __syncthreads();

  if (tid >= kCons) {
    // ---- producer warpgroup (it gives registers to the consumers): one
    // thread issues the chunk's TMA loads, one warp reads the chunk's dt
    // column and computes its decays, and then all four split B w into
    // bf16 hi + lo in b's swizzled layout (the swizzle permutes 16-byte
    // pieces inside a 128-byte row, so piece t is row t / 8)
    if constexpr (Q == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kCons;
    const int lane = pt % 32;
    constexpr int per = Q / 32;
    const float a = A[h];
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStagesTC;
      mbar_wait(smem_u32(&sm.empty[s]), ((c / kStagesTC) & 1) ^ 1);
      const int row0 = b * S + c * Q;
      const uint32_t loaded = smem_u32(&sm.loaded[s]);
      if (pt == 0) {
        mbar_expect_tx(loaded, 3 * kTileBytes);
        tma_load_3d(smem_u32(sm.x[s]), &tx, loaded, 0, h, row0);
        tma_load_2d(smem_u32(sm.b[s]), &tb, loaded, 0, row0);
        tma_load_2d(smem_u32(sm.c[s]), &tc, loaded, 0, row0);
      }
      if (pt < 32) {
        // cum: each lane a run of `per` steps, then a shuffle scan of the
        // runs; dt_k A is rounded before the add, as the reference's
        // dA = dt * A is
        const int j0 = lane * per;
        float d[per];
        float run = 0.0f;
#pragma unroll
        for (int k = 0; k < per; ++k) {
          d[k] = __bfloat162float(dt[((long long)row0 + j0 + k) * H + h]);
          run += __fmul_rn(d[k], a);
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float v = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += v;
        }
        float acc = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) acc = 0.0f;
        float cv[per];
#pragma unroll
        for (int k = 0; k < per; ++k) {
          acc += __fmul_rn(d[k], a);
          cv[k] = acc;
        }
        const float last = __shfl_sync(0xffffffffu, acc, 31);
#pragma unroll
        for (int k = 0; k < per; ++k) {
          sm.cum[s][j0 + k] = cv[k];
          sm.ecum[s][j0 + k] = expf(cv[k]);
          sm.w[s][j0 + k] = expf(last - cv[k]) * d[k];
          sm.dt[s][j0 + k] = d[k];
        }
        if (lane == 0) sm.decay[s] = expf(last);
      }
      producers_sync();
      mbar_wait(loaded, (c / kStagesTC) & 1);
      for (int t = pt; t < Q * 8; t += 128) {
        const float wj = sm.w[s][t >> 3];
        const uint4 in = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const uint8_t*>(sm.b[s]) + t * 16);
        const uint32_t* iw = reinterpret_cast<const uint32_t*>(&in);
        uint4 hi, lo;
        uint32_t* hw = reinterpret_cast<uint32_t*>(&hi);
        uint32_t* lw2 = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&iw[e]));
          split2(f.x * wj, f.y * wj, hw[e], lw2[e]);
        }
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(sm.bw[s][0]) +
                                  t * 16) = hi;
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(sm.bw[s][1]) +
                                  t * 16) = lo;
      }
      fence_async_smem();
      mbar_arrive(smem_u32(&sm.full[s]));
    }
    return;
  }

  // ---- consumers. Every warpgroup issues the same wgmma sequence (no
  // branch around one, which would make ptxas serialize them): each
  // carries the state's columns [kNS g, kNS g + kNS), and each runs M x
  // over all the chunk's columns (M is zero past its rows)
  if constexpr (Q == 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid / 128;
  const int lw = (tid % 128) / 32;
  const int lane = tid % 32;
  const int ri = wg * 64 + lw * 16 + lane / 4;   // this thread's rows ri, ri + 8
  const int col = 2 * (lane % 4);                // + 8 j: its columns

  constexpr int kNS = kW * 64 / Q;   // state columns per warpgroup
  float st[kNS / 2];   // the state [p][n0 + n], n0 = kNS wg, f32
  float ya[32];        // y rows ri, ri + 8, columns p
#pragma unroll
  for (int e = 0; e < kNS / 2; ++e) st[e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStagesTC;
    __nv_bfloat16 (&bw)[kTerms][Q * kW] = sm.bw[s];
    mbar_wait(smem_u32(&sm.full[s]), (c / kStagesTC) & 1);

    // the state terms written at the end of the last chunk
    consumers_sync(kCons);

    // S = C B^T (rows ri, ri + 8; all Q columns) and y = C . state^T over
    // the state's bf16 terms
    float sc[Q / 2];
    fence_regs(sc);
    fence_regs(ya);
    wgmma_fence();
    const uint32_t cw = smem_u32(sm.c[s]) + wg * 64 * kTileRowBytes;
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk) {
      const uint64_t da = smem_desc(cw + kk * 32);
      const uint64_t db = smem_desc(smem_u32(sm.b[s]) + kk * 32);
      if constexpr (Q == 128) {
        wgmma_ss_n128(sc, da, db, kk > 0);
      } else {
        wgmma_ss_n64<0, 0>(sc, da, db, kk > 0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk)
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        wgmma_ss_n64<0, 0>(ya, smem_desc(cw + kk * 32),
                           smem_desc(smem_u32(sm.st[t]) + kk * 32),
                           kk > 0 || t > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(ya);
    // every warpgroup is done reading the state terms
    consumers_sync(kCons);

    // y *= exp(cum_i); M = S exp(cum_i - cum_j) dt_j for j <= i, else 0
    // (never the exp of a positive difference), split into bf16 hi + lo
    // and packed as wgmma A fragments: k-step kk takes columns 16 kk ..
    const float* cum = sm.cum[s];
    const float* dts = sm.dt[s];
    const float c0 = cum[ri], c1 = cum[ri + 8];
    const float e0 = sm.ecum[s][ri], e1 = sm.ecum[s][ri + 8];
#pragma unroll
    for (int e = 0; e < 32; ++e) ya[e] *= (e & 2) ? e1 : e0;
    uint32_t mhi[Q / 4], mlo[Q / 4];
#pragma unroll
    for (int jt = 0; jt < kJ; ++jt) {
      const int j = 8 * jt + col;
      const float2 cj = *reinterpret_cast<const float2*>(cum + j);
      const float2 dj = *reinterpret_cast<const float2*>(dts + j);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = ri + 8 * r;
        const float ci = r ? c1 : c0;
        const float m0 =
            j <= i ? sc[4 * jt + 2 * r] * expf(ci - cj.x) * dj.x : 0.f;
        const float m1 =
            j + 1 <= i ? sc[4 * jt + 2 * r + 1] * expf(ci - cj.y) * dj.y
                       : 0.f;
        // A fragment order: (row, k lo), (row + 8, k lo), (row, k hi),
        // (row + 8, k hi); k lo / hi the first / second 8 columns of a step
        const int slot = 4 * (jt / 2) + 2 * (jt % 2) + r;
        split2(m0, m1, mhi[slot], mlo[slot]);
      }
    }

    // y += M x; state <- exp(cum_last) state + x^T (B w) on its terms
    const float dec = sm.decay[s];
#pragma unroll
    for (int e = 0; e < kNS / 2; ++e) st[e] *= dec;
    fence_regs(ya);
    fence_regs(st);
    fence_regs(mhi);
    fence_regs(mlo);
    wgmma_fence();
    const uint32_t xs = smem_u32(sm.x[s]);
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const uint64_t db = smem_desc(xs + kk * 16 * kTileRowBytes);
      wgmma_rs_n64(ya, &mhi[4 * kk], db);
      wgmma_rs_n64(ya, &mlo[4 * kk], db);
    }
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        const uint64_t da = smem_desc(xs + kk * 16 * kTileRowBytes);
        const uint64_t db = smem_desc(smem_u32(bw[t]) +
                                      kk * 16 * kTileRowBytes + wg * kNS * 2);
        if constexpr (kNS == 32) {
          wgmma_ss_n32<1, 1>(st, da, db, 1);
        } else {
          wgmma_ss_n64<1, 1>(st, da, db, 1);
        }
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ya);
    fence_regs(st);
    fence_regs(mhi);
    fence_regs(mlo);

    // the new state's bf16 terms for the next chunk's readout: [p][n],
    // K-major with the 128-byte swizzle; st[4 j + e] is row
    // p = 16 lw + lane / 4 + 8 (e / 2), column n = kNS wg + 8 j + col +
    // (e % 2)
    if (c + 1 < n_chunks) {
#pragma unroll
      for (int j = 0; j < kNS / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = lw * 16 + lane / 4 + 8 * r;
          const int piece = wg * kNS / 8 + j;
          const int off = p * kTileRowBytes + ((piece ^ (p & 7)) << 4) + col * 2;
          uint32_t hi, lo;
          split2(st[4 * j + 2 * r], st[4 * j + 2 * r + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(
              reinterpret_cast<uint8_t*>(sm.st[0]) + off) = hi;
          *reinterpret_cast<uint32_t*>(
              reinterpret_cast<uint8_t*>(sm.st[1]) + off) = lo;
        }
      fence_async_smem();
    }
    mbar_arrive(smem_u32(&sm.empty[s]));

    // y: ya[4 j + e] is row ri + 8 (e / 2), column 8 j + col + (e % 2)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* yrow = y + (((long long)b * S + (long long)c * Q + ri + 8 * r) *
                             H + h) * P + col;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (8 * j < P)
          *reinterpret_cast<float2*>(yrow + 8 * j) =
              make_float2(ya[4 * j + 2 * r], ya[4 * j + 2 * r + 1]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = lw * 16 + lane / 4 + 8 * r;
    if (p >= P) continue;
    float* hrow = h_last + ((long long)bh * P + p) * N + wg * kNS + col;
#pragma unroll
    for (int j = 0; j < kNS / 8; ++j)
      if (wg * kNS + 8 * j < N)
        *reinterpret_cast<float2*>(hrow + 8 * j) =
            make_float2(st[4 * j + 2 * r], st[4 * j + 2 * r + 1]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with a box of 64 contiguous elements x the given
// outer extents, 128-byte swizzle; elements past a bound (P or N below 64)
// read as zeros.
bool make_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int Q>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* h_last, int B, int S, int H,
              int P, int N, cudaStream_t stream) {
  const cuuint64_t rows = (cuuint64_t)B * S;
  CUtensorMap tx, tb, tc;
  const cuuint64_t xd[3] = {(cuuint64_t)P, (cuuint64_t)H, rows};
  const cuuint64_t xs[2] = {(cuuint64_t)P * 2, (cuuint64_t)H * P * 2};
  const cuuint32_t xbox[3] = {kW, 1, Q};
  const cuuint64_t bd[2] = {(cuuint64_t)N, rows};
  const cuuint64_t bs[1] = {(cuuint64_t)N * 2};
  const cuuint32_t bbox[2] = {kW, Q};
  if (!make_map(&tx, x, 3, xd, xs, xbox) || !make_map(&tb, Bm, 2, bd, bs, bbox) ||
      !make_map(&tc, Cm, 2, bd, bs, bbox))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(SmemSSD<Q>) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_tc_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mamba2_tc_kernel<Q><<<B * H, Q * 2 + 128, smem, stream>>>(
      tx, tb, tc, (const __nv_bfloat16*)dt, (const float*)A, (float*)y,
      (float*)h_last, S, H, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit): a refused launch never runs,
// so the caller must check it. bf16 = 1 for bfloat16 x/dt/B/C, 0 for
// float32; A is float32. Allocates nothing; y holds B*S*H*P floats and
// h_last B*H*P*N. Takes P, N and Q that are multiples of 4 with S % Q == 0.
// The CUDA-core kernel, for any such input.
extern "C" int mamba2_scan_launch(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, void* y,
                                  void* h_last, int B, int S, int H, int P,
                                  int N, int Q, int bf16, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 4 || N < 4 || Q < 4 || P % 4 ||
      N % 4 || Q % 4 || S % Q)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, h_last, B, S, H, P,
                                      N, Q, st)
              : launch<float>(x, dt, A, Bm, Cm, y, h_last, B, S, H, P, N, Q,
                              st);
}

// The tensor-core kernel: bf16 x/dt/B/C, Q in {64, 128}, P and N multiples
// of 16 up to 64, S % Q == 0. Returns as mamba2_scan_launch (also the error
// of building a tensor map).
extern "C" int mamba2_scan_tc_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, void* y, void* h_last,
                                     int B, int S, int H, int P, int N, int Q,
                                     void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 16 || N < 16 || P > kW || N > kW ||
      P % 16 || N % 16 || (Q != 64 && Q != 128) || S % Q)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return Q == 128 ? launch_tc<128>(x, dt, A, Bm, Cm, y, h_last, B, S, H, P, N,
                                   st)
                  : launch_tc<64>(x, dt, A, Bm, Cm, y, h_last, B, S, H, P, N,
                                  st);
}
