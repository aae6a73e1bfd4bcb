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
// Design (a first, simple kernel): one block of 256 threads per (b, h); the
// TPU's sequential grid axis over chunks becomes a loop inside the block,
// with the state in shared memory between chunks (stored transposed,
// [N][P], so a thread reads four p as one 16-byte load). Each chunk's x,
// B, C and dt are staged in shared memory as f32; the cumulative decay is a
// warp scan; M is computed only for j <= i (entries above the diagonal are
// stored as zeros, never as exp of a positive difference) and kept in
// shared memory for the product with x. Every product is f32 FMAs on the
// CUDA cores, each thread holding a 4 x 4 register tile. B and C rows are
// padded by 4 floats so the M tile's 32 threads read 32 rows without bank
// conflicts (the rows are interleaved with stride Q/4 for that reason).
// Shared memory at Q = 128, P = N = 64 is 185 KB, past the 48 KB static
// limit: it is dynamic and the launcher raises the kernel's limit first.
//
// What bounds it on an H100: per (b, h, chunk), the products C Bᵀ and M x
// over the pairs j <= i (N and P multiply-adds each), C stateᵀ and xᵀ(B w)
// (Q P N each), against x, dt, B, C read once and y, h_last written once.
// At the hybrid model's shapes (B = 2, S = 4096, H = 64, P = N = 64,
// Q = 128) chip_smoke.py puts the bytes at 0.0617 ms and the operations at
// 0.0174 ms on the bf16 tensor cores (NVIDIA H100 80GB HBM3, 700 W): the
// bound is bytes. This kernel does its products on the CUDA cores in f32
// with one block of 8 warps per SM, and measured 1.21 ms there;
// tensor-core tiles (wgmma) and computing C Bᵀ once per (b, chunk) for all
// heads are the ways toward the bound, and a later version's work.

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

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit): a refused launch never runs,
// so the caller must check it. bf16 = 1 for bfloat16 x/dt/B/C, 0 for
// float32; A is float32. Allocates nothing; y holds B*S*H*P floats and
// h_last B*H*P*N. Takes P, N and Q that are multiples of 4 with S % Q == 0.
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
