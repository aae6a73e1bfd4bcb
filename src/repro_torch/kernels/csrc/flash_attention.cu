// Causal or non-causal grouped-query attention with an online softmax, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (reached from repro/models/attention.py::sdpa under impl="flash": the
// prefill of every GQA layer). Same function, same semantics:
//
//   q [B, S, H, D], k/v [B, S, Hkv, D], f32 or bf16, H % Hkv == 0,
//   D in {64, 128}; query head h reads KV head h / (H / Hkv)
//   s = (q . k) * scale, masked to -1e30 where key > query (causal)
//   m, l, acc carried over the key tiles in f32 (online softmax)
//   o = acc / max(l, 1e-20), rounded to q's type (round to nearest even)
//
// The [B, S, H, D] layout is read in place, with no transposed copies.
//
// Design (a first, simple kernel): one block of 256 threads per (query tile
// of 64 rows, head, batch). The TPU's sequential grid axis over key tiles
// becomes a loop inside the block. Each 64-key tile of K and V is staged in
// shared memory as f32 (K and the block's Q transposed to [D][64], so a
// thread reads four rows or four keys as one 16-byte load), and its
// probabilities go to shared memory for the P.V product. A thread owns 4
// query rows x 4 keys of the score tile and the same 4 rows x D/16 columns
// of the output; the 16 threads that share 4 rows reduce row max and row sum
// with warp shuffles. Key tiles wholly above the diagonal are skipped: their
// entries would add exp(-1e30 - m) = 0, so this is exact. Rows and keys past
// S are masked here, so S need not be a multiple of 64. Shared memory is
// 64 KB (D = 64) or 112 KB (D = 128), past the 48 KB static limit, so it is
// dynamic and the launcher raises the kernel's limit first. Causal query
// tiles are launched heaviest first.
//
// What bounds it on an H100: the function's work is 2 B H D S(S+1) FLOPs
// when causal (4 B H D S^2 when not), which in bf16 on the tensor cores
// (989 TFLOP/s dense) outweighs the bytes of q, k, v and o once at 3.35 TB/s
// for S above a few hundred: the bound is operations. This kernel does its
// products as f32 FMAs on the CUDA cores (67 TFLOP/s at most), so it cannot
// come within about 15x of that bound; wgmma with TMA-fed tiles is the way
// there, and a later version's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows per block, keys per tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;  // the reference's mask value

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  *reinterpret_cast<uint32_t*>(&a) = u.x;
  *reinterpret_cast<uint32_t*>(&b) = u.y;
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  x[0] = fa.x; x[1] = fa.y; x[2] = fb.x; x[3] = fb.y;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Rows [row0, row0 + 64) of x (row stride ld elements) into dst[d * 64 + r],
// zeros past row n. Thread -> one row and a quarter of its columns, so the
// 32 threads of a warp store 32 neighbouring words.
template <typename T, int D>
__device__ __forceinline__ void load_tile_transposed(
    const T* __restrict__ x, long long ld, int row0, int n, float* dst) {
  constexpr int kCols = D / (kThreads / kTile);
  const int r = threadIdx.x % kTile;
  const int c0 = (threadIdx.x / kTile) * kCols;
  const int row = row0 + r;
#pragma unroll
  for (int c = c0; c < c0 + kCols; c += 4) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < n) load4(x + row * ld + c, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(c + i) * kTile + r] = v[i];
  }
}

// Rows [row0, row0 + 64) of x into dst[r * D + d], zeros past row n.
// Neighbouring threads take neighbouring 4-element chunks of a row.
template <typename T, int D>
__device__ __forceinline__ void load_tile(
    const T* __restrict__ x, long long ld, int row0, int n, float* dst) {
  constexpr int kChunks = D / 4;
  constexpr int kRowsPerPass = kThreads / kChunks;
  const int c = (threadIdx.x % kChunks) * 4;
#pragma unroll
  for (int r = threadIdx.x / kChunks; r < kTile; r += kRowsPerPass) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n) load4(x + (row0 + r) * ld + c, v);
    store4(dst + r * D + c, v);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int Hkv, int causal, float scale) {
  constexpr int kOut = D / 16;      // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [D][64]
  float* ks = qs + D * kTile;                     // [D][64]
  float* vs = ks + D * kTile;                     // [64][D]
  float* ps = vs + kTile * D;                     // [64 keys][64 rows]

  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const long long ldq = (long long)H * D;
  const long long ldk = (long long)Hkv * D;
  const T* qb = q + ((long long)b * S * H + h) * D;
  const T* kb = k + ((long long)b * S * Hkv + hk) * D;
  const T* vb = v + ((long long)b * S * Hkv + hk) * D;
  T* ob = o + ((long long)b * S * H + h) * D;
  const int q0 = qt * kTile;

  // this thread's rows tr..tr+3; its keys (and, per 64 output columns, its
  // columns) tc..tc+3. The 16 threads with one tr are one half-warp.
  const int tr = (threadIdx.x / 16) * 4;
  const int tc = (threadIdx.x % 16) * 4;

  load_tile_transposed<T, D>(qb, ldq, q0, S, qs);

  float m[4], l[4], acc[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's ks, vs and ps are read
    load_tile_transposed<T, D>(kb, ldk, k0, S, ks);
    load_tile<T, D>(vb, ldk, k0, S, vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qs + d * kTile + tr);
      const float4 c = *reinterpret_cast<const float4*>(ks + d * kTile + tc);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + tr + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tc + j;
        float x = s[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    // p of key j, rows tr..tr+3, at ps[j * 64 + (tr ^ (j & 60))]: the XOR
    // spreads the half-warp's 16 keys over the banks
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float pj[4] = {s[0][j], s[1][j], s[2][j], s[3][j]};
      store4(ps + (tc + j) * kTile + (tr ^ tc), pj);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha[i];
#pragma unroll 8
    for (int j = 0; j < kTile; ++j) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(ps + j * kTile + (tr ^ (j & 60)));
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc) {
        const float4 w =
            *reinterpret_cast<const float4*>(vs + j * D + cc * 64 + tc);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][cc * 4 + e] = fmaf(pv[i], wv[e], acc[i][cc * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc) {
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = acc[i][cc * 4 + e] / denom;
      store4(ob + row * ldq + cc * 64 + tc, out);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  const int smem = (3 * D * kTile + kTile * kTile) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (or the error of
// raising the kernel's shared-memory limit): a refused launch never runs,
// so the caller must check it. bf16 = 1 for bfloat16 tensors, 0 for float32.
// Allocates nothing; o must hold B * S * H * D elements.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int D, int bf16,
                                      int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, causal,
                                            scale, st)
                : launch<float, 64>(q, k, v, o, B, S, H, Hkv, causal, scale,
                                    st);
  if (D == 128)
    return bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, causal,
                                             scale, st)
                : launch<float, 128>(q, k, v, o, B, S, H, Hkv, causal, scale,
                                     st);
  return (int)cudaErrorInvalidValue;
}
