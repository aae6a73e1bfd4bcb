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
// What bounds it on an H100: the work is 2 B H D S(S+1) FLOPs when causal
// (4 B H D S^2 when not), which in bf16 on the tensor cores (989 TFLOP/s
// dense) outweighs the bytes of q, k, v and o once at 3.35 TB/s for S above
// a few hundred: the bound is operations. The first version did both
// products as f32 FMAs on the CUDA cores (67 TFLOP/s at most), staged every
// tile through the threads as f32 with no overlap of loads and compute,
// and sent P through shared memory: 0.74 ms on llama's layer-0 prefill,
// 12.5x scaled_dot_product_attention.
//
// bf16 (flash_bf16_kernel): the tensor cores, fed by TMA.
//   - One block per (128-row query tile, head, batch), causal tiles launched
//     heaviest first: a producer warpgroup and two consumer warpgroups, each
//     of which owns 64 query rows. The 384 threads start at 168 registers;
//     the producer drops to 24 and the consumers rise to 240 (setmaxnreg).
//   - The producer loads Q once and then each 128-key tile of K and V into
//     a ring of kStages stages, by TMA with 128-byte swizzle, one mbarrier
//     "full" (transaction bytes) and one "empty" (256 consumer arrivals)
//     per stage. The tensor maps view q, k, v as [B, S, heads * D], so a
//     tile reads one head's D columns in place (64-column panels, 128 B a
//     row: D = 128 is two panels) and the rows past S of the last tile are
//     zero-filled by the hardware, never the next batch's.
//   - S = Q K^T by wgmma m64n128k16, both operands K-major in shared
//     memory, f32 accumulators: bf16 x bf16 products are exact in f32, so S
//     differs from the reference's f32 dot only in summation order.
//   - The online softmax runs in registers, in the accumulator's layout (a
//     thread holds 2 rows x 32 keys; the 4 lanes of a row reduce by
//     shuffles): the max over unscaled scores, then exp2 of one FMA with
//     scale * log2 e folded in. Only the
//     diagonal tile and the ragged last tile are masked; tiles wholly above
//     the diagonal are never loaded (their exp(-1e30 - m) terms are 0).
//   - O += P V by wgmma m64n64k16 with P as the A operand in registers,
//     converted from the S accumulators without a trip through shared
//     memory, and V the B operand, MN-major (the transpose bit). P is split
//     into bf16 hi = bf16(p) and lo = bf16(p - hi) and both products are
//     issued: P keeps about 16 bits, so the only rounding beyond the
//     reference's f32 is the final one to bf16 (single-rounded P reaches
//     half the 2e-2 gate on randn inputs and passes it at |o| >= 4).
//   - Shared memory is Q (16 or 32 KB) and 2 stages of K and V (64 or 128
//     KB): dynamic, the limit raised by the launcher. Tensor maps are built
//     on the host per call by cuTensorMapEncodeTiled, looked up at run
//     time with cudaGetDriverEntryPoint (no -lcuda), and passed by value as
//     __grid_constant__ parameters.
//
// f32 (flash_f32_kernel): the CUDA cores, by design. The only f32 path of
// the tensor cores is TF32, which keeps 10 mantissa bits and cannot meet
// the f32 gate of 1e-5 against the reference; f32 is the type of the twins,
// not of the serving and hybrid paths, which run bf16. One block of 256
// threads per (64-row query tile, head, batch); each 64-key tile of K and V
// is staged in shared memory as f32 (K and Q transposed to [D][64]); a
// thread owns 4 rows x 4 keys of the score tile and 4 rows x D/16 output
// columns; P goes through shared memory for the P.V product.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------- f32

constexpr int kTile = 64;       // query rows per block, keys per tile
constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

// Rows [row0, row0 + 64) of x (row stride ld elements) into dst[d * 64 + r],
// zeros past row n. Thread -> one row and a quarter of its columns, so the
// 32 threads of a warp store 32 neighbouring words.
template <int D>
__device__ __forceinline__ void load_tile_transposed(
    const float* __restrict__ x, long long ld, int row0, int n, float* dst) {
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
template <int D>
__device__ __forceinline__ void load_tile(
    const float* __restrict__ x, long long ld, int row0, int n, float* dst) {
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

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
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
  const float* qb = q + ((long long)b * S * H + h) * D;
  const float* kb = k + ((long long)b * S * Hkv + hk) * D;
  const float* vb = v + ((long long)b * S * Hkv + hk) * D;
  float* ob = o + ((long long)b * S * H + h) * D;
  const int q0 = qt * kTile;

  // this thread's rows tr..tr+3; its keys (and, per 64 output columns, its
  // columns) tc..tc+3. The 16 threads with one tr are one half-warp.
  const int tr = (threadIdx.x / 16) * 4;
  const int tc = (threadIdx.x % 16) * 4;

  load_tile_transposed<D>(qb, ldq, q0, S, qs);

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
    load_tile_transposed<D>(kb, ldk, k0, S, ks);
    load_tile<D>(vb, ldk, k0, S, vs);
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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int Hkv, int causal, float scale,
               cudaStream_t stream) {
  const int smem = (3 * D * kTile + kTile * kTile) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H,
      Hkv, causal, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int kBM = 128;          // query rows per block
constexpr int kBN = 128;          // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreadsTC = kConsumers + 128;  // + the producer warpgroup
constexpr int kPanel = 64;        // columns per 128-byte swizzled panel
constexpr int kPanelBytes = kBN * kPanel * 2;   // 128 rows x 128 B
constexpr float kLog2e = 1.4426950408889634f;

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

// One box {64 columns, 128 rows, 1 batch} of a [B, S, heads * D] bf16 view
// into shared memory at dst, swizzled; completes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(batch),
      "r"(bar) : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand (layout
// 1, B128) at addr whose 8-row groups lie 1,024 B apart (the stride byte
// offset). The leading byte offset is not read for these operands (K-major
// swizzled, or MN-major one 64-column swizzle atom wide) and is set to 1.
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

// Keeps the compiler from moving accesses of these registers across the
// asynchronous wgmma that reads or writes them.
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

// S (64 x 128, f32) {=, +=} A (64 x 16, smem) . B (128 x 16, smem)^T, both
// K-major; scale_d = 0 overwrites d.
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

// O (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, smem),
// B stored MN-major (the transpose bit set).
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

__device__ __forceinline__ uint32_t pack_bf16(float lo_k, float hi_k) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo_k, hi_k);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int D>
struct alignas(1024) SmemTC {
  __nv_bfloat16 q[D / kPanel][kBM * kPanel];
  __nv_bfloat16 k[kStages][D / kPanel][kBN * kPanel];
  __nv_bfloat16 v[kStages][D / kPanel][kBN * kPanel];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t qbar;
};

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                  int causal, float scale) {
  constexpr int kPanels = D / kPanel;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms (8 rows x 128 B) must sit on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  SmemTC<D>& sm = *reinterpret_cast<SmemTC<D>*>(
      smem_raw + ((1024 - (raw & 1023)) & 1023));

  const int n_tiles = (S + kBN - 1) / kBN;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int n_kv = causal ? qt + 1 : n_tiles;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&sm.full[s]), 1);
      mbar_init(smem_u32(&sm.empty[s]), kConsumers);
    }
    mbar_init(smem_u32(&sm.qbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer: one thread issues every load; the warpgroup gives
    // its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers) {
      const uint32_t qbar = smem_u32(&sm.qbar);
      mbar_expect_tx(qbar, kPanels * kPanelBytes);
      for (int p = 0; p < kPanels; ++p)
        tma_load(smem_u32(sm.q[p]), &tq, qbar, h * D + p * kPanel, qt * kBM,
                 b);
      for (int it = 0; it < n_kv; ++it) {
        const int s = it % kStages;
        const int ph = (it / kStages) & 1;
        mbar_wait(smem_u32(&sm.empty[s]), ph ^ 1);
        const uint32_t full = smem_u32(&sm.full[s]);
        mbar_expect_tx(full, 2 * kPanels * kPanelBytes);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(smem_u32(sm.k[s][p]), &tk, full, hk * D + p * kPanel,
                   it * kBN, b);
          tma_load(smem_u32(sm.v[s][p]), &tv, full, hk * D + p * kPanel,
                   it * kBN, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int w = (tid % 128) / 32;
    const int lane = tid % 32;
    const int row0 = qt * kBM + wg * 64 + w * 16 + lane / 4;  // and row0 + 8
    const int col = 2 * (lane % 4);   // + 8 j: this thread's keys/columns
    const float sl2 = scale * kLog2e;

    float m[2] = {kNeg, kNeg};   // running max of the unscaled scores
    float l[2] = {0.f, 0.f};     // this thread's part of the row sums
    float acc[kPanels][32];
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

    mbar_wait(smem_u32(&sm.qbar), 0);
    for (int it = 0; it < n_kv; ++it) {
      const int s = it % kStages;
      mbar_wait(smem_u32(&sm.full[s]), (it / kStages) & 1);

      // S = Q K^T over D in steps of 16 (32 bytes into a 128-byte panel row)
      float sc[64];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        const uint64_t da =
            smem_desc(smem_u32(sm.q[kk / 4]) + wg * 64 * 128 + off);
        const uint64_t db = smem_desc(smem_u32(sm.k[s][kk / 4]) + off);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax on the unscaled scores (scale > 0, so the max
      // commutes with it; a masked score is -1e30 before the scale, and
      // its exp is 0 as the reference's); sc[4 j + e]: row row0 + 8 (e / 2),
      // key k0 + 8 j + col + (e % 2)
      const int k0 = it * kBN;
      const bool masked = (causal && it == qt) || k0 + kBN > S;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (masked) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int row = row0 + 8 * (e >> 1);
            if (key >= S || (causal && key > row)) sc[4 * j + e] = kNeg;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
      float alpha[2], msl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        msl[r] = mx[r] * sl2;
        l[r] *= alpha[r];
      }
      // P = exp2(x - m), split into bf16 hi + lo, packed as wgmma A
      // fragments: k-step kk takes key chunks 2 kk and 2 kk + 1
      uint32_t phi[32], plo[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = exp2f(fmaf(sc[4 * j + 2 * r], sl2, -msl[r]));
          const float p1 = exp2f(fmaf(sc[4 * j + 2 * r + 1], sl2, -msl[r]));
          l[r] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          // A fragment order: (row0, k lo), (row0 + 8, k lo), (row0, k hi),
          // (row0 + 8, k hi), k lo/hi the first/second 8 keys of the step
          const int slot = 4 * (j / 2) + 2 * (j % 2) + r;
          phi[slot] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[slot] = pack_bf16(p0 - hf.x, p1 - hf.y);
        }
      }
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V over the 128 keys in steps of 16 (2 KB of rows)
#pragma unroll
      for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
      fence_regs(phi);
      fence_regs(plo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          const uint64_t db =
              smem_desc(smem_u32(sm.v[s][p]) + kk * 16 * 128);
          wgmma_rs_n64(acc[p], &phi[4 * kk], db);
          wgmma_rs_n64(acc[p], &plo[4 * kk], db);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < kPanels; ++p) fence_regs(acc[p]);
      fence_regs(phi);
      fence_regs(plo);
      mbar_arrive(smem_u32(&sm.empty[s]));
    }

    // o = acc / max(l, 1e-20); acc[p][4 j + e]: row row0 + 8 (e / 2),
    // column 64 p + 8 j + col + (e % 2)
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      denom[r] = fmaxf(l[r], 1e-20f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      __nv_bfloat16* orow = o + (((long long)b * S + row) * H + h) * D + col;
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat162 y =
              __floats2bfloat162_rn(acc[p][4 * j + 2 * r] / denom[r],
                                    acc[p][4 * j + 2 * r + 1] / denom[r]);
          *reinterpret_cast<__nv_bfloat162*>(orow + p * kPanel + 8 * j) = y;
        }
    }
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

// The [B, S, heads * D] bf16 view of x as a 3-D tensor map with boxes of
// {64 columns, 128 rows, 1}, 128-byte swizzle, zeros past each bound.
bool make_map(CUtensorMap* map, const void* x, int B, int S, int heads,
              int D) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)heads * D;
  const cuuint64_t dims[3] = {row, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {row * 2, row * 2 * (cuuint64_t)S};
  const cuuint32_t box[3] = {kPanel, kBN, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int Hkv, int causal, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, D) || !make_map(&tk, k, B, S, Hkv, D) ||
      !make_map(&tv, v, B, S, Hkv, D))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(SmemTC<D>) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBM - 1) / kBM, H, B);
  flash_bf16_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, S, H, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (or the error of
// building a tensor map or raising the kernel's shared-memory limit): a
// refused launch never runs, so the caller must check it. bf16 = 1 for
// bfloat16 tensors (the tensor-core kernel), 0 for float32 (the CUDA-core
// kernel). Allocates nothing; o must hold B * S * H * D elements.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int Hkv, int D, int bf16,
                                      int causal, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return bf16 ? launch_bf16<64>(q, k, v, o, B, S, H, Hkv, causal, scale, st)
                : launch_f32<64>(q, k, v, o, B, S, H, Hkv, causal, scale, st);
  if (D == 128)
    return bf16 ? launch_bf16<128>(q, k, v, o, B, S, H, Hkv, causal, scale, st)
                : launch_f32<128>(q, k, v, o, B, S, H, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}
