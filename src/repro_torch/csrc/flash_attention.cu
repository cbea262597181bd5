// Flash attention forward (GQA, causal and/or sliding window) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (Pallas; grid (B*H, S/BQ, T/BK) with the KV axis run in order on one core
// and m/l/acc carried in VMEM scratch between grid steps).
//
// Computes, for query head h reading kv head h / (H/K):
//   s = (q . k) * hd^-0.5 in float32, s = -2e38 where masked
//   (causal: col <= row; window: col > row - window),
//   out = softmax(s) . v with an online softmax (m, l, acc in float32),
//   acc / l with l == 0 guarded,
//   and, where the caller passes an lse pointer (training, for the backward
//   in flash_attention_bwd.cu), lse = m + log l per row in float32 at
//   (b, h, row); +inf for a row that met no key tile. Serving passes null and
//   the epilogue skips the write.
//
// What bounds it on the H100: at the serving shapes (B 8, S = T = 512,
// hd 112/128) the bound is near balance: ~21.5 GFLOP of causal work is
// 0.022 ms on the bf16 tensor cores, the q/k/v/o bytes 0.030 ms at HBM rate.
// Either way only the tensor cores can get near it; float32 FMAs top out at
// 67 TFLOP/s.
//
// Two kernels, chosen by dtype (not a fallback: each dtype has one kernel):
//
// bfloat16 -- flash_fwd_kernel_wgmma, FA3-style. One CTA per (q tile of
//   BQ = 64 rows, b*H + h): one consumer warpgroup and one producer warp,
//   80 KB of shared memory, two CTAs an SM. The producer issues TMA loads
//   over 4-D tensor maps (hd, heads, seq, B): the q tile once, then k and v
//   tiles of BK = 64 rows through a ring of 2 stages in 128-byte-swizzled
//   shared memory with mbarrier completion, so the next tile's load
//   overlaps this tile's products. TMA zero-fills the ragged S/T edges and
//   never crosses into the next sequence. The consumer computes S = Q.K^T
//   by wgmma (both operands from shared memory, K-major), applies the -2e38
//   mask only on tiles that straddle the causal or window edge or the end of
//   T, runs the online softmax in registers (a row's columns live in the 4
//   lanes of a quad: two shuffles), casts P to bf16 in registers as the
//   register A operand of O += P.V by wgmma, and reads V MN-major through
//   the descriptor's transpose bit. O stays in registers in float32 and is
//   written once, masked on ragged rows. KV tiles wholly outside the band
//   are never loaded. The grid runs groups of 16 (b, h) pairs, heaviest
//   causal q tiles first inside a group, so q tiles reading the same k/v
//   rows meet them in L2.
//   hd 112 is padded to 128 in shared memory: a row is two TMA boxes of 64
//   columns, the second box's columns 112-127 zero-filled as out of bounds.
//   Q.K^T runs 7 k-steps (the pad k-step is skipped); P.V runs at N = 128
//   (the MN-major swizzle atom is 64 columns wide), so at zamba2's shape the
//   second product does 14% more MMA work than it needs; the 16 pad columns
//   are dropped at the epilogue.
//
// float32 -- flash_fwd_kernel, plain FMAs: no tensor-core mode keeps the
//   2e-5 float32 tolerance (TF32 keeps ~3 digits). One block per (64-row q
//   tile, b*H + h), 128 threads, each holding 8 query rows x BK/16 score
//   columns and 8 rows x HD/16 output columns in registers; tiles converted
//   to float32 in shared memory (rows padded by one word); tiles outside the
//   band skipped, ragged edges masked.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

// ---------------------------------------------------------------------------
// float32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;   // 16 (tx) x 8 (ty)
constexpr int RPT = BQ / 8;     // query rows per thread
constexpr int CPT = BK / 16;    // score columns per thread
constexpr float NEG = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int B, int S, int T_len, int H, int K, int causal, int window,
                 float scale) {
  constexpr int DPT = HD / 16;      // output columns per thread
  constexpr int LDQ = HD + 1;       // padded row stride of the q and k tiles
  extern __shared__ float smem[];
  float* qs = smem;                  // BQ x LDQ
  float* ks = qs + BQ * LDQ;         // BK x LDQ
  float* vs = ks + BK * LDQ;         // BK x HD
  float* ps = vs + BK * HD;          // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / K);

  const int64_t q_row = (int64_t)H * HD;     // stride between q positions
  const int64_t k_row = (int64_t)K * HD;     // stride between k positions
  const T* qb = q + (int64_t)b * S * q_row + (int64_t)h * HD;
  const T* kb = k + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  const T* vb = v + (int64_t)b * T_len * k_row + (int64_t)kh * HD;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    int r = i / HD, c = i % HD;
    int row = q0 + r;
    qs[r * LDQ + c] = row < S ? to_f(qb[(int64_t)row * q_row + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // KV tiles that can hold a valid column for some row of this q tile.
  const int q_last = min(q0 + BQ, S) - 1;
  int k_lo = 0;
  if (window >= 0) k_lo = max(0, q0 - window + 1);
  int k_hi = T_len;                       // exclusive
  if (causal) k_hi = min(T_len, q_last + 1);
  const int kt_begin = k_lo / BK;
  const int kt_end = (k_hi + BK - 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // previous tile's ks/vs/ps fully consumed
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      int r = i / HD, c = i % HD;
      int col = k0 + r;
      bool in = col < T_len;
      ks[r * LDQ + c] = in ? to_f(kb[(int64_t)col * k_row + c]) : 0.f;
      vs[r * HD + c] = in ? to_f(vb[(int64_t)col * k_row + c]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty + 8*i, columns tx + 16*j
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 8 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int row = q0 + ty + 8 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < T_len;
        if (causal) ok = ok && col <= row;
        if (window >= 0) ok = ok && col > row - window;
        s[i][j] = ok ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // row max over the 16 lanes that share ty (lanes 0-15 or 16-31)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 8 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p . v: rows ty + 8*i, columns tx + 16*j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + 8 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + (int64_t)b * S * q_row + (int64_t)h * HD;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 8 * i;
    if (row >= S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      ob[(int64_t)row * q_row + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * H + h) * S + row] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int T_len, int H, int K, int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, B, S, T_len, H, K, causal, window,
      (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA kernel
// ---------------------------------------------------------------------------
namespace hopper {

// One consumer warpgroup of 64 q rows and 64-row kv tiles: 80 KB of shared
// memory at hd 112/128, so two CTAs share an SM and one's loads and
// epilogue hide behind the other's products. A 128-row tile on two
// warpgroups with 128-row kv tiles needs 160 KB, one CTA an SM, and ran
// slower at both serving shapes.
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int STAGES = 2;
constexpr int GROUP = 16;                     // (b, h) pairs whose q tiles run together
constexpr int NTHREADS = 128 + 32;            // a consumer warpgroup + a producer warp
constexpr int BOX = 64;                       // TMA box width: 128 bytes, one swizzle row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x 64, f32) (+)= A(64 x 16, smem, K-major) . B(64 x 16, smem, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64 x 64, f32) += A(64 x 16, registers) . B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

// D(64 x 128, f32) += A(64 x 16, registers) . B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a0, a1, a2, a3, db, 1);
  else wgmma_rs_n128(d, a0, a1, a2, a3, db, 1);
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma between its issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Accumulator fragment of m64nN (per warpgroup): thread t = 32 w + l holds,
// for each 8-column block j, d[4j + e] at row 16 w + l / 4 + 8 (e / 2) and
// column 8 j + 2 (l % 4) + e % 2. Rows l/4 ("a") and l/4 + 8 ("b").
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int B, int S, int T_len, int H, int K,
                       int causal, int window, float scale_log2) {
  constexpr int NB = (HD + BOX - 1) / BOX;          // TMA boxes per row
  constexpr int HDP = NB * BOX;                     // padded head dim (P.V's N)
  constexpr int Q_BYTES = NB * BQ * 128;
  constexpr int KV_BYTES = NB * BK * 128;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];

  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1024-aligned
  auto sk = [&](int s) { return sq + Q_BYTES + s * 2 * KV_BYTES; };
  auto sv = [&](int s) { return sq + Q_BYTES + s * 2 * KV_BYTES + KV_BYTES; };
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };

  const int BH = B * H;
  const int nqt = (S + BQ - 1) / BQ;
  // Grid order: groups of GROUP (b, h) pairs, so the q tiles that read the
  // same k/v rows run at about the same time and find them in L2; inside a
  // group the heaviest causal q tiles first.
  const int g0 = (blockIdx.x / (GROUP * nqt)) * GROUP;
  const int grp = min(GROUP, BH - g0);
  const int idx = blockIdx.x - g0 * nqt;
  const int qt = nqt - 1 - idx / grp;
  const int bh = g0 + idx % grp;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / K);
  const int q0 = qt * BQ;

  // KV tiles that can hold a valid column for some row of this q tile.
  const int q_last = min(q0 + BQ, S) - 1;
  int k_lo = 0;
  if (window >= 0) k_lo = max(0, q0 - window + 1);
  int k_hi = T_len;                       // exclusive
  if (causal) k_hi = min(T_len, q_last + 1);
  const int kt_begin = k_lo / BK;
  const int ntiles = max(0, (k_hi + BK - 1) / BK - kt_begin);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);                   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer warp: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) tma_load_4d(sq + nb * BQ * 128, &tm_q, bar_q, nb * BOX, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        const int n = i / STAGES;
        if (n > 0) mbar_wait(empty(s), (n - 1) & 1);
        mbar_expect_tx(full(s), 2 * KV_BYTES);
        const int k0 = (kt_begin + i) * BK;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sk(s) + nb * BK * 128, &tm_k, full(s), nb * BOX, kh, k0, b);
          tma_load_4d(sv(s) + nb * BK * 128, &tm_v, full(s), nb * BOX, kh, k0, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup
  const int row_a = q0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const int q_hi = q0 + BQ - 1;
  const int cq = 2 * (lane % 4);

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

  mbar_wait(bar_q, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const int k0 = (kt_begin + i) * BK;
    mbar_wait(full(s), (i / STAGES) & 1);

    // S = Q . K^T over the head dim (the pad k-steps of hd 112 skipped)
    float sc[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int nb = kk / 4, kin = kk % 4;
      wgmma_ss_n64(sc, sw128_desc(sq + nb * BQ * 128 + kin * 32, 16, 1024),
                   sw128_desc(sk(s) + nb * BK * 128 + kin * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax, masking only a tile that straddles an edge
    const bool edge = (k0 + BK > T_len) || (causal && k0 + BK - 1 > q0) ||
                      (window >= 0 && k0 <= q_hi - window);
    float mx_a = NEG, mx_b = NEG;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + cq + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          bool ok = col < T_len;
          if (causal) ok = ok && col <= row;
          if (window >= 0) ok = ok && col > row - window;
          x = ok ? x : NEG;
        }
        sc[4 * j + e] = x;
        if (e < 2) mx_a = fmaxf(mx_a, x); else mx_b = fmaxf(mx_b, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = ex2(m_a - mn_a), alpha_b = ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;

    // P in bf16 as the register A operand: k-step kk of P.V takes the
    // 8-column blocks 2 kk and 2 kk + 1 of the score fragment.
    uint32_t pa[BK / 4];
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = ex2(sc[4 * j] - m_a), p1 = ex2(sc[4 * j + 1] - m_a);
      const float p2 = ex2(sc[4 * j + 2] - m_b), p3 = ex2(sc[4 * j + 3] - m_b);
      rs_a += p0 + p1;
      rs_b += p2 + p3;
      pa[(j / 2) * 4 + (j % 2) * 2] = pack_bf16(p0, p1);
      pa[(j / 2) * 4 + (j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * alpha_a + rs_a;        // a partial over this lane's columns;
    l_b = l_b * alpha_b + rs_b;        // the quad is summed at the end
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      acc[4 * j] *= alpha_a;
      acc[4 * j + 1] *= alpha_a;
      acc[4 * j + 2] *= alpha_b;
      acc[4 * j + 3] *= alpha_b;
    }

    // O += P . V, V MN-major: 64-column blocks BK*128 bytes apart, 8-row
    // groups 1024 bytes apart, a k-step of 16 rows 2048 bytes on.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<HDP>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                    sw128_desc(sv(s) + kk * 2048, BK * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);

    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));     // this stage may be refilled
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  const int64_t q_row = (int64_t)H * HD;
  __nv_bfloat16* ob = o + (int64_t)b * S * q_row + (int64_t)h * HD;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col >= HD) continue;
    if (row_a < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row_a * q_row + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
    if (row_b < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row_b * q_row + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
  }
  // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((int64_t)b * H + h) * S;
    if (row_a < S) lb[row_a] = l_a > 0.f ? (m_a + log2f(l_a)) * LN2 : INFINITY;
    if (row_b < S) lb[row_b] = l_b > 0.f ? (m_b + log2f(l_b)) * LN2 : INFINITY;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; reach it through the runtime
// so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 4-D map over a contiguous (batch, seq, heads, hd) bf16 tensor, boxes of
// BOX columns x `rows` positions of one head, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int hd, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)seq * heads * hd * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                   int T_len, int H, int K, int causal, int window, cudaStream_t stream) {
  constexpr int NB = (HD + BOX - 1) / BOX;
  constexpr size_t smem = 1024 + (size_t)NB * 128 * (BQ + 2 * STAGES * BK);
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, S, H, HD, BQ) || !make_map(&tk, k, B, T_len, K, HD, BK) ||
      !make_map(&tv, v, B, T_len, K, HD, BK))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel_wgmma<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = ((S + BQ - 1) / BQ) * B * H;
  kern<<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, S,
                                         T_len, H, K, causal, window,
                                         (float)(1.0 / sqrt((double)HD)) * LOG2E);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int T_len, int H, int K, int hd, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, stream);
    case 112: return launch<112>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int T_len, int H, int K, int hd, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, stream);
    case 112: return launch<T, 112>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32 (FMA kernel), 1 bfloat16 (wgmma + TMA kernel). window < 0
// means none. q: (B,S,H,hd), k/v: (B,T,K,hd), o: (B,S,H,hd), all contiguous;
// lse: null, or (B,H,S) float32 for m + log l per row.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int S, int T_len, int H, int K, int hd,
                                   int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(q, k, v, o, l, B, S, T_len, H, K, hd, causal, window, st);
    case 1:
      return (int)hopper::dispatch_hd(q, k, v, o, l, B, S, T_len, H, K, hd, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
