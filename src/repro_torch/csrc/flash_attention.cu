// Flash attention forward (GQA, causal and/or sliding window) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:flash_attention
// (Pallas; grid (B*H, S/BQ, T/BK) with the KV axis run in order on one core
// and m/l/acc carried in VMEM scratch between grid steps).
//
// Computes, for query head h reading kv head h / (H/K):
//   s = (q . k) * scale in float32 (the caller's softmax scale: hd^-0.5, or
//   Zamba2's (hd/2)^-0.5), s = -2e38 where masked
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
// 67 TFLOP/s. At gemma3-12b's prefill (B 8, S = T = 1536, 16/8 heads,
// hd 256) the operations bound it: ~155 GFLOP causal (0.157 ms), ~138 with
// the local layers' 1024-key window, against 302 MB of q/k/v/o (0.090 ms).
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
//   hd 256 (gemma3) keeps the same tiles and 2-stage ring: a row is four
//   boxes, Q.K^T runs 16 k-steps, and P.V runs as two N = 128 products on
//   the halves of V (columns 0-127 and 128-255) into the two halves of O.
//   Shared memory is then 1024 + 4 * 128 * (64 + 2 * 2 * 64) = 164,864 B,
//   so one CTA runs on an SM (__launch_bounds__(NTHREADS, 1) at hd 256):
//   the O accumulator alone is 128 float32 registers a thread beside the
//   32 of the S tile and 16 of P (ptxas: 206 registers, no spill), above
//   the 204 that two CTAs of 160 threads leave each. A 32-key single-stage
//   variant that keeps two CTAs an SM would lose the load/compute overlap
//   of the ring instead; this one keeps the tile loop and the ring as they
//   are at hd 128, and is the simple one that is right first.
//   hd 224 (Zamba2-7B's shared attention) runs hd 256's kernel on a row
//   whose fourth box has columns 224-255 zero-filled as out of bounds, as
//   hd 112's second box is: Q.K^T runs 14 k-steps, the two N = 128 P.V
//   products do 14% more MMA work than the 224 columns need, and the pad
//   columns are dropped at the epilogue. Same shared memory, one CTA an SM.
//
// float32 -- flash_fwd_kernel, plain FMAs: no tensor-core mode keeps the
//   2e-5 float32 tolerance (TF32 keeps ~3 digits). One block per (64-row q
//   tile, b*H + h), 128 threads, each holding 8 query rows x BK/16 score
//   columns and 8 rows x HD/16 output columns in registers; tiles converted
//   to float32 in shared memory (rows padded by one word); tiles outside the
//   band skipped, ragged edges masked. At hd 256 those tiles take 213,760 B
//   of dynamic shared memory (189,184 B at hd 224), under the 232,448 a
//   block may have; the launch asks for exactly that with
//   cudaFuncSetAttribute.

#include <cmath>

#include "sm90.cuh"

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
                   int S, int T_len, int H, int K, int causal, int window, double scale,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, B, S, T_len, H, K, causal, window, (float)scale);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA kernel
// ---------------------------------------------------------------------------
namespace hopper {
using namespace sm90;

// One consumer warpgroup of 64 q rows and 64-row kv tiles: 80 KB of shared
// memory at hd 112/128, so two CTAs share an SM and one's loads and
// epilogue hide behind the other's products. A 128-row tile on two
// warpgroups with 128-row kv tiles needs 160 KB, one CTA an SM, and ran
// slower at both serving shapes. At hd 256 these tiles take 161 KB, and
// one CTA runs on an SM (the header says why).
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int STAGES = 2;
constexpr int GROUP = 16;                     // (b, h) pairs whose q tiles run together
constexpr int NTHREADS = 128 + 32;            // a consumer warpgroup + a producer warp
constexpr float LN2 = 0.6931471805599453f;

// Accumulator fragment of m64nN (per warpgroup): thread t = 32 w + l holds,
// for each 8-column block j, d[4j + e] at row 16 w + l / 4 + 8 (e / 2) and
// column 8 j + 2 (l % 4) + e % 2. Rows l/4 ("a") and l/4 + 8 ("b").
// O of hd 256 is two such m64n128 fragments, acc[0] for columns 0-127 and
// acc[1] for 128-255.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, HD > 128 ? 1 : 2)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int B, int S, int T_len, int H, int K,
                       int causal, int window, float scale_log2) {
  constexpr int NB = (HD + BOX - 1) / BOX;          // TMA boxes per row
  constexpr int HDP = NB * BOX;                     // padded head dim
  constexpr int NH = HDP > 128 ? HDP / 128 : 1;     // P.V products of N = HDP / NH
  constexpr int PVN = HDP / NH;
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

  float acc[NH][PVN / 2];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < PVN / 2; ++i) acc[hf][i] = 0.f;
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
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int j = 0; j < PVN / 8; ++j) {
        acc[hf][4 * j] *= alpha_a;
        acc[hf][4 * j + 1] *= alpha_a;
        acc[hf][4 * j + 2] *= alpha_b;
        acc[hf][4 * j + 3] *= alpha_b;
      }

    // O += P . V, V MN-major: 64-column blocks BK*128 bytes apart, 8-row
    // groups 1024 bytes apart, a k-step of 16 rows 2048 bytes on; the
    // product hf of hd 256 starts PVN / 64 blocks on.
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(acc[hf]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
        wgmma_rs<PVN>(acc[hf], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                      sw128_desc(sv(s) + hf * (PVN / BOX) * BK * 128 + kk * 2048, BK * 128,
                                 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(acc[hf]);

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
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int j = 0; j < PVN / 8; ++j) {
      const int col = hf * PVN + 8 * j + cq;
      if (col >= HD) continue;
      if (row_a < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row_a * q_row + col) =
            __floats2bfloat162_rn(acc[hf][4 * j] * inv_a, acc[hf][4 * j + 1] * inv_a);
      if (row_b < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row_b * q_row + col) =
            __floats2bfloat162_rn(acc[hf][4 * j + 2] * inv_b, acc[hf][4 * j + 3] * inv_b);
    }
  // m is in log2 units of the scaled score: lse = (m + log2 l) ln 2
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((int64_t)b * H + h) * S;
    if (row_a < S) lb[row_a] = l_a > 0.f ? (m_a + log2f(l_a)) * LN2 : INFINITY;
    if (row_b < S) lb[row_b] = l_b > 0.f ? (m_b + log2f(l_b)) * LN2 : INFINITY;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                   int T_len, int H, int K, int causal, int window, double scale,
                   cudaStream_t stream) {
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
                                         T_len, H, K, causal, window, (float)scale * LOG2E);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int T_len, int H, int K, int hd, int causal, int window,
                        double sc, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 112: return launch<112>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 128: return launch<128>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 224: return launch<224>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 256: return launch<256>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int S, int T_len, int H, int K, int hd, int causal, int window,
                        double sc, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 112: return launch<T, 112>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 224: return launch<T, 224>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, B, S, T_len, H, K, causal, window, sc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32 (FMA kernel), 1 bfloat16 (wgmma + TMA kernel). window < 0
// means none. q: (B,S,H,hd), k/v: (B,T,K,hd), o: (B,S,H,hd), all contiguous;
// lse: null, or (B,H,S) float32 for m + log l per row. scale: the softmax
// scale, taken in float32 (kernels/flash_attention.py passes 1 / sqrt(hd)
// unless told otherwise, the value these kernels computed before).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int S, int T_len, int H, int K, int hd,
                                   int causal, int window, int dtype, double scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(q, k, v, o, l, B, S, T_len, H, K, hd, causal, window,
                                     scale, st);
    case 1:
      return (int)hopper::dispatch_hd(q, k, v, o, l, B, S, T_len, H, K, hd, causal, window,
                                      scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
