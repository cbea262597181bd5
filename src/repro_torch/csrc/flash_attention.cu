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
//   acc / l with l == 0 guarded.
//
// What bounds it on the H100: operations (4*B*H*S*T*hd/2 flops for a causal
// prefill against q/k/v/o bytes; at qwen3-14b widths and S = 512 it is far
// above the card's ~295 flop/byte ridge).
//
// Design: the TPU's sequential KV grid axis becomes a loop inside one block.
// One block per (q tile of BQ = 64 rows, b*H + h); 128 threads, each holding
// 8 query rows x BK/16 score columns and 8 rows x HD/16 output columns in
// registers. q, k and v tiles are converted to float32 in shared memory
// (rows padded by one word so the column reads do not collide in a bank).
// KV tiles wholly outside the causal/window band of the q tile are skipped,
// ragged q and kv edges are masked (no divisibility requirement). Products
// are plain float32 FMAs: right first; wgmma/TMA is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

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
                 const T* __restrict__ v, T* __restrict__ o,
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
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S,
                   int T_len, int H, int K, int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (size_t)(BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), B, S, T_len, H, K, causal, window, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int T_len, int H, int K, int hd, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, H, K, causal, window, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, S, T_len, H, K, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, H, K, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32, 1 bfloat16. window < 0 means none.
// q: (B,S,H,hd), k/v: (B,T,K,hd), o: (B,S,H,hd), all contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T_len, int H, int K, int hd,
                                   int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_hd<float>(q, k, v, o, B, S, T_len, H, K, hd, causal, window, st);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, K, hd, causal, window,
                                             st);
    default: return (int)cudaErrorInvalidValue;
  }
}
