// Single-token decode attention over a KV cache (flash-decoding) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:decode_attention
// (Pallas; grid (B*H, T/BK) with the KV axis run in order on one core, m/l/acc
// in VMEM scratch, kv_len a runtime scalar in SMEM).
//
// Computes, for each (b, h), with kv head h / (H/K) and one query row:
//   s = (q . k) * hd^-0.5 in float32 over cache columns [0, T),
//   s = -2e38 unless col < kv_len (and col > kv_len - 1 - window),
//   out = softmax(s) . v, accumulated in float32.
//
// What bounds it on the H100: bytes. Each step reads the valid prefix of the
// layer's K and V cache (2 * B * kv_len * K * hd * itemsize) for ~4 flops per
// element, far below the card's ~295 flop/byte ridge.
//
// Design: the TPU's sequential KV grid axis is split over blocks. One block
// per (chunk of CH = 64 cache columns, b, kv head): it stages the chunk's K
// and V once in shared memory and serves all H/K query heads of the group
// from it, so the cache is read once per step and not H/K times. Each block
// writes a partial (m, l, acc) in float32; a second small kernel combines the
// partials of a (b, h). B*K*ceil(T/CH) blocks fill the 132 SMs where B*H
// blocks alone would not. kv_len is read from device memory, so the step
// needs no host value and can later be captured in a CUDA graph; chunks
// wholly outside [kv_len - window, kv_len) exit at once. Plain float32 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr int CH = 64;
constexpr int NTHREADS = 128;
constexpr float NEG = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Partials are laid out [(b*H + h) * nsplit + split] (and * HD for acc).
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int T_len, int H, int K, int window,
                    float scale) {
  constexpr int LDK = HD + 1;
  const int G = H / K;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int b = blockIdx.y / K;
  const int kh = blockIdx.y % K;
  const int tid = threadIdx.x;
  const int s0 = split * CH;

  const int kv_len = *kv_len_ptr;
  const int hi = min(kv_len, T_len);
  const int lo = window >= 0 ? max(0, kv_len - window) : 0;

  if (s0 >= hi || s0 + CH <= lo) {
    for (int idx = tid; idx < G * HD; idx += NTHREADS) {
      const int g = idx / HD, d = idx % HD;
      const int64_t row = ((int64_t)b * H + kh * G + g) * nsplit + split;
      part_acc[row * HD + d] = 0.f;
      if (d == 0) {
        part_m[row] = NEG;
        part_l[row] = 0.f;
      }
    }
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;                 // G x HD
  float* ks = qs + G * HD;          // CH x LDK
  float* vs = ks + CH * LDK;        // CH x HD
  float* ps = vs + CH * HD;         // G x CH
  float* ms = ps + G * CH;          // G
  float* ls = ms + G;               // G

  const int64_t kv_row = (int64_t)K * HD;
  const T* qb = q + ((int64_t)b * H + kh * G) * HD;
  const T* kb = k + (int64_t)b * T_len * kv_row + (int64_t)kh * HD;
  const T* vb = v + (int64_t)b * T_len * kv_row + (int64_t)kh * HD;

  for (int i = tid; i < G * HD; i += NTHREADS) qs[i] = to_f(qb[i]);
  for (int i = tid; i < CH * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD;
    const int col = s0 + r;
    const bool in = col < T_len;
    ks[r * LDK + c] = in ? to_f(kb[(int64_t)col * kv_row + c]) : 0.f;
    vs[r * HD + c] = in ? to_f(vb[(int64_t)col * kv_row + c]) : 0.f;
  }
  __syncthreads();

  for (int idx = tid; idx < G * CH; idx += NTHREADS) {
    const int g = idx / CH, c = idx % CH;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) s = fmaf(qs[g * HD + d], ks[c * LDK + d], s);
    const int col = s0 + c;
    bool ok = col < hi;
    if (window >= 0) ok = ok && col > kv_len - 1 - window;
    ps[idx] = ok ? s * scale : NEG;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += NTHREADS / 32) {
    float mx = NEG;
    for (int c = lane; c < CH; c += 32) mx = fmaxf(mx, ps[g * CH + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < CH; c += 32) {
      const float p = expf(ps[g * CH + c] - mx);
      ps[g * CH + c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ms[g] = mx;
      ls[g] = sum;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < G * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < CH; ++c) a = fmaf(ps[g * CH + c], vs[c * HD + d], a);
    const int64_t row = ((int64_t)b * H + kh * G + g) * nsplit + split;
    part_acc[row * HD + d] = a;
    if (d == 0) {
      part_m[row] = ms[g];
      part_l[row] = ls[g];
    }
  }
}

// One block per (b, h), HD threads: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M).
template <typename T, int HD>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc, T* __restrict__ o,
                                      int nsplit) {
  const int64_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  float M = NEG;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, pm[s]);
  float L = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(pm[s] - M);
    L = fmaf(pl[s], w, L);
    acc = fmaf(part_acc[(bh * nsplit + s) * HD + d], w, acc);
  }
  o[bh * HD + d] = from_f<T>(acc / (L == 0.f ? 1.f : L));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   float* part_m, float* part_l, float* part_acc, int B, int T_len, int H,
                   int K, int window, cudaStream_t stream) {
  const int G = H / K;
  const int nsplit = (T_len + CH - 1) / CH;
  const size_t smem =
      sizeof(float) * (size_t)(G * HD + CH * (HD + 1) + CH * HD + G * CH + 2 * G);
  auto kern = decode_split_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nsplit, B * K), NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      part_m, part_l, part_acc, T_len, H, K, window, (float)(1.0 / sqrt((double)HD)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<B * H, HD, 0, stream>>>(part_m, part_l, part_acc,
                                                         static_cast<T*>(o), nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const int* kv_len,
                        void* o, float* pm, float* pl, float* pa, int B, int T_len, int H,
                        int K, int hd, int window, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, kv_len, o, pm, pl, pa, B, T_len, H, K, window, st);
    case 128: return launch<T, 128>(q, k, v, kv_len, o, pm, pl, pa, B, T_len, H, K, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int decode_attention_nsplit(int T_len) { return (T_len + CH - 1) / CH; }

// dtype: 0 float32, 1 bfloat16. window < 0 means none.
// q: (B,1,H,hd), k/v: (B,T,K,hd), o: (B,1,H,hd), all contiguous; kv_len: one
// int32 on the device. part_m/part_l: B*H*nsplit floats, part_acc: that * hd.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, void* part_m, void* part_l,
                                    void* part_acc, int B, int T_len, int H, int K, int hd,
                                    int window, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  switch (dtype) {
    case 0: return (int)dispatch_hd<float>(q, k, v, kl, o, pm, pl, pa, B, T_len, H, K, hd, window, st);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(q, k, v, kl, o, pm, pl, pa, B, T_len, H, K, hd,
                                             window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
