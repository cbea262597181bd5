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
// element, far below the card's ~295 flop/byte ridge. So the design keeps
// enough bytes in flight on every SM and reads each cache row once per step.
//
// Split-then-combine: one block per (chunk of cache columns, b, kv head
// [, group of up to 8 query heads]) serves all query heads of its kv head from
// the same staged rows, so the cache is read once per step and not H/K times,
// and writes a partial (m, l, acc) in float32; decode_combine_kernel merges
// the partials of a (b, h). kv_len is read from device memory and the grid
// depends only on (B, K, T), so a step needs no host value and can later be
// captured in a CUDA graph; chunks wholly outside [kv_len - window, kv_len)
// exit at once. The partials live in one float32 scratch buffer: m, then l
// (B*H*nsplit each), then acc (B*H*nsplit*hd).
//
// Two split kernels, chosen by dtype (not a fallback: each dtype has one):
//
// bfloat16 -- decode_split_kernel_bf16. The chunk length comes from
//   plan_splits() in kernels/decode_attention.py: about 4 blocks per SM, in
//   multiples of 16 rows (zamba2-7b, B*K = 256, T = 544: 2 splits of 272;
//   qwen3-14b, B*K = 64, T = 544: 7 splits of 80). Each block streams its
//   rows through a 3-stage cp.async ring of 32-row K and V tiles (16 at hd
//   256, below), 16-byte loads kept as bf16 in shared memory, rows past the
//   valid range zero-filled. Each warp takes a quarter of a tile's rows; a row is 16
//   lanes of 8 columns (8 lanes at hd 64, the whole warp at hd 256), so a
//   warp scores 2 (4, 1) rows at once with float32 FMAs and shuffles within
//   the row's lanes, for up to 8 query heads held in registers. Every warp
//   works whatever H/K is. Each warp keeps its own running max, sum and
//   acc; the 4 warps merge through shared memory once per chunk.
//   At hd 256 (gemma3-12b) the ring's tiles are 16 rows, so a stage holds
//   the same 16 KB of K and V as at hd 128 and the 3-stage ring stays at
//   48 KB, the most a block takes without cudaFuncSetAttribute; four blocks
//   still fit an SM. On gemma3's local layers the cache is the W = 1024-slot
//   ring (position p at slot p % W), read with kv_len = min(pos + 1, W).
//
// float32 -- decode_split_kernel, plain FMAs on chunks of CH = 64 rows
//   converted to float32 in shared memory (the float32 path keeps its 2e-5
//   tolerance and is not on the serving path).

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

// One block per (b, h), HD threads: out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M),
// and, where lse is given, lse = M + log(sum_s l_s e^(m_s - M)) in natural-log
// units (-inf where no column is valid: out is 0 there), so that partial
// outputs over disjoint column ranges merge exactly.
template <typename T, int HD>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc, T* __restrict__ o,
                                      float* __restrict__ lse, int nsplit) {
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
  if (lse != nullptr && d == 0) lse[bh] = L == 0.f ? -INFINITY : M + logf(L);
}


// ---------------------------------------------------------------------------
// bfloat16 split kernel
// ---------------------------------------------------------------------------
namespace hopper {

constexpr int NWARPS = NTHREADS / 32;
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Cache rows per ring stage: 32, or 16 at hd 256, so a stage stays 16 KB.
__host__ __device__ constexpr int ring_rows(int hd) { return hd > 128 ? 16 : 32; }

// 8 bf16 (16 bytes) to float32
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// GT: query heads served per block (the group's G = H/K, or a slice of it).
template <int HD, int GT>
__global__ void __launch_bounds__(NTHREADS)
decode_split_kernel_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len_ptr,
                         float* __restrict__ part_m, float* __restrict__ part_l,
                         float* __restrict__ part_acc, int T_len, int H, int K, int window,
                         float scale_log2, int chunk) {
  constexpr int SUB = ring_rows(HD);
  constexpr int VPR = HD / 8;                  // 16-byte vectors per row
  constexpr int LPR = VPR <= 8 ? 8 : VPR <= 16 ? 16 : 32;   // lanes per row
  constexpr int RPS = 32 / LPR;                // rows a warp scores at once
  static_assert(VPR <= 32 && SUB % (NWARPS * RPS) == 0,
                "a row spans at most a warp, one vector a lane");
  constexpr int STEPS = SUB / NWARPS / RPS;
  constexpr int ROW_BYTES = HD * 2;
  constexpr int STAGE_BYTES = 2 * SUB * ROW_BYTES;
  const int G = H / K;
  const int ngroups = (G + GT - 1) / GT;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int b = blockIdx.y / (K * ngroups);
  const int kh = (blockIdx.y / ngroups) % K;
  const int hg = blockIdx.y % ngroups;
  const int h0 = kh * G + hg * GT;             // first query head of this block
  const int ng = min(GT, G - hg * GT);         // live heads
  const int tid = threadIdx.x;

  const int kv_len = *kv_len_ptr;
  const int hi = min(kv_len, T_len);
  const int lo = window >= 0 ? max(0, kv_len - window) : 0;
  const int s0 = split * chunk;
  const int a = max(s0, lo);                   // valid rows of this chunk: [a, e)
  const int e = min(min(s0 + chunk, T_len), hi);

  if (a >= e) {
    for (int idx = tid; idx < ng * HD; idx += NTHREADS) {
      const int g = idx / HD, d = idx % HD;
      const int64_t row = ((int64_t)b * H + h0 + g) * nsplit + split;
      part_acc[row * HD + d] = 0.f;
      if (d == 0) {
        part_m[row] = NEG;
        part_l[row] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) uint8_t smem_ring[];
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ring));
  const int warp = tid / 32, lane = tid % 32;
  const int lr = lane / LPR;                   // row within a warp step
  const int lc = lane % LPR;                   // 16-byte vector within the row
  const bool lane_on = lc < VPR;

  // q, pre-scaled to log2 units: this lane's 8 columns of each head
  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (lane_on && g < ng) {
      const uint4 u = *reinterpret_cast<const uint4*>(q + ((int64_t)b * H + h0 + g) * HD + lc * 8);
      unpack8(u, qf[g]);
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] *= scale_log2;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qf[g][i] = 0.f;
    }
  }

  const int64_t kv_row = (int64_t)K * HD;
  const __nv_bfloat16* kb = k + (int64_t)b * T_len * kv_row + (int64_t)kh * HD;
  const __nv_bfloat16* vb = v + (int64_t)b * T_len * kv_row + (int64_t)kh * HD;
  const int nsub = (e - a + SUB - 1) / SUB;

  auto load = [&](int t) {
    const uint32_t st = ring + (t % STAGES) * STAGE_BYTES;
    const int r0 = a + t * SUB;
    for (int idx = tid; idx < SUB * VPR; idx += NTHREADS) {
      const int r = idx / VPR, c = idx % VPR;
      const bool in = r0 + r < e;
      const int64_t off = (int64_t)(in ? r0 + r : a) * kv_row + c * 8;
      const uint32_t dst = st + r * ROW_BYTES + c * 16;
      cp_async16(dst, kb + off, in ? 16 : 0);
      cp_async16(dst + SUB * ROW_BYTES, vb + off, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < nsub) load(t);
    cp_async_commit();
  }

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  for (int t = 0; t < nsub; ++t) {
    if (t + STAGES - 1 < nsub) load(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const uint8_t* ks = smem_ring + (t % STAGES) * STAGE_BYTES;
    const uint8_t* vs = ks + SUB * ROW_BYTES;
    const int r0 = a + t * SUB;
    float sc[STEPS][GT];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = warp * (SUB / NWARPS) + j * RPS + lr;
      float kf[8];
      if (lane_on) {
        unpack8(*reinterpret_cast<const uint4*>(ks + r * ROW_BYTES + lc * 16), kf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(qf[g][i], kf[i], d);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        sc[j][g] = r0 + r < e ? d : NEG;
      }
    }

    // one running max per warp and head; rows of a step sit in lane groups
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int j = 1; j < STEPS; ++j) mx = fmaxf(mx, sc[j][g]);
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = ex2(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int r = warp * (SUB / NWARPS) + j * RPS + lr;
      float vf[8];
      if (lane_on) {
        unpack8(*reinterpret_cast<const uint4*>(vs + r * ROW_BYTES + lc * 16), vf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vf[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = ex2(sc[j][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
    __syncthreads();   // this stage is refilled STAGES - 1 tiles on
  }
  cp_async_wait<0>();

  // sum the row groups of each warp (they share the warp's max)
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
    }
  }

  // merge the warps through shared memory (the ring is free now)
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem_ring);          // [warp][g][HD + 2]
  constexpr int RED = HD + 2;
  if (lr == 0 && lane_on) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) red[(warp * GT + g) * RED + lc * 8 + i] = acc[g][i];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      red[(warp * GT + g) * RED + HD] = m[g];
      red[(warp * GT + g) * RED + HD + 1] = l[g];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < ng * HD; idx += NTHREADS) {
    const int g = idx / HD, d = idx % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) M = fmaxf(M, red[(w * GT + g) * RED + HD]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = ex2(red[(w * GT + g) * RED + HD] - M);
      A = fmaf(red[(w * GT + g) * RED + d], f, A);
      L = fmaf(red[(w * GT + g) * RED + HD + 1], f, L);
    }
    const int64_t row = ((int64_t)b * H + h0 + g) * nsplit + split;
    part_acc[row * HD + d] = A;
    if (d == 0) {
      part_m[row] = M * LN2;          // natural-log units, as the combine kernel takes them
      part_l[row] = L;
    }
  }
}

template <int HD, int GT>
cudaError_t launch_split(const void* q, const void* k, const void* v, const int* kv_len,
                         float* pm, float* pl, float* pa, int B, int T_len, int H, int K,
                         int window, int chunk, int nsplit, cudaStream_t stream) {
  constexpr int smem = STAGES * 2 * ring_rows(HD) * HD * 2;
  static_assert(smem >= NWARPS * GT * (HD + 2) * 4, "merge area exceeds the ring");
  static_assert(smem <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  auto kern = decode_split_kernel_bf16<HD, GT>;
  const int G = H / K;
  const int ngroups = (G + GT - 1) / GT;
  kern<<<dim3(nsplit, B * K * ngroups), NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_len, pm, pl, pa, T_len, H, K, window,
      (float)(1.0 / sqrt((double)HD)) * LOG2E, chunk);
  return cudaGetLastError();
}

// Query heads per block: the smallest of 1, 2, 4, 5, 8 that holds the
// group, 8 where the group is larger (its heads then span several blocks).
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   float* lse, float* pm, float* pl, float* pa, int B, int T_len, int H, int K,
                   int window, int chunk, cudaStream_t stream) {
  if (chunk <= 0 || chunk % 16 != 0) return cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) return cudaErrorInvalidValue;
  const int nsplit = (T_len + chunk - 1) / chunk;
  const int G = H / K;
  cudaError_t err;
  if (G == 1)
    err = launch_split<HD, 1>(q, k, v, kv_len, pm, pl, pa, B, T_len, H, K, window, chunk, nsplit, stream);
  else if (G == 2)
    err = launch_split<HD, 2>(q, k, v, kv_len, pm, pl, pa, B, T_len, H, K, window, chunk, nsplit, stream);
  else if (G <= 4)
    err = launch_split<HD, 4>(q, k, v, kv_len, pm, pl, pa, B, T_len, H, K, window, chunk, nsplit, stream);
  else if (G == 5)
    err = launch_split<HD, 5>(q, k, v, kv_len, pm, pl, pa, B, T_len, H, K, window, chunk, nsplit, stream);
  else
    err = launch_split<HD, 8>(q, k, v, kv_len, pm, pl, pa, B, T_len, H, K, window, chunk, nsplit, stream);
  if (err != cudaSuccess) return err;
  decode_combine_kernel<__nv_bfloat16, HD><<<B * H, HD, 0, stream>>>(
      pm, pl, pa, static_cast<__nv_bfloat16*>(o), lse, nsplit);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                        float* lse, float* pm, float* pl, float* pa, int B, int T_len, int H,
                        int K, int hd, int window, int chunk, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<64>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, chunk, st);
    case 112: return launch<112>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, chunk, st);
    case 128: return launch<128>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, chunk, st);
    case 256: return launch<256>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace hopper

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* o,
                   float* lse, float* part_m, float* part_l, float* part_acc, int B, int T_len,
                   int H, int K, int window, cudaStream_t stream) {
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
                                                         static_cast<T*>(o), lse, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const int* kv_len,
                        void* o, float* lse, float* pm, float* pl, float* pa, int B, int T_len,
                        int H, int K, int hd, int window, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, st);
    case 112: return launch<T, 112>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, st);
    case 128: return launch<T, 128>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, st);
    case 256: return launch<T, 256>(q, k, v, kv_len, o, lse, pm, pl, pa, B, T_len, H, K, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32 (chunk must be CH = 64), 1 bfloat16 (chunk a multiple of
// 16, from plan_splits). window < 0 means none. q: (B,1,H,hd), k/v:
// (B,T,K,hd), o: (B,1,H,hd), all contiguous; kv_len: one int32 on the device.
// lse: null, or float32 (B, H), each row's log-sum-exp of its scaled scores.
// part: one float32 buffer of B*H*nsplit*(hd + 2), nsplit = ceil(T / chunk):
// m at 0, l at B*H*nsplit, acc at 2*B*H*nsplit.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, void* lse, void* part, int B,
                                    int T_len, int H, int K, int hd, int window, int chunk,
                                    int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || K <= 0 || H % K != 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* kl = static_cast<const int*>(kv_len);
  const int64_t n = (int64_t)B * H * ((T_len + chunk - 1) / chunk);
  float* pm = static_cast<float*>(part);
  float* pl = pm + n;
  float* pa = pm + 2 * n;
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      if (chunk != CH) return (int)cudaErrorInvalidValue;
      return (int)dispatch_hd<float>(q, k, v, kl, o, ls, pm, pl, pa, B, T_len, H, K, hd, window,
                                     st);
    case 1:
      return (int)hopper::dispatch_hd(q, k, v, kl, o, ls, pm, pl, pa, B, T_len, H, K, hd,
                                      window, chunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
