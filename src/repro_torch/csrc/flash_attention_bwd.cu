// Flash attention backward (GQA, causal and/or sliding window) for Hopper.
//
// The gradient of csrc/flash_attention.cu's forward, for training. The TPU
// kernel src/repro/kernels/flash_attention.py:flash_attention has no
// backward of its own (repro trains through the plain jnp path), so this
// kernel has no TPU counterpart; its plain version is
// kernels/flash_attention.py:flash_attention_bwd_plain.
//
// Computes, for query head h reading kv head kh = h / G (G = H / K), with
// s = (q . k) * hd^-0.5 and the forward's mask (causal: col <= row; window:
// col > row - window; col < T):
//   P  = exp(s - lse[row])            (0 where masked; lse from the forward)
//   D  = rowsum(dO * O)               (pre-pass, float32)
//   dV = P^T dO                       (P rounded to the input type first, as
//                                      the forward's P . V rounds it)
//   dS = P * (dO V^T - D)
//   dK = dS^T Q * hd^-0.5,  dQ = dS K * hd^-0.5
// A row that no key may reach gets zero gradient everywhere (P = 0).
//
// What bounds it on the H100: operations. The five products are 2.5x the
// forward's causal flops (~258 GFLOP at phi4-mini's training shape, B 4,
// S 2048, H 24, K 8, hd 128), 0.26 ms on the bf16 tensor cores, against
// 0.13 ms for the bytes of q, k, v, o, dO, dq, dk, dv. In float32, outside
// the tensor cores (67 TFLOP/s), 3.8 ms.
//
// Both kernels take one block per (k tile of BKV = 64 keys, b * K + kh): the
// block holds K_j and V_j in shared memory, walks the q tiles of BQ = 64 rows
// that the mask lets reach its keys, for each of the G q heads of its group,
// and keeps dK_j and dV_j in registers across all of them, so dk and dv need
// no atomics under GQA. Per q tile it recomputes S and dP, forms P and dS,
// adds P^T dO and dS^T Q to dV and dK, and adds dS K into a float32 dq
// buffer by atomicAdd. The entry point zeroes that buffer, runs the D
// pre-pass, the main kernel and, for bf16, a cast of the buffer into dq.
// Two kernels, chosen by dtype (as in the forward, each dtype has one):
//
// bfloat16 -- flash_bwd_kernel_mma: the five products on the tensor cores,
//   mma.sync m16n8k16 (bf16 in, float32 accumulators), 4 warps; warp w owns
//   key rows 16 w.. of the tile for S^T = K Q^T, dP^T = V dO^T, dV and dK,
//   and q rows 16 w.. for dQ. Operands come from padded bf16 tiles in
//   shared memory by ldmatrix (.trans where the k dimension runs down the
//   rows); P^T and dS^T go from accumulator to A fragments in registers, as
//   bf16 (P is rounded there, as the forward's P . V rounds it; dS too); dS^T
//   also goes to shared memory for dQ = dS K. ~79 KB of shared memory at hd
//   128. Loads are plain 16-byte copies, not yet overlapped with the products.
//
// float32 -- flash_bwd_kernel: FMAs from float32 tiles in shared memory
//   (no tensor-core mode keeps float32 accuracy), 256 threads each with a
//   4 x 4 block of S and dP; P (rounded to T) and dS through shared memory.
//   ~166 KB of shared memory at hd 128: one block an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <cmath>
#include <type_traits>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int NTHREADS = 256;   // 16 (tx) x 16 (ty)
constexpr int LP = BKV + 1;     // padded row stride of the P and dS tiles

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back: the value the forward's P . V saw
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: one warp per (b, s, h).
template <typename T>
__global__ void bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                               float* __restrict__ D, int B, int S, int H, int hd) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * S * H) return;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const int64_t bs = row / H;
    const int s = (int)(bs % S);
    const int64_t b = bs / S;
    D[(b * H + h) * S + s] = acc;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ D, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H, int K,
                 int causal, int window, float scale) {
  constexpr int LD = HD + 1;        // padded row stride of the q, dO, k and v tiles
  constexpr int DPT = HD / 16;      // head-dim columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                 // BKV x LD
  float* vs = ks + BKV * LD;        // BKV x LD
  float* qs = vs + BKV * LD;        // BQ x LD
  float* dos = qs + BQ * LD;        // BQ x LD
  float* ps = dos + BQ * LD;        // BQ x LP
  float* dss = ps + BQ * LP;        // BQ x LP
  float* lse_s = dss + BQ * LP;     // BQ
  float* d_s = lse_s + BQ;          // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y / K;
  const int kh = blockIdx.y % K;
  const int G = H / K;
  const int64_t q_row = (int64_t)H * HD;     // stride between q positions
  const int64_t k_row = (int64_t)K * HD;     // stride between k positions
  const T* kb = k + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  const T* vb = v + (int64_t)b * T_len * k_row + (int64_t)kh * HD;

  for (int i = tid; i < BKV * HD; i += NTHREADS) {
    const int r = i / HD, c = i % HD;
    const int col = k0 + r;
    const bool in = col < T_len;
    ks[r * LD + c] = in ? to_f(kb[(int64_t)col * k_row + c]) : 0.f;
    vs[r * LD + c] = in ? to_f(vb[(int64_t)col * k_row + c]) : 0.f;
  }

  float dk_acc[4][DPT], dv_acc[4][DPT];     // key rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // q rows that can reach a key of this tile
  const int k_last = min(k0 + BKV, T_len) - 1;
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window >= 0 ? min(S, k_last + window) : S;     // exclusive
  const int qt_begin = r_lo / BQ;
  const int qt_end = r_lo < r_hi ? (r_hi + BQ - 1) / BQ : qt_begin;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + (int64_t)b * S * q_row + (int64_t)h * HD;
    const T* dob = dout + (int64_t)b * S * q_row + (int64_t)h * HD;
    float* dqb = dq_acc + (int64_t)b * S * q_row + (int64_t)h * HD;
    const float* lse_b = lse + ((int64_t)b * H + h) * S;
    const float* D_b = D + ((int64_t)b * H + h) * S;

    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();      // the previous tile's qs, dos, ps, dss consumed
      for (int i = tid; i < BQ * HD; i += NTHREADS) {
        const int r = i / HD, c = i % HD;
        const int row = q0 + r;
        const bool in = row < S;
        qs[r * LD + c] = in ? to_f(qb[(int64_t)row * q_row + c]) : 0.f;
        dos[r * LD + c] = in ? to_f(dob[(int64_t)row * q_row + c]) : 0.f;
      }
      if (tid < BQ) {
        const int row = q0 + tid;
        lse_s[tid] = row < S ? lse_b[row] : INFINITY;
        d_s[tid] = row < S ? D_b[row] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T: rows ty + 16 i, columns tx + 16 j
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qv[i] = qs[(ty + 16 * i) * LD + d];
          dov[i] = dos[(ty + 16 * i) * LD + d];
          kv[i] = ks[(tx + 16 * i) * LD + d];
          vv[i] = vs[(tx + 16 * i) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int col = k0 + c;
          bool ok = row < S && col < T_len;
          if (causal) ok = ok && col <= row;
          if (window >= 0) ok = ok && col > row - window;
          const float p = ok ? expf(sc[i][j] * scale - lse_s[r]) : 0.f;
          ps[r * LP + c] = round_to<T>(p);
          dss[r * LP + c] = p * (dp[i][j] - d_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: key rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pv[4], dsv[4], dov[DPT], qv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * LP + ty + 16 * i];
          dsv[i] = dss[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dov[j] = dos[r * LD + tx + 16 * j];
          qv[j] = qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) {
            dv_acc[i][j] = fmaf(pv[i], dov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }

      // dQ += dS K * scale: q rows ty + 16 i, columns tx + 16 j, by atomics
      float dqa[4][DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dqa[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < BKV; ++c) {
        float dsv[4], kv[DPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) dqa[i][j] = fmaf(dsv[i], kv[j], dqa[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          atomicAdd(dqb + (int64_t)row * q_row + tx + 16 * j, dqa[i][j] * scale);
      }
    }
  }

  T* dkb = dk + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  T* dvb = dv + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col >= T_len) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      dkb[(int64_t)col * k_row + tx + 16 * j] = from_f<T>(dk_acc[i][j] * scale);
      dvb[(int64_t)col * k_row + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: the five products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------
namespace tc {

constexpr int NTHREADS = 128;              // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [0, n) of a (rows, HD) bf16 tile from global (row stride `stride`
// elements) into shared memory (row stride LDS), zeros past `valid` rows
template <int HD, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t stride, int rows, int valid) {
  constexpr int CH = HD / 8;               // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (int64_t)r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = val;
  }
}

// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): a C tile holds
// c[0..1] at row g, columns 2t, 2t + 1 and c[2..3] at row g + 8; an A tile
// a[0] rows g / cols 2t.., a[1] rows g + 8, a[2] and a[3] the same at cols
// 8 + 2t; a B tile b0 at k rows 2t, 2t + 1 of column g, b1 at k rows 8 + 2t.
// Warp w owns key rows 16 w .. 16 w + 15 of the k tile (S^T, dP^T, dK, dV)
// and q rows 16 w .. 16 w + 15 of the q tile (dQ).
template <int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ D,
                     float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int T_len, int H, int K, int causal,
                     int window, float scale) {
  constexpr int LDS = HD + 8;                // row stride (elements): no ldmatrix conflicts
  constexpr int LDP = BQ + 8;
  constexpr int NT = HD / 8;                 // 8-column n-tiles over the head dim
  constexpr int NP = HD / 16;                // pairs of them (x4 loads)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BKV x LDS
  __nv_bfloat16* vs = ks + BKV * LDS;                                // BKV x LDS
  __nv_bfloat16* qs = vs + BKV * LDS;                                // BQ x LDS
  __nv_bfloat16* dos = qs + BQ * LDS;                                // BQ x LDS
  __nv_bfloat16* dss = dos + BQ * LDS;                               // BKV x LDP: dS^T
  float* lse_s = reinterpret_cast<float*>(dss + BKV * LDP);          // BQ, log2 units
  float* d_s = lse_s + BQ;                                           // BQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BKV;
  const int b = blockIdx.y / K, kh = blockIdx.y % K;
  const int G = H / K;
  const int64_t q_row = (int64_t)H * HD, k_row = (int64_t)K * HD;
  const float scale_log2 = scale * LOG2E;

  load_tile<HD, LDS>(ks, k + ((int64_t)b * T_len + k0) * k_row + (int64_t)kh * HD, k_row, BKV,
                     T_len - k0);
  load_tile<HD, LDS>(vs, v + ((int64_t)b * T_len + k0) * k_row + (int64_t)kh * HD, k_row, BKV,
                     T_len - k0);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int k_last = min(k0 + BKV, T_len) - 1;
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window >= 0 ? min(S, k_last + window) : S;     // exclusive
  const int qt_begin = r_lo / BQ;
  const int qt_end = r_lo < r_hi ? (r_hi + BQ - 1) / BQ : qt_begin;

  // Each lane's row and column in a 16 x 16 block for ldmatrix.x4 (lane / 8
  // picks the 8 x 8 matrix). (r1, c1) orders the matrices rows 0-7 / 8-15
  // first: an A tile stored row-major, or a B tile stored k-major (read with
  // .trans). (r2, c2) orders them columns 0-7 / 8-15 first: a B tile stored
  // n-major (two n-tiles), or an A tile stored k-major (read with .trans).
  const int r1 = (lane % 8) + 8 * ((lane / 8) % 2), c1 = 8 * (lane / 16);
  const int r2 = (lane % 8) + 8 * (lane / 16), c2 = 8 * ((lane / 8) % 2);
  const int jw = 16 * warp;                  // this warp's first key row in the tile

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const float* lse_b = lse + ((int64_t)b * H + h) * S;
    const float* D_b = D + ((int64_t)b * H + h) * S;
    float* dqb = dq_acc + (int64_t)b * S * q_row + (int64_t)h * HD;

    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();      // the previous tile's qs, dos and dss consumed
      load_tile<HD, LDS>(qs, q + ((int64_t)b * S + q0) * q_row + (int64_t)h * HD, q_row, BQ,
                         S - q0);
      load_tile<HD, LDS>(dos, dout + ((int64_t)b * S + q0) * q_row + (int64_t)h * HD, q_row,
                         BQ, S - q0);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse_b[row] * LOG2E : INFINITY;
        d_s[threadIdx.x] = row < S ? D_b[row] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T: 16 key rows x BQ q columns (8 n-tiles)
      float acc[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int ks_ = 0; ks_ < HD / 16; ++ks_) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(ks + (jw + r1) * LDS + 16 * ks_ + c1));
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t bq[4];
          ldsm_x4(bq, smem_u32(qs + (16 * np + r2) * LDS + 16 * ks_ + c2));
          mma(acc[2 * np], a, bq[0], bq[1]);
          mma(acc[2 * np + 1], a, bq[2], bq[3]);
        }
      }
      // P^T = exp(s - lse), 0 where masked; as bf16 A fragments over the q columns
      uint32_t pa[BQ / 16][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + jw + g + 8 * (e / 2);
          const int il = 8 * n + 2 * t + (e % 2);
          const int i = q0 + il;
          bool ok = i < S && j < T_len;
          if (causal) ok = ok && j <= i;
          if (window >= 0) ok = ok && j > i - window;
          acc[n][e] = ok ? ex2(acc[n][e] * scale_log2 - lse_s[il]) : 0.f;
        }
        pa[n / 2][(n % 2) * 2] = pack_bf16(acc[n][0], acc[n][1]);
        pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(acc[n][2], acc[n][3]);
      }
      // dV += P^T dO: k = the q rows (dO read transposed)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          uint32_t bo[4];
          ldsm_x4_t(bo, smem_u32(dos + (16 * kk + r1) * LDS + 16 * np + c1));
          mma(dv_acc[2 * np], pa[kk], bo[0], bo[1]);
          mma(dv_acc[2 * np + 1], pa[kk], bo[2], bo[3]);
        }
      // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int ks_ = 0; ks_ < HD / 16; ++ks_) {
        uint32_t a[4];
        ldsm_x4(a, smem_u32(vs + (jw + r1) * LDS + 16 * ks_ + c1));
#pragma unroll
        for (int np = 0; np < BQ / 16; ++np) {
          uint32_t bo[4];
          ldsm_x4(bo, smem_u32(dos + (16 * np + r2) * LDS + 16 * ks_ + c2));
          mma(acc[2 * np], a, bo[0], bo[1]);
          mma(acc[2 * np + 1], a, bo[2], bo[3]);
        }
      }
      // dS^T = P^T (dP^T - D): in place of pa as A fragments, and to shared
      // memory (bf16) for dQ
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
        const float2 p01 = unpack_bf16(pa[n / 2][(n % 2) * 2]);
        const float2 p23 = unpack_bf16(pa[n / 2][(n % 2) * 2 + 1]);
        const int il = 8 * n + 2 * t;
        const float ds0 = p01.x * (acc[n][0] - d_s[il]), ds1 = p01.y * (acc[n][1] - d_s[il + 1]);
        const float ds2 = p23.x * (acc[n][2] - d_s[il]), ds3 = p23.y * (acc[n][3] - d_s[il + 1]);
        const uint32_t lo = pack_bf16(ds0, ds1), hi = pack_bf16(ds2, ds3);
        pa[n / 2][(n % 2) * 2] = lo;
        pa[n / 2][(n % 2) * 2 + 1] = hi;
        *reinterpret_cast<uint32_t*>(dss + (jw + g) * LDP + il) = lo;
        *reinterpret_cast<uint32_t*>(dss + (jw + g + 8) * LDP + il) = hi;
      }
      // dK += dS^T Q: k = the q rows (Q read transposed)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          uint32_t bq[4];
          ldsm_x4_t(bq, smem_u32(qs + (16 * kk + r1) * LDS + 16 * np + c1));
          mma(dk_acc[2 * np], pa[kk], bq[0], bq[1]);
          mma(dk_acc[2 * np + 1], pa[kk], bq[2], bq[3]);
        }
      __syncthreads();      // dS^T complete in shared memory

      // dQ (q rows 16 w .., HD columns) += dS K, by float32 atomics; the head
      // dim in chunks of 64 columns to bound the accumulator
      const int iw = 16 * warp;
#pragma unroll
      for (int c0 = 0; c0 < NP; c0 += 4) {
        float dqa[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4_t(a, smem_u32(dss + (16 * kk + r2) * LDP + iw + c2));
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            if (c0 + p < NP) {
              uint32_t bk[4];
              ldsm_x4_t(bk, smem_u32(ks + (16 * kk + r1) * LDS + 16 * (c0 + p) + c1));
              mma(dqa[2 * p], a, bk[0], bk[1]);
              mma(dqa[2 * p + 1], a, bk[2], bk[3]);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (c0 * 2 + n < NT) {
            const int col = 8 * (c0 * 2 + n) + 2 * t;
            const int ra = q0 + iw + g, rb = ra + 8;
            if (ra < S) {
              atomicAdd(dqb + (int64_t)ra * q_row + col, dqa[n][0] * scale);
              atomicAdd(dqb + (int64_t)ra * q_row + col + 1, dqa[n][1] * scale);
            }
            if (rb < S) {
              atomicAdd(dqb + (int64_t)rb * q_row + col, dqa[n][2] * scale);
              atomicAdd(dqb + (int64_t)rb * q_row + col + 1, dqa[n][3] * scale);
            }
          }
        }
      }
    }
  }

  __nv_bfloat16* dkb = dk + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  __nv_bfloat16* dvb = dv + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  const int ja = k0 + jw + g, jb = ja + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (ja < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)ja * k_row + col) =
          __floats2bfloat162_rn(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)ja * k_row + col) =
          __floats2bfloat162_rn(dv_acc[n][0], dv_acc[n][1]);
    }
    if (jb < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)jb * k_row + col) =
          __floats2bfloat162_rn(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)jb * k_row + col) =
          __floats2bfloat162_rn(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

}  // namespace tc

template <typename T>
__global__ void cast_kernel(const float* __restrict__ src, T* __restrict__ dst, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    dst[i] = from_f<T>(src[i]);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* D, float* dq_acc, void* dq, void* dk, void* dv,
                   int B, int S, int T_len, int H, int K, int causal, int window,
                   cudaStream_t stream) {
  const int64_t nq = (int64_t)B * S * H * HD;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, nq * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)B * S * H;
  bwd_dot_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, B, S, H, HD);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  dim3 grid((T_len + BKV - 1) / BKV, B * K);
  const float scale = (float)(1.0 / sqrt((double)HD));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)(2 * (BKV + BQ) * (HD + 8) +
                                                         BKV * (BQ + 8)) + sizeof(float) * 2 * BQ;
    auto kern = tc::flash_bwd_kernel_mma<HD>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, tc::NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, D, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv),
        S, T_len, H, K, causal, window, scale);
  } else {
    const size_t smem = sizeof(float) * (size_t)(2 * BKV * (HD + 1) + 2 * BQ * (HD + 1) +
                                                 2 * BQ * LP + 2 * BQ);
    auto kern = flash_bwd_kernel<T, HD>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, D, dq_acc, static_cast<T*>(dk), static_cast<T*>(dv),
        S, T_len, H, K, causal, window, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if (dq != static_cast<void*>(dq_acc)) {
    const int64_t blocks = (nq + 255) / 256 < 132 * 16 ? (nq + 255) / 256 : 132 * 16;
    cast_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(dq_acc, static_cast<T*>(dq), nq);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* D, float* dq_acc, void* dq,
                        void* dk, void* dv, int B, int S, int T_len, int H, int K, int hd,
                        int causal, int window, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, D, dq_acc, dq, dk, dv, B, S, T_len, H,
                                  K, causal, window, st);
    case 112: return launch<T, 112>(q, k, v, o, dout, lse, D, dq_acc, dq, dk, dv, B, S, T_len,
                                    H, K, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, D, dq_acc, dq, dk, dv, B, S, T_len,
                                    H, K, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 float32, 1 bfloat16. window < 0 means none. q, o, dout: (B,S,H,hd);
// k, v: (B,T,K,hd); lse: (B,H,S) float32 from the forward; D: (B,H,S) float32
// scratch; dq_acc: (B,S,H,hd) float32 scratch, zeroed here; dq: (B,S,H,hd) of
// dtype, or dq_acc itself for float32 (no cast); dk, dv: (B,T,K,hd) of dtype.
// All contiguous.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* D, void* dq_acc,
                                   void* dq, void* dk, void* dv, int B, int S, int T_len, int H,
                                   int K, int hd, int causal, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || S <= 0 || T_len <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  float* acc = static_cast<float*>(dq_acc);
  switch (dtype) {
    case 0:
      return (int)dispatch_hd<float>(q, k, v, o, dout, l, d, acc, dq, dk, dv, B, S, T_len, H, K,
                                     hd, causal, window, st);
    case 1:
      return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, dout, l, d, acc, dq, dk, dv, B, S,
                                             T_len, H, K, hd, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
