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
// S 2048, H 24, K 8, hd 128), 0.2607 ms on the bf16 tensor cores, against
// 0.13 ms for the bytes of q, k, v, o, dO, dq, dk, dv. In float32, outside
// the tensor cores (67 TFLOP/s), 3.8 ms.
//
// Both kernels take one block per (kv tile, b * K + kh): the block holds K_j
// and V_j in shared memory, walks the q tiles of BQ = 64 rows that the mask
// lets reach its keys, for each of the G q heads of its group, and keeps dK_j
// and dV_j in registers across all of them, so dk and dv need no atomics
// under GQA. Per q tile it recomputes S and dP, forms P and dS, adds P^T dO
// and dS^T Q to dV and dK, and adds dS K into a float32 dq buffer. The entry
// point runs a pre-pass that writes D and zeroes that buffer, the main kernel
// and, for bf16, a cast of the buffer into dq. Two kernels, chosen by dtype
// (as in the forward, each dtype has one; nothing falls back from one to the
// other):
//
// bfloat16 -- flash_bwd_kernel_wgmma, FA3-style, so that the products run at
//   the tensor cores' rate and the loads hide behind them. kv tiles of 128
//   keys over two consumer warpgroups of 64 keys each (64 keys and one
//   warpgroup at hd 64), beside a producer warpgroup whose first warp issues
//   TMA loads over the forward's 4-D tensor maps (csrc/sm90.cuh): K and V
//   once, then Q and dO of each (head, q tile) through a ring of 2 stages in
//   128-byte-swizzled shared memory with mbarrier completion, the tile's lse
//   and D rows stored beside them by the same warp after the loads are
//   issued, so the next tile's loads overlap this tile's products.
//   setmaxnreg gives the consumers 240 registers and the producer 24. All
//   five products are wgmma with float32 accumulators: S^T = K Q^T and
//   dP^T = V dO^T with both operands K-major in shared memory;
//   P^T = exp2(S^T scale log2e - lse), zeroed where masked in a separate pass
//   that runs only on a tile straddling the causal or window edge or the end
//   of S or T, kept in float32 for dS = P (dP - D); dV += P^T dO (issued
//   before dP^T is waited for) and dK += dS^T Q with P^T and dS^T as bf16
//   register A operands and dO, Q read MN-major through the descriptor's
//   transpose bit (hd 112 runs them at N = 128 on zero-filled columns);
//   dS^T goes once to shared memory, and dQ = dS K runs from it and K, both
//   MN-major, each warpgroup taking half of the head dim over all 128 keys.
//   dQ (times hd^-0.5) goes to shared memory in float32 and one thread adds
//   it into dq_acc with bulk tensor reductions (cp.reduce.async.bulk.tensor
//   .add: the copy engine does the additions and drops rows past S and
//   columns past hd), two boxes of 64 x 32 a warpgroup and q tile, in place
//   of 8,192 scalar atomics a 64 x 64 tile pair. Their order still varies
//   from run to run. The grid launches the heaviest causal kv tiles (lowest
//   keys) first. Shared memory: 194 KB at hd 112/128 (one CTA an SM), 81 KB
//   at hd 64. nvcc -Xptxas -v: 168 registers at launch and no spill at hd
//   112 and 128, 203 and no spill at hd 64.
//   hd 256 (gemma3): dK and dV of 64 keys over all 256 columns would be 256
//   accumulator registers a thread, past the consumers' 240, and the tiles
//   above would take over 256 KB. So the kv tile is 64 keys, both consumer
//   warpgroups take the same keys and each keeps dK's and dV's columns
//   128 w .. 128 w + 127 (2 x 64 registers, as at hd 128); each computes
//   S^T and dP^T for itself (2 of the 5 products twice, 1.4x the flops),
//   the first stores dS^T, and each adds 128 of dQ's columns. The (Q, dO)
//   ring has one stage, released once dV and dK have read it, so the next
//   tile's loads overlap dQ; dV is waited for before dS^T is formed, so
//   that P^T's registers are free. Shared memory 214 KB: K and V 64 KB, Q
//   and dO 64 KB, dS^T twice 16 KB, the two dQ tiles 64 KB.
//
// float32 -- flash_bwd_kernel: FMAs from float32 tiles in shared memory
//   (no tensor-core mode keeps float32 accuracy), 256 threads each with a
//   4 x 4 block of S and dP; P (rounded to T) and dS through shared memory,
//   dq by float32 atomicAdd; kv tiles of BKV = 64 keys. ~166 KB of shared
//   memory at hd 128: one block an SM. At hd 256 the q tile is 32 rows
//   (each thread 2 x 4 of S and dP), 214 KB.

#include <cmath>
#include <type_traits>

#include "sm90.cuh"

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

// D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], and the row of the
// float32 dq buffer at (b, s, h) zeroed for the main kernel's additions: one
// warp per (b, s, h), the head dim unrolled so each lane's loads are all in
// flight at once.
template <typename T, int HD>
__global__ void bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                float* __restrict__ D, float* __restrict__ dq_acc, int B, int S,
                                int H) {
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * S * H) return;
  const T* op = o + row * HD;
  const T* dp = dout + row * HD;
  float* zp = dq_acc + row * HD;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) {
    acc = fmaf(to_f(op[c]), to_f(dp[c]), acc);
    zp[c] = 0.f;
  }
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

// q rows a q tile of the float32 kernel holds: 64, and 32 at hd 256, where
// 64-row q and dO tiles beside the 64-key K and V would not fit 227 KB
__host__ __device__ constexpr int f32_q_tile(int hd) { return hd > 128 ? 32 : BQ; }

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ D, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int T_len, int H, int K,
                 int causal, int window, float scale) {
  constexpr int QB = f32_q_tile(HD);
  constexpr int RQ = QB / 16;       // q rows per thread
  constexpr int LD = HD + 1;        // padded row stride of the q, dO, k and v tiles
  constexpr int DPT = HD / 16;      // head-dim columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                 // BKV x LD
  float* vs = ks + BKV * LD;        // BKV x LD
  float* qs = vs + BKV * LD;        // QB x LD
  float* dos = qs + QB * LD;        // QB x LD
  float* ps = dos + QB * LD;        // QB x LP
  float* dss = ps + QB * LP;        // QB x LP
  float* lse_s = dss + QB * LP;     // QB
  float* d_s = lse_s + QB;          // QB

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
  const int qt_begin = r_lo / QB;
  const int qt_end = r_lo < r_hi ? (r_hi + QB - 1) / QB : qt_begin;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + (int64_t)b * S * q_row + (int64_t)h * HD;
    const T* dob = dout + (int64_t)b * S * q_row + (int64_t)h * HD;
    float* dqb = dq_acc + (int64_t)b * S * q_row + (int64_t)h * HD;
    const float* lse_b = lse + ((int64_t)b * H + h) * S;
    const float* D_b = D + ((int64_t)b * H + h) * S;

    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * QB;
      __syncthreads();      // the previous tile's qs, dos, ps, dss consumed
      for (int i = tid; i < QB * HD; i += NTHREADS) {
        const int r = i / HD, c = i % HD;
        const int row = q0 + r;
        const bool in = row < S;
        qs[r * LD + c] = in ? to_f(qb[(int64_t)row * q_row + c]) : 0.f;
        dos[r * LD + c] = in ? to_f(dob[(int64_t)row * q_row + c]) : 0.f;
      }
      if (tid < QB) {
        const int row = q0 + tid;
        lse_s[tid] = row < S ? lse_b[row] : INFINITY;
        d_s[tid] = row < S ? D_b[row] : 0.f;
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T: rows ty + 16 i, columns tx + 16 j
      float sc[RQ][4], dp[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[RQ], dov[RQ], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          qv[i] = qs[(ty + 16 * i) * LD + d];
          dov[i] = dos[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = ks[(tx + 16 * j) * LD + d];
          vv[j] = vs[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
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
      for (int r = 0; r < QB; ++r) {
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
      float dqa[RQ][DPT];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) dqa[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < BKV; ++c) {
        float dsv[RQ], kv[DPT];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dsv[i] = dss[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < DPT; ++j) dqa[i][j] = fmaf(dsv[i], kv[j], dqa[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
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
// bfloat16: wgmma products fed by a TMA ring
// ---------------------------------------------------------------------------
namespace hopper {
using namespace sm90;

constexpr int BQ = 64;          // q rows a ring stage holds
constexpr int STAGES = 2;
// Consumer warpgroups at hd 112 and 128, 64 keys each. 1 builds the 64-key
// tile variant (one warpgroup adding all of dQ's columns), which ran 1.25x
// slower at phi4-mini's training shape.
constexpr int WIDE_WG = 2;

// Consumer warpgroups of the kernel for a head dim: at hd 64 one, as dQ's
// columns are split between the warpgroups in whole 64-column boxes.
__host__ __device__ constexpr int consumers(int hd) { return hd == 64 ? 1 : WIDE_WG; }
// At hd 256 the two warpgroups take the same 64 keys and split dK's and dV's
// columns (each keeps 2 x 64 accumulator registers, as at hd 128, where
// owning all 256 columns would take 256), each computing S^T and dP^T for
// itself; and the ring has one stage, so that K, V, Q, dO, dS^T and the dQ
// tiles fit 227 KB.
__host__ __device__ constexpr bool split_cols(int hd) { return hd > 128; }
__host__ __device__ constexpr int kv_tile(int hd) { return split_cols(hd) ? 64 : 64 * consumers(hd); }
__host__ __device__ constexpr int ring_stages(int hd) { return split_cols(hd) ? 1 : STAGES; }

// Adds bytes to the barrier's current phase without arriving.
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" :: "r"(addr), "f"(x), "f"(y) : "memory");
}

// Adds a box of float32 in shared memory into global memory through a
// tensor map (the copy engine does the additions; out-of-bounds elements
// are dropped), tracked by this thread's bulk group.
__device__ __forceinline__ void tma_reduce_add_4d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's bulk reductions have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// D(64 x 64, f32) (+)= A(64 x 16, smem, MN-major) . B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_tt_n64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D(64 x 128, f32) (+)= A(64 x 16, smem, MN-major) . B(16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_ss_tt_n128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
template <int N>
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_ss_tt_n64(d, da, db, acc);
  else wgmma_ss_tt_n128(d, da, db, acc);
}

// One CTA per (kv tile of BKV = 64 NWG keys, b K + kh): a producer
// warpgroup (one warp loads, the rest exit) and NWG consumer warpgroups,
// warpgroup w owning keys 64 w .. 64 w + 63 of the tile (at hd 256, BKV 64:
// warpgroup w owns columns 128 w .. 128 w + 127 of dK and dV). Shared memory,
// every tile 128-byte swizzled in 64-column boxes (hd 112 zero-filled to
// 128): K and V (BKV rows), a ring of STAGES (Q, dO) stages of BQ rows with
// their lse (log2 units) and D rows, dS^T (BKV x BQ bf16) twice, by
// iteration parity, and each warpgroup's float32 dQ tile in 32-column boxes.
// Accumulator fragments as in the forward: thread 32 w' + l of a warpgroup
// holds, for each 8-column block j, d[4j + e] at row 16 w' + l / 4 + 8 (e / 2)
// and column 8 j + 2 (l % 4) + e % 2.
template <int HD, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_bwd_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const float* __restrict__ lse, const float* __restrict__ D,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int B,
                       int S, int T_len, int H, int K, int causal, int window, float scale) {
  constexpr bool SPLIT = split_cols(HD);
  constexpr int BKV = kv_tile(HD);
  constexpr int NST = ring_stages(HD);
  constexpr int NB = (HD + BOX - 1) / BOX;          // 64-column boxes a row
  constexpr int HDP = NB * BOX;                     // padded head dim
  constexpr int NKV = SPLIT ? HDP / NWG : HDP;      // dV's and dK's columns a warpgroup holds
  constexpr int NQ = HDP / NWG;                     // dQ columns a warpgroup adds
  constexpr int KV_BYTES = NB * BKV * 128;          // K, and V
  constexpr int QT_BYTES = NB * BQ * 128;           // Q, and dO, of a stage
  constexpr int DS_BYTES = BKV * 128;               // dS^T: 64 q columns of bf16 a key
  constexpr int DQ_BYTES = (NQ / 32) * BQ * 128;    // a warpgroup's dQ, 32-column boxes
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * NST];
  __shared__ __align__(16) float s_lse[NST][BQ];       // lse in log2 units, +inf past S
  __shared__ __align__(16) float s_d[NST][BQ];         // D, 0 past S

  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms: 1024-aligned
  const uint32_t sv = sk + KV_BYTES;
  auto sq = [&](int s) { return sk + 2 * KV_BYTES + s * 2 * QT_BYTES; };
  auto sdo = [&](int s) { return sk + 2 * KV_BYTES + s * 2 * QT_BYTES + QT_BYTES; };
  auto sds = [&](int p) { return sk + 2 * KV_BYTES + NST * 2 * QT_BYTES + p * DS_BYTES; };
  const uint32_t sdq0 = sk + 2 * KV_BYTES + NST * 2 * QT_BYTES + 2 * DS_BYTES;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return smem_u32(&bars[1 + NST + s]); };

  // Grid order: the heaviest causal kv tiles (lowest keys) first.
  const int kt = blockIdx.x / (B * K);
  const int b = (blockIdx.x % (B * K)) / K;
  const int kh = blockIdx.x % K;
  const int G = H / K;
  const int k0 = kt * BKV;

  // q tiles that can reach a key of this tile, for each of the G heads
  const int k_last = min(k0 + BKV, T_len) - 1;
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window >= 0 ? min(S, k_last + window) : S;     // exclusive
  const int qt_begin = r_lo / BQ;
  const int nqt = r_lo < r_hi ? (r_hi + BQ - 1) / BQ - qt_begin : 0;
  const int iters = G * nqt;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full(s), 32);                   // every producer lane
      mbar_init(empty(s), 4 * NWG);             // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // producer warpgroup: its first warp loads K and V once, then Q, dO,
    // lse and D of each (head, q tile) into the ring
    if constexpr (NWG > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 4 * NWG) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          tma_load_4d(sk + nb * BKV * 128, &tm_k, bar_kv, nb * BOX, kh, k0, b);
          tma_load_4d(sv + nb * BKV * 128, &tm_v, bar_kv, nb * BOX, kh, k0, b);
        }
      }
      // the tile's bytes are posted and its loads issued before lse and D
      // are read, so the two latencies overlap; every lane then arrives
      for (int i = 0, h = kh * G, qt = qt_begin; i < iters; ++i) {
        const int s = i % NST;
        const int n = i / NST;
        const int q0 = qt * BQ;
        if (n > 0) mbar_wait(empty(s), (n - 1) & 1);
        if (lane == 0) {
          mbar_add_tx(full(s), 2 * QT_BYTES);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            tma_load_4d(sq(s) + nb * BQ * 128, &tm_q, full(s), nb * BOX, h, q0, b);
            tma_load_4d(sdo(s) + nb * BQ * 128, &tm_do, full(s), nb * BOX, h, q0, b);
          }
        }
        const float* lse_b = lse + ((int64_t)b * H + h) * S;
        const float* D_b = D + ((int64_t)b * H + h) * S;
        for (int r = lane; r < BQ; r += 32) {
          const int row = q0 + r;
          s_lse[s][r] = row < S ? lse_b[row] * LOG2E : INFINITY;
          s_d[s][r] = row < S ? D_b[row] : 0.f;
        }
        mbar_arrive(full(s));
        if (++qt == qt_begin + nqt) {
          qt = qt_begin;
          ++h;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg
  if constexpr (NWG > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int wq = warp % 4;                   // warp within the warpgroup
  const int tid = threadIdx.x % 128;
  const int g = lane / 4, t = lane % 4;
  const int kw0 = k0 + (SPLIT ? 0 : 64 * wg); // this warpgroup's first key
  const uint32_t kv_rows = SPLIT ? 0 : wg * 8192;   // its keys' offset in a K or V box
  const int col0 = SPLIT ? wg * NKV : 0;     // its first dK and dV column
  const int ra = 16 * wq + g;                // fragment row "a" in a 64-row block; "b" is ra + 8
  const uint32_t sdq = sdq0 + wg * DQ_BYTES;
  const float scale_log2 = scale * LOG2E;

  float dv_acc[NKV / 2], dk_acc[NKV / 2];
#pragma unroll
  for (int i = 0; i < NKV / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;

  mbar_wait(bar_kv, 0);

  for (int i = 0, h = kh * G, qt = qt_begin; i < iters; ++i) {
    const int s = i % NST;
    const int q0 = qt * BQ;
    mbar_wait(full(s), (i / NST) & 1);

    // S^T = K_w Q^T and dP^T = V_w dO^T, both operands K-major (the pad
    // k-steps of hd 112 skipped); dP^T stays in flight while P is formed
    float sc[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int j = 0; j < BQ / 2; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int nb = kk / 4, kin = kk % 4;
      wgmma_ss_n64(sc, sw128_desc(sk + nb * BKV * 128 + kv_rows + kin * 32, 16, 1024),
                   sw128_desc(sq(s) + nb * BQ * 128 + kin * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int nb = kk / 4, kin = kk % 4;
      wgmma_ss_n64(dp, sw128_desc(sv + nb * BKV * 128 + kv_rows + kin * 32, 16, 1024),
                   sw128_desc(sdo(s) + nb * BQ * 128 + kin * 32, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T = exp2(S^T scale log2e - lse), float32 in sc; zeroed where masked,
    // in a pass of its own that runs only on a tile straddling an edge; in
    // bf16 as the register A operand of dV (k-step kk takes 8-column blocks
    // 2 kk, 2 kk + 1)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(&s_lse[s][8 * j + 2 * t]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * j + e] = ex2(sc[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x));
    }
    if (q0 + BQ > S || kw0 + 64 > T_len || (causal && kw0 + 63 > q0) ||
        (window >= 0 && kw0 <= q0 + BQ - 1 - window)) {
      // element (j, e): q row q0 + col, key kw0 + row; qi - kj = base + col - row
      const int base = q0 - kw0;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int row = ra + 8 * (e >> 1);
          bool ok = col < S - q0 && row < T_len - kw0;
          if (causal) ok = ok && base + col - row >= 0;
          if (window >= 0) ok = ok && base + col - row < window;
          if (!ok) sc[4 * j + e] = 0.f;
        }
      }
    }
    uint32_t pp[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      pp[(j / 2) * 4 + (j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pp[(j / 2) * 4 + (j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }

    // dV += P^T dO, dO MN-major (64-column blocks BQ*128 bytes apart, 8-row
    // groups 1024 apart, a k-step 2048 on), in flight while dS is formed
    // (at hd 256 waited for, so that P^T's registers are free for dS^T)
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<NKV>(dv_acc, pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2], pp[4 * kk + 3],
                    sw128_desc(sdo(s) + (col0 / BOX) * BQ * 128 + kk * 2048, BQ * 128, 1024));
    wgmma_commit();
    if constexpr (SPLIT) {
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_u32(pp);
    } else {
      wgmma_wait<1>();                          // dP^T done, dV may still run
    }
    fence_regs(dp);

    // dS^T = P^T (dP^T - D) in bf16: the A operand of dK; then to shared
    // memory (the 16-byte chunk j of key row r at chunk j ^ (r % 8)) for dQ,
    // after all of it is formed, so no load of D waits behind a store
    uint32_t dsp[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(&s_d[s][8 * j + 2 * t]);
      dsp[(j / 2) * 4 + (j % 2) * 2] = pack_bf16(sc[4 * j] * (dp[4 * j] - d2.x),
                                                 sc[4 * j + 1] * (dp[4 * j + 1] - d2.y));
      dsp[(j / 2) * 4 + (j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2] * (dp[4 * j + 2] - d2.x),
                                                     sc[4 * j + 3] * (dp[4 * j + 3] - d2.y));
    }
    // (at hd 256 both warpgroups hold the same dS^T; the first stores it)
    if (!SPLIT || wg == 0) {
      const uint32_t sdsw = sds(i & 1) + kv_rows + ra * 128 + 4 * t;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        st_shared(sdsw + ((j ^ g) << 4), dsp[(j / 2) * 4 + (j % 2) * 2]);
        st_shared(sdsw + ((j ^ g) << 4) + 8 * 128, dsp[(j / 2) * 4 + (j % 2) * 2 + 1]);
      }
    }

    // dK += dS^T Q, Q MN-major as dO
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<NKV>(dk_acc, dsp[4 * kk], dsp[4 * kk + 1], dsp[4 * kk + 2], dsp[4 * kk + 3],
                    sw128_desc(sq(s) + (col0 / BOX) * BQ * 128 + kk * 2048, BQ * 128, 1024));
    wgmma_commit();
    if constexpr (SPLIT) {
      // Q and dO of the one stage are read: the producer may refill it
      // while dQ runs
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_u32(dsp);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    // dQ = dS K over all BKV keys, once every warpgroup's dS^T is in shared
    // memory: this warpgroup's NQ columns, dS^T and K both MN-major. The
    // barrier also tells the warpgroup that the last tile's reductions have
    // read its dQ buffer.
    fence_proxy_async();
    if (tid == 0) bulk_wait_read();
    named_bar(1, 128 * NWG);
    float dq[NQ / 2];
#pragma unroll
    for (int j = 0; j < NQ / 2; ++j) dq[j] = 0.f;
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_ss_tt<NQ>(dq, sw128_desc(sds(i & 1) + kk * 2048, DS_BYTES, 1024),
                      sw128_desc(sk + (wg * NQ / BOX) * BKV * 128 + kk * 2048, BKV * 128, 1024),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if constexpr (!SPLIT) {
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_u32(pp);
      fence_u32(dsp);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));   // Q and dO of this stage may be refilled
    }

    // dQ * hd^-0.5 into shared memory (32-column boxes of 128-byte rows,
    // the 16-byte chunk c of q row r at c ^ (r % 8)), then one bulk reduction
    // a box into dq_acc; rows past S and columns past hd are dropped
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      const uint32_t at = sdq + (j / 4) * BQ * 128 + ra * 128 +
                          (((2 * (j % 4) + t / 2) ^ g) << 4) + 8 * (t % 2);
      st_shared(at, dq[4 * j] * scale, dq[4 * j + 1] * scale);
      st_shared(at + 8 * 128, dq[4 * j + 2] * scale, dq[4 * j + 3] * scale);
    }
    fence_proxy_async();
    named_bar(2 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int bx = 0; bx < NQ / 32; ++bx)
        tma_reduce_add_4d(&tm_dq, sdq + bx * BQ * 128, wg * NQ + 32 * bx, h, q0, b);
      bulk_commit();
    }
    if (++qt == qt_begin + nqt) {
      qt = qt_begin;
      ++h;
    }
  }
  if (tid == 0) bulk_wait();

  const int64_t k_row = (int64_t)K * HD;
  __nv_bfloat16* dkb = dk + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  __nv_bfloat16* dvb = dv + (int64_t)b * T_len * k_row + (int64_t)kh * HD;
  const int ja = kw0 + ra, jb = ja + 8;
#pragma unroll
  for (int n = 0; n < NKV / 8; ++n) {
    const int col = col0 + 8 * n + 2 * t;
    if (col >= HD) continue;
    if (ja < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)ja * k_row + col) =
          __floats2bfloat162_rn(dk_acc[4 * n] * scale, dk_acc[4 * n + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)ja * k_row + col) =
          __floats2bfloat162_rn(dv_acc[4 * n], dv_acc[4 * n + 1]);
    }
    if (jb < T_len) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)jb * k_row + col) =
          __floats2bfloat162_rn(dk_acc[4 * n + 2] * scale, dk_acc[4 * n + 3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)jb * k_row + col) =
          __floats2bfloat162_rn(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* D, float* dq_acc, void* dk, void* dv, int B,
                   int S, int T_len, int H, int K, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int NWG = consumers(HD);
  constexpr int BKV = kv_tile(HD);
  constexpr int NB = (HD + BOX - 1) / BOX;
  constexpr int NQ = NB * BOX / NWG;
  constexpr size_t smem = 1024 + (size_t)NB * 128 * (2 * BKV + 2 * ring_stages(HD) * BQ) +
                          2 * (size_t)BKV * 128 + (size_t)NWG * (NQ / 32) * BQ * 128;
  static_assert(smem + sizeof(uint64_t) * (1 + 2 * ring_stages(HD)) +
                    8 * ring_stages(HD) * BQ <= 232448, "shared memory over 227 KB");
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq_acc) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!make_map(&tq, q, B, S, H, HD, BQ) || !make_map(&tk, k, B, T_len, K, HD, BKV) ||
      !make_map(&tv, v, B, T_len, K, HD, BKV) || !make_map(&tdo, dout, B, S, H, HD, BQ) ||
      !make_map(&tdq, dq_acc, B, S, H, HD, BQ, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 32))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_kernel_wgmma<HD, NWG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = ((T_len + BKV - 1) / BKV) * B * K;
  kern<<<grid, 128 * (NWG + 1), smem, stream>>>(
      tq, tk, tv, tdo, tdq, lse, D, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, S, T_len, H, K, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace hopper

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
  const int64_t rows = (int64_t)B * S * H;
  bwd_prep_kernel<T, HD><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), D, dq_acc, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float scale = (float)(1.0 / sqrt((double)HD));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    err = hopper::launch<HD>(q, k, v, dout, lse, D, dq_acc, dk, dv, B, S, T_len, H, K, causal,
                             window, scale, stream);
    if (err != cudaSuccess) return err;
  } else {
    constexpr int QB = f32_q_tile(HD);
    dim3 grid((T_len + BKV - 1) / BKV, B * K);
    const size_t smem = sizeof(float) * (size_t)(2 * BKV * (HD + 1) + 2 * QB * (HD + 1) +
                                                 2 * QB * LP + 2 * QB);
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
    case 256: return launch<T, 256>(q, k, v, o, dout, lse, D, dq_acc, dq, dk, dv, B, S, T_len,
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
