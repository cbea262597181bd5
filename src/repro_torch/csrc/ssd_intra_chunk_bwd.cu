// Mamba2 SSD intra-chunk block, backward, for Hopper.
//
// The gradient of csrc/ssd_intra_chunk.cu's forward, for training. The TPU
// kernel src/repro/kernels/ssd_scan.py:ssd_intra_chunk has no backward of its
// own (repro differentiates through it), so this kernel has no TPU
// counterpart; its plain version is
// kernels/ssd_scan.py:ssd_intra_chunk_bwd_plain, autograd through the
// forward's plain version.
//
// The forward, per (b, chunk) and head h, with L = cumsum(la) over the Q rows:
//   M[t,s] = exp(L_t - L_s) (C_t . B_s)   for s <= t, else 0
//   y      = M x                           (Q x P)
//   w_s    = exp(L_end - L_s),  state = (w x)^T B  (P x N),  tot = L_end
// Given dy, dstate and dtot:
//   dM[t,s] = dy_t . x_s                   (s <= t)
//   dx      = M^T dy + w (B dstate^T)
//   dCB     = sum_h exp(L_t - L_s) dM      (one matrix for all heads)
//   dC      = dCB B,   dB = dCB^T C + sum_h w (x dstate)
//   dL_t    = sum_s G[t,s] - sum_s G[s,t] - E_t, G = dM * M,
//             E_s = w_s B_s . (x dstate)_s, plus (sum_s E_s + dtot) at L_end
//   dla     = the reverse cumsum of dL over the chunk's rows.
//
// What bounds it on the H100. At zamba2-7b's training shape (B 4, S 2048:
// 16 chunks of Q 128, H 112, N = P = 64) the reads and writes (la, C, B, x,
// dy, dstate, dla, dC, dB, dx) are ~0.82 GB, ~0.25 ms at 3.35 TB/s; the
// products are ~4 Q^2 P + 4 Q P N flops a head, ~62 GFLOP in all as this
// kernel runs them (full Q x Q tiles, no triangle skipped), which on the
// FMA units (67 TFLOP/s) take ~0.9 ms. This first design is float32 FMA
// throughout and is bound by those operations; the tensor-core form (the
// forward's 3xTF32 mma.sync) is later work.
//
// Two kernels. ssd_bwd_heads: one block per (b * chunk, group of HG heads),
// 256 threads. C . B^T is built once a block into registers, each thread
// owning an 8 x 8 set of (t, s) entries (t = ty + 16 i, s = tx + 16 j; the 16
// threads of a row form a half-warp), and dCB is summed over the group's
// heads in registers on the same entries. Per head: L in float64 (warp 0) and
// then as float pairs, as in the forward, so that exp(L_t - L_s) keeps its
// digits where L reaches -100 over a chunk; dM over P in passes of 64
// columns of x and dy in shared memory; M written to shared memory for
// dx = M^T dy; the row and column sums of G by shuffles and per-warp partials
// (no atomics); x dstate formed per row and folded into dB's head term, which
// is summed in shared memory; dL and its reverse cumsum in float64 by warp 0.
// The block then writes its dCB and dB-term partials. ssd_bwd_cb: one block a
// (b * chunk) sums the groups' partials and forms dC and dB. Q <= 128 and
// N <= 64; any P (passes of 64 columns).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int QT = 128;           // rows (and columns) of the Q x Q tiles
constexpr int PC = 64;            // columns of x and dy a pass holds
constexpr int MAX_N = 64;
constexpr int LDP = PC + 1;       // padded row strides: no bank conflicts
constexpr int LDN = MAX_N + 1;
constexpr int LDQ = QT + 1;

// Shared memory of ssd_bwd_heads, in floats.
constexpr int OFF_B = 0;                          // B[s][n]        QT x LDN
constexpr int OFF_X = OFF_B + QT * LDN;           // x[s][p]        QT x LDP
constexpr int OFF_DY = OFF_X + QT * LDP;          // dy[t][p]       QT x LDP
constexpr int OFF_DST = OFF_DY + QT * LDP;        // dstate[p][n]   PC x LDN
constexpr int OFF_M = OFF_DST + PC * LDN;         // M[t][s]        QT x LDQ (C while CB is built)
constexpr int OFF_DBH = OFF_M + QT * LDQ;         // dB's head term QT x MAX_N
constexpr int OFF_L = OFF_DBH + QT * MAX_N;       // L as float pairs, QT float2
constexpr int OFF_W = OFF_L + 2 * QT;             // w_s
constexpr int OFF_ROW = OFF_W + QT;               // row sums of G
constexpr int OFF_COL = OFF_ROW + QT;             // per-warp column sums of G, 8 x QT
constexpr int OFF_E = OFF_COL + (NTHREADS / 32) * QT;
constexpr int HEADS_SMEM = (OFF_E + QT) * 4;      // 221,952 bytes

// Shared memory of ssd_bwd_cb, in floats.
constexpr int CB_SMEM = (QT * LDQ + 2 * QT * LDN) * 4;

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [0, QT) x cols [0, cols) of a row-major source with row stride
// src_ld into shared memory with stride ld, zero past `rows` and `cols`
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int64_t src_ld,
                                          int rows, int cols, int ncols_tile, int tid) {
  for (int i = tid; i < QT * ncols_tile; i += NTHREADS) {
    const int r = i / ncols_tile, c = i % ncols_tile;
    dst[r * ld + c] = (r < rows && c < cols) ? src[r * src_ld + c] : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
ssd_bwd_heads(const float* __restrict__ la, const float* __restrict__ C,
              const float* __restrict__ Bm, const float* __restrict__ x,
              const float* __restrict__ dy, const float* __restrict__ dst,
              const float* __restrict__ dtot, float* __restrict__ dla,
              float* __restrict__ dx, float* __restrict__ part_dcb,
              float* __restrict__ part_dbh, int Q, int H, int N, int P, int HG) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem + OFF_B;
  float* xs = smem + OFF_X;
  float* dys = smem + OFF_DY;
  float* dsts = smem + OFF_DST;
  float* Ms = smem + OFF_M;
  float* dBh = smem + OFF_DBH;
  float2* Lp = reinterpret_cast<float2*>(smem + OFF_L);
  float* ws = smem + OFF_W;
  float* rowG = smem + OFF_ROW;
  float* colG = smem + OFF_COL;
  float* Es = smem + OFF_E;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);
  const int64_t bc = blockIdx.x;
  const int ngrp = gridDim.y, grp = blockIdx.y;
  const int h0 = grp * HG, hg = min(HG, H - h0);
  const int64_t row_x = (int64_t)H * P;          // stride between rows of x and dy

  // B, and C in M's region, then CB = C . B^T on this thread's entries
  load_rows(Bs, LDN, Bm + bc * Q * N, N, Q, N, MAX_N, tid);
  load_rows(Ms, LDN, C + bc * Q * N, N, Q, N, MAX_N, tid);
  for (int i = tid; i < QT * MAX_N; i += NTHREADS) dBh[i] = 0.f;
  __syncthreads();
  float cb[8][8], dcb[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cb[i][j] = dcb[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[8], bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      cv[i] = Ms[(ty + 16 * i) * LDN + n];
      bv[i] = Bs[(tx + 16 * i) * LDN + n];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
  }

  const int npass = (P + PC - 1) / PC;
  for (int g = 0; g < hg; ++g) {
    const int h = h0 + g;
    const float* xh = x + bc * Q * row_x + (int64_t)h * P;
    const float* dyh = dy + bc * Q * row_x + (int64_t)h * P;
    const float* dsth = dst + (bc * H + h) * (int64_t)P * N;
    __syncthreads();   // the last head's readers of every shared tile are done

    // L = cumsum(la) in float64, 4 rows a lane; then float pairs and w
    if (warp == 0) {
      double r[4];
      double run = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        run += t < Q ? (double)la[(bc * Q + t) * H + h] : 0.0;
        r[k] = run;
      }
      double incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const double excl = incl - run;
      double own_end = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        r[k] += excl;
        if (4 * lane + k == Q - 1) own_end = r[k];
      }
      const double Lend = __shfl_sync(0xffffffffu, own_end, (Q - 1) >> 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        const float hi = (float)r[k];
        Lp[t] = make_float2(hi, (float)(r[k] - hi));
        ws[t] = t < Q ? (float)exp(Lend - r[k]) : 0.f;
      }
    }

    // dM = dy x^T over P, a pass of 64 columns at a time
    float dm[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dm[i][j] = 0.f;
    for (int ps = 0; ps < npass; ++ps) {
      const int p0 = ps * PC, pc = min(PC, P - p0);
      if (ps > 0) __syncthreads();
      load_rows(xs, LDP, xh + p0, row_x, Q, pc, PC, tid);
      load_rows(dys, LDP, dyh + p0, row_x, Q, pc, PC, tid);
      __syncthreads();
      for (int p = 0; p < pc; ++p) {
        float dv[8], xv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dv[i] = dys[(ty + 16 * i) * LDP + p];
          xv[i] = xs[(tx + 16 * i) * LDP + p];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dm[i][j] = fmaf(dv[i], xv[j], dm[i][j]);
      }
    }

    // M, dCB and G = dM * M on this thread's entries; M to shared memory,
    // the row sums of G by half-warp shuffles, its column sums per warp
    float colsum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) colsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      const float2 Lt = Lp[t];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = tx + 16 * j;
        const float2 Ls = Lp[s];
        // exp only where s <= t < Q: above the diagonal L_t - L_s > 0 may
        // overflow, and 0 * inf would be NaN
        const float e = (s <= t && t < Q) ? expf((Lt.x - Ls.x) + (Lt.y - Ls.y)) : 0.f;
        const float m = cb[i][j] * e;
        const float gg = dm[i][j] * m;
        dcb[i][j] = fmaf(dm[i][j], e, dcb[i][j]);
        Ms[t * LDQ + s] = m;
        rs += gg;
        colsum[j] += gg;
      }
      rs = half_warp_sum(rs);
      if (tx == 0) rowG[t] = rs;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float c = colsum[j] + __shfl_xor_sync(0xffffffffu, colsum[j], 16);
      if (lane < 16) colG[warp * QT + tx + 16 * j] = c;
    }

    // dx = w (B dstate^T) + M^T dy, and xd = x dstate, per pass of 64 columns
    float xd[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) xd[i][j] = 0.f;
    for (int ps = 0; ps < npass; ++ps) {
      const int p0 = ps * PC, pc = min(PC, P - p0);
      __syncthreads();   // M is written; the last pass's tiles are read
      if (npass > 1) {
        load_rows(xs, LDP, xh + p0, row_x, Q, pc, PC, tid);
        load_rows(dys, LDP, dyh + p0, row_x, Q, pc, PC, tid);
      }
      for (int i = tid; i < PC * MAX_N; i += NTHREADS) {
        const int p = i / MAX_N, n = i % MAX_N;
        dsts[p * LDN + n] = (p < pc && n < N) ? dsth[(int64_t)(p0 + p) * N + n] : 0.f;
      }
      __syncthreads();
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[8], dv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) bv[i] = Bs[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = dsts[(tx + 16 * j) * LDN + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float w = ws[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= w;
      }
      for (int t = 0; t < Q; ++t) {
        float mv[8], dv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) mv[i] = Ms[t * LDQ + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = dys[t * LDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], dv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 16 * i;
        if (s >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < pc) dx[(bc * Q + s) * row_x + (int64_t)h * P + p0 + p] = acc[i][j];
        }
      }
      for (int p = 0; p < pc; ++p) {
        float xv[8], dv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = xs[(ty + 16 * i) * LDP + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = dsts[p * LDN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) xd[i][j] = fmaf(xv[i], dv[j], xd[i][j]);
      }
    }

    // dB's head term w (x dstate) into shared memory; E_s = B_s . that
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = ty + 16 * i;
      const float w = ws[s];
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        const float v = w * xd[i][j];
        dBh[s * MAX_N + n] += v;
        e = fmaf(v, Bs[s * LDN + n], e);
      }
      e = half_warp_sum(e);
      if (tx == 0) Es[s] = e;
    }
    __syncthreads();

    // dL and dla = its reverse cumsum, in float64, 4 rows a lane
    if (warp == 0) {
      double d[4];
      double esum = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        double col = 0.0;
#pragma unroll
        for (int w8 = 0; w8 < NTHREADS / 32; ++w8) col += (double)colG[w8 * QT + t];
        d[k] = t < Q ? (double)rowG[t] - col - (double)Es[t] : 0.0;
        esum += t < Q ? (double)Es[t] : 0.0;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) esum += __shfl_xor_sync(0xffffffffu, esum, off);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k == Q - 1) d[k] += esum + (double)dtot[bc * H + h];
      double suf[4];
      double run = 0.0;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        run += d[k];
        suf[k] = run;
      }
      double incl = run;          // sum over this lane's rows and every later lane's
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      const double later = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * lane + k;
        if (t < Q) dla[(bc * Q + t) * H + h] = (float)(suf[k] + later);
      }
    }
  }

  // this block's partials of dCB (Q x Q) and of dB's head term (Q x N)
  float* pc_out = part_dcb + (bc * ngrp + grp) * (int64_t)Q * Q;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = ty + 16 * i;
    if (t >= Q) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int s = tx + 16 * j;
      if (s < Q) pc_out[t * Q + s] = dcb[i][j];
    }
  }
  __syncthreads();
  float* pb_out = part_dbh + (bc * ngrp + grp) * (int64_t)Q * N;
  for (int i = tid; i < Q * N; i += NTHREADS) pb_out[i] = dBh[(i / N) * MAX_N + i % N];
}

__global__ void __launch_bounds__(NTHREADS)
ssd_bwd_cb(const float* __restrict__ C, const float* __restrict__ Bm,
           const float* __restrict__ part_dcb, const float* __restrict__ part_dbh,
           float* __restrict__ dC, float* __restrict__ dB, int Q, int N, int ngrp) {
  extern __shared__ __align__(16) float smem[];
  float* dcb = smem;                    // QT x LDQ
  float* Cs = dcb + QT * LDQ;           // QT x LDN
  float* Bs = Cs + QT * LDN;            // QT x LDN
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);
  const int64_t bc = blockIdx.x;
  load_rows(Cs, LDN, C + bc * Q * N, N, Q, N, MAX_N, tid);
  load_rows(Bs, LDN, Bm + bc * Q * N, N, Q, N, MAX_N, tid);
  const float* pc_in = part_dcb + bc * ngrp * (int64_t)Q * Q;
  for (int i = tid; i < QT * QT; i += NTHREADS) {
    const int t = i / QT, s = i % QT;
    float v = 0.f;
    if (t < Q && s < Q)
      for (int g = 0; g < ngrp; ++g) v += pc_in[(int64_t)g * Q * Q + t * Q + s];
    dcb[t * LDQ + s] = v;
  }
  __syncthreads();
  float ac[8][4], ab[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ac[i][j] = ab[i][j] = 0.f;
  for (int k = 0; k < Q; ++k) {
    float r[8], c[8], bv[4], cv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      r[i] = dcb[(ty + 16 * i) * LDQ + k];     // dCB[t][k]
      c[i] = dcb[k * LDQ + ty + 16 * i];       // dCB[k][s]
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[j] = Bs[k * LDN + tx + 16 * j];
      cv[j] = Cs[k * LDN + tx + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ac[i][j] = fmaf(r[i], bv[j], ac[i][j]);
        ab[i][j] = fmaf(c[i], cv[j], ab[i][j]);
      }
  }
  const float* pb_in = part_dbh + bc * ngrp * (int64_t)Q * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n >= N) continue;
      float hb = 0.f;
      for (int g = 0; g < ngrp; ++g) hb += pb_in[(int64_t)g * Q * N + r * N + n];
      dC[(bc * Q + r) * N + n] = ac[i][j];
      dB[(bc * Q + r) * N + n] = ab[i][j] + hb;
    }
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All float32 and contiguous: la (BC,Q,H), C/B (BC,Q,N), x/dy (BC,Q,H,P),
// dst (BC,H,P,N), dtot (BC,H) -> dla (BC,Q,H), dx (BC,Q,H,P), dC/dB (BC,Q,N);
// part_dcb (BC,G,Q,Q) and part_dbh (BC,G,Q,N) scratch, G = ceil(H / HG).
// 0 < Q <= 128, 0 < N <= 64, P > 0, HG >= 1.
extern "C" int ssd_intra_chunk_bwd(const void* la, const void* C, const void* B, const void* x,
                                   const void* dy, const void* dst, const void* dtot, void* dla,
                                   void* dx, void* dC, void* dB, void* part_dcb, void* part_dbh,
                                   int BC, int Q, int H, int N, int P, int HG, void* stream) {
  if (BC <= 0 || H <= 0 || Q <= 0 || Q > QT || N <= 0 || N > MAX_N || P <= 0 || HG <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_heads,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, HEADS_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize, CB_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ngrp = (H + HG - 1) / HG;
  ssd_bwd_heads<<<dim3(BC, ngrp), NTHREADS, HEADS_SMEM, st>>>(
      static_cast<const float*>(la), static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(dst),
      static_cast<const float*>(dtot), static_cast<float*>(dla), static_cast<float*>(dx),
      static_cast<float*>(part_dcb), static_cast<float*>(part_dbh), Q, H, N, P, HG);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_cb<<<BC, NTHREADS, CB_SMEM, st>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(part_dcb), static_cast<const float*>(part_dbh),
      static_cast<float*>(dC), static_cast<float*>(dB), Q, N, ngrp);
  return (int)cudaGetLastError();
}
