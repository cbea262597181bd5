// Mamba2 SSD intra-chunk block for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:ssd_intra_chunk
// (Pallas; grid (B*nc, H), one (chunk, head) a grid step with the chunk's
// C/B, x and log-decay tiles in VMEM; its wrapper transposes la and x to put
// the head ahead of the chunk's rows).
//
// Computes, for each (b, chunk, head), in float32 (L in float64):
//   L_t   = la_0 + ... + la_t                        (cumulative log decay)
//   y_t   = sum_{s<=t} exp(L_t - L_s) (C_t . B_s) x_s          (Q x P)
//   state = sum_s exp(L_{Q-1} - L_s) x_s (outer) B_s            (P x N)
//   tot   = L_{Q-1}
//
// What bounds it on the H100: operations. Per (chunk, head) it does about
// Q^2 P + 2 Q P N flops on Q P + Q floats in and Q P + P N + 1 out; at the
// zamba2-7b prefill shape (Q 128, N = P = 64) that is ~26 flop/byte against
// the ~20 flop/byte ridge of non-tensor float32 (67 TFLOP/s, 3.35 TB/s).
//
// Design: one block of 512 threads per (b*chunk, group of up to 16 heads;
// the wrapper picks the group size that fills the SMs in the fewest waves).
// C . B^T is the same for every head (one B/C group), so the block builds it
// once in shared memory (transposed, CBt[s][t]) and serves its heads from
// it. la and x are read in their natural (B, nc, Q, H[, P]) layouts, with no
// transposes. Per head: L by one warp's scan in float64, so that L_t - L_s
// keeps its digits when L reaches ~-100 over a chunk (a float32 cumsum
// loses ~4e-5 there, and exp turns that into relative error); then
// Mt[s][t] = exp(L_t - L_s) * CBt[s][t] for s <= t only (exp never sees a
// masked exponent, which is positive and can overflow), zero above the
// diagonal. Threads 0-255 compute y = M . x in 4 x 4 register tiles, each
// thread a pair of row tiles mirrored about the middle so that every thread
// runs Q + 4 steps and the upper triangle is skipped; threads 256-511
// compute the state in 4 x 4 tiles at the same time. Every step of both
// loads two float4s from shared memory for 16 FMAs. Shared memory (~210 KB
// at the main shape) holds B, CBt, Mt, x and L: one block per SM. Plain
// float32 FMAs, so TF32 never enters; mma/wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 512;
constexpr int HALF = NTHREADS / 2;
constexpr int MAX_Q = 128;
constexpr int MAX_HG = NTHREADS / 32;      // one warp scans one head's L
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout in floats; every region starts on a 16-byte boundary.
struct Layout {
  int ldm;       // row stride of CBt and Mt: Q + 4 (float4 rows)
  int ldt;       // row stride of the transposed C tile: Q + 1
  int off_cb, off_m, off_x, off_l, off_w, total;
};

__host__ __device__ inline Layout layout(int Q, int N, int P, int HG) {
  Layout s;
  s.ldm = Q + 4;
  s.ldt = Q + 1;
  const int m_words = Q * s.ldm;
  const int ct_words = N * s.ldt;                 // C^T while CBt is built
  s.off_cb = round4(Q * N);                       // B, row-major, first
  s.off_m = s.off_cb + m_words;
  s.off_x = s.off_m + round4(m_words > ct_words ? m_words : ct_words);
  s.off_l = s.off_x + round4(Q * P);
  s.off_w = s.off_l + round4(2 * HG * Q);         // L in float64
  s.total = s.off_w + round4(Q);
  return s;
}

__global__ void __launch_bounds__(NTHREADS, 1)
ssd_intra_chunk_kernel(const float* __restrict__ la, const float* __restrict__ C,
                       const float* __restrict__ Bm, const float* __restrict__ x,
                       float* __restrict__ y, float* __restrict__ st,
                       float* __restrict__ tot, int Q, int H, int N, int P, int HG) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(Q, N, P, HG);
  const int ldm = lay.ldm, ldt = lay.ldt;
  float* Bs = smem;                                   // Q x N
  float* CBt = smem + lay.off_cb;                     // Q x ldm, [s][t] = B_s . C_t
  float* Mt = smem + lay.off_m;                       // Q x ldm, [s][t]
  float* Ct = Mt;                                     // N x ldt, only while CBt is built
  float* xs = smem + lay.off_x;                       // Q x P
  double* Ls = reinterpret_cast<double*>(smem + lay.off_l);   // HG x Q
  float* ws = smem + lay.off_w;                       // Q

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t bc = blockIdx.x;       // b * nc + chunk
  const int h0 = blockIdx.y * HG;
  const int hg = min(HG, H - h0);

  // 1. this group's la columns, the chunk's B and C (C transposed).
  for (int i = tid; i < Q * hg; i += NTHREADS) {
    const int t = i / hg, g = i % hg;
    Ls[g * Q + t] = (double)la[(bc * Q + t) * H + h0 + g];
  }
  const float4* C4 = reinterpret_cast<const float4*>(C + bc * Q * N);
  const float4* B4 = reinterpret_cast<const float4*>(Bm + bc * Q * N);
  for (int i = tid; i < Q * N / 4; i += NTHREADS) {
    reinterpret_cast<float4*>(Bs)[i] = B4[i];
    const float4 c = C4[i];
    const int t = (4 * i) / N, n = (4 * i) % N;
    Ct[(n + 0) * ldt + t] = c.x;
    Ct[(n + 1) * ldt + t] = c.y;
    Ct[(n + 2) * ldt + t] = c.z;
    Ct[(n + 3) * ldt + t] = c.w;
  }
  __syncthreads();

  // 2. L = cumsum(la) in float64, one warp a head: each lane sums a run of
  // rows in order, then the lanes' totals are scanned with shuffles.
  if (warp < hg) {
    double* Lh = Ls + warp * Q;
    const int per = (Q + 31) / 32;
    const int lo = lane * per;
    double run = 0.0;
    for (int k = 0; k < per; ++k)
      if (lo + k < Q) {
        run += Lh[lo + k];
        Lh[lo + k] = run;
      }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    for (int k = 0; k < per; ++k)
      if (lo + k < Q) Lh[lo + k] += excl;
    __syncwarp();
    if (lane == 0) tot[bc * H + h0 + warp] = (float)Lh[Q - 1];
  }

  // 3. CBt = B . C^T once for the group: rows (s) ty + 16 i, columns (t)
  // tx + 32 j.
  {
    const int ty = warp, tx = lane;
    float acc[MAX_Q / 16][MAX_Q / 32];
#pragma unroll
    for (int i = 0; i < MAX_Q / 16; ++i)
#pragma unroll
      for (int j = 0; j < MAX_Q / 32; ++j) acc[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float bv[MAX_Q / 16], cv[MAX_Q / 32];
#pragma unroll
      for (int i = 0; i < MAX_Q / 16; ++i)
        bv[i] = ty + 16 * i < Q ? Bs[(ty + 16 * i) * N + n] : 0.f;
#pragma unroll
      for (int j = 0; j < MAX_Q / 32; ++j)
        cv[j] = tx + 32 * j < Q ? Ct[n * ldt + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < MAX_Q / 16; ++i)
#pragma unroll
        for (int j = 0; j < MAX_Q / 32; ++j) acc[i][j] = fmaf(bv[i], cv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < MAX_Q / 16; ++i)
#pragma unroll
      for (int j = 0; j < MAX_Q / 32; ++j) {
        const int s = ty + 16 * i, t = tx + 32 * j;
        if (s < Q && t < Q) CBt[s * ldm + t] = acc[i][j];
      }
  }
  __syncthreads();   // CBt done; the Mt region (C^T) may be overwritten

  // 4. each head of the group.
  const int PT = P / 4, NT4 = N / 4, QT = Q / 4;
  const float4* xs4 = reinterpret_cast<const float4*>(xs);
  for (int g = 0; g < hg; ++g) {
    const int h = h0 + g;
    const double* Lh = Ls + g * Q;
    for (int i = tid; i < Q * PT; i += NTHREADS) {
      const int t = i / PT, c = i % PT;
      reinterpret_cast<float4*>(xs)[i] =
          reinterpret_cast<const float4*>(x + ((bc * Q + t) * H + h) * P)[c];
    }
    for (int i = tid; i < Q * Q; i += NTHREADS) {
      const int s = i / Q, t = i % Q;
      Mt[s * ldm + t] = s <= t ? expf((float)(Lh[t] - Lh[s])) * CBt[s * ldm + t] : 0.f;
    }
    for (int s = tid; s < Q; s += NTHREADS) ws[s] = expf((float)(Lh[Q - 1] - Lh[s]));
    __syncthreads();

    if (tid < HALF) {
      // y = M . x: row tiles tp and QT-1-tp, column tile tc.
      for (int j = tid; j < (QT / 2) * PT; j += HALF) {
        const int tc = j % PT, tp = j / PT;
        for (int half = 0; half < 2; ++half) {
          const int r0 = 4 * (half ? QT - 1 - tp : tp);
          float acc[4][4];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
          for (int s = 0; s < r0 + 4; ++s) {
            const float4 xv = xs4[s * PT + tc];
            const float4 mv = *reinterpret_cast<const float4*>(Mt + s * ldm + r0);
            const float m[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              acc[a][0] = fmaf(m[a], xv.x, acc[a][0]);
              acc[a][1] = fmaf(m[a], xv.y, acc[a][1]);
              acc[a][2] = fmaf(m[a], xv.z, acc[a][2]);
              acc[a][3] = fmaf(m[a], xv.w, acc[a][3]);
            }
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
            *reinterpret_cast<float4*>(y + ((bc * Q + r0 + a) * H + h) * P + 4 * tc) =
                make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        }
      }
    } else {
      // state = sum_s w_s x_s (outer) B_s: rows (p) 4 tp.., columns (n) 4 tn..
      const float4* Bs4 = reinterpret_cast<const float4*>(Bs);
      for (int k = tid - HALF; k < PT * NT4; k += HALF) {
        const int tn = k % NT4, tp = k / NT4;
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
        for (int s = 0; s < Q; ++s) {
          const float4 xv = xs4[s * PT + tp];
          const float4 bv = Bs4[s * NT4 + tn];
          const float w = ws[s];
          const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][0] = fmaf(xw[a], bv.x, acc[a][0]);
            acc[a][1] = fmaf(xw[a], bv.y, acc[a][1]);
            acc[a][2] = fmaf(xw[a], bv.z, acc[a][2]);
            acc[a][3] = fmaf(xw[a], bv.w, acc[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(st + ((bc * H + h) * P + 4 * tp + a) * N + 4 * tn) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    __syncthreads();   // xs, Mt and ws are rewritten for the next head
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All float32 and contiguous, 16-byte aligned: la (BC,Q,H), C/B (BC,Q,N),
// x (BC,Q,H,P) -> y (BC,Q,H,P), st (BC,H,P,N), tot (BC,H), BC = B * nc.
// Q % 8 == 0 and Q <= 128, N % 4 == 0, P % 4 == 0, 1 <= HG <= 16, and the
// shared memory of the layout within a block's 227 KB.
extern "C" int ssd_intra_chunk_fwd(const void* la, const void* C, const void* B,
                                   const void* x, void* y, void* st, void* tot, int BC,
                                   int Q, int H, int N, int P, int HG, void* stream) {
  if (BC <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q || Q % 8 || N <= 0 || N % 4 || P <= 0 ||
      P % 4 || HG <= 0 || HG > MAX_HG)
    return (int)cudaErrorInvalidValue;
  const int smem = layout(Q, N, P, HG).total * (int)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BC, (H + HG - 1) / HG);
  ssd_intra_chunk_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(C),
      static_cast<const float*>(B), static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(tot), Q, H, N, P, HG);
  return (int)cudaGetLastError();
}
