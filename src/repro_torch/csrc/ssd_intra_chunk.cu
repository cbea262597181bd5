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
// What bounds it on the H100. Per (chunk, head) it does about Q^2 P + 2 Q P N
// flops on Q P + Q floats in and Q P + P N + 1 out; at the zamba2-7b prefill
// shape (Q 128, N = P = 64) that is ~26 flop/byte, above the ~20 flop/byte
// ridge of float32 outside the tensor cores (67 TFLOP/s, 3.35 TB/s). So the
// three products (C . B^T, M . x and (w * x)^T . B) run on the tensor cores,
// mma.sync m16n8k8 with TF32 operands, where even at three TF32 products for
// each float32 one (495 / 3 TFLOP/s) the floor is the bytes. TF32 keeps 10
// mantissa bits, too few for the 2e-4 the kernel is held to, so every
// operand is split in registers into hi = tf32(a) and lo = a - hi and each
// tile takes lo.hi + hi.lo + hi.hi (3xTF32): the dropped lo.lo term and the
// TF32 part taken of lo leave ~1e-6 relative. The core rounds each mma's
// float32 sum toward zero, a bias that adds up over the 48 mma of a
// 128-deep product; so each k-block's three products are summed on the core
// from zero and added to the accumulator in registers, rounded to nearest.
// That keeps float32's accuracy where a y entry is a small difference of
// large terms. What bounds the kernel in practice is the rate at which each
// SM sub-partition issues those products and the splits, adds and loads
// that feed them.
//
// One block per (b*chunk, group of up to 16 heads; the wrapper picks the
// group size that fills the SMs in the fewest waves). C . B^T is the same
// for every head, so the block builds it once (the 16 x 8 tiles on or below
// the diagonal) into a shared tile CB[t][s] whose row stride (Q + 4) keeps
// fragment loads free of bank conflicts. L is scanned in float64, one warp a
// head, so that L_t - L_s keeps its digits when L reaches ~-100 over a
// chunk; tot and the end weights w_s = exp(L_{Q-1} - L_s) are taken from it,
// and it is then kept as float pairs (hi + lo), whose differences carry the
// same digits without float64 math. The block's 16 warps form two slots of
// 8 that take the group's heads in turns and synchronise only among
// themselves (named barriers), so one slot's x load overlaps the other's
// products. In a slot, four warps own the 16-row strips of y, strip r paired
// with strip Q/16-1-r so that each does the same work, over all P columns.
// M is never stored: a warp builds its A fragment from CB and L,
// CB[t][s] * exp(L_t - L_s), with the exponent -inf above the diagonal, so
// exp never sees a masked, positive exponent and the four exps of a
// fragment need no branch. Each M entry is exponentiated once a head, and
// k-blocks above the diagonal are skipped. The other four warps own 16-row
// strips of the state and apply w_s while they form the A fragment from x.
// Each A fragment serves NT = 8 n-tiles, independent chains of products
// that keep the tensor core busy. Q is padded to 16 and N and P to 8 with
// zeros in shared memory. Shared memory (~200 KB at the main shape: CB, B,
// two x tiles, L and w) allows one block per SM; where the two x tiles do
// not fit, one slot of 8 warps runs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SLOT_THREADS = 256;          // 8 warps: 4 for y, 4 for the state
constexpr int MAX_SLOTS = 2;
constexpr int MAX_Q = 128;
constexpr int MAX_HG = 16;
constexpr int MAX_SMEM = 232448;
constexpr int NT = 8;                      // n-tiles of 8 a warp accumulates at once
constexpr int LOAD_DEPTH = 8;              // float4 loads a thread keeps in flight

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// x and B are read as mma operands along their rows (k = s, column = g),
// which is free of bank conflicts when the row stride is 8 or 24 mod 32.
__host__ __device__ inline int stride_k_major(int n) {
  const int r = round_up(n, 8);
  return r % 16 ? r : r + 8;
}

// Shared-memory layout in floats; every region starts on a 16-byte boundary.
struct Layout {
  int Qp, Np, Pp;   // Q padded to 16; N and P to 8
  int ldc;          // CB[t][s]: Qp + 4
  int ldb, ldx;     // B[s][n], x[s][p]: 8 or 24 mod 32
  int ldcc;         // C[t][n] while CB is built: 4 mod 8
  int off_b, off_x, off_l, off_w, total;
};

__host__ __device__ inline Layout layout(int Q, int N, int P, int HG, int slots) {
  Layout s;
  s.Qp = round_up(Q, 16);
  s.Np = round_up(N, 8);
  s.Pp = round_up(P, 8);
  s.ldc = s.Qp + 4;
  s.ldb = stride_k_major(N);
  s.ldx = stride_k_major(P);
  s.ldcc = s.Np + 4;
  const int x_words = slots * s.Qp * s.ldx;
  const int c_words = s.Qp * s.ldcc;              // C, only while CB is built
  s.off_b = round_up(s.Qp * s.ldc, 4);
  s.off_x = s.off_b + round_up(s.Qp * s.ldb, 4);
  s.off_l = s.off_x + round_up(x_words > c_words ? x_words : c_words, 4);
  s.off_w = s.off_l + 2 * HG * s.Qp;              // L in float64
  s.total = s.off_w + HG * s.Qp;
  return s;
}

// hi = a rounded to TF32, to nearest with ties away from zero: for finite a
// the value cvt.rna.tf32.f32 gives, by an integer add and mask (2
// instructions where cvt.rna takes 4 on sm_90a, with its checks for inf and
// NaN, which these inputs never hold). lo = a - hi, exact in float32, goes
// to the tensor core as it is: the core uses only its top 19 bits (sign,
// exponent, 10 mantissa bits), an error below 2^-10 |lo| <= 2^-21 |a|.
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// d = A . B on the tensor core, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_from0(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// acc[j] += A . B_j in 3xTF32 for the n-tiles j < nt (all NT when FULL):
// a is the float32 A fragment (16 x 8, m16n8k8's row-major A layout); this
// lane's two B elements of n-tile j are b[j * jstride] and b[j * jstride + k4]
// (rows k = tq and tq + 4 of the 8 x 8 tile, column gq). Each tile's three
// products, small terms first, are summed on the core from zero and added
// to acc[j] in registers (see the header); the NT tiles are independent
// chains, which the compiler interleaves. FULL drops the j < nt guards: the
// guarded copy alone took 21% longer at the main shape on an H100
// (tools/time_ssd_sources.py).
template <bool FULL>
__device__ __forceinline__ void mma_tiles(float (&acc)[NT][4], const float (&a)[4],
                                          const float* b, int jstride, int k4, int nt) {
  uint32_t ah[4], al[4];
  split4(a, ah, al);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (FULL || j < nt) {
      uint32_t bh[2], bl[2];
      split(b[j * jstride], bh[0], bl[0]);
      split(b[j * jstride + k4], bh[1], bl[1]);
      float p[4];
      mma_tf32_from0(p, al, bh);
      mma_tf32(p, ah, bl);
      mma_tf32(p, ah, bh);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += p[i];
    }
}

__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const float (&a)[4],
                                        const float* b, int jstride, int k4, int nt) {
  if (nt >= NT)
    mma_tiles<true>(acc, a, b, jstride, k4, NT);
  else
    mma_tiles<false>(acc, a, b, jstride, k4, nt);
}

// The exponent of M's decay, L_t - L_s from L as float pairs, or -inf where
// s > t.
__device__ __forceinline__ float decay_exponent(float2 Lt, float2 Ls, bool keep) {
  return keep ? (Lt.x - Ls.x) + (Lt.y - Ls.y) : -INFINITY;
}

__device__ __forceinline__ void slot_barrier(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(slot + 1), "r"(SLOT_THREADS) : "memory");
}

// Copy a Q x n float row-major tile (n % 4 == 0) into shared memory with row
// stride ld, zero-filling rows [Q, Qp) and columns [n, round_up(n, 8)).
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int64_t src_ld,
                                          int Q, int Qp, int n, int tid, int nthreads) {
  const int c4 = round_up(n, 8) / 4, total = Qp * c4;
  for (int i0 = tid; i0 < total; i0 += LOAD_DEPTH * nthreads) {
    float4 v[LOAD_DEPTH];                 // all of a thread's loads in flight at once
#pragma unroll
    for (int u = 0; u < LOAD_DEPTH; ++u) {
      const int i = i0 + u * nthreads, t = i / c4, c = i % c4;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < total && t < Q && 4 * c < n)
        v[u] = reinterpret_cast<const float4*>(src + t * src_ld)[c];
    }
#pragma unroll
    for (int u = 0; u < LOAD_DEPTH; ++u) {
      const int i = i0 + u * nthreads, t = i / c4, c = i % c4;
      if (i < total) *reinterpret_cast<float4*>(dst + t * ld + 4 * c) = v[u];
    }
  }
}

__global__ void __launch_bounds__(SLOT_THREADS * MAX_SLOTS, 1)
ssd_intra_chunk_kernel(const float* __restrict__ la, const float* __restrict__ C,
                       const float* __restrict__ Bm, const float* __restrict__ x,
                       float* __restrict__ y, float* __restrict__ st,
                       float* __restrict__ tot, int Q, int H, int N, int P, int HG) {
  extern __shared__ __align__(16) float smem[];
  const int slots = blockDim.x / SLOT_THREADS;
  const Layout lay = layout(Q, N, P, HG, slots);
  const int Qp = lay.Qp, ldc = lay.ldc, ldb = lay.ldb, ldx = lay.ldx;
  float* CB = smem;                                   // Qp x ldc, [t][s] = C_t . B_s
  float* Bs = smem + lay.off_b;                       // Qp x ldb
  float* Cs = smem + lay.off_x;                       // Qp x ldcc, only while CB is built
  double* Ls = reinterpret_cast<double*>(smem + lay.off_l);   // HG x Qp
  float* Ws = smem + lay.off_w;                       // HG x Qp

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int gq = lane >> 2, tq = lane & 3;            // mma fragment row / column
  const int64_t bc = blockIdx.x;                      // b * nc + chunk
  const int h0 = blockIdx.y * HG;
  const int hg = min(HG, H - h0);

  // 1. this group's la columns (zero past Q), the chunk's B and C.
  for (int i = tid; i < Qp * hg; i += nthreads) {
    const int t = i / hg, g = i % hg;
    Ls[g * Qp + t] = t < Q ? (double)la[(bc * Q + t) * H + h0 + g] : 0.0;
  }
  load_tile(Bs, ldb, Bm + bc * Q * N, N, Q, Qp, N, tid, nthreads);
  load_tile(Cs, lay.ldcc, C + bc * Q * N, N, Q, Qp, N, tid, nthreads);
  __syncthreads();

  // 2. L = cumsum(la) in float64, one warp a head: each lane sums a run of
  // rows in order, then the lanes' totals are scanned with shuffles. Then
  // tot and the end weights w_s = exp(L_{Q-1} - L_s).
  for (int g = warp; g < hg; g += nwarps) {
    double* Lh = Ls + g * Qp;
    const int per = (Qp + 31) / 32;
    const int lo = lane * per;
    double run = 0.0;
    for (int k = 0; k < per; ++k)
      if (lo + k < Qp) {
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
      if (lo + k < Qp) Lh[lo + k] += excl;
    __syncwarp();
    const double Lend = Lh[Q - 1];
    if (lane == 0) tot[bc * H + h0 + g] = (float)Lend;
    for (int k = 0; k < per; ++k)
      if (lo + k < Qp) Ws[g * Qp + lo + k] = expf((float)(Lend - Lh[lo + k]));
    // Then each L_t in place as a float pair hi + lo (8 bytes, as the
    // double), so that the y warps take L_t - L_s without float64 math:
    // (hi_t - hi_s) + (lo_t - lo_s) is within ~1 ulp of the float nearest
    // the difference.
    __syncwarp();
    for (int k = 0; k < per; ++k)
      if (lo + k < Qp) {
        const double v = Lh[lo + k];
        const float vh = (float)v;
        reinterpret_cast<float2*>(Lh)[lo + k] = make_float2(vh, (float)(v - vh));
      }
  }

  // 3. CB = C . B^T once for the group, on mma: row strip i (16 rows) takes
  // the 16 x 8 tiles j <= 2 i + 1 (on or below the diagonal), NT at a time,
  // one (strip, chunk) a warp.
  {
    const int ns = Qp / 16, nkb = lay.Np / 8;
    for (int i = 0, q = 0; i < ns; ++i)
      for (int j0 = 0; j0 < 2 * i + 2; j0 += NT, ++q) {
        if (q % nwarps != warp) continue;
        const int nt = min(NT, 2 * i + 2 - j0);
        const float* c0 = Cs + (16 * i + gq) * lay.ldcc + tq;
        float acc[NT][4] = {};
        for (int kb = 0; kb < nkb; ++kb) {
          const float a[4] = {c0[8 * kb], c0[8 * lay.ldcc + 8 * kb], c0[8 * kb + 4],
                              c0[8 * lay.ldcc + 8 * kb + 4]};
          mma_row(acc, a, Bs + (8 * j0 + gq) * ldb + 8 * kb + tq, 8 * ldb, 4, nt);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt) {
            float* out = CB + (16 * i + gq) * ldc + 8 * (j0 + j) + 2 * tq;
            *reinterpret_cast<float2*>(out) = make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(out + 8 * ldc) = make_float2(acc[j][2], acc[j][3]);
          }
      }
  }
  __syncthreads();   // CB, L and w are done; the C region becomes the x tiles

  // 4. each slot takes heads slot, slot + slots, ... of the group.
  const int slot = tid / SLOT_THREADS, stid = tid % SLOT_THREADS;
  const int sw = warp % (SLOT_THREADS / 32);          // warp in the slot: 0-3 y, 4-7 state
  float* xs = smem + lay.off_x + slot * Qp * ldx;     // Qp x ldx
  const int ns = Qp / 16;
  for (int g = slot; g < hg; g += slots) {
    const int h = h0 + g;
    load_tile(xs, ldx, x + (bc * Q * H + h) * P, (int64_t)H * P, Q, Qp, P, stid,
              SLOT_THREADS);
    slot_barrier(slot);

    if (sw < 4) {
      // y = M . x: strips pi and ns-1-pi, 16 rows each, over all P columns.
      const float2* Lh = reinterpret_cast<const float2*>(Ls + g * Qp);
      for (int pi = sw; pi < (ns + 1) / 2; pi += 4) {
        for (int half = 0; half < 2; ++half) {
          const int r = half ? ns - 1 - pi : pi;
          if (half && r == pi) break;
          const int t0 = 16 * r + gq, t1 = t0 + 8;
          const float2 L0 = Lh[t0], L1 = Lh[t1];
          const float* cb0 = CB + t0 * ldc + tq;
          for (int n0 = 0; n0 < lay.Pp / 8; n0 += NT) {
            const int nt = min(NT, lay.Pp / 8 - n0);
            float acc[NT][4] = {};
            for (int kb = 0; kb < 2 * r + 2; ++kb) {
              const int s0 = 8 * kb + tq, s1 = s0 + 4;
              const float2 Ls0 = Lh[s0], Ls1 = Lh[s1];
              const float* cb = cb0 + 8 * kb;
              // M = CB * exp(L_t - L_s) for s <= t; a masked entry (s > t)
              // takes the exponent -inf, so exp gives 0 and never sees the
              // masked L_t - L_s (positive where la < 0), and no branch
              // keeps the four exps apart. __expf (ex2.approx of x log2 e)
              // is within ~6e-6 relative for |x| up to 100.
              const float m[4] = {cb[0] * __expf(decay_exponent(L0, Ls0, s0 <= t0)),
                                  cb[8 * ldc] * __expf(decay_exponent(L1, Ls0, s0 <= t1)),
                                  cb[4] * __expf(decay_exponent(L0, Ls1, s1 <= t0)),
                                  cb[8 * ldc + 4] * __expf(decay_exponent(L1, Ls1, s1 <= t1))};
              mma_row(acc, m, xs + s0 * ldx + 8 * n0 + gq, 8, 4 * ldx, nt);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int p = 8 * (n0 + j) + 2 * tq;
              if (j >= nt || p >= P) continue;
              if (t0 < Q)
                *reinterpret_cast<float2*>(y + ((bc * Q + t0) * H + h) * P + p) =
                    make_float2(acc[j][0], acc[j][1]);
              if (t1 < Q)
                *reinterpret_cast<float2*>(y + ((bc * Q + t1) * H + h) * P + p) =
                    make_float2(acc[j][2], acc[j][3]);
            }
          }
        }
      }
    } else {
      // state = (w * x)^T . B: rows (p) 16 mt .., columns (n) all of N.
      const float* wh = Ws + g * Qp;
      for (int mt = sw - 4; 16 * mt < P; mt += 4) {
        const int p0 = 16 * mt + gq, p1 = p0 + 8;
        for (int n0 = 0; n0 < lay.Np / 8; n0 += NT) {
          const int nt = min(NT, lay.Np / 8 - n0);
          float acc[NT][4] = {};
          for (int kb = 0; kb < Qp / 8; ++kb) {
            const int s0 = 8 * kb + tq, s1 = s0 + 4;
            const float w0 = wh[s0], w1 = wh[s1];
            const float* x0 = xs + s0 * ldx;
            const float* x1 = xs + s1 * ldx;
            const float a[4] = {p0 < P ? w0 * x0[p0] : 0.f, p1 < P ? w0 * x0[p1] : 0.f,
                                p0 < P ? w1 * x1[p0] : 0.f, p1 < P ? w1 * x1[p1] : 0.f};
            mma_row(acc, a, Bs + s0 * ldb + 8 * n0 + gq, 8, 4 * ldb, nt);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int n = 8 * (n0 + j) + 2 * tq;
            if (j >= nt || n >= N) continue;
            if (p0 < P)
              *reinterpret_cast<float2*>(st + ((bc * H + h) * P + p0) * N + n) =
                  make_float2(acc[j][0], acc[j][1]);
            if (p1 < P)
              *reinterpret_cast<float2*>(st + ((bc * H + h) * P + p1) * N + n) =
                  make_float2(acc[j][2], acc[j][3]);
          }
        }
      }
    }
    slot_barrier(slot);   // xs is rewritten for the slot's next head
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All float32 and contiguous, 16-byte aligned: la (BC,Q,H), C/B (BC,Q,N),
// x (BC,Q,H,P) -> y (BC,Q,H,P), st (BC,H,P,N), tot (BC,H), BC = B * nc.
// Q % 8 == 0 and Q <= 128, N % 4 == 0, P % 4 == 0, 1 <= HG <= 16, and the
// shared memory of the one-slot layout within a block's 227 KB.
extern "C" int ssd_intra_chunk_fwd(const void* la, const void* C, const void* B,
                                   const void* x, void* y, void* st, void* tot, int BC,
                                   int Q, int H, int N, int P, int HG, void* stream) {
  if (BC <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q || Q % 8 || N <= 0 || N % 4 || P <= 0 ||
      P % 4 || HG <= 0 || HG > MAX_HG)
    return (int)cudaErrorInvalidValue;
  int slots = MAX_SLOTS;
  while (slots > 1 && layout(Q, N, P, HG, slots).total * (int)sizeof(float) > MAX_SMEM)
    --slots;
  const int smem = layout(Q, N, P, HG, slots).total * (int)sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_intra_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BC, (H + HG - 1) / HG);
  ssd_intra_chunk_kernel<<<grid, slots * SLOT_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(C),
      static_cast<const float*>(B), static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<float*>(st), static_cast<float*>(tot), Q, H, N, P, HG);
  return (int)cudaGetLastError();
}
