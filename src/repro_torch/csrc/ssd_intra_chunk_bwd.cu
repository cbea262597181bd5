// Mamba2 SSD intra-chunk block, backward, for Hopper.
//
// The gradient of csrc/ssd_intra_chunk.cu's forward, for training. The TPU
// kernel src/repro/kernels/ssd_scan.py:ssd_intra_chunk has no backward of its
// own (repro differentiates through it), so this kernel has no TPU
// counterpart; its plain version is
// kernels/ssd_scan.py:ssd_intra_chunk_bwd_plain, autograd through the
// forward's plain version.
//
// The forward, per (b, chunk) and head h, with L = cumsum(la) over the Q rows
// and C, B those of the head's group (G groups of H/G heads, Mamba2's
// n_groups; head h reads group h / (H/G)):
//   M[t,s] = exp(L_t - L_s) (C_t . B_s)   for s <= t, else 0
//   y      = M x                           (Q x P)
//   w_s    = exp(L_end - L_s),  state = (w x)^T B  (P x N),  tot = L_end
// Given dy, dstate and dtot:
//   dM[t,s] = dy_t . x_s                   (s <= t)
//   dx      = M^T dy + w (B dstate^T)
//   dCB     = sum_h exp(L_t - L_s) dM      (one matrix for a group's heads)
//   dC      = dCB B,   dB = dCB^T C + sum_h w (x dstate)
//   dL_t    = sum_s G[t,s] - sum_s G[s,t] - E_t, G = dM * M,
//             E_s = x_s . (w B dstate^T)_s, plus (sum_s E_s + dtot) at L_end
//   dla     = the reverse cumsum of dL over the chunk's rows.
//
// What bounds it on the H100. At zamba2-7b's training shape (B 4, S 2048:
// 16 chunks of Q 128, H 112, N = P = 64) the reads and writes (la, C, B, x,
// dy, dstate, dla, dC, dB, dx) are 0.838 GB, 0.250 ms at 3.35 TB/s. The
// products, on s <= t where M is triangular, are 30.4 GFLOP: on the FMA
// units (67 TFLOP/s) 0.45 ms, above the bytes, so they run on the tensor
// cores as the forward's do: mma.sync m16n8k8 with TF32 operands split hi/lo
// (3xTF32, three TF32 products for each float32 one: 0.18 ms at 495/3
// TFLOP/s, below the bytes). Each k-block's three products are summed on the
// core from zero and added to the accumulator in registers, as the core
// rounds its sums toward zero (see the forward's header). What bounds the
// kernel in practice is how fast two or three warps on each SM sub-partition
// issue those mma and the loads, splits and adds that feed them: on an H100
// 80GB HBM3 at 700 W it takes ~6x its bound (PERF.md; tools/ssd_bwd_phases.py
// shows where a stage's cycles go).
//
// Two kernels. ssd_bwd_heads: one block per (b * chunk, block of HG heads
// of one B/C group; kernels/ssd_scan.py:bwd_heads_per_block), one block an
// SM, 12 warps: two warpgroups of compute warps and a producer warpgroup.
// The producer's four
// warps copy each stage's x, dy and dstate tiles by cp.async into the other
// of two buffers while the compute warps work on the current one, form dB's
// head term dBh += (w x) dstate (two 16-row strips a warp, summed in shared
// memory where B sat while C . B^T was built), scan the next head's L in
// float64 (kept as float pairs, whose differences keep L_t - L_s's digits
// where L reaches -100 over a chunk, and w) and form the last head's dL and
// its reverse cumsum in float64 from the compute warps' partial sums. No
// compute warp waits on a copy or works alone.
//
// Per head the compute warps form dM^T = x dy^T (Q x Q, on s <= t) and
// dx = M^T dy + (w B) dstate^T. The Q x Q work is cut into units, a 16-row
// strip of s by an 8-column tile of t, on or right of the diagonal (t-tiles
// 2r.. of strip r): ns (ns + 1) units for ns = Q/16 strips. Strips r and
// ns-1-r are paired, and the pair's units (2 ns + 2) and its two
// B dstate^T terms are split evenly between two warps; the warp that does
// not write a strip's dx hands its part to the other through shared memory
// (a named barrier of the two warps). So each warp owns at most 9 units,
// and for those it keeps C.B^T (built once a block) and dCB (summed over
// the heads) in registers, in the mma accumulator layout. dM^T is formed
// there too: thread (g, q) of a warp holds entries (s = g, g+8; t = 2q,
// 2q+1) of a 16 x 8 tile, which is an A fragment of M^T dy with the tile's 8
// k-columns taken in the order 0,2,4,6,1,3,5,7 (the B fragment takes dy's
// rows in the same order), so M is never stored and its exponent is taken
// once an entry: M = CB exp(L_t - L_s), with the exponent -inf where t < s
// (exp never sees a masked, positive exponent), G = dM M, dCB += exp() dM.
// The other products take their k-columns in the same order, so that a
// lane's two elements of a row are one 8-byte load. The row sums of G come
// from shuffles over the tile's rows and its column sums from shuffles over
// its columns, into one array per warp in shared memory (no atomics); E_s
// comes from the B dstate^T term while it is in registers. Every tile in
// shared memory has a row stride that is a multiple of 32 floats and its
// columns XOR-swizzled by the row (swz_mask), so that an mma fragment reads
// it without bank conflicts whichever of its dimensions is the k of the
// product.
//
// The main shape (Q 113-128, N = P = 64) runs dbh_full and segment_full,
// whose loops have fixed counts, so that independent mma chains are
// straight-line code; any other shape runs the same plan with its counts at
// run time, P in passes of 64 columns and dBh in the compute warps'
// registers. The block then writes its
// dCB and dBh partials. ssd_bwd_cb: one block a (b * chunk, B/C group) sums
// the partials of that group's head blocks and forms dC = dCB B and
// dB = dCB^T C + dBh on the same 3xTF32 mma.sync path. Q <= 128, N <= 64
// with N % 4 == 0, P % 4 == 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NCOMPUTE = 8;        // compute warps; then the producer warpgroup:
constexpr int PRODUCER = NCOMPUTE; // its first warp forms dL, the next scans L
constexpr int NTHREADS = 32 * (NCOMPUTE + 4);
constexpr int CB_THREADS = 256;    // ssd_bwd_cb
constexpr int MAX_Q = 128;
constexpr int MAX_N = 64;
constexpr int PC = 64;             // columns of x and dy (rows of dstate) a pass holds
constexpr int MAXU = 9;            // units a warp owns: ns + 1 for ns <= 8 strips
constexpr int NT = 8;              // n-tiles of 8 columns in a row of 64
constexpr int MAX_SMEM = 232448;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The column of element (r, c) of a shared tile whose row stride is a
// multiple of 32 floats: c with bits 2-4 flipped by bits 0-2 of the row.
// An mma fragment reads 8 rows r0 + g by 4 columns c0 + q (A, and B where k
// runs along the row), 4 rows r0 + q by 8 columns c0 + g (B where k runs down
// the column), or rows r0 + 2q, r0 + 2q + 1 by 8 columns (dy in M^T dy): all
// 32 lanes land on distinct banks in each case. Four aligned columns stay
// together, so float4 copies and float2 reads keep working.
__host__ __device__ inline int swz_mask(int r) {
  return (r & 4) | ((r & 2) << 2) | (((r ^ (r >> 2)) & 1) << 4);
}
__device__ __forceinline__ int sw(int r, int ld, int c) { return r * ld + (c ^ swz_mask(r)); }

// Shared-memory layout in floats; every region starts on a 16-byte boundary.
struct Layout {
  int Qp, ns, Np, ldn, pc, ldp;     // Q padded to 16; N to 8 (row stride ldn); a pass's
                                     // columns pc, padded to 8, row stride ldp
  int off_x, off_dst, xbuf, dbuf;   // buffer b: x at off_x + b xbuf, dy xbuf / 2 after it,
                                     // dstate at off_dst + b dbuf
  int off_xchg, off_l, off_w, off_d, off_e, total;
};

__host__ __device__ inline Layout layout(int Q, int N, int P) {
  Layout s;
  s.Qp = round_up(Q, 16);
  s.ns = s.Qp / 16;
  s.Np = round_up(N, 8);
  s.ldn = round_up(N, 32);
  s.pc = imin(PC, round_up(P, 8));
  s.ldp = round_up(s.pc, 32);
  s.off_x = s.Qp * s.ldn;                          // after B[s][n]
  s.xbuf = 2 * s.Qp * s.ldp;                       // x then dy: C sits in buffer 1 first
  s.off_dst = s.off_x + 2 * s.xbuf;
  s.dbuf = s.pc * s.ldn;
  int off = s.off_dst + 2 * s.dbuf;
  s.off_xchg = off;                                // 4 pairs x NT x 32 lanes x float4
  off += 4 * NT * 32 * 4;
  s.off_l = off;                                   // L as float pairs, 2 heads
  off += 2 * 2 * s.Qp;
  s.off_w = off;                                   // w, 2 heads
  off += 2 * s.Qp;
  s.off_d = off;                                   // per-warp partial sums of dL, 2 heads
  off += 2 * NCOMPUTE * s.Qp;
  s.off_e = off;                                   // E, 2 heads
  off += 2 * s.Qp;
  s.total = off;
  return s;
}

// hi = a rounded to TF32 (to nearest, ties away); lo = a - hi, exact in
// float32 (copied from csrc/ssd_intra_chunk.cu, which says why).
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

// d = A . B on the tensor core, from a zero accumulator.
__device__ __forceinline__ void mma_tf32_from0(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// An A fragment split hi/lo: elements (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4).
struct Frag {
  uint32_t h[4], l[4];
};

__device__ __forceinline__ Frag split_frag(float a0, float a1, float a2, float a3) {
  Frag f;
  split(a0, f.h[0], f.l[0]);
  split(a1, f.h[1], f.l[1]);
  split(a2, f.h[2], f.l[2]);
  split(a3, f.h[3], f.l[3]);
  return f;
}

// acc += A . B in 3xTF32 for one 16 x 8 tile; b0, b1 are this lane's B
// elements (k = q and q + 4, column g). The three products, small terms
// first, are summed on the core from zero and added to acc in registers.
__device__ __forceinline__ void mma3(float (&acc)[4], const Frag& a, float b0, float b1) {
  uint32_t bh[2], bl[2];
  split(b0, bh[0], bl[0]);
  split(b1, bh[1], bl[1]);
  float p[4];
  mma_tf32_from0(p, a.l, bh);
  mma_tf32(p, a.h, bl);
  mma_tf32(p, a.h, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += p[i];
}

// The A fragment of rows r0 + g, r0 + g + 8 and columns c0 + q, c0 + q + 4 of
// a swizzled tile.
__device__ __forceinline__ Frag frag_rows(const float* t, int ld, int r0, int c0, int g, int q) {
  const int ra = r0 + g, rb = ra + 8;
  return split_frag(t[sw(ra, ld, c0 + q)], t[sw(rb, ld, c0 + q)], t[sw(ra, ld, c0 + q + 4)],
                    t[sw(rb, ld, c0 + q + 4)]);
}

// The exponent of M's decay, L_t - L_s from L as float pairs, or -inf where
// s > t.
__device__ __forceinline__ float decay_exponent(float2 Lt, float2 Ls, bool keep) {
  return keep ? (Lt.x - Ls.x) + (Lt.y - Ls.y) : -INFINITY;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float column_sum(float v) {     // over the 8 rows g of a fragment
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Copy rows [0, rows) x columns [0, cols) (cols % 4 == 0) of a row-major
// source with row stride src_ld into a swizzled shared tile with stride ld,
// by cp.async, zero-filling rows [rows, rows_p) and columns [cols, cols_p).
__device__ __forceinline__ void load_async(float* dst, int ld, const float* src, int64_t src_ld,
                                           int rows, int cols, int rows_p, int cols_p, int tid,
                                           int nthreads) {
  const int c4 = cols_p / 4, total = rows_p * c4;
  for (int i = tid; i < total; i += nthreads) {
    const int r = i / c4, c = 4 * (i % c4);
    const bool v = r < rows && c < cols;
    cp_async16(dst + sw(r, ld, c), v ? src + r * src_ld + c : src, v);
  }
}

// Stage k of a block: head g of the group, pass j of P; kind A forms dM^T
// and dBh over the pass, kind B dx. With one pass a stage is both.
struct Stage {
  int g, pass;
  bool a, b;
};

__device__ __forceinline__ Stage stage_of(int k, int npass) {
  if (npass == 1) return {k, 0, true, true};
  const int g = k / (2 * npass), j = k % (2 * npass);
  return j < npass ? Stage{g, j, true, false} : Stage{g, j - npass, false, true};
}

// L = cumsum(la) in float64, 4 rows a lane (the lane's la in v), as float
// pairs, and w_t = exp(L_end - L_t) (0 past Q).
__device__ __forceinline__ void scan_head(const float (&v)[4], int Q, int Qp, float2* L,
                                          float* w, int lane) {
  double r[4];
  double run = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += (double)v[k];
    r[k] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
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
    if (t >= Qp) continue;
    const float hi = (float)r[k];
    L[t] = make_float2(hi, (float)(r[k] - hi));
    w[t] = t < Q ? (float)exp(Lend - r[k]) : 0.f;
  }
}

__device__ __forceinline__ void load_la(float (&v)[4], const float* la, int64_t bc, int Q, int H,
                                        int h, int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * lane + k;
    v[k] = t < Q ? la[(bc * Q + t) * H + h] : 0.f;
  }
}

// dL of head h from the warps' partial sums D (NCOMPUTE x Qp) and E, in
// float64, and dla = its reverse cumsum; then D and E are zeroed for the
// head two ahead.
__device__ __forceinline__ void finish_head(float* D, float* E, const float* dtot, float* dla,
                                            int64_t bc, int Q, int Qp, int H, int h, int lane) {
  double d[4];
  double esum = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * lane + k;
    d[k] = 0.0;
    if (t < Q) {
      double acc = 0.0;
#pragma unroll
      for (int wi = 0; wi < NCOMPUTE; ++wi) acc += (double)D[wi * Qp + t];
      d[k] = acc - (double)E[t];
      esum += (double)E[t];
    }
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
  double incl = run;             // sum over this lane's rows and every later lane's
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += u;
  }
  const double later = incl - run;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int t = 4 * lane + k;
    if (t < Q) dla[(bc * Q + t) * H + h] = (float)(suf[k] + later);
  }
  __syncwarp();
  for (int i = lane; i < NCOMPUTE * Qp; i += 32) D[i] = 0.f;
  for (int i = lane; i < Qp; i += 32) E[i] = 0.f;
}

// -- the main shape's form: Q 128 (8 strips), N = P = 64, one pass -----------
constexpr int LDF = 64;   // row stride of every tile at the main shape
constexpr int GU = 3;     // units whose dM^T, M and M^T dy a warp forms together

// A lane's fragment coordinates and the swizzle masks of the rows it reads:
// rows = g, 2q and 2q + 1 modulo 8.
struct Lane {
  int gq, tq, mg, m2, m21;
};

// The products below take each k-block's 8 columns in the order 0,2,4,6,
// 1,3,5,7 (k = q is column 2q, k = q + 4 column 2q + 1, in A and B alike),
// so that a lane's two elements of a row are adjacent: one 8-byte load.

// dBh += (w x) dstate on strip `r` (all of N): this head's part in registers,
// then added to the lane's slots of the block's sum (dbs[32 j], float4).
__device__ __forceinline__ void dbh_full(const Lane& ln, int r, const float* xs, const float* dsts,
                                         const float* w, float4* dbs) {
  float dbh[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dbh[j][i] = 0.f;
  const int sa = 16 * r + ln.gq;
  const float wa = w[sa], wb = w[sa + 8];
  const float* xa = xs + sa * LDF;
  const float* xb = xa + 8 * LDF;
#pragma unroll 1
  for (int kb = 0; kb < NT; ++kb) {
    const int c = (8 * kb + 2 * ln.tq) ^ ln.mg;
    const float2 va = *reinterpret_cast<const float2*>(xa + c);
    const float2 vb = *reinterpret_cast<const float2*>(xb + c);
    const Frag A = split_frag(wa * va.x, wb * vb.x, wa * va.y, wb * vb.y);
    const float* d0 = dsts + (8 * kb + 2 * ln.tq) * LDF;
    const float* d1 = d0 + LDF;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma3(dbh[j], A, d0[(8 * j + ln.gq) ^ ln.m2], d1[(8 * j + ln.gq) ^ ln.m21]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float4 v = dbs[32 * j];
    v.x += dbh[j][0];
    v.y += dbh[j][1];
    v.z += dbh[j][2];
    v.w += dbh[j][3];
    dbs[32 * j] = v;
  }
}

// One segment at the main shape: strip S's units [UB, UE), t-tiles T + u - UB,
// in groups of GU: dM^T = x dy^T, then M, dCB and G's sums, then dx += M^T dy.
// ROLE 0 hands its dx to the pair's other warp; 1 writes it, with the other
// warp's part added, and 2 writes it alone (1 and 2 also add the strip's
// (w B) dstate^T and form E).
template <int UB, int UE, int ROLE>
__device__ __forceinline__ void segment_full(
    const Lane& ln, int S, int T, const float* xs, const float* dys, const float* dsts,
    const float* Bg, int ldbg, const float2* L, const float* w, float* D, float* E, float4* xc,
    int bar, float* dxh, int64_t row_x, int Q, float (&cb)[MAXU][4], float (&dcb)[MAXU][4]) {
  const int gq = ln.gq, tq = ln.tq;
  const int sa = 16 * S + gq, sb = sa + 8;
  const float* xa = xs + sa * LDF;
  const float* xb = xs + sb * LDF;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  if (ROLE != 0) {
    // (w B) dstate^T, and E_s = x_s . that; B's rows from global memory (a
    // chunk's B serves every head of the group, so they stay in cache)
    const float wa = sa < Q ? w[sa] : 0.f, wb = sb < Q ? w[sb] : 0.f;
    const float* ba = Bg + (sa < Q ? sa : 0) * ldbg + 2 * tq;
    const float* bb = Bg + (sb < Q ? sb : 0) * ldbg + 2 * tq;
#pragma unroll 1
    for (int kb = 0; kb < NT; ++kb) {
      const int c = (8 * kb + 2 * tq) ^ ln.mg;
      const float2 va = __ldg(reinterpret_cast<const float2*>(ba + 8 * kb));
      const float2 vb = __ldg(reinterpret_cast<const float2*>(bb + 8 * kb));
      const Frag A = split_frag(wa * va.x, wb * vb.x, wa * va.y, wb * vb.y);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(dsts + (8 * j + gq) * LDF + c);
        mma3(acc[j], A, v.x, v.y);
      }
    }
    float ea = 0.f, eb = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = (8 * j + 2 * tq) ^ ln.mg;
      const float2 va = *reinterpret_cast<const float2*>(xa + c);
      const float2 vb = *reinterpret_cast<const float2*>(xb + c);
      ea = fmaf(va.x, acc[j][0], fmaf(va.y, acc[j][1], ea));
      eb = fmaf(vb.x, acc[j][2], fmaf(vb.y, acc[j][3], eb));
    }
    ea = quad_sum(ea);
    eb = quad_sum(eb);
    if (tq == 0) {
      E[sa] = ea;
      E[sb] = eb;
    }
  }
  const float2 Lsa = L[sa], Lsb = L[sb];
  float csa = 0.f, csb = 0.f;
#pragma unroll
  for (int g0 = UB; g0 < UE; g0 += GU) {
    float mm[GU][4];
#pragma unroll
    for (int i = 0; i < GU; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) mm[i][e] = 0.f;
#pragma unroll 1
    for (int kb = 0; kb < NT; ++kb) {
      const int c = (8 * kb + 2 * tq) ^ ln.mg;
      const float2 va = *reinterpret_cast<const float2*>(xa + c);
      const float2 vb = *reinterpret_cast<const float2*>(xb + c);
      const Frag A = split_frag(va.x, vb.x, va.y, vb.y);
#pragma unroll
      for (int i = 0; i < GU; ++i) {
        if (g0 + i >= UE) break;
        const float2 v =
            *reinterpret_cast<const float2*>(dys + (8 * (T + g0 + i - UB) + gq) * LDF + c);
        mma3(mm[i], A, v.x, v.y);
      }
    }
#pragma unroll
    for (int i = 0; i < GU; ++i) {
      const int u = g0 + i;
      if (u >= UE) break;
      const int ta = 8 * (T + u - UB) + 2 * tq, tb = ta + 1;
      const float4 Lt = *reinterpret_cast<const float4*>(L + ta);
      const float2 Lta = make_float2(Lt.x, Lt.y), Ltb = make_float2(Lt.z, Lt.w);
      const float e[4] = {__expf(decay_exponent(Lta, Lsa, ta >= sa)),
                          __expf(decay_exponent(Ltb, Lsa, tb >= sa)),
                          __expf(decay_exponent(Lta, Lsb, ta >= sb)),
                          __expf(decay_exponent(Ltb, Lsb, tb >= sb))};
      float g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float mv = cb[u][k] * e[k];
        dcb[u][k] = fmaf(e[k], mm[i][k], dcb[u][k]);
        g[k] = mm[i][k] * mv;
        mm[i][k] = mv;
      }
      // each t is one unit's alone in this warp: the row sums are stored
      const float ra = column_sum(g[0] + g[2]), rb = column_sum(g[1] + g[3]);
      if (gq == 0) *reinterpret_cast<float2*>(D + ta) = make_float2(ra, rb);
      csa += g[0] + g[1];
      csb += g[2] + g[3];
    }
#pragma unroll
    for (int i = 0; i < GU; ++i) {
      const int u = g0 + i;
      if (u >= UE) break;
      const int tr = 8 * (T + u - UB) + 2 * tq;
      const Frag A = split_frag(mm[i][0], mm[i][2], mm[i][1], mm[i][3]);
      const float* d0 = dys + tr * LDF;
      const float* d1 = d0 + LDF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(acc[j], A, d0[(8 * j + gq) ^ ln.m2], d1[(8 * j + gq) ^ ln.m21]);
    }
  }
  csa = quad_sum(csa);
  csb = quad_sum(csb);
  __syncwarp();
  if (tq == 0) {
    D[sa] -= csa;
    D[sb] -= csb;
  }
  __syncwarp();
  if (ROLE == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      xc[32 * j] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    named_arrive(bar, 64);
    return;
  }
  if (ROLE == 1) {
    named_sync(bar, 64);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 v = xc[32 * j];
      acc[j][0] += v.x;
      acc[j][1] += v.y;
      acc[j][2] += v.z;
      acc[j][3] += v.w;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int p = 8 * j + 2 * tq;
    if (sa < Q)
      *reinterpret_cast<float2*>(dxh + sa * row_x + p) = make_float2(acc[j][0], acc[j][1]);
    if (sb < Q)
      *reinterpret_cast<float2*>(dxh + sb * row_x + p) = make_float2(acc[j][2], acc[j][3]);
  }
}

// The kernel's arguments.
struct Args {
  const float *la, *C, *Bm, *x, *dy, *dst, *dtot;
  float *dla, *dx, *part_dcb, *part_dbh;
  int Q, H, G, N, P, HG;
};

// This block's heads: blockIdx.y is head block y % nblk of B/C group
// y / nblk (nblk blocks of up to HG heads a group), so its heads share C
// and B, whose rows are G N apart, the group's N columns at grp N.
struct HeadBlock {
  int h0, hg;
  int64_t cb_off;   // C's and B's group columns in this chunk
};
__device__ __forceinline__ HeadBlock head_block(const Args& g) {
  const int Hg = g.H / g.G, nblk = (Hg + g.HG - 1) / g.HG;
  const int grp = blockIdx.y / nblk;
  const int h0 = grp * Hg + (blockIdx.y % nblk) * g.HG;
  return {h0, min(g.HG, (grp + 1) * Hg - h0),
          ((int64_t)blockIdx.x * g.Q * g.G + grp) * g.N};
}

// Copy stage k's x, dy and dstate tiles into buffer k & 1, as thread t of nt,
// and commit the copies.
__device__ __forceinline__ void issue_stage(const Args& g, const Layout& lay, float* smem, int k,
                                            int t, int nt) {
  const int Q = g.Q, H = g.H, N = g.N, P = g.P, npass = (P + PC - 1) / PC;
  const int64_t bc = blockIdx.x, row_x = (int64_t)H * P;
  const Stage st = stage_of(k, npass);
  const int b = k & 1, h = head_block(g).h0 + st.g, p0 = st.pass * PC, pw = min(PC, P - p0);
  const int c4x = round_up(pw, 8) / 4, c4n = lay.Np / 4;
  const int nx = lay.Qp * c4x, total = 2 * nx + 4 * c4x * c4n;
  // row and column of chunk j of a tile c4 chunks wide: by shifts where c4
  // is a power of two (always at the main shape)
  auto rc = [](int j, int c4, int& r, int& c) {
    if ((c4 & (c4 - 1)) == 0) {
      const int sh = __ffs(c4) - 1;
      r = j >> sh;
      c = 4 * (j & (c4 - 1));
    } else {
      r = j / c4;
      c = 4 * (j % c4);
    }
  };
  float* xb = smem + lay.off_x + b * lay.xbuf;
  float* db = smem + lay.off_dst + b * lay.dbuf;
  const float* xh = g.x + bc * Q * row_x + (int64_t)h * P + p0;
  const float* dyh = g.dy + bc * Q * row_x + (int64_t)h * P + p0;
  const float* dh = g.dst + ((bc * H + h) * P + p0) * N;
  for (int i = t; i < total; i += nt) {
    int r, c;
    if (i < 2 * nx) {
      const bool is_dy = i >= nx;
      rc(is_dy ? i - nx : i, c4x, r, c);
      const bool ok = r < Q && c < pw;
      const float* src = (is_dy ? dyh : xh) + (ok ? r * row_x + c : 0);
      cp_async16(xb + (is_dy ? lay.xbuf / 2 : 0) + sw(r, lay.ldp, c), src, ok);
    } else {
      rc(i - 2 * nx, c4n, r, c);
      const bool ok = r < pw && c < N;
      cp_async16(db + sw(r, lay.ldn, c), dh + (ok ? r * N + c : 0), ok);
    }
  }
  cp_async_commit();
}

// The block's start, for every warp: B (in the state region St) and C (in
// the second buffer's x and dy tiles) until C . B^T is built, stage 0's
// tiles, zero partial sums of dL, and the first head's L (producer).
__device__ __forceinline__ void prelude(const Args& g, const Layout& lay, float* smem) {
  const int tid = threadIdx.x, Q = g.Q, N = g.N, Qp = lay.Qp;
  const int64_t bc = blockIdx.x;
  const HeadBlock hb = head_block(g);
  const int64_t ldg = (int64_t)g.G * N;
  load_async(smem, lay.ldn, g.Bm + hb.cb_off, ldg, Q, N, Qp, lay.Np, tid, NTHREADS);
  load_async(smem + lay.off_x + lay.xbuf, lay.ldn, g.C + hb.cb_off, ldg, Q, N, Qp, lay.Np, tid,
             NTHREADS);
  cp_async_commit();
  issue_stage(g, lay, smem, 0, tid, NTHREADS);
  for (int i = tid; i < 2 * NCOMPUTE * Qp; i += NTHREADS) smem[lay.off_d + i] = 0.f;
  for (int i = tid; i < 2 * Qp; i += NTHREADS) smem[lay.off_e + i] = 0.f;
  if (tid / 32 == PRODUCER) {
    float v[4];
    load_la(v, g.la, bc, Q, g.H, hb.h0, tid % 32);
    scan_head(v, Q, Qp, reinterpret_cast<float2*>(smem + lay.off_l), smem + lay.off_w, tid % 32);
  }
  cp_async_wait_all();   // every thread's copies of B, C and stage 0
  __syncthreads();
}

// The producer warpgroup. Its four warps copy the next stage's tiles and,
// at the main shape, form dBh for two strips each (dbh_full), so that each
// SM sub-partition has three warps at work; at a head's first stage warp
// PRODUCER + 1 scans the next head's L and warp PRODUCER finishes the last
// head's dL.
template <bool FULL>
__device__ __forceinline__ void producer_body(const Args& g, float* smem) {
  const Layout lay = layout(g.Q, g.N, g.P);
  prelude(g, lay, smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, Qp = lay.Qp;
  const int pw = warp - NCOMPUTE;                   // 0..3: strips 2 pw, 2 pw + 1 of dBh
  const int npass = (g.P + PC - 1) / PC;
  const HeadBlock hb = head_block(g);
  const int h0 = hb.h0, hg = hb.hg;
  const int nstage = npass == 1 ? hg : hg * 2 * npass;
  const int64_t bc = blockIdx.x;
  const Lane ln = {lane >> 2, lane & 3, swz_mask(lane >> 2), swz_mask(2 * (lane & 3)),
                   swz_mask(2 * (lane & 3) + 1)};
  float4* dbs = reinterpret_cast<float4*>(smem) + 2 * pw * NT * 32 + lane;   // 2 strips
  float2* Ls = reinterpret_cast<float2*>(smem + lay.off_l);
  float* Ws = smem + lay.off_w;
  float* Ds = smem + lay.off_d;
  float* Es = smem + lay.off_e;
  for (int k = 0; k < nstage; ++k) {
    __syncthreads();   // stage k's tiles are in; every warp is done with stage k - 1's
    const Stage st = stage_of(k, npass);
    const int hp = st.g & 1, h = h0 + st.g;
    if (k + 1 < nstage)
      issue_stage(g, lay, smem, k + 1, threadIdx.x - 32 * NCOMPUTE, NTHREADS - 32 * NCOMPUTE);
    if constexpr (FULL) {
      if (k == 0)   // B is read (C . B^T is built) by now: its space sums dBh
#pragma unroll
        for (int j = 0; j < 2 * NT; ++j) dbs[32 * j] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* xs = smem + lay.off_x + (k & 1) * lay.xbuf;
      const float* dsts = smem + lay.off_dst + (k & 1) * lay.dbuf;
      dbh_full(ln, 2 * pw, xs, dsts, Ws + hp * Qp, dbs);
      dbh_full(ln, 2 * pw + 1, xs, dsts, Ws + hp * Qp, dbs + NT * 32);
    }
    if (st.a && st.pass == 0) {   // a head's first stage
      if (warp == PRODUCER + 1 && st.g + 1 < hg) {
        float v[4];
        load_la(v, g.la, bc, g.Q, g.H, h + 1, lane);
        scan_head(v, g.Q, Qp, Ls + (hp ^ 1) * Qp, Ws + (hp ^ 1) * Qp, lane);
      }
      if (warp == PRODUCER && st.g > 0)
        finish_head(Ds + (hp ^ 1) * NCOMPUTE * Qp, Es + (hp ^ 1) * Qp, g.dtot, g.dla, bc, g.Q,
                    Qp, g.H, h - 1, lane);
    }
    cp_async_wait_all();
  }
  __syncthreads();
  if (warp == PRODUCER) {
    const int hp = (hg - 1) & 1;
    finish_head(Ds + hp * NCOMPUTE * Qp, Es + hp * Qp, g.dtot, g.dla, bc, g.Q, Qp, g.H,
                h0 + hg - 1, lane);
  }
  if constexpr (FULL) {   // this block's dBh partial on the two strips
    float* pb_out = g.part_dbh + (bc * gridDim.y + blockIdx.y) * (int64_t)Qp * g.N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sa = 16 * (2 * pw + r) + ln.gq;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 v = dbs[(r * NT + j) * 32];
        const int n = 8 * j + 2 * ln.tq;
        *reinterpret_cast<float2*>(pb_out + sa * g.N + n) = make_float2(v.x, v.y);
        *reinterpret_cast<float2*>(pb_out + (sa + 8) * g.N + n) = make_float2(v.z, v.w);
      }
    }
  }
}

// The block's work for one warp. C0F >= 0 is the main shape's form (8
// strips, N = P = 64, one pass): the warp's first C0F units are of strip S0
// and the rest, up to MAXU, of strip S1, and every loop has a fixed count,
// so that its independent mma chains are straight-line code the compiler
// interleaves (dbh_full, segment_full). C0F < 0 takes any shape, with the
// counts at run time.
template <int C0F>
__device__ __forceinline__ void heads_body(const Args& g, float* smem) {
  constexpr bool FULL = C0F >= 0;
  const float* __restrict__ Bm = g.Bm;
  float* __restrict__ dx = g.dx;
  float* __restrict__ part_dcb = g.part_dcb;
  float* __restrict__ part_dbh = g.part_dbh;
  const int Q = g.Q, H = g.H, N = g.N, P = g.P;
  const Layout lay = layout(Q, N, P);
  const int Qp = lay.Qp, ns = FULL ? 8 : lay.ns, ldn = lay.ldn, ldp = lay.ldp;
  const int nbn = FULL ? NT : lay.Np / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;          // mma fragment row / column
  const int64_t bc = blockIdx.x;                    // b * nc + chunk
  const int ngrp = gridDim.y, grp = blockIdx.y;   // the partials' head block
  const HeadBlock hb = head_block(g);
  const int h0 = hb.h0, hg = hb.hg;
  const int ldbg = g.G * N;                         // row stride of B in global memory
  const int npass = (P + PC - 1) / PC;
  const int nstage = npass == 1 ? hg : hg * 2 * npass;
  const int64_t row_x = (int64_t)H * P;             // stride between rows of x and dy
  float* St = smem;   // B while C . B^T is built; then, at the main shape, dBh
  float2* Ls = reinterpret_cast<float2*>(smem + lay.off_l);
  float* Ws = smem + lay.off_w;
  float* Ds = smem + lay.off_d;
  float* Es = smem + lay.off_e;

  // This warp's units. Pair q takes strips lo = q and hi = ns-1-q (one strip
  // where they meet); its warp A (even) takes strip lo's first a t-tiles
  // (segment 0, whose dx it hands to warp B) and all of strip hi's (segment
  // 1, whose dx it writes); warp B (odd) takes strip lo's other t-tiles
  // (segment 0, whose dx it writes). Each has ns + 1 units.
  const int q = warp >> 1;
  const bool pair = q < (ns + 1) / 2, wa = (warp & 1) == 0;
  const int lo = q, hi = ns - 1 - q;
  const int a = (pair && hi != lo) ? ns - 2 * q - 1 : 0;
  const int S0 = lo, S1 = hi, T1 = 2 * hi;
  int T0 = 2 * lo, c0r = 0, c1r = 0;               // units [0, c0) of strip S0 from t-tile T0,
  if (pair && wa) {                                 // [c0, c1) of strip S1 from t-tile T1
    c0r = a;
    c1r = hi != lo ? ns + 1 : a;
  } else if (pair) {
    T0 = 2 * lo + a;
    c0r = c1r = 2 * ns - 2 * lo - a;
  }
  const int c0 = FULL ? C0F : c0r, c1 = FULL ? MAXU : c1r;
  // whether the warp writes its segment's dx (else it hands it on)
  const bool own0 = FULL ? C0F == MAXU : pair && !wa;
  const bool own1 = FULL ? C0F < MAXU : pair && wa && hi != lo;

  prelude(g, lay, smem);
  const float* Cs = smem + lay.off_x + lay.xbuf;

  // C . B^T on this warp's units, transposed: cb[u] holds CB[t][s] at the
  // unit's (s, t) entries.
  float cb[MAXU][4], dcb[MAXU][4], m[MAXU][4], dbh[NT][4];
#pragma unroll
  for (int u = 0; u < MAXU; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) cb[u][i] = dcb[u][i] = m[u][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dbh[j][i] = 0.f;
  for (int kb = 0; kb < nbn && warp < NCOMPUTE; ++kb) {
    Frag A0 = {}, A1 = {};
    if (c0 > 0) A0 = frag_rows(St, ldn, 16 * S0, 8 * kb, gq, tq);
    if (c1 > c0) A1 = frag_rows(St, ldn, 16 * S1, 8 * kb, gq, tq);
#pragma unroll
    for (int u = 0; u < MAXU; ++u) {
      if (u >= c1) continue;
      const int r = 8 * (u < c0 ? T0 + u : T1 + u - c0) + gq;
      mma3(cb[u], u < c0 ? A0 : A1, Cs[sw(r, ldn, 8 * kb + tq)], Cs[sw(r, ldn, 8 * kb + tq + 4)]);
    }
  }

  for (int k = 0; k < nstage; ++k) {
    const Stage st = stage_of(k, npass);
    const int b = k & 1, hp = st.g & 1, h = h0 + st.g;
    __syncthreads();   // stage k's tiles are in; every warp is done with stage k - 1's
    const float* xs = smem + lay.off_x + b * lay.xbuf;
    const float* dys = xs + lay.xbuf / 2;
    const float* dsts = smem + lay.off_dst + b * lay.dbuf;
    const float2* L = Ls + hp * Qp;
    const float* w = Ws + hp * Qp;
    float* D = Ds + (hp * NCOMPUTE + warp) * Qp;
    float* E = Es + hp * Qp;
    const int p0 = st.pass * PC, pw = FULL ? PC : min(PC, P - p0);
    const int pb = FULL ? NT : round_up(pw, 8) / 8;

    if constexpr (FULL) {
      const Lane ln = {gq, tq, swz_mask(gq), swz_mask(2 * tq), swz_mask(2 * tq + 1)};
      float4* xc = reinterpret_cast<float4*>(smem + lay.off_xchg) + q * NT * 32 + lane;
      float* dxh = dx + bc * Q * row_x + (int64_t)h * P;
      const float* Bg = Bm + hb.cb_off;
      if constexpr (C0F == MAXU) {
        segment_full<0, MAXU, 1>(ln, S0, T0, xs, dys, dsts, Bg, ldbg, L, w, D, E, xc, 1 + q, dxh,
                                 row_x, Q, cb, dcb);
      } else {
        segment_full<0, C0F, 0>(ln, S0, T0, xs, dys, dsts, Bg, ldbg, L, w, D, E, xc, 1 + q, dxh,
                                row_x, Q, cb, dcb);
        segment_full<C0F, MAXU, 2>(ln, S1, T1, xs, dys, dsts, Bg, ldbg, L, w, D, E, xc, 1 + q, dxh,
                                   row_x, Q, cb, dcb);
      }
    } else {
    if (st.a) {
      if (st.pass == 0) {
#pragma unroll
        for (int u = 0; u < MAXU; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i) m[u][i] = 0.f;
      }
      // dM^T = x dy^T over this pass's columns, on this warp's units
      for (int kb = 0; kb < pb; ++kb) {
        Frag A0 = {}, A1 = {};
        if (c0 > 0) A0 = frag_rows(xs, ldp, 16 * S0, 8 * kb, gq, tq);
        if (c1 > c0) A1 = frag_rows(xs, ldp, 16 * S1, 8 * kb, gq, tq);
#pragma unroll
        for (int u = 0; u < MAXU; ++u) {
          if (u >= c1) continue;
          const int r = 8 * (u < c0 ? T0 + u : T1 + u - c0) + gq;
          mma3(m[u], u < c0 ? A0 : A1, dys[sw(r, ldp, 8 * kb + tq)],
               dys[sw(r, ldp, 8 * kb + tq + 4)]);
        }
      }
      // dBh += (w x) dstate on strip `warp`
      if (warp < ns) {
        const int sa = 16 * warp + gq, sb = sa + 8;
        const float wa_ = w[sa], wb_ = w[sb];
        for (int kb = 0; kb < pb; ++kb) {
          const int c = 8 * kb + tq;
          const Frag A = split_frag(wa_ * xs[sw(sa, ldp, c)], wb_ * xs[sw(sb, ldp, c)],
                                    wa_ * xs[sw(sa, ldp, c + 4)], wb_ * xs[sw(sb, ldp, c + 4)]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < nbn)
              mma3(dbh[j], A, dsts[sw(c, ldn, 8 * j + gq)], dsts[sw(c + 4, ldn, 8 * j + gq)]);
        }
      }
    }

    if (st.a && st.pass == npass - 1) {
      // M, dCB and G on the units; G's row sums (over s) into D[t], its
      // column sums (over t) out of D[s]
      float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        if (u >= c1) continue;
        const bool seg0 = u < c0;
        const int sa = 16 * (seg0 ? S0 : S1) + gq, sb = sa + 8;
        const int ta = 8 * (seg0 ? T0 + u : T1 + u - c0) + 2 * tq, tb = ta + 1;
        const float2 Lsa = L[sa], Lsb = L[sb], Lta = L[ta], Ltb = L[tb];
        // entries (sa, ta), (sa, tb), (sb, ta), (sb, tb); __expf is within
        // ~6e-6 relative for exponents down to -100
        const float e[4] = {__expf(decay_exponent(Lta, Lsa, ta >= sa)),
                            __expf(decay_exponent(Ltb, Lsa, tb >= sa)),
                            __expf(decay_exponent(Lta, Lsb, ta >= sb)),
                            __expf(decay_exponent(Ltb, Lsb, tb >= sb))};
        float g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float mv = cb[u][i] * e[i];
          dcb[u][i] = fmaf(e[i], m[u][i], dcb[u][i]);
          g[i] = m[u][i] * mv;
          m[u][i] = mv;
        }
        const float ra = column_sum(g[0] + g[2]), rb = column_sum(g[1] + g[3]);
        if (gq == 0) {
          D[ta] += ra;
          D[tb] += rb;
        }
        cs[seg0 ? 0 : 1][0] += g[0] + g[1];
        cs[seg0 ? 0 : 1][1] += g[2] + g[3];
      }
#pragma unroll
      for (int sg = 0; sg < 2; ++sg)
#pragma unroll
        for (int i = 0; i < 2; ++i) cs[sg][i] = quad_sum(cs[sg][i]);
      __syncwarp();
      if (tq == 0) {
        if (c0 > 0) {
          D[16 * S0 + gq] -= cs[0][0];
          D[16 * S0 + gq + 8] -= cs[0][1];
        }
        if (c1 > c0) {
          D[16 * S1 + gq] -= cs[1][0];
          D[16 * S1 + gq + 8] -= cs[1][1];
        }
      }
      __syncwarp();
    }

    if (st.b) {
      // dx = (w B) dstate^T + M^T dy, one strip a segment
#pragma unroll
      for (int sg = 0; sg < 2; ++sg) {
        const bool own = sg ? own1 : own0;
        if (!(sg ? own1 : (c0 > 0))) continue;
        const int S = sg ? S1 : S0, sa = 16 * S + gq, sb = sa + 8;
        float acc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
        if (own) {
          const float wa_ = w[sa], wb_ = w[sb];
          for (int kb = 0; kb < nbn; ++kb) {
            const int c = 8 * kb + tq;
            const float* Bg = Bm + hb.cb_off;
            auto bv = [&](int r, int cc) { return r < Q && cc < N ? Bg[r * ldbg + cc] : 0.f; };
            const Frag A = split_frag(wa_ * bv(sa, c), wb_ * bv(sb, c), wa_ * bv(sa, c + 4),
                                      wb_ * bv(sb, c + 4));
#pragma unroll
            for (int j = 0; j < NT; ++j)
              if (j < pb)
                mma3(acc[j], A, dsts[sw(8 * j + gq, ldn, c)], dsts[sw(8 * j + gq, ldn, c + 4)]);
          }
          // E_s = x_s . (w B dstate^T)_s over this pass
          float ea = 0.f, eb = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < pb) {
              const float2 xa = *reinterpret_cast<const float2*>(xs + sw(sa, ldp, 8 * j + 2 * tq));
              const float2 xb = *reinterpret_cast<const float2*>(xs + sw(sb, ldp, 8 * j + 2 * tq));
              ea = fmaf(xa.x, acc[j][0], fmaf(xa.y, acc[j][1], ea));
              eb = fmaf(xb.x, acc[j][2], fmaf(xb.y, acc[j][3], eb));
            }
          ea = quad_sum(ea);
          eb = quad_sum(eb);
          if (tq == 0) {
            E[sa] += ea;
            E[sb] += eb;
          }
        }
        // M^T dy: the unit's dM^T registers, now M^T, are the A fragment
        // with k-columns t = 2q (k = q) and 2q + 1 (k = q + 4)
#pragma unroll
        for (int u = 0; u < MAXU; ++u) {
          if (sg == 0 ? u >= c0 : (u < c0 || u >= c1)) continue;
          const int tr = 8 * (sg == 0 ? T0 + u : T1 + u - c0) + 2 * tq;
          const Frag A = split_frag(m[u][0], m[u][2], m[u][1], m[u][3]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < pb)
              mma3(acc[j], A, dys[sw(tr, ldp, 8 * j + gq)], dys[sw(tr + 1, ldp, 8 * j + gq)]);
        }
        float4* xc = reinterpret_cast<float4*>(smem + lay.off_xchg) + q * NT * 32 + lane;
        if (!own) {      // warp A's part of strip lo, to warp B
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < pb) xc[32 * j] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
          named_arrive(1 + q, 64);
          continue;
        }
        if (sg == 0 && a > 0) {
          named_sync(1 + q, 64);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < pb) {
              const float4 v = xc[32 * j];
              acc[j][0] += v.x;
              acc[j][1] += v.y;
              acc[j][2] += v.z;
              acc[j][3] += v.w;
            }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int p = 8 * j + 2 * tq;
          if (j >= pb || p >= pw) continue;
          if (sa < Q)
            *reinterpret_cast<float2*>(dx + (bc * Q + sa) * row_x + (int64_t)h * P + p0 + p) =
                make_float2(acc[j][0], acc[j][1]);
          if (sb < Q)
            *reinterpret_cast<float2*>(dx + (bc * Q + sb) * row_x + (int64_t)h * P + p0 + p) =
                make_float2(acc[j][2], acc[j][3]);
        }
      }
    }

    }  // FULL
  }
  __syncthreads();

  // this block's partials: dCB^T on the units (Qp x Qp, [s][t]) and dBh on
  // strip `warp` (Qp x N)
  float* pc_out = part_dcb + (bc * ngrp + grp) * (int64_t)Qp * Qp;
#pragma unroll
  for (int u = 0; u < MAXU; ++u) {
    if (u >= c1) continue;
    const bool seg0 = u < c0;
    const int sa = 16 * (seg0 ? S0 : S1) + gq;
    const int ta = 8 * (seg0 ? T0 + u : T1 + u - c0) + 2 * tq;
    *reinterpret_cast<float2*>(pc_out + sa * Qp + ta) = make_float2(dcb[u][0], dcb[u][1]);
    *reinterpret_cast<float2*>(pc_out + (sa + 8) * Qp + ta) = make_float2(dcb[u][2], dcb[u][3]);
  }
  if (!FULL && warp < ns) {   // (at the main shape the producer warps write dBh)
    float* pb_out = part_dbh + (bc * ngrp + grp) * (int64_t)Qp * N;
    const int sa = 16 * warp + gq;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * tq;
      if (n >= N) continue;
      *reinterpret_cast<float2*>(pb_out + sa * N + n) = make_float2(dbh[j][0], dbh[j][1]);
      *reinterpret_cast<float2*>(pb_out + (sa + 8) * N + n) = make_float2(dbh[j][2], dbh[j][3]);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
ssd_bwd_heads(const float* __restrict__ la, const float* __restrict__ C,
              const float* __restrict__ Bm, const float* __restrict__ x,
              const float* __restrict__ dy, const float* __restrict__ dst,
              const float* __restrict__ dtot, float* __restrict__ dla,
              float* __restrict__ dx, float* __restrict__ part_dcb,
              float* __restrict__ part_dbh, int Q, int H, int G, int N, int P, int HG) {
  extern __shared__ __align__(16) float smem[];
  const Args g = {la, C, Bm, x, dy, dst, dtot, dla, dx, part_dcb, part_dbh, Q, H, G, N, P, HG};
  const int warp = threadIdx.x >> 5;
  const bool full = round_up(Q, 16) == 128 && N == LDF && P == LDF;
  if (warp >= NCOMPUTE) {
    if (full)
      producer_body<true>(g, smem);
    else
      producer_body<false>(g, smem);
    return;
  }
  if (full) {
    // warp A of pair q has 7 - 2q units of its first strip, warp B all 9
    switch (warp & 1 ? MAXU : 7 - (warp & ~1)) {
      case 1: heads_body<1>(g, smem); return;
      case 3: heads_body<3>(g, smem); return;
      case 5: heads_body<5>(g, smem); return;
      case 7: heads_body<7>(g, smem); return;
      default: heads_body<MAXU>(g, smem); return;
    }
  }
  heads_body<-1>(g, smem);
}

// Shared memory of ssd_bwd_cb, in floats: dCB^T (Qp x ldq), C and B (Qp x ldn).
__host__ __device__ inline int cb_smem_floats(int Q, int N) {
  const int Qp = round_up(Q, 16);
  return Qp * round_up(Qp, 32) + 2 * Qp * round_up(N, 32);
}

__global__ void __launch_bounds__(CB_THREADS)
ssd_bwd_cb(const float* __restrict__ C, const float* __restrict__ Bm,
           const float* __restrict__ part_dcb, const float* __restrict__ part_dbh,
           float* __restrict__ dC, float* __restrict__ dB, int Q, int G, int N, int nblk) {
  extern __shared__ __align__(16) float smem[];
  const int Qp = round_up(Q, 16), ns = Qp / 16, ldq = round_up(Qp, 32);
  const int Np = round_up(N, 8), ldn = round_up(N, 32), nbn = Np / 8;
  float* dcbT = smem;                   // dCB^T[s][t]
  float* Cs = dcbT + Qp * ldq;
  float* Bs = Cs + Qp * ldn;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  // blockIdx.y: the B/C group, whose nblk head blocks' partials are summed
  const int64_t bc = blockIdx.x, ldg = (int64_t)G * N;
  const int64_t cb_off = (bc * Q * G + blockIdx.y) * N;
  const int64_t blk0 = (bc * G + blockIdx.y) * nblk;
  load_async(Cs, ldn, C + cb_off, ldg, Q, N, Qp, Np, tid, CB_THREADS);
  load_async(Bs, ldn, Bm + cb_off, ldg, Q, N, Qp, Np, tid, CB_THREADS);
  cp_async_commit();
  // the head blocks' partials, written on t >= 16 (s / 16) (zero elsewhere)
  const float* pc_in = part_dcb + blk0 * Qp * Qp;
  const int c4 = Qp / 4;
  for (int i = tid; i < Qp * c4; i += CB_THREADS) {
    const int s = i / c4, t = 4 * (i % c4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 16 * (s / 16))
      for (int g = 0; g < nblk; ++g) {
        const float4 p =
            *reinterpret_cast<const float4*>(pc_in + (int64_t)g * Qp * Qp + s * Qp + t);
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
    *reinterpret_cast<float4*>(dcbT + sw(s, ldq, t)) = v;
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp >= ns) return;

  // dC on t-strip `warp`: sum over s <= t of dCB[t][s] B[s][n]
  {
    float acc[NT][4] = {};
    const int t0 = 16 * warp;
    for (int kb = 0; kb < 2 * warp + 2; ++kb) {
      const int s = 8 * kb + tq;
      const Frag A = split_frag(dcbT[sw(s, ldq, t0 + gq)], dcbT[sw(s, ldq, t0 + gq + 8)],
                                dcbT[sw(s + 4, ldq, t0 + gq)], dcbT[sw(s + 4, ldq, t0 + gq + 8)]);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nbn) mma3(acc[j], A, Bs[sw(s, ldn, 8 * j + gq)], Bs[sw(s + 4, ldn, 8 * j + gq)]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * tq, ta = t0 + gq, tb = ta + 8;
      if (n >= N) continue;
      if (ta < Q)
        *reinterpret_cast<float2*>(dC + cb_off + ta * ldg + n) = make_float2(acc[j][0], acc[j][1]);
      if (tb < Q)
        *reinterpret_cast<float2*>(dC + cb_off + tb * ldg + n) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  // dB on s-strip `warp`: sum over t >= s of dCB[t][s] C[t][n], plus dBh
  {
    float acc[NT][4] = {};
    const int s0 = 16 * warp;
    for (int kb = 2 * warp; kb < 2 * ns; ++kb) {
      const Frag A = frag_rows(dcbT, ldq, s0, 8 * kb, gq, tq);
      const int t = 8 * kb + tq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < nbn) mma3(acc[j], A, Cs[sw(t, ldn, 8 * j + gq)], Cs[sw(t + 4, ldn, 8 * j + gq)]);
    }
    const float* pb_in = part_dbh + blk0 * Qp * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * tq, sa = s0 + gq, sb = sa + 8;
      if (n >= N) continue;
      for (int g = 0; g < nblk; ++g) {
        const float2 va = *reinterpret_cast<const float2*>(pb_in + ((int64_t)g * Qp + sa) * N + n);
        const float2 vb = *reinterpret_cast<const float2*>(pb_in + ((int64_t)g * Qp + sb) * N + n);
        acc[j][0] += va.x;
        acc[j][1] += va.y;
        acc[j][2] += vb.x;
        acc[j][3] += vb.y;
      }
      if (sa < Q)
        *reinterpret_cast<float2*>(dB + cb_off + sa * ldg + n) = make_float2(acc[j][0], acc[j][1]);
      if (sb < Q)
        *reinterpret_cast<float2*>(dB + cb_off + sb * ldg + n) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

}  // namespace

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// All float32, contiguous and 16-byte aligned: la (BC,Q,H), C/B (BC,Q,G,N),
// x/dy (BC,Q,H,P), dst (BC,H,P,N), dtot (BC,H) -> dla (BC,Q,H),
// dx (BC,Q,H,P), dC/dB (BC,Q,G,N); part_dcb (BC,NB,Qp,Qp) and part_dbh
// (BC,NB,Qp,N) scratch, NB = G ceil(H / G / HG) head blocks, Qp = Q rounded
// up to 16. 0 < Q <= 128, 0 < N <= 64, N % 4 == 0, P > 0, P % 4 == 0,
// G dividing H, 1 <= HG (heads a block serves, of one group).
extern "C" int ssd_intra_chunk_bwd(const void* la, const void* C, const void* B, const void* x,
                                   const void* dy, const void* dst, const void* dtot, void* dla,
                                   void* dx, void* dC, void* dB, void* part_dcb, void* part_dbh,
                                   int BC, int Q, int H, int G, int N, int P, int HG,
                                   void* stream) {
  if (BC <= 0 || H <= 0 || Q <= 0 || Q > MAX_Q || N <= 0 || N > MAX_N || N % 4 || P <= 0 ||
      P % 4 || HG <= 0 || G <= 0 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int heads_smem = layout(Q, N, P).total * (int)sizeof(float);
  const int cb_smem = cb_smem_floats(Q, N) * (int)sizeof(float);
  if (heads_smem > MAX_SMEM || cb_smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_heads,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, heads_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize, cb_smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (H / G + HG - 1) / HG;
  ssd_bwd_heads<<<dim3(BC, G * nblk), NTHREADS, heads_smem, st>>>(
      static_cast<const float*>(la), static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<const float*>(dst),
      static_cast<const float*>(dtot), static_cast<float*>(dla), static_cast<float*>(dx),
      static_cast<float*>(part_dcb), static_cast<float*>(part_dbh), Q, H, G, N, P, HG);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_cb<<<dim3(BC, G), CB_THREADS, cb_smem, st>>>(
      static_cast<const float*>(C), static_cast<const float*>(B),
      static_cast<const float*>(part_dcb), static_cast<const float*>(part_dbh),
      static_cast<float*>(dC), static_cast<float*>(dB), Q, G, N, nblk);
  return (int)cudaGetLastError();
}
