"""The Mamba2 mixer's and the mLSTM's causal conv with its bias and SiLU:
one Triton pass forward, one backward (and a pass that sums the weight's and
bias's partials), and their plain PyTorch versions.

No TPU kernel is replaced: ``repro``'s ``_causal_conv`` is
``conv_general_dilated`` followed by a bias add and a SiLU, which XLA fuses.
Eager PyTorch runs it as about seven passes over the conv's input: a
transposing pad, cuDNN's or PyTorch's depthwise conv, an add whose output is
laid out like its transposed input, a transposing ``.contiguous()``, the
SiLU; and in the backward the transposed gradient made contiguous again,
the conv's two gradients, SiLU's backward and the bias's sum.

The function: for x (B, S, Ch), a depthwise weight w (W, Ch) and bias b (Ch,)

    u[t] = sum_k w[k] * x[t - (W-1) + k] + b        (x[t] = 0 for t < 0)
    y[t] = silu(u[t]) = u[t] * sigmoid(u[t])

What bounds it on the H100: bytes. A 4-tap stencil and a sigmoid an element
against 2 B read and 2 B written in bf16: the forward's least time is
``(x + y) bytes / 3.35 TB/s``, the backward's ``(x + dy + dx) bytes /
3.35 TB/s`` (the halo rows, w, b and the partials are a few % more).

Design. x is read where it lies: a (B, S, Ch) view with unit channel stride
and any row and batch stride (the ``xBC`` slice of the mixer's ``in_proj``
output), so nothing is copied before the conv. Both passes run four taps,
a narrower conv's weight padded in front with zero taps (W <= 4, the width
of every config). ``causal_conv_silu_fwd_kernel``: a program takes a tile of
rows by channels, loads it and its W-1 halo rows as four row-shifted tiles
(coalesced along the channels; the shifted reloads hit L1 and L2), sums the
taps and the bias in float32, applies SiLU in float32 and rounds to x's
dtype once into a contiguous (B, S, Ch) output.
``causal_conv_silu_bwd_kernel`` keeps nothing from the forward but x, w and
b. Its dx row needs du at the W rows from it on, which a tile of rows could
only have by recomputing the conv and the sigmoid W times an element. So a
program (one warp, 16 bytes of a row a thread) walks a chunk of rows of one
channel block in order, four rows an iteration, with the last W-1 rows of x
and of du in float32 registers and eight rows of x and dy loaded in their
own dtype, the four it computes and the four after, whose loads stay in
flight through the iteration:

    u[t] from x[t-3..t] held;  du[t] = dy[t] * s (1 + u (1 - s)),  s = sigmoid(u[t])
    dx[t-3] = sum_k w[k] * du[t-3 + (W-1) - k]     (du[t] = 0 for t >= S)

one sigmoid an element. dx is written in x's dtype; dw[k] = sum_t x[t -
(W-1) + k] du[t] and db = sum_t du[t] are summed in float32 registers over
the chunk's rows (the three rows after it are computed again, for its last
dx rows, and not summed); each program writes one float32 row of partials,
which ``causal_conv_silu_dwdb_kernel`` sums over the programs in a fixed
order and casts to w's and b's dtype. No atomics: the gradients are the
same bits in every call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..precision import widen

TAPS = 4                       # the kernels' taps: a narrower conv is padded in front


def causal_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv plus bias: x (B, S, Ch), w (W, Ch), b (Ch,) ->
    (B, S, Ch), contiguous, by ``F.conv1d`` on the transposed input."""
    W = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))
    out = F.conv1d(xp, w.t().unsqueeze(1), groups=x.shape[-1])
    return (out.transpose(1, 2) + b).contiguous()


def causal_conv_silu_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu(causal conv + bias), in x's dtype at every step."""
    return F.silu(causal_conv_plain(x, w, b))


def causal_conv_silu_bwd_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                               dy: torch.Tensor):
    """(dx in x's dtype, dw in w's, db in b's) of ``causal_conv_silu_plain``
    at x for the output gradient ``dy``: the backward kernel's formula, in
    float32 (float64 for float64 inputs) from u recomputed."""
    xf, wf, bf, gf = widen(x), widen(w), widen(b), widen(dy)
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(xf, (0, 0, W - 1, 0))             # row t + k is x[t - (W-1) + k]
    u = sum(wf[k] * xp[:, k:k + S] for k in range(W)) + bf
    s = torch.sigmoid(u)
    du = gf * s * (1 + u * (1 - s))
    dup = F.pad(du, (0, 0, 0, W - 1))            # row t + j is du[t + j], 0 past S
    dx = sum(wf[W - 1 - j] * dup[:, j:j + S] for j in range(W))
    dw = torch.stack([(xp[:, k:k + S] * du).sum((0, 1)) for k in range(W)])
    return dx.to(x.dtype), dw.to(w.dtype), du.sum((0, 1)).to(b.dtype)


_KERNELS = None
tl = None  # triton.language, bound on first use: the JIT reads it from globals


def _kernels():
    """Define the Triton kernels on first use (``triton`` exists only where a
    card does)."""
    global _KERNELS, tl
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _rows(base, t, c, S, stride, cmask):
        """Rows ``t`` (any, masked to [0, S)) by channels ``c`` of one
        sequence, in float32."""
        m = ((t >= 0) & (t < S))[:, None] & cmask[None, :]
        return tl.load(base + t.to(tl.int64)[:, None] * stride + c[None, :], mask=m,
                       other=0.0).to(tl.float32)

    @triton.jit
    def _tap(w_ptr, k: tl.constexpr, W: tl.constexpr, Ch, c, cmask):
        """Tap ``k`` of the four, in float32: w[k - (4 - W)], zero in front."""
        real = (c * 0 + (k + W - 4)) >= 0
        return tl.load(w_ptr + (k + W - 4) * Ch + c, mask=cmask & real,
                       other=0.0).to(tl.float32)

    @triton.jit
    def _u(x0, x1, x2, x3, w0, w1, w2, w3, bias):
        """The conv plus bias at a row from its four inputs, oldest first."""
        return x0 * w0[None, :] + x1 * w1[None, :] + x2 * w2[None, :] + x3 * w3[None, :] \
            + bias[None, :]

    @triton.jit
    def _du(u, g):
        s = tl.sigmoid(u)
        return g * s * (1.0 + u * (1.0 - s))

    @triton.jit
    def causal_conv_silu_fwd_kernel(x_ptr, w_ptr, b_ptr, o_ptr, S, Ch, sxb, sxs,
                                    W: tl.constexpr, BLOCK_T: tl.constexpr,
                                    BLOCK_C: tl.constexpr):
        t = tl.program_id(0) * BLOCK_T + tl.arange(0, BLOCK_T)
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        bi = tl.program_id(2).to(tl.int64)
        cmask = c < Ch
        xb = x_ptr + bi * sxb
        w0 = _tap(w_ptr, 0, W, Ch, c, cmask)
        w1 = _tap(w_ptr, 1, W, Ch, c, cmask)
        w2 = _tap(w_ptr, 2, W, Ch, c, cmask)
        w3 = _tap(w_ptr, 3, W, Ch, c, cmask)
        bias = tl.load(b_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        u = _u(_rows(xb, t - 3, c, S, sxs, cmask), _rows(xb, t - 2, c, S, sxs, cmask),
               _rows(xb, t - 1, c, S, sxs, cmask), _rows(xb, t, c, S, sxs, cmask),
               w0, w1, w2, w3, bias)
        y = u * tl.sigmoid(u)
        om = (t < S)[:, None] & cmask[None, :]
        offs = (bi * S + t.to(tl.int64))[:, None] * Ch + c[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=om)

    @triton.jit
    def _row(ptrs, t, S, stride, cmask):
        """Row ``t`` (a scalar, masked to [0, S)) at channels ``ptrs``, in
        the tensor's own dtype (half the registers of float32 while it waits
        in the loads ahead)."""
        return tl.load(ptrs + t.to(tl.int64) * stride, mask=cmask & (t >= 0) & (t < S),
                       other=0.0)

    @triton.jit
    def _bwd_row(t, own, xa, xb, xc, xr, gr, da, db, dc, w0, w1, w2, w3, bias,
                 acc0, acc1, acc2, acc3, accb):
        """Row t of the backward from the window (x's row t and dy's as
        loaded): du[t] summed into the partials where t is the chunk's,
        dx[t - 3]; the window moved on."""
        xt = xr.to(tl.float32)
        d = _du(w0 * xa + w1 * xb + w2 * xc + w3 * xt + bias, gr.to(tl.float32))
        mine = tl.where(t < own, d, 0.0)
        dx = w3 * da + w2 * db + w1 * dc + w0 * d
        return (xb, xc, xt, db, dc, d, acc0 + xa * mine, acc1 + xb * mine, acc2 + xc * mine,
                acc3 + xt * mine, accb + mine, dx)

    @triton.jit
    def causal_conv_silu_bwd_kernel(x_ptr, w_ptr, b_ptr, dy_ptr, dx_ptr, part_ptr,
                                    S, Ch, sxb, sxs, sdb, sds, chunks,
                                    W: tl.constexpr, CHUNK: tl.constexpr,
                                    BLOCK_C: tl.constexpr):
        pid = tl.program_id(0)
        bi = (pid // chunks).to(tl.int64)
        r0 = (pid % chunks) * CHUNK
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = c < Ch
        w0 = _tap(w_ptr, 0, W, Ch, c, cmask)
        w1 = _tap(w_ptr, 1, W, Ch, c, cmask)
        w2 = _tap(w_ptr, 2, W, Ch, c, cmask)
        w3 = _tap(w_ptr, 3, W, Ch, c, cmask)
        bias = tl.load(b_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        xp = x_ptr + bi * sxb + c
        gp = dy_ptr + bi * sdb + c
        orow = dx_ptr + bi * S * Ch + c
        # the window: x[t-3], x[t-2], x[t-1] and du[t-3], du[t-2], du[t-1]
        # in float32 (du before the chunk feeds only dx rows before it,
        # never stored); four rows an iteration, rows t to t+7 of x and dy
        # loaded (x1..x8, g1..g8): the four computed, and the four after,
        # whose loads stay in flight through this iteration
        xa = _row(xp, r0 - 3, S, sxs, cmask).to(tl.float32)
        xb = _row(xp, r0 - 2, S, sxs, cmask).to(tl.float32)
        xc = _row(xp, r0 - 1, S, sxs, cmask).to(tl.float32)
        x1 = _row(xp, r0, S, sxs, cmask)
        g1 = _row(gp, r0, S, sds, cmask)
        x2 = _row(xp, r0 + 1, S, sxs, cmask)
        g2 = _row(gp, r0 + 1, S, sds, cmask)
        x3 = _row(xp, r0 + 2, S, sxs, cmask)
        g3 = _row(gp, r0 + 2, S, sds, cmask)
        x4 = _row(xp, r0 + 3, S, sxs, cmask)
        g4 = _row(gp, r0 + 3, S, sds, cmask)
        x5 = _row(xp, r0 + 4, S, sxs, cmask)
        g5 = _row(gp, r0 + 4, S, sds, cmask)
        x6 = _row(xp, r0 + 5, S, sxs, cmask)
        g6 = _row(gp, r0 + 5, S, sds, cmask)
        x7 = _row(xp, r0 + 6, S, sxs, cmask)
        g7 = _row(gp, r0 + 6, S, sds, cmask)
        x8 = _row(xp, r0 + 7, S, sxs, cmask)
        g8 = _row(gp, r0 + 7, S, sds, cmask)
        da = tl.zeros((BLOCK_C,), dtype=tl.float32)
        db = tl.zeros((BLOCK_C,), dtype=tl.float32)
        dc = tl.zeros((BLOCK_C,), dtype=tl.float32)
        acc0 = tl.zeros((BLOCK_C,), dtype=tl.float32)
        acc1 = tl.zeros((BLOCK_C,), dtype=tl.float32)
        acc2 = tl.zeros((BLOCK_C,), dtype=tl.float32)
        acc3 = tl.zeros((BLOCK_C,), dtype=tl.float32)
        accb = tl.zeros((BLOCK_C,), dtype=tl.float32)
        own = r0 + CHUNK
        # du past the chunk's rows (the next chunk's first three, zero past S)
        # finishes its last dx rows and is not summed into dw and db; rows
        # past ``end`` are computed and not stored
        end = tl.minimum(own, S) + 3
        ty = dx_ptr.dtype.element_ty
        for t in range(r0, end, 4):
            xa, xb, xc, da, db, dc, acc0, acc1, acc2, acc3, accb, dx = _bwd_row(
                t, own, xa, xb, xc, x1, g1, da, db, dc, w0, w1, w2, w3, bias,
                acc0, acc1, acc2, acc3, accb)
            tl.store(orow + (t - 3).to(tl.int64) * Ch, dx.to(ty), mask=cmask & (t - 3 >= r0))
            xa, xb, xc, da, db, dc, acc0, acc1, acc2, acc3, accb, dx = _bwd_row(
                t + 1, own, xa, xb, xc, x2, g2, da, db, dc, w0, w1, w2, w3, bias,
                acc0, acc1, acc2, acc3, accb)
            tl.store(orow + (t - 2).to(tl.int64) * Ch, dx.to(ty),
                     mask=cmask & (t - 2 >= r0) & (t + 1 < end))
            xa, xb, xc, da, db, dc, acc0, acc1, acc2, acc3, accb, dx = _bwd_row(
                t + 2, own, xa, xb, xc, x3, g3, da, db, dc, w0, w1, w2, w3, bias,
                acc0, acc1, acc2, acc3, accb)
            tl.store(orow + (t - 1).to(tl.int64) * Ch, dx.to(ty),
                     mask=cmask & (t - 1 >= r0) & (t + 2 < end))
            xa, xb, xc, da, db, dc, acc0, acc1, acc2, acc3, accb, dx = _bwd_row(
                t + 3, own, xa, xb, xc, x4, g4, da, db, dc, w0, w1, w2, w3, bias,
                acc0, acc1, acc2, acc3, accb)
            tl.store(orow + t.to(tl.int64) * Ch, dx.to(ty),
                     mask=cmask & (t >= r0) & (t + 3 < end))
            x1 = x5
            g1 = g5
            x2 = x6
            g2 = g6
            x3 = x7
            g3 = g7
            x4 = x8
            g4 = g8
            x5 = _row(xp, t + 8, S, sxs, cmask)
            g5 = _row(gp, t + 8, S, sds, cmask)
            x6 = _row(xp, t + 9, S, sxs, cmask)
            g6 = _row(gp, t + 9, S, sds, cmask)
            x7 = _row(xp, t + 10, S, sxs, cmask)
            g7 = _row(gp, t + 10, S, sds, cmask)
            x8 = _row(xp, t + 11, S, sxs, cmask)
            g8 = _row(gp, t + 11, S, sds, cmask)
        # one row of W + 1 partials: the real taps (the last W of the four), then db
        row = part_ptr + pid.to(tl.int64) * (W + 1) * Ch + c
        if W == 4:
            tl.store(row + (W - 4) * Ch, acc0, mask=cmask)
        if W >= 3:
            tl.store(row + (W - 3) * Ch, acc1, mask=cmask)
        if W >= 2:
            tl.store(row + (W - 2) * Ch, acc2, mask=cmask)
        tl.store(row + (W - 1) * Ch, acc3, mask=cmask)
        tl.store(row + W * Ch, accb, mask=cmask)

    @triton.jit
    def causal_conv_silu_dwdb_kernel(part_ptr, dw_ptr, db_ptr, R, n_w, n_all,
                                     BLOCK_R: tl.constexpr, BLOCK_N: tl.constexpr):
        j = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        jmask = j < n_all
        acc = tl.zeros((BLOCK_N,), dtype=tl.float32)
        for start in range(0, R, BLOCK_R):
            r = start + tl.arange(0, BLOCK_R)
            m = (r < R)[:, None] & jmask[None, :]
            acc += tl.sum(tl.load(part_ptr + r.to(tl.int64)[:, None] * n_all + j[None, :],
                                  mask=m, other=0.0), axis=0)
        tl.store(dw_ptr + j, acc.to(dw_ptr.dtype.element_ty), mask=j < n_w)
        tl.store(db_ptr + (j - n_w), acc.to(db_ptr.dtype.element_ty), mask=(j >= n_w) & jmask)

    _KERNELS = (triton, causal_conv_silu_fwd_kernel, causal_conv_silu_bwd_kernel,
                causal_conv_silu_dwdb_kernel)
    return _KERNELS


DTYPES = (torch.float32, torch.bfloat16)
# The launches, from sweeps on an H100 (PERF.md's kernel findings). Forward:
# tiles of 32 rows by 64 channels on 4 warps (65-67% of its bytes bound at
# Zamba2-7B's training shape; 16-64 rows by 32-128 channels on 2-8 warps read
# 27-66%). Backward: one warp a program, 16 bytes of a row a thread (256
# bf16 or 128 float32 channels), chunks of 256 rows (66-68% in bf16, 76-78%
# in float32 there), halved to 128 where 256 gives fewer than 6 programs an
# SM (xlstm-1.3b's (4, 2048, 4096): 54% at 256, 69% at 128; Zamba2's 60-64%
# at 128, 50% at 192). Two rows an iteration with four loaded ahead read
# 58-61%, twelve rows loaded ahead 46-59%. The sum of the partials in
# 32-row steps of 64 columns (3 us at Zamba2's shape; 256 columns 6 us).
FWD_PLAN = {"BLOCK_T": 32, "BLOCK_C": 64, "num_warps": 4}
BWD_CHUNK, BWD_MIN_PROGRAMS_PER_SM, BWD_THREAD_BYTES = 256, 6, 16
DWDB_BLOCK_R, DWDB_BLOCK_N = 32, 64


def _check(x, w, b, what: str) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{what} takes CUDA tensors on one device ({name})")
        if t.dtype not in DTYPES:
            raise ValueError(f"{what}: unsupported dtype {t.dtype} of {name}")
    if x.dim() != 3 or x.stride(-1) != 1:
        raise ValueError(f"{what}: x must be (B, S, Ch) with unit channel stride, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    W, Ch = w.shape if w.dim() == 2 else (0, 0)
    if not 1 <= W <= TAPS or Ch != x.shape[-1] or b.shape != (Ch,):
        raise ValueError(f"{what}: w must be (W <= {TAPS}, Ch) and b (Ch,) for x "
                         f"{tuple(x.shape)}, got {tuple(w.shape)} and {tuple(b.shape)}")
    if not (w.is_contiguous() and b.is_contiguous()) or w.dtype != b.dtype:
        raise ValueError(f"{what}: w and b must be contiguous and of one dtype")


def causal_conv_silu_triton(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the forward: silu(causal conv(x, w) + b) in x's dtype,
    contiguous (B, S, Ch). x: (B, S, Ch) CUDA with unit channel stride (any
    row and batch stride); w (W <= 4, Ch) and b (Ch,) contiguous."""
    _check(x, w, b, "causal_conv_silu_triton")
    Bsz, S, Ch = x.shape
    out = torch.empty((Bsz, S, Ch), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    triton, fwd, _, _ = _kernels()
    grid = (triton.cdiv(S, FWD_PLAN["BLOCK_T"]), triton.cdiv(Ch, FWD_PLAN["BLOCK_C"]), Bsz)
    fwd[grid](x, w, b, out, S, Ch, x.stride(0), x.stride(1), W=w.shape[0], **FWD_PLAN)
    return out


def causal_conv_silu_bwd_triton(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                dy: torch.Tensor):
    """Launch the backward: (dx in x's dtype, contiguous; dw in w's; db in
    b's) for the output gradient ``dy`` (x's shape and dtype, unit channel
    stride, any row and batch stride)."""
    _check(x, w, b, "causal_conv_silu_bwd_triton")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or dy.stride(-1) != 1:
        raise ValueError("causal_conv_silu_bwd_triton: dy must be shaped like x, of its "
                         "dtype and device, with unit channel stride")
    Bsz, S, Ch = x.shape
    W = w.shape[0]
    dx = torch.empty((Bsz, S, Ch), dtype=x.dtype, device=x.device)
    if dx.numel() == 0:
        return dx, torch.zeros_like(w), torch.zeros_like(b)
    triton, _, bwd, dwdb = _kernels()
    block_c = 32 * BWD_THREAD_BYTES // x.element_size()
    c_blocks = triton.cdiv(Ch, block_c)
    chunk = BWD_CHUNK
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if Bsz * triton.cdiv(S, chunk) * c_blocks < BWD_MIN_PROGRAMS_PER_SM * sms:
        chunk //= 2
    chunks = triton.cdiv(S, chunk)
    R = Bsz * chunks
    part = torch.empty((R, W + 1, Ch), dtype=torch.float32, device=x.device)
    bwd[(R, c_blocks)](
        x, w, b, dy, dx, part, S, Ch, x.stride(0), x.stride(1), dy.stride(0), dy.stride(1),
        chunks, W=W, CHUNK=chunk, BLOCK_C=block_c, num_warps=1)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    n_all = (W + 1) * Ch
    dwdb[(triton.cdiv(n_all, DWDB_BLOCK_N),)](part, dw, db, R, W * Ch, n_all,
                                               BLOCK_R=DWDB_BLOCK_R, BLOCK_N=DWDB_BLOCK_N,
                                               num_warps=4)
    return dx, dw, db
