"""Fused RMSNorm: a Triton kernel for Hopper and its plain PyTorch version.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm.py:rmsnorm`` (Pallas,
``pl.pallas_call`` over row blocks of 256 with the (BR, d) tile in VMEM).

What bounds it on the H100: bytes. Each element is read once and written
once with a handful of flops, so the least time is
``(2 * rows * d * itemsize + d * scale_itemsize) / 3.35 TB/s``.

Design: one program normalises ``BLOCK_R`` rows held in registers as a
(BLOCK_R, BLOCK_D) block, BLOCK_D the next power of two above d (d = 5120
for qwen3-14b's layer norms, 128 for its q/k head norms). Statistics are
float32; the ragged row and column edges are masked, so any row count is
taken (the TPU kernel fell back to one row a program when ``rows % 256``).
Narrow rows are packed several to a program so that a program still moves
about 4k elements and the 163,840 head-norm rows of a qwen3-14b prefill
do not become as many tiny programs.

Backward (training; the TPU kernel has none, ``repro`` differentiates its
plain path, and ``_rms_bwd`` of ``src/repro/models/layers.py:68-80`` is the
math): ``rmsnorm_bwd_triton``. With ``return_inv`` the forward also writes
each row's float32 ``inv = rsqrt(mean x^2 + eps)``; the backward reads x, g
and inv once and writes dx = inv * (g*s - x * mean(g*s*x) * inv^2) in x's
dtype, bound by bytes like the forward (x, g and dx: 3 * rows * d * itemsize).
dscale = sum over rows of g * x * inv: each of ``bwd_plan``'s programs (two
an SM) walks a strided set of row blocks, keeps its column sums in
registers and writes one float32 row of partials; a second Triton pass of
32-column programs sums those rows per column and casts to scale's dtype.
Four programs an SM and 128-column sum programs (eight at granite's d
1024) spent a third of the time in that pass; one launch, whose last
program finishes the column sums, was timed in two forms and not kept
(``tools/time_rmsnorm_bwd.py``, ``PERF.md`` §6).
"""

from __future__ import annotations

import torch

from ..precision import widen


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,). float32 statistics (float64 for float64 x),
    output in x's dtype."""
    xf = widen(x)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.to(xf.dtype)).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor, *,
                      eps: float = 1e-5):
    """``_rms_bwd`` of ``repro``'s ``rmsnorm_bf16bwd``: (dx in x's dtype,
    dscale in scale's dtype) for the output gradient ``g``."""
    xf, gf = widen(x), widen(g)
    var = xf.square().mean(-1, keepdim=True) + eps
    inv = torch.rsqrt(var)
    gs = gf * scale.to(xf.dtype)
    proj = (gs * xf).mean(-1, keepdim=True) / var
    dx = (inv * (gs - xf * proj)).to(x.dtype)
    dscale = (gf * xf * inv).reshape(-1, x.shape[-1]).sum(0)
    return dx, dscale.to(scale.dtype)


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
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, inv_ptr, rows, d, eps,
                       BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr, WRITE_INV: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.arange(0, BLOCK_D)
        rmask = r < rows
        cmask = c < d
        mask = rmask[:, None] & cmask[None, :]
        offs = r.to(tl.int64)[:, None] * d + c[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / d
        inv = 1.0 / tl.sqrt(var + eps)
        y = x * inv[:, None] * s[None, :]
        tl.store(o_ptr + offs, y.to(o_ptr.dtype.element_ty), mask=mask)
        if WRITE_INV:
            tl.store(inv_ptr + r, inv, mask=rmask)

    @triton.jit
    def rmsnorm_bwd_kernel(x_ptr, s_ptr, g_ptr, inv_ptr, dx_ptr, part_ptr, rows, d,
                           BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        step = tl.num_programs(0) * BLOCK_R
        c = tl.arange(0, BLOCK_D)
        cmask = c < d
        s = tl.load(s_ptr + c, mask=cmask, other=0.0).to(tl.float32)
        acc = tl.zeros((BLOCK_R, BLOCK_D), dtype=tl.float32)
        for start in range(pid * BLOCK_R, rows, step):
            r = start + tl.arange(0, BLOCK_R)
            rmask = r < rows
            mask = rmask[:, None] & cmask[None, :]
            offs = r.to(tl.int64)[:, None] * d + c[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            inv = tl.load(inv_ptr + r, mask=rmask, other=0.0)
            gs = g * s[None, :]
            proj = tl.sum(gs * x, axis=1) / d * inv * inv          # mean(gs x) / var
            dx = inv[:, None] * (gs - x * proj[:, None])
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)
            acc += g * x * inv[:, None]
        tl.store(part_ptr + pid * d + c, tl.sum(acc, axis=0), mask=cmask)

    @triton.jit
    def colsum_kernel(part_ptr, out_ptr, n, d, BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        c = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = c < d
        acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
        for start in range(0, n, BLOCK_N):
            r = start + tl.arange(0, BLOCK_N)
            m = (r < n)[:, None] & cmask[None, :]
            acc += tl.sum(tl.load(part_ptr + r[:, None] * d + c[None, :], mask=m, other=0.0),
                          axis=0)
        tl.store(out_ptr + c, acc.to(out_ptr.dtype.element_ty), mask=cmask)

    _KERNELS = (triton, rmsnorm_kernel, rmsnorm_bwd_kernel, colsum_kernel)
    return _KERNELS


_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check(x, scale, what):
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError(f"{what} needs contiguous x and scale")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")


def _blocks(d: int):
    """Rows and (power-of-two) columns of a program's block, and its warps."""
    BLOCK_D = 1 << max(0, (d - 1).bit_length())
    BLOCK_R = max(1, min(64, 4096 // BLOCK_D))
    return BLOCK_R, BLOCK_D, 8 if BLOCK_D * BLOCK_R >= 4096 else 4


def rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5,
                   return_inv: bool = False):
    """Launch the Triton kernel on CUDA tensors. x: (..., d) contiguous. With
    ``return_inv`` also returns each row's float32 rsqrt(mean x^2 + eps),
    shaped like x without its last dim, for the backward."""
    _check(x, scale, "rmsnorm_triton")
    d = x.shape[-1]
    triton, kernel, _, _ = _kernels()
    rows = x.numel() // d
    out = torch.empty_like(x)
    # without return_inv the kernel never touches inv_ptr (WRITE_INV is a constexpr)
    inv = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) if return_inv else out
    if rows:
        BLOCK_R, BLOCK_D, num_warps = _blocks(d)
        grid = (triton.cdiv(rows, BLOCK_R),)
        kernel[grid](x, scale, out, inv, rows, d, eps,
                     BLOCK_R=BLOCK_R, BLOCK_D=BLOCK_D, WRITE_INV=return_inv,
                     num_warps=num_warps)
    return (out, inv) if return_inv else out


def bwd_plan(rows: int, d: int, n_sm: int) -> dict:
    """The backward's launch: row block and column width (as the forward's),
    programs (each writes one float32 row of column partials; two an SM, no
    more than there are row blocks) and the column width of the pass that
    sums the partials."""
    BLOCK_R, BLOCK_D, num_warps = _blocks(d)
    nprog = max(1, min(-(-rows // BLOCK_R), 2 * n_sm))
    return {"BLOCK_R": BLOCK_R, "BLOCK_D": BLOCK_D, "num_warps": num_warps, "nprog": nprog,
            "colsum_block": 32}


def rmsnorm_bwd_triton(x: torch.Tensor, scale: torch.Tensor, g: torch.Tensor,
                       inv: torch.Tensor, *, plan: dict | None = None):
    """Launch the backward: (dx in x's dtype, dscale in scale's dtype) for the
    output gradient ``g`` and the forward's ``inv``. All contiguous CUDA.
    ``plan`` (``bwd_plan``'s keys) overrides the launch, for timing
    variants."""
    _check(x, scale, "rmsnorm_bwd_triton")
    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous() or not g.is_cuda:
        raise ValueError("rmsnorm_bwd_triton: g must be a contiguous CUDA tensor like x")
    if inv.shape != x.shape[:-1] or inv.dtype != torch.float32 or not inv.is_contiguous():
        raise ValueError("rmsnorm_bwd_triton: inv must be float32 shaped like x[..., 0]")
    d = x.shape[-1]
    triton, _, bwd, colsum = _kernels()
    rows = x.numel() // d
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    p = plan or bwd_plan(rows, d, sms)
    nprog, bc = p["nprog"], p["colsum_block"]
    part = torch.empty((nprog, d), dtype=torch.float32, device=x.device)
    bwd[(nprog,)](x, scale, g, inv, dx, part, rows, d,
                  BLOCK_R=p["BLOCK_R"], BLOCK_D=p["BLOCK_D"], num_warps=p["num_warps"])
    colsum[(triton.cdiv(d, bc),)](part, dscale, nprog, d, BLOCK_N=32, BLOCK_C=bc, num_warps=4)
    return dx, dscale
