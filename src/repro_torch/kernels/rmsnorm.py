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
"""

from __future__ import annotations

import torch


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); scale: (d,). float32 statistics, output in x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


_KERNEL = None
tl = None  # triton.language, bound on first use: the JIT reads it from globals


def _kernel():
    """Define the Triton kernel on first use (``triton`` exists only where a
    card does)."""
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, o_ptr, rows, d, eps,
                       BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
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

    _KERNEL = (triton, rmsnorm_kernel)
    return _KERNEL


def rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Launch the Triton kernel on CUDA tensors. x: (..., d) contiguous."""
    if not (x.is_cuda and scale.is_cuda):
        raise ValueError("rmsnorm_triton takes CUDA tensors")
    if not x.is_contiguous() or not scale.is_contiguous():
        raise ValueError("rmsnorm_triton needs contiguous x and scale")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"rmsnorm_triton: unsupported dtype {x.dtype}")
    triton, kernel = _kernel()
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    BLOCK_D = triton.next_power_of_2(d)
    BLOCK_R = max(1, min(64, 4096 // BLOCK_D))
    num_warps = 8 if BLOCK_D * BLOCK_R >= 4096 else 4
    grid = (triton.cdiv(rows, BLOCK_R),)
    kernel[grid](x, scale, out, rows, d, eps,
                 BLOCK_R=BLOCK_R, BLOCK_D=BLOCK_D, num_warps=num_warps)
    return out
