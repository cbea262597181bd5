"""Fused AdamW: one Triton pass a leaf for the update, one for the clip's sum
of squares, and their plain PyTorch versions.

No TPU kernel is replaced: ``src/repro/optim/adamw.py`` is plain JAX, and
under ``jit`` XLA fuses its elementwise update into one loop a leaf. Eager
PyTorch runs the same formula as about eighteen float32 passes a leaf, each
reading and writing temporaries as large as the leaf (~172 B an element).

What bounds it on the H100: bytes; a handful of flops an element, no reuse.
The update reads the gradient (2 B in bf16) and the float32 m, v and master
weight (12 B) and writes m, v, the master weight and the param (12 + 2 B):
28 B an element, ``(2 * g + 24 + p) * n / 3.35 TB/s`` in general. The sum of
squares reads the gradient once: ``g * n / 3.35 TB/s``.

Design: ``adamw_kernel`` gives each program one block of ``BLOCK`` elements
(a grid over the leaf, the tail masked), every stream read and written once
with evict-first hints, since nothing is read again. The arithmetic is the
plain version's, in its order and float32 roundings: the divisions and the
square root correctly rounded (``div_rn``, ``sqrt_rn``) and no multiply-add
contracted (``enable_fp_fusion=False``), as PyTorch's own kernels compute
each pass, so the fused step gives the plain loop's bits. The clip scale,
lr and the two bias corrections stay on the device: the kernel reads them
from a float32 (4,) tensor, so nothing is read back to the host.
``sumsq_kernel`` runs a fixed number of programs over the leaf in a
grid-stride loop, each keeping a float32 block of sums in registers and
writing one partial into its row of a zeroed (leaves, programs) buffer; the
buffer is then summed by one reduction. No atomics: the norm is the same
bits in every call.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def adamw_plain(g, m, v, mw, hyper, *, b1: float, b2: float, eps: float,
                weight_decay: float) -> None:
    """One AdamW step of one leaf, in place on the float32 ``m``, ``v`` and
    master weights ``mw`` (plain tensors or DTensors in one layout).
    ``hyper`` holds (clip scale, lr, bias correction 1, bias correction 2)
    as float32 scalars on the leaf's device. The caller casts ``mw`` into the
    param."""
    scale, lr, bc1, bc2 = hyper
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_(((1 - b2) * g).mul_(g))
    # lr * (mhat / (sqrt(vhat) + eps) + wd * mw), temporaries reused
    upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps)).add_(weight_decay * mw)
    mw.sub_(upd.mul_(lr))


def grad_sumsq_plain(grads: list) -> torch.Tensor:
    """The sum over the leaves of sum(g^2), in float32. On a DTensor it is
    the whole tensor's on every rank (a rank clipping by its own shard's norm
    would drift from the others without an error)."""
    total = None
    for g in grads:
        if isinstance(g, DTensor):
            sq = g.float().square().sum().full_tensor()
        else:
            gf = g.reshape(-1).float()
            sq = torch.dot(gf, gf)
        total = sq if total is None else total + sq
    return total


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
    def adamw_kernel(g_ptr, m_ptr, v_ptr, w_ptr, p_ptr, h_ptr, n, b1, b2, c1, c2, eps, wd,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        scale = tl.load(h_ptr)
        lr = tl.load(h_ptr + 1)
        bc1 = tl.load(h_ptr + 2)
        bc2 = tl.load(h_ptr + 3)
        g = tl.load(g_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        m = tl.load(m_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        v = tl.load(v_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        w = tl.load(w_ptr + offs, mask=mask, other=0.0, eviction_policy="evict_first")
        g = g.to(tl.float32) * scale
        m = m * b1 + c1 * g
        v = v * b2 + (c2 * g) * g
        den = tl.sqrt_rn(tl.div_rn(v, bc2)) + eps
        w = w - (tl.div_rn(tl.div_rn(m, bc1), den) + wd * w) * lr
        tl.store(m_ptr + offs, m, mask=mask, eviction_policy="evict_first")
        tl.store(v_ptr + offs, v, mask=mask, eviction_policy="evict_first")
        tl.store(w_ptr + offs, w, mask=mask, eviction_policy="evict_first")
        tl.store(p_ptr + offs, w.to(p_ptr.dtype.element_ty), mask=mask,
                 eviction_policy="evict_first")

    @triton.jit
    def sumsq_kernel(g_ptr, out_ptr, n, iters, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        nprog = tl.num_programs(0)
        acc = tl.zeros((BLOCK,), dtype=tl.float32)
        for i in range(iters):
            offs = (i * nprog + pid).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            x = tl.load(g_ptr + offs, mask=offs < n, other=0.0,
                        eviction_policy="evict_first").to(tl.float32)
            acc += x * x
        tl.store(out_ptr + pid, tl.sum(acc, axis=0))

    _KERNELS = (triton, adamw_kernel, sumsq_kernel)
    return _KERNELS


DTYPES = (torch.float32, torch.bfloat16)       # of the gradient and the param
# The launches, from sweeps on an H100 at phi4-mini's embedding and stacked
# layer leaf (PERF.md's kernel findings): the update's blocks of 1,024 to
# 8,192 elements on 4 to 16 warps all read 88-89% of the bytes bound; the sum
# of squares reads 65-67% of it with two programs an SM, 89-90% with four,
# 90-93% with eight.
ADAMW_BLOCK, ADAMW_WARPS = 2048, 8
SUMSQ_BLOCK, SUMSQ_WARPS, SUMSQ_PROGRAMS_PER_SM = 4096, 8, 8


def _check_leaf(t, what: str, dtypes) -> None:
    if isinstance(t, DTensor) or not t.is_cuda:
        raise ValueError(f"{what} takes plain CUDA tensors")
    if not t.is_contiguous():
        raise ValueError(f"{what} needs contiguous tensors")
    if t.dtype not in dtypes:
        raise ValueError(f"{what}: unsupported dtype {t.dtype}")


def adamw_triton(g, m, v, mw, p, hyper, *, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """Launch the fused update of one leaf on CUDA tensors: ``g`` (bf16 or
    float32), float32 ``m``, ``v``, ``mw`` updated in place and ``p`` (bf16
    or float32) written from the new ``mw``; all contiguous and of one
    shape. ``hyper``: float32 (4,) on the same device, (clip scale, lr, bias
    correction 1, bias correction 2)."""
    _check_leaf(g, "adamw_triton", DTYPES)
    _check_leaf(p, "adamw_triton", DTYPES)
    for t in (m, v, mw):
        _check_leaf(t, "adamw_triton", (torch.float32,))
    for t in (m, v, mw, p):
        if t.shape != g.shape or t.device != g.device:
            raise ValueError(f"adamw_triton: shapes or devices differ: {tuple(g.shape)} on "
                             f"{g.device} against {tuple(t.shape)} on {t.device}")
    if hyper.shape != (4,) or hyper.dtype != torch.float32 or hyper.device != g.device:
        raise ValueError("adamw_triton: hyper must be float32 (4,) on the leaves' device")
    triton, kernel, _ = _kernels()
    n = g.numel()
    grid = (max(1, triton.cdiv(n, ADAMW_BLOCK)),)
    kernel[grid](g, m, v, mw, p, hyper, n, b1, b2, 1 - b1, 1 - b2, eps, weight_decay,
                 BLOCK=ADAMW_BLOCK, num_warps=ADAMW_WARPS, enable_fp_fusion=False)


def grad_sumsq_triton(grads: list) -> torch.Tensor:
    """The float32 sum over the leaves of sum(g^2) on contiguous CUDA
    tensors of one device, one launch a leaf."""
    for g in grads:
        _check_leaf(g, "grad_sumsq_triton", DTYPES)
        if g.device != grads[0].device:
            raise ValueError("grad_sumsq_triton: the leaves lie on more than one device")
    triton, _, kernel = _kernels()
    dev = grads[0].device
    programs = SUMSQ_PROGRAMS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.zeros((len(grads), programs), dtype=torch.float32, device=dev)
    for row, g in zip(part, grads):
        n = g.numel()
        blocks = triton.cdiv(n, SUMSQ_BLOCK)
        nprog = max(1, min(blocks, programs))
        kernel[(nprog,)](g, row, n, triton.cdiv(blocks, nprog),
                         BLOCK=SUMSQ_BLOCK, num_warps=SUMSQ_WARPS)
    return part.sum()
