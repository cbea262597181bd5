"""Mamba2 SSD intra-chunk block: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel, ``csrc/ssd_intra_chunk.cu``, replaces the TPU kernel
``src/repro/kernels/ssd_scan.py:ssd_intra_chunk``. On the H100 its bound
is the bytes (la, C, B and x read once, y and the states written once); its
three products run on the tensor cores (mma.sync, TF32 operands split hi/lo
for float32 accuracy), and its header says how. It
reads la and x in their natural layouts (the TPU wrapper transposed both)
and computes C . B^T once for a group of heads. The inter-chunk scan stays
in the model code (``models/mamba2.ssd_chunked``).

Backward (training; the TPU kernel has none, ``repro`` differentiates
through it): ``csrc/ssd_intra_chunk_bwd.cu``, launched by
``ssd_intra_chunk_bwd_cuda``, whose plain version is
``ssd_intra_chunk_bwd_plain``: autograd through ``ssd_intra_chunk_plain``.
Its header says what bounds it and how it is built.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..precision import widen
from . import build

MAX_HEADS_PER_BLOCK = 16
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_intra_chunk_fwd": [_P] * 7 + [_I] * 6 + [_P]}
_BWD_SIGNATURES = {"ssd_intra_chunk_bwd": [_P] * 13 + [_I] * 6 + [_P]}
BWD_MAX_Q, BWD_MAX_N = 128, 64      # the backward kernel's limits (any Q, N % 4 == 0)


def ssd_intra_chunk_plain(la: torch.Tensor, C: torch.Tensor, B_in: torch.Tensor,
                          x: torch.Tensor):
    """la: (B,nc,Q,H) log-decay; C/B_in: (B,nc,Q,N); x: (B,nc,Q,H,P).

    Returns (y (B,nc,Q,H,P), states (B,nc,H,P,N), tot (B,nc,H)) in float32,
    or in float64 where the inputs are float64 (an oracle for the kernel).
    """
    la, C, B_in, x = (widen(t) for t in (la, C, B_in, x))
    Q = la.shape[2]
    L = torch.cumsum(la, dim=2)
    CB = torch.einsum("bcqn,bcsn->bcqs", C, B_in)
    seg = L[:, :, :, None, :] - L[:, :, None, :, :]              # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=la.device))
    # masked before the exp: above the diagonal seg > 0 may overflow, and the
    # gradient of where(mask, exp(seg), 0) would then be 0 * inf
    seg = torch.where(tri[None, None, :, :, None], seg, float("-inf"))
    M = torch.exp(seg) * CB[..., None]
    y = torch.einsum("bcqsh,bcshp->bcqhp", M, x)
    tot = L[:, :, -1, :]
    w_end = torch.exp(tot[:, :, None, :] - L)
    st = torch.einsum("bcqh,bcqhp,bcqn->bchpn", w_end, x, B_in)
    return y, st, tot


def ssd_intra_chunk_bwd_plain(la: torch.Tensor, C: torch.Tensor, B_in: torch.Tensor,
                              x: torch.Tensor, dy: torch.Tensor, dstates: torch.Tensor,
                              dtot: torch.Tensor):
    """Autograd through ``ssd_intra_chunk_plain``: the gradients (dla, dC, dB,
    dx) of <y, dy> + <states, dstates> + <tot, dtot>, in float32, or float64
    where the inputs are float64."""
    with torch.enable_grad():
        ins = [widen(t.detach()).requires_grad_() for t in (la, C, B_in, x)]
        outs = ssd_intra_chunk_plain(*ins)
        return torch.autograd.grad(outs, ins, [g.to(o.dtype) for g, o in
                                               zip((dy, dstates, dtot), outs)])


def heads_per_block(BC: int, H: int, n_sm: int, max_heads: int = MAX_HEADS_PER_BLOCK) -> int:
    """Heads a block serves: fewest waves of one-block-per-SM blocks over the
    card, each block paying for one C . B^T (about one head's work) besides
    its heads; at most ``max_heads`` (the forward's shared memory and scan
    take ``MAX_HEADS_PER_BLOCK``)."""
    def cost(hg):
        waves = math.ceil(BC * math.ceil(H / hg) / n_sm)
        return waves * (hg + 1)
    return min(range(1, min(H, max_heads) + 1), key=cost)


BWD_BLOCK_COST = 2


def bwd_heads_per_block(BC: int, H: int, n_sm: int) -> int:
    """Heads a backward block serves: fewest waves of one-block-per-SM
    blocks (the kernel's shared memory allows one) over the card, each block
    paying besides its heads about ``BWD_BLOCK_COST`` heads' time: C . B^T,
    the first head's copy that nothing overlaps, and its dCB and dB
    partials (Q^2 + Q N floats, about a head's bytes), which the second
    kernel reads back. Any group size up to H: a block keeps no per-head
    state."""
    def cost(hg):
        return math.ceil(BC * math.ceil(H / hg) / n_sm) * (hg + BWD_BLOCK_COST)
    return min(range(1, H + 1), key=cost)


def check_inputs(la: torch.Tensor, C: torch.Tensor, B_in: torch.Tensor, x: torch.Tensor,
                 q_multiple: int = 8):
    """Raise ValueError unless the tensors are what the kernel takes: float32,
    contiguous and 16-byte aligned, la (B,nc,Q,H), C/B_in (B,nc,Q,N),
    x (B,nc,Q,H,P) with Q % q_multiple == 0 (8 for the forward, 1 for the
    backward), Q <= 128, N % 4 == 0, P % 4 == 0. Returns (B, nc, Q, H, N, P)."""
    ts = (la, C, B_in, x)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("ssd_intra_chunk_cuda takes float32 tensors")
    if la.dim() != 4 or C.dim() != 4 or x.dim() != 5 or C.shape != B_in.shape:
        raise ValueError(f"bad shapes la {tuple(la.shape)} C {tuple(C.shape)} "
                         f"B {tuple(B_in.shape)} x {tuple(x.shape)}")
    Bs, nc, Q, H = la.shape
    N, P = C.shape[-1], x.shape[-1]
    if C.shape[:3] != (Bs, nc, Q) or x.shape[:4] != (Bs, nc, Q, H):
        raise ValueError(f"la {tuple(la.shape)}, C {tuple(C.shape)} and x {tuple(x.shape)} "
                         "do not match")
    if Q % q_multiple or Q > 128 or N % 4 or P % 4:
        raise ValueError(f"ssd_intra_chunk_cuda takes Q % {q_multiple} == 0, Q <= 128, "
                         f"N % 4 == 0 and P % 4 == 0; got Q {Q}, N {N}, P {P}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("ssd_intra_chunk_cuda needs contiguous, 16-byte aligned tensors")
    return Bs, nc, Q, H, N, P


def ssd_intra_chunk_cuda(la: torch.Tensor, C: torch.Tensor, B_in: torch.Tensor,
                         x: torch.Tensor):
    """Launch the CUDA kernel on PyTorch's current stream. Takes CUDA tensors
    that pass ``check_inputs``."""
    if not all(t.is_cuda for t in (la, C, B_in, x)):
        raise ValueError("ssd_intra_chunk_cuda takes CUDA tensors")
    Bs, nc, Q, H, N, P = check_inputs(la, C, B_in, x)
    lib = build.library("ssd_intra_chunk", _SIGNATURES)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    hg = heads_per_block(Bs * nc, H, n_sm)
    y = torch.empty_like(x)
    st = torch.empty((Bs, nc, H, P, N), dtype=torch.float32, device=x.device)
    tot = torch.empty((Bs, nc, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_intra_chunk_fwd(
            la.data_ptr(), C.data_ptr(), B_in.data_ptr(), x.data_ptr(), y.data_ptr(),
            st.data_ptr(), tot.data_ptr(), Bs * nc, Q, H, N, P, hg,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd_intra_chunk_fwd")
    return y, st, tot


def ssd_intra_chunk_bwd_cuda(la: torch.Tensor, C: torch.Tensor, B_in: torch.Tensor,
                             x: torch.Tensor, dy: torch.Tensor, dstates: torch.Tensor,
                             dtot: torch.Tensor, heads_per_group: int | None = None):
    """Launch the backward kernels on PyTorch's current stream: (dla, dC, dB,
    dx) for the output gradients ``dy`` (like x), ``dstates`` (B,nc,H,P,N)
    and ``dtot`` (B,nc,H). Takes CUDA tensors that pass ``check_inputs``
    with any Q <= 128, and N <= 64. ``heads_per_group`` overrides
    ``bwd_heads_per_block``'s plan."""
    ts = (la, C, B_in, x, dy, dstates, dtot)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssd_intra_chunk_bwd_cuda takes CUDA tensors")
    Bs, nc, Q, H, N, P = check_inputs(la, C, B_in, x, q_multiple=1)
    if Q > BWD_MAX_Q or N > BWD_MAX_N:
        raise ValueError(f"ssd_intra_chunk_bwd_cuda takes Q <= {BWD_MAX_Q} and N <= "
                         f"{BWD_MAX_N}; got Q {Q}, N {N}")
    for name, t, shape in (("dy", dy, x.shape), ("dstates", dstates, (Bs, nc, H, P, N)),
                           ("dtot", dtot, (Bs, nc, H))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"ssd_intra_chunk_bwd_cuda: {name} must be contiguous, 16-byte "
                             f"aligned float32 {tuple(shape)}, got {tuple(t.shape)} {t.dtype}")
    BC = Bs * nc
    lib = build.library("ssd_intra_chunk_bwd", _BWD_SIGNATURES)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    hg = heads_per_group or bwd_heads_per_block(BC, H, n_sm)
    ngrp, Qp = math.ceil(H / hg), -(-Q // 16) * 16
    dla, dC, dB, dx = (torch.empty_like(t) for t in (la, C, B_in, x))
    f32 = dict(dtype=torch.float32, device=x.device)
    part_dcb = torch.empty((BC, ngrp, Qp, Qp), **f32)
    part_dbh = torch.empty((BC, ngrp, Qp, N), **f32)
    with torch.cuda.device(x.device):
        err = lib.ssd_intra_chunk_bwd(
            la.data_ptr(), C.data_ptr(), B_in.data_ptr(), x.data_ptr(), dy.data_ptr(),
            dstates.data_ptr(), dtot.data_ptr(), dla.data_ptr(), dx.data_ptr(), dC.data_ptr(),
            dB.data_ptr(), part_dcb.data_ptr(), part_dbh.data_ptr(), BC, Q, H, N, P, hg,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd_intra_chunk_bwd")
    return dla, dC, dB, dx
