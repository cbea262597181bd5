"""Mamba2 (SSD) mixer: chunked parallel form for prefill, O(1)-state
recurrent form for decode (arXiv:2405.21060).

The port of ``src/repro/models/mamba2.py``, serving and training. Recurrence
(heads H, head dim P, state N, chunk Q):
    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)        h: (H, P, N)
    y_t = C_t · h_t + D * x_t
with a_t = exp(dt_t * A), A = -exp(A_log) < 0. B and C come in ``ssm_groups``
groups (Mamba2's n_groups; head h reads group h // (H/G)), and the gated
norm after the scan normalises each group's d_inner / G channels apart.

The causal conv with its bias and SiLU goes through
``kernels.ops.causal_conv_silu`` and the intra-chunk block through
``kernels.ops.ssd_intra_chunk`` (the Triton and CUDA kernels on the card,
reading the conv's input in place in the ``in_proj`` output; their plain
versions on the CPU; under autograd on the card their backward kernels
too); the inter-chunk scan (``carry_states``) is, in
training, one product with the chunks' decays for each block of up to 64
chunks, and otherwise a loop over the chunks. Two
differences from ``repro``: the prefill form also returns the layer's decode
state (the raw conv tail and the final SSM state, which ``repro``'s
``hybrid.prefill`` recomputes inline), and the decode form updates the
cache's tensors IN PLACE where JAX returns new ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..hints import constrain
from ..kernels import ops, sharded
from ..precision import compute_dtype, widen
from ..spans import span, tally
from .layers import dense, dense_init, norm


def groups(cfg) -> int:
    """B/C groups: ``cfg.ssm_groups``; 1 for ``repro``'s configs, which the
    parity tests pass in and which have no such field."""
    return getattr(cfg, "ssm_groups", 1)


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_channels) rolling conv input window
    h: torch.Tensor       # (B, H, P, N) SSM state, float32


def mamba_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    """Random params on ``gen``'s device. dt_bias, A_log and D are float32
    whatever ``dtype`` is, as in ``repro``."""
    d, di, N, H, W = (cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_conv_width)
    GN = groups(cfg) * N
    conv_ch = di + 2 * GN
    dev = gen.device
    conv_w = torch.randn((W, conv_ch), generator=gen, device=dev) * (W ** -0.5)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * GN + H, dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "gnorm": {"scale": torch.ones((di,), dtype=dtype, device=dev)},
        "out_proj": dense_init(gen, di, d, dtype=dtype),
    }


def conv_tail_of(x: torch.Tensor, W: int) -> torch.Tensor:
    """The decode state's last W-1 conv inputs of x (B, S, Ch): a slice of x,
    left-padded with the zeros the causal conv pads with where S < W-1."""
    S = x.shape[1]
    return x[:, S - (W - 1):] if S >= W - 1 else F.pad(x, (0, 0, W - 1 - S, 0))


def ssd_chunked(x, dt, A, B_in, C_in, Q: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    B_in/C_in: (B, S, G, N), G groups of heads (head h reads group
    h // (H/G); G = 1 shares one across all heads).
    Returns y: (B, S, H, P) in x's dtype and the final state (B, H, P, N).
    """
    Bsz, S, H, P = x.shape
    G, N = B_in.shape[2:]
    S_orig = S
    if S % Q:
        # pad the tail with identity steps: dt=0 -> a=1, xbar=0 -> state unchanged
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_in = F.pad(B_in, (0, 0, 0, 0, 0, pad))
        C_in = F.pad(C_in, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    tally(chunks=Bsz * nc)

    # log a_t, its heads laid out as x's (a slice where dt is whole)
    lac = constrain(widen(dt * A).reshape(Bsz, nc, Q, H), "dp", None, None, "model").contiguous()
    xc = widen(dt[..., None] * x).reshape(Bsz, nc, Q, H, P).contiguous()
    Bc = widen(B_in).reshape(Bsz, nc, Q, G, N).contiguous()
    Cc = widen(C_in).reshape(Bsz, nc, Q, G, N).contiguous()
    y_intra, states, _ = ops.ssd_intra_chunk(lac, Cc, Bc, xc)

    # inter-chunk scan over h: h_prevs[:, c] is the state entering chunk c
    L = torch.cumsum(lac, dim=2)                                         # (B,nc,Q,H)
    h = torch.zeros((Bsz, H, P, N), dtype=compute_dtype(x.dtype), device=x.device) \
        if h0 is None else widen(h0)
    h_prevs, h = carry_states(states, L[:, :, -1, :], h)

    # y_inter[t] = exp(L_t) * C_t · h_prev (C_t of the head's group)
    y_inter = torch.einsum("bcqgn,bcgjpn->bcqgjp", Cc,
                           h_prevs.reshape(Bsz, nc, G, H // G, P, N)).reshape(Bsz, nc, Q, H, P)
    y_inter = y_inter * torch.exp(L)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S_orig]
    return y.to(x.dtype), h


# chunks a product carries at once, so its work grows with the row's length,
# not with its square
CARRY_BLOCK = 64


def carry_states(states: torch.Tensor, tot: torch.Tensor, h0: torch.Tensor):
    """The inter-chunk scan: each chunk's own end state ``states``
    (B,nc,H,P,N) carried across the chunks by their total log decays ``tot``
    (B,nc,H), from the state ``h0`` (B,H,P,N). Returns (h_prevs (B,nc,H,P,N),
    the state entering each chunk; the state after the last (B,H,P,N)).

    Where autograd records it (training), block by block: each block of up
    to ``CARRY_BLOCK`` chunks is one product (``_carry_block``) from the
    state entering it, whose backward is a few products where ``repro``'s
    chunk loop leaves two small ops a chunk; on an H100 the scan's forward
    and backward ran 1.1-3.1x faster so, at 1-8 rows of 8-64 chunks.
    Otherwise (prefill) the chunk loop, whose forward alone ran faster at
    4-8 rows and within 0.6 ms at 1-2 rows. Every (batch row, head) is carried
    apart, so on a mesh it runs on each rank's batch and head shards
    (``kernels.sharded.batch_heads``)."""
    if isinstance(states, DTensor):
        return sharded.batch_heads(carry_states, (states, tot, h0), (2, 2, 1), (2, 1))
    nc = tot.shape[1]
    if not states.requires_grad:
        decay, entering, h = torch.exp(tot), [], h0
        for c in range(nc):
            entering.append(h)
            h = decay[:, c, :, None, None] * h + states[:, c]
        return torch.stack(entering, dim=1), h
    entering, h = [], h0
    for c in range(0, nc, CARRY_BLOCK):
        h_prevs, h = _carry_block(states[:, c:c + CARRY_BLOCK], tot[:, c:c + CARRY_BLOCK], h)
        entering.append(h_prevs)
    return torch.cat(entering, dim=1) if len(entering) > 1 else entering[0], h


def _carry_block(states: torch.Tensor, tot: torch.Tensor, h0: torch.Tensor):
    """``carry_states`` over nc chunks in one product:

        h_c = exp(tot_0 + ... + tot_{c-1}) h0
              + sum_{j<c} exp(tot_{j+1} + ... + tot_{c-1}) states_j

    for c = 0..nc, the (nc+1)^2 decays summed from the chunks' own totals
    (no difference of long running sums, which would lose digits), as
    ``repro``'s chunk loop computes h_c one chunk at a time."""
    Bsz, nc, H = tot.shape
    T = nc + 1
    x = F.pad(tot, (0, 0, 1, 0)).transpose(1, 2)                         # (B,H,T): 0, tot_0, ..
    ones = torch.ones((T, T), dtype=torch.bool, device=tot.device)
    # seg[c, j] = x_{j+1} + ... + x_c, a running sum over c of the x_c below j
    seg = torch.cumsum(x[..., None].expand(Bsz, H, T, T).masked_fill(~ones.tril(-1), 0.0), dim=-2)
    decay = torch.exp(seg.masked_fill(~ones.tril(), float("-inf")))      # [c, j], j <= c
    out = torch.einsum("bhcj,bjhpn->bchpn", decay, torch.cat([h0[:, None], states], dim=1))
    return out[:, :nc], out[:, nc]


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, *, cache: MambaCache | None = None):
    """One mamba2 mixer. x: (B, S, d). Returns (out, state).

    Without ``cache`` (prefill) the state is a new MambaCache: the last W-1
    conv inputs before the conv and the final SSM state. With ``cache``
    (decode, S = 1) the cache's tensors are updated in place and returned.
    """
    Bsz, S, d = x.shape
    di, N, H, P, W, G = (cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_conv_width, groups(cfg))
    if cache is not None and G > 1:
        raise ValueError("decode takes one B/C group only")

    zxbcdt = dense(p["in_proj"], x)
    z, xBC, dt_raw = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)

    if cache is None:
        conv_tail = conv_tail_of(xBC, W)
        xBC = ops.causal_conv_silu(xBC, p["conv_w"], p["conv_b"])
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got S={S}")
        window = torch.cat([cache.conv, xBC], dim=1)                    # (B, W, Ch)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
        xBC = F.silu(conv_out)[:, None, :]
        cache.conv.copy_(window[:, 1:, :])

    xs, B_in, C_in = torch.split(xBC, [di, G * N, G * N], dim=-1)
    xs = constrain(xs.reshape(Bsz, S, H, P), "dp", None, "model", None)
    B_in = constrain(B_in.reshape(Bsz, S, G, N), "dp", None, None, None)
    C_in = constrain(C_in.reshape(Bsz, S, G, N), "dp", None, None, None)
    dt = F.softplus(widen(dt_raw) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None:
        with span("mamba.ssd"):
            y, hT = ssd_chunked(xs, dt, A, B_in, C_in, cfg.ssm_chunk)
        state = MambaCache(conv=conv_tail, h=hT)
    else:
        a = torch.exp(dt * A)                                           # (B,1,H)
        xbar = widen(dt[..., None] * xs)                                # (B,1,H,P)
        dh = torch.einsum("bhp,bn->bhpn", xbar[:, 0], widen(B_in[:, 0, 0]))
        cache.h.mul_(a[:, 0, :, None, None]).add_(dh)
        y = torch.einsum("bn,bhpn->bhp", widen(C_in[:, 0, 0]), cache.h)
        y = y[:, None].to(x.dtype)
        state = cache

    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(Bsz, S, di)
    y = gated_norm(p["gnorm"], y, z, G, cfg.norm_eps)
    return dense(p["out_proj"], y), state


def gated_norm(p, y: torch.Tensor, z: torch.Tensor, G: int, eps: float) -> torch.Tensor:
    """rmsnorm of y * silu(z), each of the G groups of channels on its own:
    one group through ``norm``; G groups normalised by the kernel with a unit
    scale, then times the scale, as Zamba2's ``RMSNormGated`` rounds."""
    g = y * F.silu(z)
    if G == 1:
        return norm(p, g, eps)
    Bsz, S, di = g.shape
    unit = {"scale": torch.ones(di // G, dtype=g.dtype, device=g.device)}
    return norm(unit, g.reshape(Bsz, S, G, di // G), eps).reshape(Bsz, S, di) * p["scale"]


def empty_mamba_cache(cfg: ModelConfig, B: int, dtype, device=None) -> MambaCache:
    di, N, H, P, W = (cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_conv_width)
    return MambaCache(
        conv=torch.zeros((B, W - 1, di + 2 * groups(cfg) * N), dtype=dtype, device=device),
        h=torch.zeros((B, H, P, N), dtype=torch.float32, device=device),
    )
