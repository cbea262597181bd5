"""Mamba2 (SSD) mixer: chunked parallel form for prefill, O(1)-state
recurrent form for decode (arXiv:2405.21060).

The port of ``src/repro/models/mamba2.py``, serving and training. Recurrence
(heads H, head dim P, state N, chunk Q):
    h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)        h: (H, P, N)
    y_t = C_t · h_t + D * x_t
with a_t = exp(dt_t * A), A = -exp(A_log) < 0.

The intra-chunk block goes through ``kernels.ops.ssd_intra_chunk`` (the CUDA
kernel on the card, its plain version on the CPU; under autograd on the card
its backward kernel too); the inter-chunk scan is a loop over the chunks,
differentiable as written (each chunk's entering state kept in a list and
stacked, no in-place write). Two differences from ``repro``: the prefill form also
returns the layer's decode state (the raw conv tail and the final SSM state,
which ``repro``'s ``hybrid.prefill`` recomputes inline), and the decode form
updates the cache's tensors IN PLACE where JAX returns new ones.
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
from .layers import dense, dense_init, norm


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_channels) rolling conv input window
    h: torch.Tensor       # (B, H, P, N) SSM state, float32


def mamba_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    """Random params on ``gen``'s device. dt_bias, A_log and D are float32
    whatever ``dtype`` is, as in ``repro``."""
    d, di, N, H, W = (cfg.d_model, cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads,
                      cfg.ssm_conv_width)
    conv_ch = di + 2 * N
    dev = gen.device
    conv_w = torch.randn((W, conv_ch), generator=gen, device=dev) * (W ** -0.5)
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * N + H, dtype=dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "gnorm": {"scale": torch.ones((di,), dtype=dtype, device=dev)},
        "out_proj": dense_init(gen, di, d, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, Ch); w: (W, Ch) -> (B, S, Ch), contiguous.

    ``repro``'s ``conv_general_dilated`` with WIO weights ``w[:, None, :]`` is a
    cross-correlation, which is what ``F.conv1d`` computes with the weight as
    (Ch, 1, W) from ``w.T``. On a DTensor it runs on each rank's batch and
    channel shards (``kernels.sharded.depthwise_conv``)."""
    if isinstance(x, DTensor):
        return sharded.depthwise_conv(x, w, b, local=_causal_conv)
    W = w.shape[0]
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))
    out = F.conv1d(xp, w.t().unsqueeze(1), groups=x.shape[-1])
    return (out.transpose(1, 2) + b).contiguous()


def ssd_chunked(x, dt, A, B_in, C_in, Q: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); A: (H,) negative;
    B_in/C_in: (B, S, N) (single group, shared across heads).
    Returns y: (B, S, H, P) in x's dtype and the final state (B, H, P, N).
    """
    Bsz, S, H, P = x.shape
    N = B_in.shape[-1]
    S_orig = S
    if S % Q:
        # pad the tail with identity steps: dt=0 -> a=1, xbar=0 -> state unchanged
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_in = F.pad(B_in, (0, 0, 0, pad))
        C_in = F.pad(C_in, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    # log a_t, its heads laid out as x's (a slice where dt is whole)
    lac = constrain(widen(dt * A).reshape(Bsz, nc, Q, H), "dp", None, None, "model").contiguous()
    xc = widen(dt[..., None] * x).reshape(Bsz, nc, Q, H, P).contiguous()
    Bc = widen(B_in).reshape(Bsz, nc, Q, N).contiguous()
    Cc = widen(C_in).reshape(Bsz, nc, Q, N).contiguous()
    y_intra, states, _ = ops.ssd_intra_chunk(lac, Cc, Bc, xc)

    # inter-chunk scan over h: h_prevs[:, c] is the state entering chunk c
    L = torch.cumsum(lac, dim=2)                                         # (B,nc,Q,H)
    decay = torch.exp(L[:, :, -1, :])                                    # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=compute_dtype(x.dtype), device=x.device) \
        if h0 is None else widen(h0)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    h_prevs = torch.stack(entering, dim=1)                               # (B,nc,H,P,N)

    # y_inter[t] = exp(L_t) * C_t · h_prev
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_prevs) * torch.exp(L)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)[:, :S_orig]
    return y.to(x.dtype), h


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, *, cache: MambaCache | None = None):
    """One mamba2 mixer. x: (B, S, d). Returns (out, state).

    Without ``cache`` (prefill) the state is a new MambaCache: the last W-1
    conv inputs before the conv and the final SSM state. With ``cache``
    (decode, S = 1) the cache's tensors are updated in place and returned.
    """
    Bsz, S, d = x.shape
    di, N, H, P, W = (cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_conv_width)

    zxbcdt = dense(p["in_proj"], x)
    z, xBC, dt_raw = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)

    if cache is None:
        # the last W-1 conv inputs, left-padded with the zeros _causal_conv
        # pads with when the prompt is shorter than W-1
        conv_tail = F.pad(xBC, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):, :]
        xBC = F.silu(_causal_conv(xBC, p["conv_w"], p["conv_b"]))
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got S={S}")
        window = torch.cat([cache.conv, xBC], dim=1)                    # (B, W, Ch)
        conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
        xBC = F.silu(conv_out)[:, None, :]
        cache.conv.copy_(window[:, 1:, :])

    xs, B_in, C_in = torch.split(xBC, [di, N, N], dim=-1)
    xs = constrain(xs.reshape(Bsz, S, H, P), "dp", None, "model", None)
    B_in = constrain(B_in, "dp", None, None)
    C_in = constrain(C_in, "dp", None, None)
    dt = F.softplus(widen(dt_raw) + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    if cache is None:
        y, hT = ssd_chunked(xs, dt, A, B_in, C_in, cfg.ssm_chunk)
        state = MambaCache(conv=conv_tail, h=hT)
    else:
        a = torch.exp(dt * A)                                           # (B,1,H)
        xbar = widen(dt[..., None] * xs)                                # (B,1,H,P)
        dh = torch.einsum("bhp,bn->bhpn", xbar[:, 0], widen(B_in[:, 0]))
        cache.h.mul_(a[:, 0, :, None, None]).add_(dh)
        y = torch.einsum("bn,bhpn->bhp", widen(C_in[:, 0]), cache.h)
        y = y[:, None].to(x.dtype)
        state = cache

    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(Bsz, S, di)
    y = norm(p["gnorm"], y * F.silu(z), cfg.norm_eps)
    return dense(p["out_proj"], y), state


def empty_mamba_cache(cfg: ModelConfig, B: int, dtype, device=None) -> MambaCache:
    di, N, H, P, W = (cfg.d_inner_ssm, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_conv_width)
    return MambaCache(
        conv=torch.zeros((B, W - 1, di + 2 * N), dtype=dtype, device=device),
        h=torch.zeros((B, H, P, N), dtype=torch.float32, device=device),
    )
