"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, chunked-parallel
for training and prefill, O(1) state for decode) and sLSTM (scalar memory
with exponential gating and a per-head recurrence, a loop over time).

The port of ``src/repro/models/xlstm.py``. Stabilisation follows the paper:
a running log-scale ``m`` with ``h = num / max(|den|, exp(-m))`` for the
mLSTM and the max trick for the sLSTM's exponential input gate. Neither has
a kernel of its own (``repro`` has none): both are PyTorch ops and cuBLAS
products, in float32 (float64 for float64 inputs, ``precision.widen``), as
``repro`` computes them; the norms go through ``layers.norm`` (the rmsnorm
kernel on the card).

Three differences from ``repro``: the prefill forms also return the layer's
decode state (``repro``'s ``xlstm_model.prefill`` recomputes the mLSTM's
inline), the mLSTM's conv tail is left-padded with zeros to W-1 rows for a
prompt shorter than that (``repro`` keeps a short tail there), and the
decode forms update the cache's tensors IN PLACE where JAX returns new
ones. The sLSTM's recurrent weight and input pre-activations are widened
and laid out once, before its time loop (``recurrent_weight``,
``gate_inputs``), so that a step is one batched product and the gates'
elementwise work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..hints import constrain
from ..kernels import sharded
from ..precision import compute_dtype, widen
from .attention import split_heads
from .layers import dense, dense_init, norm
from .mamba2 import _causal_conv

_LOG_ZERO = -1e30            # log of an absent gate / the empty state's m


class MLSTMCache(NamedTuple):
    conv: torch.Tensor     # (B, W-1, di) raw conv inputs
    C: torch.Tensor        # (B, H, dh, dh) float32
    n: torch.Tensor        # (B, H, dh)
    m: torch.Tensor        # (B, H)


class SLSTMCache(NamedTuple):
    c: torch.Tensor        # (B, H, dh) float32
    n: torch.Tensor
    m: torch.Tensor        # (B, H)
    h: torch.Tensor


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; on a DTensor, which has no rule for it, on the
    local shards (``kernels.sharded.elementwise``)."""
    if isinstance(x, DTensor):
        return sharded.elementwise(F.logsigmoid, x)
    return F.logsigmoid(x)


def _ff_dim(d: int) -> int:
    f = (4 * d + 2) // 3
    return ((f + 63) // 64) * 64


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads, head dim): the head dim is d_inner / n_heads, as in
    ``repro`` (``ssm_head_dim`` is not read)."""
    di = cfg.ssm_expand * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    """Random params on ``gen``'s device; ``w_gates`` float32 whatever
    ``dtype`` is, as in ``repro``."""
    d = cfg.d_model
    di, H, _ = _dims(cfg)
    W = cfg.ssm_conv_width
    dev = gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype=dtype),
        "conv_w": (torch.randn((W, di), generator=gen, device=dev) * (W ** -0.5)).to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "wq": dense_init(gen, di, di, dtype=dtype),
        "wk": dense_init(gen, di, di, dtype=dtype),
        "wv": dense_init(gen, di, di, dtype=dtype),
        "w_gates": dense_init(gen, di, 2 * H, bias=True, dtype=torch.float32),
        "skip": torch.ones((di,), dtype=dtype, device=dev),
        "gnorm": {"scale": torch.ones((di,), dtype=dtype, device=dev)},
        "out_proj": dense_init(gen, di, d, dtype=dtype),
    }


def _mlstm_chunk(q, k, v, log_f, log_i, carry):
    """One chunk of the stabilised parallel mLSTM.

    q, k, v: (B,Q,H,dh) float32 (q pre-scaled); log_f/log_i: (B,Q,H);
    carry: (C (B,H,dh,dh), n (B,H,dh), m (B,H)). Returns (h, new carry).
    """
    C_prev, n_prev, m_prev = carry
    Q = q.shape[1]
    Fc = torch.cumsum(log_f, dim=1)                                  # (B,Q,H)
    # W[t, s] = F_t - F_s + log_i_s for s <= t, -inf above the diagonal
    Wmat = Fc[:, :, None, :] - Fc[:, None, :, :] + log_i[:, None, :, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    Wmat = torch.where(tri, Wmat, torch.full((), float("-inf"), dtype=Wmat.dtype,
                                             device=q.device))
    G = Fc + m_prev[:, None, :]                                      # (B,Q,H)
    m_t = torch.maximum(Wmat.amax(dim=2), G)                         # every row holds s = t
    D = torch.exp(Wmat - m_t[:, :, None, :])                         # (B,Q,Q,H)
    A = D * torch.einsum("bqhd,bshd->bqsh", q, k)
    eg = torch.exp(G - m_t)
    num = torch.einsum("bqsh,bshd->bqhd", A, v) \
        + eg[..., None] * torch.einsum("bqhd,bhde->bqhe", q, C_prev)
    den = A.sum(dim=2) + eg * torch.einsum("bqhd,bhd->bqh", q, n_prev)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # the carry at the chunk's end
    Fq = Fc[:, -1, :]                                                # (B,H)
    w_end = Fq[:, None, :] - Fc + log_i                              # (B,Q,H)
    m_new = torch.maximum(Fq + m_prev, w_end.amax(dim=1))
    scale_old = torch.exp(Fq + m_prev - m_new)
    wk = torch.exp(w_end - m_new[:, None, :])[..., None] * k         # (B,Q,H,dh)
    C_new = scale_old[:, :, None, None] * C_prev + torch.einsum("bqhd,bqhe->bhde", wk, v)
    n_new = scale_old[:, :, None] * n_prev + wk.sum(dim=1)
    return h, (C_new, n_new, m_new)


def _empty_carry(B: int, H: int, dh: int, dtype, device):
    return (torch.zeros((B, H, dh, dh), dtype=dtype, device=device),
            torch.zeros((B, H, dh), dtype=dtype, device=device),
            torch.full((B, H), _LOG_ZERO, dtype=dtype, device=device))


def mlstm_core(q, k, v, log_f, log_i, Q: int, carry=None):
    """q, k, v: (B,S,H,dh); gates (B,S,H). Returns (h (B,S,H,dh) float32,
    carry). A prompt that is not a multiple of ``Q`` is padded with
    identity steps (f = 1, i = 0), which leave the carry as it was. On
    DTensors it runs on each rank's batch and head shards
    (``kernels.sharded.batch_heads``)."""
    if isinstance(q, DTensor):
        def local(*ts):
            h, c = mlstm_core(*ts[:5], Q, ts[5:] or None)
            return (h, *c)
        ins = (q, k, v, log_f, log_i, *(carry or ()))
        h, *c = sharded.batch_heads(local, ins, (2,) * 5 + (1,) * (len(ins) - 5), (2, 1, 1, 1))
        return h, tuple(c)
    B, S, H, dh = q.shape
    cd = compute_dtype(q.dtype)
    q = q.to(cd) * (dh ** -0.5)
    k, v, log_f, log_i = k.to(cd), v.to(cd), log_f.to(cd), log_i.to(cd)
    if carry is None:
        carry = _empty_carry(B, H, dh, cd, q.device)
    if S == 1:
        return _mlstm_chunk(q, k, v, log_f, log_i, carry)
    pad = -S % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=_LOG_ZERO)
    # one split a tensor (whose backward concatenates the chunks' grads
    # once, where a slice a chunk would scatter each into a zero tensor)
    hs = []
    for qc, kc, vc, fc, ic in zip(*(t.split(Q, dim=1) for t in (q, k, v, log_f, log_i))):
        h, carry = _mlstm_chunk(qc, kc, vc, fc, ic, carry)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S], carry


def _mlstm_decode(q, k, v, log_f, log_i, cache: MLSTMCache) -> torch.Tensor:
    """``_mlstm_chunk`` at Q = 1, the carry updated in place: q, k, v (B,1,H,dh),
    gates (B,1,H). At one position the chunk's weights reduce to D =
    exp(log_i - m_t) and eg = exp(log_f + m - m_t), m_t = max(log_f + m, log_i),
    and the new carry is (eg C + D k v^T, eg n + D k, m_t): C is read once
    for q.C and rewritten twice (scaled, then the outer product added). On
    DTensors q, k, v and the gates are first laid out as the state is
    (batch-local, whole over "model": their heads gathered), so that no
    einsum sees both its batch and its heads sharded and the state is
    updated where it lives."""
    if isinstance(cache.C, DTensor):
        q, k, v = (constrain(t, "dp", None, None, None) for t in (q, k, v))
        log_f, log_i = (constrain(t, "dp", None, None) for t in (log_f, log_i))
    B, _, H, dh = q.shape
    cd = cache.C.dtype
    q = q[:, 0].to(cd) * (dh ** -0.5)
    k, v, log_f, log_i = k[:, 0].to(cd), v[:, 0].to(cd), log_f[:, 0].to(cd), log_i[:, 0].to(cd)
    G = log_f + cache.m                                                  # (B,H)
    m_t = torch.maximum(log_i, G)
    D = torch.exp(log_i - m_t)
    eg = torch.exp(G - m_t)
    A = D * (q * k).sum(-1)
    num = A[..., None] * v + eg[..., None] * torch.einsum("bhd,bhde->bhe", q, cache.C)
    den = A + eg * (q * cache.n).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    Dk = D[..., None] * k
    cache.C.mul_(eg[..., None, None])
    cache.C.view(B * H, dh, dh).baddbmm_(Dk.reshape(B * H, dh, 1), v.reshape(B * H, 1, dh))
    cache.n.mul_(eg[..., None]).add_(Dk)
    cache.m.copy_(m_t)
    return h[:, None]


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig, *, cache: MLSTMCache | None = None):
    """One mLSTM mixer. x: (B, S, d). Returns (out, state).

    Without ``cache`` (training, prefill) the state is a new MLSTMCache: the
    last W-1 conv inputs (zeros before the prompt) and the carry after the
    last position. With ``cache`` (decode, S = 1) the cache's tensors are
    updated in place and returned.
    """
    B, S, _ = x.shape
    di, H, dh = _dims(cfg)
    W = cfg.ssm_conv_width
    x_in, z = dense(p["in_proj"], x).chunk(2, dim=-1)

    if cache is None:
        conv_tail = F.pad(x_in, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):, :]
        cx = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
        carry = None
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per sequence, got S={S}")
        window = torch.cat([cache.conv, x_in], dim=1)                   # (B, W, di)
        cx = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"])[:, None]
        cache.conv.copy_(window[:, 1:, :])

    q = split_heads(dense(p["wq"], cx), H, dh)
    k = split_heads(dense(p["wk"], cx), H, dh)
    v = split_heads(dense(p["wv"], x_in), H, dh)
    i_pre, f_pre = dense(p["w_gates"], widen(x_in)).chunk(2, dim=-1)    # (B,S,H) each
    if cache is None:
        h, carry = mlstm_core(q, k, v, _log_sigmoid(f_pre), i_pre, cfg.ssm_chunk)
    else:
        h = _mlstm_decode(q, k, v, _log_sigmoid(f_pre), i_pre, cache)

    # contiguous: after a padded last chunk h is a slice (the kernel takes rows)
    h = h.reshape(B, S, di).to(x.dtype).contiguous()
    h = norm(p["gnorm"], h, cfg.norm_eps) + p["skip"] * cx
    out = dense(p["out_proj"], h * F.silu(z))
    return out, (MLSTMCache(conv_tail, *carry) if cache is None else cache)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    d = cfg.d_model
    di, H, dh = _dims(cfg)
    ff = _ff_dim(d)
    dev = gen.device
    return {
        "in_norm": {"scale": torch.ones((d,), dtype=dtype, device=dev)},
        "w_in": dense_init(gen, d, 4 * di, bias=True, dtype=dtype),
        "R": (torch.randn((4, H, dh, dh), generator=gen, device=dev) * (dh ** -0.5)).to(dtype),
        "gnorm": {"scale": torch.ones((di,), dtype=dtype, device=dev)},
        "out_proj": dense_init(gen, di, d, dtype=dtype),
        "ffn": {
            "up": dense_init(gen, d, 2 * ff, dtype=dtype),
            "down": dense_init(gen, ff, d, dtype=dtype),
        },
        "ffn_norm": {"scale": torch.ones((d,), dtype=dtype, device=dev)},
    }


def recurrent_weight(R: torch.Tensor) -> torch.Tensor:
    """``R`` (4, H, dh, dh), gates (z, i, f, o) -> (H, dh, 2 dh + 2), widened:
    per head the z and o columns, then the head-dim means of the i and f
    columns. The i and f gates are one scalar a head, the mean of their
    pre-activations over the head dim, and the mean of h.R is h.mean(R), so
    a step's recurrent term of all four gates is one batched product over
    the heads, reading about half the bytes of R."""
    Rz, Ri, Rf, Ro = widen(R).unbind(0)
    return torch.cat([Rz, Ro, Ri.mean(-1, keepdim=True), Rf.mean(-1, keepdim=True)], dim=-1)


def gate_inputs(xg: torch.Tensor) -> torch.Tensor:
    """The input's pre-activations xg (B, S, 4, H, dh) -> (S, H, B, 2 dh + 2),
    widened: ``recurrent_weight``'s columns (z, o, mean i, mean f), time
    first, so that a step's slice adds to its recurrent product as it is."""
    z, i, f, o = widen(xg).unbind(2)
    g = torch.cat([z, o, i.mean(-1, keepdim=True), f.mean(-1, keepdim=True)], dim=-1)
    return g.permute(1, 2, 0, 3).contiguous()


def slstm_cell(Rw: torch.Tensor, g_t: torch.Tensor, state: SLSTMCache) -> SLSTMCache:
    """One recurrent step. ``Rw``: ``recurrent_weight(p["R"])``; ``g_t``: one
    step (H, B, 2 dh + 2) of ``gate_inputs``."""
    c, n, m, h = state
    dh = h.shape[-1]
    pre = torch.baddbmm(g_t, h.transpose(0, 1), Rw).transpose(0, 1)    # (B, H, 2 dh + 2)
    # one split (whose backward is one concatenation, where each slice's
    # would fill a zero tensor)
    z_pre, o_pre, i_t, f_pre = pre.split([dh, dh, 1, 1], dim=-1)       # i_t, f_pre (B, H, 1)
    fm = _log_sigmoid(f_pre) + m[..., None]
    m_new = torch.maximum(fm, i_t)
    i_s = torch.exp(i_t - m_new)
    f_s = torch.exp(fm - m_new)
    c_new = torch.addcmul(f_s * c, i_s, torch.tanh(z_pre))
    n_new = torch.addcmul(i_s, f_s, n)
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return SLSTMCache(c_new, n_new, m_new[..., 0], h_new)


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig, *, cache: SLSTMCache | None = None):
    """The whole sLSTM block: pre-norm mixer and a post FFN. Takes the raw
    residual stream and returns (the updated stream, state): it owns two
    residual adds. Without ``cache`` the recurrence starts from the empty
    state and the state after the last position is returned; with
    ``cache`` it starts from the cache, whose tensors are updated in place."""
    B, S, d = x.shape
    di, H, dh = _dims(cfg)
    xn = norm(p["in_norm"], x, cfg.norm_eps)
    # heads, not gates, over "model" (the gates are taken apart below): the
    # flat dim made whole first, as its shards need not hold whole gates
    xg = constrain(dense(p["w_in"], xn), "dp", None, None).reshape(B, S, 4, H, dh)
    xg = constrain(xg, "dp", None, None, "model", None)
    g = gate_inputs(xg)
    state = cache if cache is not None else empty_slstm_state(
        cfg, B, x.device, compute_dtype(x.dtype))
    Rw = recurrent_weight(p["R"])
    hs = []
    # one unbind over time (whose backward stacks the steps' grads once,
    # where a slice a step would scatter each into a zero (S, ...) tensor)
    for g_t in g.unbind(0):
        state = slstm_cell(Rw, g_t, state)
        hs.append(state.h)
    h = torch.stack(hs, dim=1).reshape(B, S, di).to(x.dtype)
    x = x + dense(p["out_proj"], norm(p["gnorm"], h, cfg.norm_eps))
    # post-block gated FFN (GeLU, tanh approximation as jax.nn.gelu's default)
    u, g = dense(p["ffn"]["up"], norm(p["ffn_norm"], x, cfg.norm_eps)).chunk(2, dim=-1)
    x = x + dense(p["ffn"]["down"], F.gelu(u, approximate="tanh") * g)
    if cache is not None:
        for dst, src in zip(cache, state):
            dst.copy_(src)
        state = cache
    return x, state


def empty_slstm_state(cfg: ModelConfig, B: int, device=None,
                      dtype=torch.float32) -> SLSTMCache:
    _, H, dh = _dims(cfg)
    z = torch.zeros((B, H, dh), dtype=dtype, device=device)
    return SLSTMCache(c=z, n=z.clone(), m=torch.full((B, H), _LOG_ZERO, dtype=dtype,
                                                      device=device), h=z.clone())


def empty_mlstm_cache(cfg: ModelConfig, B: int, dtype, device=None) -> MLSTMCache:
    di, H, dh = _dims(cfg)
    C, n, m = _empty_carry(B, H, dh, torch.float32, device)
    return MLSTMCache(conv=torch.zeros((B, cfg.ssm_conv_width - 1, di), dtype=dtype,
                                       device=device), C=C, n=n, m=m)
