"""Mixture-of-Experts FFN: top-k routing and capacity-bounded, sort-based
dispatch (GShard/Switch lineage, MaxText-style sort dispatch).

The port of ``src/repro/models/moe.py``:
  * each batch row is a dispatch group: per-row capacity
    ``C = ceil(S * k * capacity_factor / E)``;
  * dispatch is index-based (a stable argsort by expert id and bounded
    slots), not a (tokens x E x C) one-hot product;
  * dropped dispatches (over capacity) go to a trash slot ``E * C`` that is
    never read, and contribute 0.

Routing (``route``) and the dispatch, expert products and combine
(``experts``) are two functions, so that two implementations can be fed the
same routing. Every shape is fixed by (B, S, k, E, C): the plan is built
with scatters into preallocated tensors, so nothing reads a value back to
the host (no ``bincount``, boolean masks or ``nonzero``). The expert
products are batched matmuls (``repro`` runs them as ``einsum``s; there is
no TPU kernel for them).

``moe_ffn`` returns the Switch load-balance auxiliary loss (Switch §2.2):
``aux = E * sum_e f_e * P_e``.

On DTensors (the mesh steps) ``experts`` runs ``repro``'s layouts: the
dispatch plan, the gather of each row's tokens into its (E, C) slots and the
combine run on each rank's own rows (``local_map``); between them the
(B, E, C, d) buffer is constrained as ``repro`` constrains it. The baseline
(GShard) reshards it to (E, B*C, d) with experts over "model"; under the
"moe2d" flag it stays (B, E, C, d), batch over dp and experts over "model",
and only the combine gathers the expert outputs over "model".

``observe`` is the one hook for comparison runs and tests to see the
routing: a routing hook that ``route`` calls with what it computed. The
program's spans (``spans.py``) run around ``route``, ``dispatch_plan``,
``experts`` and ``load_balance_aux`` as ``moe.<name>``; ``launch/profile.py``
records them. Off, each costs one test per call.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..hints import constrain, flag
from ..spans import spanned
from .layers import dense_init

_ROUTE_HOOK = None     # hook(p, x, logits, probs, w, idx) -> (w, idx)


@contextlib.contextmanager
def observe(route_hook=None):
    """Inside, ``route`` passes each call's (p, x, logits, probs, w, idx) to
    ``route_hook`` and returns the (w, idx) it gives back."""
    global _ROUTE_HOOK
    saved = _ROUTE_HOOK
    _ROUTE_HOOK = route_hook
    try:
        yield
    finally:
        _ROUTE_HOOK = saved


def moe_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.float32):
    """The router is float32 whatever ``dtype``; gate/up (E, d, f), down (E, f, d)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)

    return {
        "router": dense_init(gen, d, E, dtype=torch.float32),
        "gate": normal((E, d, f), d ** -0.5),
        "up": normal((E, d, f), d ** -0.5),
        "down": normal((E, f, d), f ** -0.5),
    }


def _capacity(S: int, cfg: ModelConfig) -> int:
    c = int(-(-S * cfg.experts_per_token * cfg.moe_capacity_factor // cfg.n_experts))
    return max(1, c)


@spanned("moe.dispatch_plan")
def dispatch_plan(idx: torch.Tensor, E: int, C: int):
    """Per-row dispatch plan, batched over rows. idx: (B, S, k) expert ids.

    Returns (slot_tok (B, E*C): the token in each slot, S where the slot is
    empty; slots (B, S*k): the slot of each dispatch, E*C where dropped).
    Row by row this is ``repro``'s ``_dispatch_row``.
    """
    B, S, k = idx.shape
    n = S * k
    dev = idx.device
    eid = idx.reshape(B, n).long()
    order = torch.argsort(eid, dim=-1, stable=True)
    sorted_eid = torch.gather(eid, 1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, eid, torch.ones_like(eid))
    starts = counts.cumsum(-1) - counts
    pos_in_e = torch.arange(n, device=dev) - torch.gather(starts, 1, sorted_eid)
    slot_sorted = torch.where(pos_in_e < C, sorted_eid * C + pos_in_e,
                              torch.full_like(pos_in_e, E * C))
    # slot -> source token; every drop writes the trash slot E*C, cut off here
    slot_tok = torch.full((B, E * C + 1), S, dtype=torch.long, device=dev).scatter_(
        1, slot_sorted, order // k)[:, :E * C]
    slots = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    return slot_tok, slots


@spanned("moe.route")
def route(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (logits (B,S,E) f32, probs (B,S,E) f32, w (B,S,k) in
    x's dtype, renormalised, idx (B,S,k)); top-k sorted descending."""
    logits = x.float() @ p["router"]["w"].float()
    probs = F.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    w = (w / w.sum(-1, keepdim=True).clamp_min(1e-9)).to(x.dtype)
    if _ROUTE_HOOK is not None:
        w, idx = _ROUTE_HOOK(p, x, logits, probs, w, idx)
    return logits, probs, w, idx


@spanned("moe.experts")
def experts(p, x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig):
    """Dispatch, expert products and combine for a given routing (w, idx).

    x: (B, S, d) -> y (B, S, d). The products run on an (E, B*C, d) buffer
    gathered straight from x in (e, b, c) row order (a zero row appended for
    empty slots), and each dispatch reads its expert output by row index (a
    zero row appended for drops): the same values as ``repro``'s transposes.
    """
    if isinstance(x, DTensor):
        return _experts_sharded(p, x, w, idx, cfg)
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(S, cfg)
    dev = x.device
    slot_tok, slots = dispatch_plan(idx, E, C)

    b = torch.arange(B, device=dev)[:, None]
    src = torch.where(slot_tok < S, b * S + slot_tok, B * S)            # (B, E*C)
    x_pad = torch.cat([x.reshape(B * S, d), x.new_zeros((1, d))])
    rows = src.view(B, E, C).transpose(0, 1).reshape(-1)                # (e, b, c) order
    buf = x_pad.index_select(0, rows).view(E, B * C, d)
    h = torch.bmm(buf, p["gate"])
    u = torch.bmm(buf, p["up"])
    out = torch.bmm(F.silu(h) * u, p["down"])
    row = torch.div(slots, C, rounding_mode="floor") * (B * C) + b * C + slots % C
    row = torch.where(slots < E * C, row, B * E * C)                   # drops: zero row
    out_pad = torch.cat([out.reshape(B * E * C, d), out.new_zeros((1, d))])
    y_rep = out_pad.index_select(0, row.reshape(-1)).view(B, S, k, d)
    return (y_rep * w[..., None]).sum(dim=2)


def _rows(t: DTensor) -> list:
    """``t``'s placements, checked to shard nothing but rows (dim 0)."""
    if any(not (pl.is_replicate() or pl.is_shard(0)) for pl in t.placements):
        raise ValueError(f"moe: rows sharded only, got {tuple(t.placements)}")
    return list(t.placements)


def _experts_sharded(p, x: DTensor, w, idx, cfg: ModelConfig):
    """``experts`` on DTensors, in ``repro``'s (B, E, C, d) layouts."""
    mesh = x.device_mesh
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(S, cfg)
    rows = _rows(x)

    def gather(xl, il):
        slot_tok, slots = dispatch_plan(il, E, C)
        Bl = xl.shape[0]
        x_pad = torch.cat([xl, xl.new_zeros((Bl, 1, d))], dim=1)      # empty slots: zero row
        buf = x_pad.gather(1, slot_tok[..., None].expand(Bl, E * C, d))
        return buf.view(Bl, E, C, d), slots

    buf, slots = local_map(gather, out_placements=(rows, rows), in_placements=(rows, rows),
                           device_mesh=mesh)(x, idx)
    if flag("moe2d"):
        buf = constrain(buf, "dp", "model", None, None)
        h = torch.einsum("becd,edf->becf", buf, p["gate"])
        u = torch.einsum("becd,edf->becf", buf, p["up"])
        out = torch.einsum("becf,efd->becd", F.silu(h) * u, p["down"])
        out = constrain(out, "dp", None, None, None).reshape(B, E * C, d)
    else:
        buf = constrain(buf, "dp", None, None, None)
        buf = constrain(buf.transpose(0, 1).reshape(E, B * C, d), "model", None, None)
        h = torch.bmm(buf, p["gate"])
        u = torch.bmm(buf, p["up"])
        out = torch.bmm(F.silu(h) * u, p["down"])
        out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
        out = constrain(out, "dp", None, None)

    def combine(ol, sl, wl):
        Bl = ol.shape[0]
        o_pad = torch.cat([ol, ol.new_zeros((Bl, 1, d))], dim=1)      # drops: zero row
        y_rep = o_pad.gather(1, sl[..., None].expand(Bl, S * k, d)).view(Bl, S, k, d)
        return (y_rep * wl[..., None]).sum(dim=2)

    out = out.redistribute(mesh, rows) if list(out.placements) != rows else out
    return local_map(combine, out_placements=rows, in_placements=(rows, rows, w.placements),
                     device_mesh=mesh)(out, slots, w)


@spanned("moe.load_balance_aux")
def load_balance_aux(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch aux: E * sum_e (fraction of dispatches to e) * (mean prob of e)."""
    if isinstance(idx, DTensor):     # each rank counts its rows; the counts add up
        counts = local_map(lambda il: _counts(il, E),
                           out_placements=[Partial() if pl.is_shard() else pl
                                           for pl in _rows(idx)],
                           in_placements=(idx.placements,), device_mesh=idx.device_mesh)
        f_e = counts(idx) / idx.numel()
    else:
        f_e = _counts(idx, E) / idx.numel()
    p_e = probs.mean(dim=(0, 1))
    return E * torch.sum(f_e * p_e)


def _counts(idx: torch.Tensor, E: int) -> torch.Tensor:
    flat = idx.reshape(-1)
    return torch.zeros((E,), dtype=torch.float32, device=idx.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=idx.device))


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux_loss)."""
    _, probs, w, idx = route(p, x, cfg)
    return experts(p, x, w, idx, cfg), load_balance_aux(probs, idx, cfg.n_experts)
