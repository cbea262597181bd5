"""Kernel entry points on DTensors: each kernel runs on every rank's local
shards through ``local_map``, under placements where that is exact.

``kernels.ops`` sends a DTensor here; the local function it is given is the
same entry point, which on local CUDA tensors launches the kernel (and
counts it in ``ops.LAUNCHES``) and on local CPU tensors runs the plain
version. Which placements each kernel takes:

* ``rmsnorm``: the normalised (last) dim whole on every rank. A shard of it,
  or a pending sum (``Partial``, e.g. the vocab-sharded embedding's output),
  is first redistributed to ``Replicate`` on that mesh dim, as GSPMD would.
  ``scale`` is replicated; its gradient is a partial sum over the mesh dims
  that shard the rows.
* ``flash_attention`` (and its backward): batch and heads only, q
  (B, S, H, hd) and k/v (B, T, K, hd). Where a mesh dim shards q's heads and
  leaves k/v replicated (``hints.constrain`` does so when it divides H but
  not K), each rank passes the kernel the KV heads of its own q heads, q head
  ``h`` -> KV head ``h // G``, and k/v's gradients are partial sums over that
  dim.
* ``decode_attention``: k/v (B, T, K, hd) with batch and heads as above, and
  the cache's sequence sharded over at most one mesh dim (``repro``'s cache
  rule puts it on "model"). There q is made whole over that dim (one row a
  head), each rank attends over its own rows with a local ``kv_len``
  clamped into [0, T_local], and the partial outputs merge by their
  log-sum-exp across the dim: a rank with no valid row gives o = 0 and
  lse = -inf and weighs nothing. The merge runs on the device; nothing is
  read back to the host.
* ``ssd_intra_chunk`` (and its backward): batch and heads only.

Three PyTorch (not kernel) computations need the same care and are here:
``depthwise_conv`` (Mamba2's and the mLSTM's causal conv: batch over any
mesh dim, channels over one where the weight's channels are sharded; it is
channel-wise, so a replicated operand is cut to the other's channel shard,
and the weight's gradient is a partial sum over the mesh dims that shard
the batch), ``batch_heads`` (work that treats every batch row and head
apart) and ``elementwise`` (an op DTensor has no rule for).

Any other placement raises, naming the placements: nothing gathers
silently, and the card never falls back to a plain version.

The cache writes of the decode and prefill paths (``cache_write_at``,
``cache_write_prefix``) are here too: on a sequence-sharded cache only the
rank that owns a row writes it, decided on the device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def _names(placements) -> str:
    return "(" + ", ".join(repr(p) for p in placements) + ")"


def _refuse(what: str, **tensors) -> ValueError:
    named = "; ".join(f"{k} {_names(t.placements)}" for k, t in tensors.items())
    return ValueError(f"{what}: no exact local form for placements {named}")


def _shard_dim(p) -> Optional[int]:
    return p.dim if isinstance(p, Shard) else None


def _as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor (made inside the step: a table, a mask) counts as
    replicated, as ``implicit_replication`` treats it."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _replicate(t: DTensor) -> DTensor:
    want = (Replicate(),) * t.device_mesh.ndim
    return t if tuple(t.placements) == want else t.redistribute(t.device_mesh, want)


def _local(t) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _coord(mesh, i: int) -> int:
    return mesh.get_local_rank(i)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the local gradient contiguous: DTensor
    takes a local gradient to be laid out as its global strides say, and a
    plain version's einsum backward gives transposed ones."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _cg(t: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(t) if t.requires_grad else t


# -- rmsnorm -----------------------------------------------------------------
def rmsnorm(x: DTensor, scale, *, eps: float, local: Callable) -> DTensor:
    mesh, nd = x.device_mesh, x.ndim
    xp = tuple(Replicate() if isinstance(p, Partial) or _shard_dim(p) == nd - 1 else p
               for p in x.placements)
    if xp != tuple(x.placements):
        x = x.redistribute(mesh, xp)
    scale = _replicate(_as_dtensor(scale, mesh))
    grad_scale = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in xp)
    fn = local_map(lambda a, s: local(_cg(a), _cg(s), eps=eps), out_placements=list(xp),
                   in_placements=(xp, scale.placements), in_grad_placements=(xp, grad_scale),
                   device_mesh=mesh)
    return fn(x, scale)


# -- head layout shared by flash and decode attention -------------------------
def _kv_heads(mesh, i: int, H: int, K: int) -> tuple[int, int]:
    """(first KV head, KV head count) that the local q heads of mesh dim
    ``i``'s rank read, where that dim shards q's heads and not k/v's."""
    n = mesh.size(i)
    if H % n:
        raise ValueError(f"{n} ranks do not divide {H} q heads")
    G, Hl = H // K, H // n
    start = _coord(mesh, i) * Hl
    if Hl % G == 0:
        return start // G, Hl // G
    if G % Hl == 0:
        return start // G, 1
    raise ValueError(f"local q heads {Hl} and group size {G} do not nest")


def _head_plan(what: str, mesh, q: DTensor, k: DTensor, *, seq_ok: bool):
    """Check q/k placements dim by dim (batch 0, sequence 1, heads 2); return
    (KV head slice or None, mesh dims where k/v's grads are partial sums,
    mesh dim that shards k/v's sequence or None)."""
    sel, partial, seq = None, [], None
    H, K = q.shape[2], k.shape[2]
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        dq, dk = _shard_dim(pq), _shard_dim(pk)
        if isinstance(pq, Partial) or isinstance(pk, Partial):
            raise _refuse(what, q=q, k=k)
        if dk == 1 and seq_ok and dq is None and seq is None:
            seq = i
        elif dq == dk and dq in (None, 0, 2):
            if dq == 2 and (H % mesh.size(i) or K % mesh.size(i)):
                raise _refuse(what, q=q, k=k)       # uneven heads: the groups would not match
            continue
        elif dq == 2 and dk is None and sel is None:
            sel = _kv_heads(mesh, i, H, K)
            partial.append(i)
        else:
            raise _refuse(what, q=q, k=k)
    return sel, partial, seq


def _select(t: torch.Tensor, sel) -> torch.Tensor:
    if sel is None:
        return t
    return t.narrow(2, sel[0], sel[1]).contiguous()


# -- flash attention ----------------------------------------------------------
def flash_attention(q: DTensor, k, v, *, causal: bool, window, local: Callable) -> DTensor:
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    if tuple(k.placements) != tuple(v.placements):
        raise _refuse("flash_attention", k=k, v=v)
    sel, partial, _ = _head_plan("flash_attention", mesh, q, k, seq_ok=False)
    kv_grad = tuple(Partial() if i in partial else p for i, p in enumerate(k.placements))

    def run(ql, kl, vl):
        return local(_cg(ql), _select(_cg(kl), sel), _select(_cg(vl), sel), causal=causal,
                     window=window)

    fn = local_map(run, out_placements=list(q.placements),
                   in_placements=(q.placements, k.placements, v.placements),
                   in_grad_placements=(q.placements, kv_grad, kv_grad), device_mesh=mesh)
    return fn(q, k, v)


# -- decode attention ---------------------------------------------------------
def _merge(o: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """Partial outputs over disjoint key ranges -> the whole softmax's
    output: weights exp(lse - max lse) summed across ``group``."""
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    w = torch.exp(lse - m)                                       # (B, H); 0 where lse = -inf
    num = o.float() * w[:, None, :, None]
    dist.all_reduce(num, group=group)
    dist.all_reduce(w, group=group)
    return (num / torch.where(w == 0, torch.ones_like(w), w)[:, None, :, None]).to(o.dtype)


def decode_attention(q: DTensor, k, v, *, kv_len, window, local: Callable) -> DTensor:
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    if tuple(k.placements) != tuple(v.placements):
        raise _refuse("decode_attention", k=k, v=v)
    seq = next((i for i, p in enumerate(k.placements) if _shard_dim(p) == 1), None)
    if seq is not None and _shard_dim(q.placements[seq]) == 2:
        # the merge needs every head on every sequence shard: one row a head
        want = list(q.placements)
        want[seq] = Replicate()
        q = q.redistribute(mesh, want)
    sel, _, seq = _head_plan("decode_attention", mesh, q, k, seq_ok=True)
    kv_len = _local(kv_len)
    if seq is None or mesh.size(seq) == 1:
        def run(ql, kl, vl):
            return local(ql, _select(kl, sel), _select(vl, sel), kv_len=kv_len, window=window)
    else:
        if window is not None:
            raise ValueError("decode_attention: a window over a sequence-sharded cache "
                             f"(k {_names(k.placements)}) has no exact local form")
        group = mesh.get_group(seq)

        def run(ql, kl, vl):
            T_l = kl.shape[1]
            off = _coord(mesh, seq) * T_l
            n_l = torch.clamp(kv_len.reshape(()) - off, 0, T_l).to(torch.int32)
            o, lse = local(ql, _select(kl, sel), _select(vl, sel), kv_len=n_l, window=None,
                           return_lse=True)
            return _merge(o, lse, group)

    out_pl = [Replicate() if i == seq else p for i, p in enumerate(q.placements)]
    fn = local_map(run, out_placements=out_pl,
                   in_placements=(q.placements, k.placements, v.placements), device_mesh=mesh)
    return fn(q, k, v)


# -- ssd_intra_chunk ----------------------------------------------------------
def ssd_intra_chunk(la: DTensor, C, B_in, x, *, local: Callable):
    """la (B,nc,Q,H), C/B_in (B,nc,Q,G,N), x (B,nc,Q,H,P): batch over any mesh
    dim; heads (la dim 3, x dim 3) over one where C/B_in are replicated
    there, their grads then partial sums."""
    mesh = la.device_mesh
    C, B_in, x = (_as_dtensor(t, mesh) for t in (C, B_in, x))
    cb_grad = []
    for i, (pa, pc, pb, px) in enumerate(zip(la.placements, C.placements, B_in.placements,
                                             x.placements)):
        da, dc, db, dx = (_shard_dim(p) for p in (pa, pc, pb, px))
        if any(isinstance(p, Partial) for p in (pa, pc, pb, px)):
            raise _refuse("ssd_intra_chunk", la=la, C=C, B=B_in, x=x)
        if da == dc == db == dx and da in (None, 0):
            cb_grad.append(pc)
        elif da == 3 and dx == 3 and dc is None and db is None:
            cb_grad.append(Partial())
        else:
            raise _refuse("ssd_intra_chunk", la=la, C=C, B=B_in, x=x)
    # y (B,nc,Q,H,P), states (B,nc,H,P,N), tot (B,nc,H): heads at 3, 2, 2
    heads = {3: (3, 2, 2)}
    outs = tuple([Shard(heads[p.dim][j]) if _shard_dim(p) == 3 else p for p in la.placements]
                 for j in range(3))
    fn = local_map(local, out_placements=outs,
                   in_placements=(la.placements, C.placements, B_in.placements, x.placements),
                   in_grad_placements=(la.placements, tuple(cb_grad), tuple(cb_grad),
                                       x.placements),
                   device_mesh=mesh)
    return fn(la, C, B_in, x)


# -- an elementwise op without a DTensor rule -----------------------------------
def elementwise(fn: Callable, x: DTensor) -> DTensor:
    """``fn`` (elementwise, e.g. ``F.logsigmoid``, for which DTensor has no
    sharding rule) on each rank's shard, in x's placements."""
    if any(isinstance(p, Partial) for p in x.placements):
        raise _refuse("elementwise", x=x)
    return local_map(fn, out_placements=list(x.placements), in_placements=(x.placements,),
                     device_mesh=x.device_mesh)(x)


# -- per (batch row, head) work ----------------------------------------------------
def batch_heads(fn: Callable, tensors: tuple, heads: tuple, out_heads: tuple) -> tuple:
    """``fn(*local tensors) -> tuple`` on each rank's batch and head shards:
    ``fn`` treats every (batch row, head) apart (the mLSTM's chunks, whose
    einsums over both would make DTensor flatten two sharded dims). Each
    tensor has its batch at dim 0 and its heads at ``heads[i]``, each output
    at ``out_heads[j]``. ``tensors[0]`` sets the layout (batch or heads over
    each mesh dim); the others are redistributed to it."""
    lead, mesh = tensors[0], tensors[0].device_mesh
    plan = []
    for p in lead.placements:
        d = _shard_dim(p)
        if isinstance(p, Partial) or d not in (None, 0, heads[0]):
            raise _refuse("batch_heads", lead=lead)
        plan.append(d if d is None else d == 0)

    def placed(h: int) -> list:
        return [Replicate() if k is None else Shard(0) if k else Shard(h) for k in plan]

    ins = []
    for t, h in zip(tensors, heads):
        t, want = _as_dtensor(t, mesh), placed(h)
        ins.append(t if tuple(t.placements) == tuple(want) else t.redistribute(mesh, want))
    fn_l = local_map(fn, out_placements=tuple(placed(h) for h in out_heads),
                     in_placements=tuple(placed(h) for h in heads), device_mesh=mesh)
    return fn_l(*ins)


# -- depthwise causal conv ----------------------------------------------------
def depthwise_conv(x: DTensor, w, b, *, local: Callable) -> DTensor:
    """x (B, S, Ch), w (W, Ch), b (Ch,): ``local(x, w, b)`` on each rank's
    batch and channel shards."""
    mesh = x.device_mesh
    w, b = _as_dtensor(w, mesh), _as_dtensor(b, mesh)
    xp, wp, grad = [], [], []
    for px, pw, pb in zip(x.placements, w.placements, b.placements):
        dx, dw, db = _shard_dim(px), _shard_dim(pw), _shard_dim(pb)
        if any(isinstance(p, Partial) for p in (px, pw, pb)) or dx == 1 or dw == 0 \
                or (dw == 1) != (db == 0) or (dx == 0 and dw == 1):
            raise _refuse("depthwise_conv", x=x, w=w, b=b)
        channels = dx == 2 or dw == 1
        xp.append(Shard(2) if channels else px)
        wp.append(Shard(1) if channels else Replicate())
        grad.append(Partial() if dx == 0 else wp[-1])
    if tuple(xp) != tuple(x.placements):
        x = x.redistribute(mesh, xp)
    bp = [Shard(0) if isinstance(p, Shard) else p for p in wp]
    if tuple(wp) != tuple(w.placements):
        w, b = w.redistribute(mesh, wp), b.redistribute(mesh, bp)
    bgrad = [Shard(0) if isinstance(p, Shard) else p for p in grad]
    fn = local_map(lambda a, ww, bb: local(_cg(a), _cg(ww), _cg(bb)), out_placements=xp,
                   in_placements=(xp, wp, bp), in_grad_placements=(xp, grad, bgrad),
                   device_mesh=mesh)
    return fn(x, w, b)


# -- cache writes on a sequence-sharded cache ---------------------------------
def _cache_layout(what: str, dst: DTensor):
    """(mesh dim sharding the sequence or None, src placements: dst's batch
    sharding, replicated elsewhere)."""
    seq = None
    for i, p in enumerate(dst.placements):
        d = _shard_dim(p)
        if d == 1 and seq is None:
            seq = i
        elif d not in (None, 0) or isinstance(p, Partial):
            raise _refuse(what, cache=dst)
    src_pl = [p if _shard_dim(p) == 0 else Replicate() for p in dst.placements]
    return seq, src_pl


def cache_write_at(dst: DTensor, pos, src) -> None:
    """dst[:, pos] = src[:, 0] IN PLACE; dst (B, T, ...), src (B, 1, ...),
    ``pos`` a 0-dim integer tensor. Only the rank holding row ``pos`` writes
    it: the others write their row back, chosen on the device."""
    mesh = dst.device_mesh
    seq, src_pl = _cache_layout("cache write", dst)
    src = _as_dtensor(src, mesh)
    if tuple(src.placements) != tuple(src_pl):
        src = src.redistribute(mesh, src_pl)
    dl, sl = dst.to_local(), src.to_local()
    T_l = dl.shape[1]
    lp = _local(pos).reshape(()) - (0 if seq is None else _coord(mesh, seq) * T_l)
    idx = torch.clamp(lp, 0, T_l - 1).reshape(1).long()
    inside = (lp >= 0) & (lp < T_l)
    dl.index_copy_(1, idx, torch.where(inside, sl.to(dl.dtype), dl.index_select(1, idx)))


def cache_write_prefix(dst: DTensor, src) -> None:
    """dst[:, :S] = src IN PLACE; dst (B, T, ...), src (B, S, ...): each rank
    copies the rows of [0, S) that it holds."""
    mesh = dst.device_mesh
    seq, src_pl = _cache_layout("cache write", dst)
    src = _as_dtensor(src, mesh)
    if tuple(src.placements) != tuple(src_pl):
        src = src.redistribute(mesh, src_pl)
    dl, sl = dst.to_local(), src.to_local()
    T_l, S = dl.shape[1], sl.shape[1]
    off = 0 if seq is None else _coord(mesh, seq) * T_l
    n = max(0, min(S - off, T_l))
    if n:
        dl[:, :n] = sl[:, off:off + n]
