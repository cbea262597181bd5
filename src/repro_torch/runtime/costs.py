"""Analytic cost extraction: the port of ``src/repro/runtime/costs.py``.

``step_costs(fn, *args)`` runs ``fn`` once on fake tensors
(``FakeTensorMode``, CPU fakes: nothing is computed, no device is needed,
and ``kernels.ops`` takes the plain versions, as ``repro`` traces its
reference path with ``jax.make_jaxpr``) and applies ``jaxpr_costs``' rules
to the aten ops it dispatches:

* **flops**: 2·M·N·K for every ``mm``/``bmm``/``addmm``/``baddbmm`` (einsum
  and ``F.linear`` lower to these), and 2·out·(C_in/groups)·prod(kernel)
  for a convolution and for each gradient its backward computes. A
  depthwise conv is 2·B·L·C·W; ``repro``'s ``_conv_flops`` divides that
  once more by the group count (C), a fault on the reference side.
* **dot_bytes**: the operands and outputs of each matmul.
* **bytes**: ``dot_bytes``, a convolution's operands and outputs, for a
  gather/scatter/index op its outputs plus the smaller of its indexed
  operand and four times its outputs, and the outputs of every other op
  (taken as fused with its producers). View ops add nothing, nor do
  allocations (``empty``) or ops outside ``aten``.

**Loops.** The port's layer loops, chunk loops and time loops are Python
loops, so every iteration dispatches its ops and is counted: no trip-count
logic is needed (``repro`` multiplies a ``scan`` body by its length).

**DTensors.** The counting mode lets DTensor decompose first and counts the
local ops: run on a sharded step it gives one rank's costs. The dry-run
counts the one-device step globally and divides by the ranks, as ``repro``
does.

``collective_bytes(fn, *args)`` is the counterpart of
``hlo_collective_bytes`` (there is no HLO text to parse): it runs ``fn`` on
a fake world (``launch.mesh.init_fake_world``) under ``CommDebugMode``,
which counts the ``c10d_functional`` ops DTensor's redistributions issue and
the plain c10d ops, and adds each one's result bytes (per device) under
``repro``'s keys.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

_DOTS = ("mm", "bmm", "addmm", "addmm_", "baddbmm", "baddbmm_")
_CONVS = ("convolution", "convolution_backward")
_INDEXED = ("index", "index_put", "index_put_", "_index_put_impl_", "index_select", "gather",
            "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
            "scatter_reduce_", "index_add", "index_add_", "index_copy", "index_copy_",
            "embedding", "embedding_dense_backward", "slice_scatter", "select_scatter")
_FREE = ("_unsafe_view", "detach", "lift_fresh", "alias", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided")
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _dot_flops(name: str, args) -> int:
    a, b = (args[1], args[2]) if name.startswith(("addmm", "baddbmm")) else (args[0], args[1])
    *batch, m, k = a.shape
    return 2 * math.prod(batch) * m * k * b.shape[-1]


def _conv_flops(name: str, args, out) -> int:
    """2·(the non-transposed conv's output)·(C_in/groups)·prod(kernel), once
    for the forward and once per gradient the backward computes."""
    if name == "convolution":
        x, w, transposed = args[0], args[1], args[6]
        y = x if transposed else out
        return 2 * y.numel() * math.prod(w.shape[1:])
    grad_out, x, w, transposed, mask = args[0], args[1], args[2], args[7], args[10]
    y = x if transposed else grad_out
    return 2 * y.numel() * math.prod(w.shape[1:]) * (int(mask[0]) + int(mask[1]))


@functools.cache
def _composite(func) -> bool:
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


class _Counter(TorchDispatchMode):
    """jaxpr_costs' rules on the aten ops dispatched under it."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.dot_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented                      # DTensor decomposes; count the locals
        kwargs = kwargs or {}
        if func.namespace != "aten":
            return func(*args, **kwargs)
        if _composite(func):
            # without autograd (inference mode) composite ops (matmul,
            # einsum) reach the mode whole: count the ops they decompose
            # into, as autograd's dispatch would
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        name = func._overloadpacket.__name__
        if name in _FREE:
            return out
        outs = sum(_nbytes(t) for t in _tensors(out))
        if name in _DOTS or name in _CONVS:
            io = sum(_nbytes(t) for t in _tensors((args, kwargs))) + outs
            self.bytes += io
            if name in _DOTS:
                self.flops += _dot_flops(name, args)
                self.dot_bytes += io
            else:
                self.flops += _conv_flops(name, args, out)
        elif name in _INDEXED:
            operand = _tensors(args[:1])
            self.bytes += outs + min(_nbytes(operand[0]) if operand else 0, 4 * outs or 1 << 62)
        else:
            self.bytes += outs
        return out

    def costs(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "dot_bytes": self.dot_bytes}


def _fake_mode(trees):
    """The ``FakeTensorMode`` that ``trees``' fake tensors belong to (or the
    active one), else a new one (CPU fakes)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode(trees) or FakeTensorMode()


def _run_fake(fn: Callable, args, mode: TorchDispatchMode):
    from torch._subclasses.fake_tensor import FakeTensor

    fm = _fake_mode(args)
    with fm:
        args = pytree.tree_map_only(
            torch.Tensor, lambda t: t if isinstance(t, (FakeTensor, DTensor)) else fm.from_tensor(t),
            args)
        with mode:
            return fn(*args)


def step_costs(fn: Callable, *args) -> dict:
    """{"flops", "bytes", "dot_bytes"} of one call ``fn(*args)``, run on fake
    tensors (real tensors among ``args`` are faked first; nothing is
    computed)."""
    counter = _Counter()
    _run_fake(fn, args, counter)
    return counter.costs()


def collective_bytes(fn: Callable, *args) -> dict:
    """Per-device result bytes of the collectives one call ``fn(*args)``
    issues, by ``repro``'s kinds, and their ``count``: run on fake tensors
    (as ``step_costs``) under ``CommDebugMode``, in the process's (fake)
    world."""
    from torch.distributed.tensor.debug import CommDebugMode

    sizes: collections.Counter = collections.Counter()

    class _Bytes(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and isinstance(func, torch._ops.OpOverload):
                name = func._overloadpacket.__name__
                if func.namespace != "aten" and name in _COLLECTIVES:
                    sizes[_COLLECTIVES[name]] += sum(_nbytes(t) for t in _tensors(out))
            return out

    comm = _Bytes()
    _run_fake(fn, args, comm)
    res = {k: 0 for k in KINDS}
    res.update(sizes)
    res["count"] = comm.get_total_counts()
    return res
