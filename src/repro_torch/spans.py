"""Wall-clock spans inside the port: which part of the program the host was
running, and when.

``span(name)`` is a context manager and ``spanned(name)`` a decorator;
``tally(**amounts)`` adds to the innermost open span's fields. Off
(the default) each costs one test of a module global and hands back the
shared no-op ``OFF``: nothing is allocated. ``record()`` turns recording on
for a block and yields a ``Recording``: each span that starts inside it is
appended as a ``Span`` (name, parent, start_ns, end_ns, thread, fields),
stamped with ``time.perf_counter_ns()``. ``parent`` is the index of the
innermost span open when it started, on any thread: the layers that autograd
recomputes on its own thread nest under the span that called
``torch.autograd.grad``.

The recording also holds the offset between ``perf_counter_ns`` and the
clock of ``torch.profiler``'s events (the system clock, ``time.time_ns``),
read back to back at the block's entry and at its exit, so that the spans and
a profiler's events can be put on one clock (``Recording.to_profiler_ns``).
With ``profiler=True`` each span also opens
``torch.profiler.record_function(name)``, for tools that profile host
activity.

The spans of a train step: ``data.batch_at`` (the loader, with the bytes it
read), ``step.forward``, ``step.backward``, ``step.optimizer`` (with
``optim.clip`` inside), ``model.layer`` (each layer under ``remat_wrap``,
again for its recompute inside ``step.backward``), ``model.head`` (the
unembedding and the loss); and ``moe.*`` around the MoE layers' functions.

Imports the standard library only; torch is imported by ``record(profiler=True)``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time


class Span:
    """One recorded span. ``end_ns`` is None while it is open; ``fields``
    holds what was counted inside it (``tally``), None where nothing was."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "thread", "fields")

    def __init__(self, name, parent, start_ns, thread):
        self.name, self.parent, self.start_ns, self.thread = name, parent, start_ns, thread
        self.end_ns = None
        self.fields = None


class Recording:
    """What ``record`` yields: ``spans`` in the order they started, and
    ``offsets``, (perf_counter_ns, profiler clock minus perf_counter_ns) read
    at the block's entry and, once it has ended, at its exit."""

    def __init__(self, profiler: bool):
        self.spans: list[Span] = []
        self.offsets: list[tuple[int, int]] = []
        self.profiler = profiler
        self._open: list[int] = []          # indices into spans, innermost last
        self._lock = threading.Lock()

    def _mark(self):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        mid = (a + b) // 2
        self.offsets.append((mid, wall - mid))

    def to_profiler_ns(self, t_ns: int) -> int:
        """perf_counter time ``t_ns`` on the profiler's clock: the offsets
        read at entry and exit, interpolated."""
        (t0, o0), (t1, o1) = self.offsets[0], self.offsets[-1]
        if t1 == t0:
            return t_ns + o0
        return t_ns + o0 + (o1 - o0) * (t_ns - t0) // (t1 - t0)


class _Off:
    """The shared no-op every span is while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()
_REC: Recording | None = None


class _Open:
    """A span being recorded into ``rec``."""

    __slots__ = ("_rec", "_name", "_index", "_rf")

    def __init__(self, rec: Recording, name: str):
        self._rec, self._name, self._rf = rec, name, None

    def __enter__(self):
        rec = self._rec
        start = time.perf_counter_ns()
        with rec._lock:
            parent = rec._open[-1] if rec._open else None
            self._index = len(rec.spans)
            rec.spans.append(Span(self._name, parent, start, threading.get_ident()))
            rec._open.append(self._index)
        if rec.profiler:
            from torch.profiler import record_function
            self._rf = record_function(self._name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        rec = self._rec
        with rec._lock:
            rec.spans[self._index].end_ns = end
            if rec._open and rec._open[-1] == self._index:
                rec._open.pop()
            else:                            # another thread's span closed first
                rec._open.remove(self._index)
        return False


def span(name: str):
    """A context manager around one part of the program: ``OFF`` unless a
    ``record`` block is running."""
    rec = _REC
    if rec is None:
        return OFF
    return _Open(rec, name)


def spanned(name: str):
    """Decorator: each call of the function runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            rec = _REC
            if rec is None:
                return fn(*args, **kwargs)
            with _Open(rec, name):
                return fn(*args, **kwargs)
        return run
    return wrap


def tally(**amounts):
    """Add ``amounts`` to the fields of the innermost open span; nothing
    while no ``record`` block runs."""
    rec = _REC
    if rec is None:
        return
    with rec._lock:
        if not rec._open:
            return
        sp = rec.spans[rec._open[-1]]
        fields = sp.fields if sp.fields is not None else {}
        for k, v in amounts.items():
            fields[k] = fields.get(k, 0) + v
        sp.fields = fields


@contextlib.contextmanager
def record(profiler: bool = False):
    """Record every span that starts inside the block; yields the
    ``Recording``. What was recording before (nothing, as a rule) is
    restored on the way out, also when the block raises."""
    global _REC
    saved = _REC
    rec = Recording(profiler)
    rec._mark()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = saved
        rec._mark()
