"""The port's wall-clock spans (``repro_torch/spans.py``): off, a span is the
shared no-op and nothing is recorded; on, spans nest by the innermost one
open on any thread, ``tally`` adds to the innermost, and ``record`` leaves
the off state behind even when its block raises. A smoke phi4-mini train
step under remat "full" records its phases (forward, each layer and its
recompute, the head, backward, the optimizer and its clip), and recording
changes no bit of the state. The loader's span counts the bytes it read
through the file system. Under a profiler that records host activity, each
span's ``record_function`` event lies inside the span once the recorded
clock offset is applied."""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.runtime import RuntimeConfig, make_train_state, make_train_step  # noqa: E402

B, S = 2, 16


def _names(rec):
    return [s.name for s in rec.spans]


def _chain(rec, i):
    """Names of span ``i`` and its ancestors, innermost first."""
    out = []
    while i is not None:
        out.append(rec.spans[i].name)
        i = rec.spans[i].parent
    return out


def test_off_records_nothing_and_returns_the_shared_no_op():
    assert spans.span("a") is spans.OFF
    assert spans.span("b") is spans.OFF
    with spans.span("a") as s:
        spans.tally(read_bytes=3)
    assert s is spans.OFF

    @spans.spanned("f")
    def f(x):
        return x + 1
    assert f(1) == 2
    with spans.record() as rec:
        pass
    assert rec.spans == []
    assert spans.span("a") is spans.OFF


def test_spans_nest_and_a_thread_nests_under_the_open_span():
    seen = {}

    def other():
        with spans.span("worker"):
            spans.tally(items=2)
            spans.tally(items=3)
        seen["thread"] = threading.get_ident()

    with spans.record() as rec:
        with spans.span("outer"):
            with spans.span("inner"):
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
            assert not t.is_alive()
        with spans.span("after"):
            pass
    assert _names(rec) == ["outer", "inner", "worker", "after"]
    outer, inner, worker, after = rec.spans
    assert (outer.parent, inner.parent, worker.parent, after.parent) == (None, 0, 1, None)
    assert worker.thread == seen["thread"] != outer.thread == inner.thread
    assert worker.fields == {"items": 5}
    assert outer.fields is None
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    assert outer.start_ns <= inner.start_ns <= worker.start_ns <= worker.end_ns \
        <= inner.end_ns <= outer.end_ns < after.start_ns
    assert len(rec.offsets) == 2


def test_record_restores_the_off_state_after_an_exception():
    @spans.spanned("failing")
    def failing():
        raise RuntimeError("left by an error")
    with pytest.raises(RuntimeError):
        with spans.record() as rec:
            with spans.span("outer"):
                failing()
    assert spans.span("x") is spans.OFF
    assert _names(rec) == ["outer", "failing"]
    assert all(s.end_ns is not None for s in rec.spans)
    assert rec.spans[1].parent == 0
    assert len(rec.offsets) == 2


def _phi4_step():
    cfg = get_smoke("phi4-mini-3.8b")
    model = build_model(cfg)
    rt = RuntimeConfig(remat="full", schedule="constant", opt=AdamWConfig(lr=1e-3))
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return cfg, (lambda: make_train_state(model, torch.Generator().manual_seed(1), rt)), \
        make_train_step(model, rt), batch


def test_train_step_records_its_phases_and_recording_changes_no_bit():
    cfg, fresh, step, batch = _phi4_step()
    off, on = fresh(), fresh()
    for _ in range(2):
        off, _ = step(off, batch)
    with spans.record() as rec:
        for _ in range(2):
            on, _ = step(on, batch)
    for a, b in zip(leaves(off.params) + leaves(off.opt.master) + leaves(off.opt.m)
                    + leaves(off.opt.v), leaves(on.params) + leaves(on.opt.master)
                    + leaves(on.opt.m) + leaves(on.opt.v)):
        assert torch.equal(a, b)
    assert torch.equal(off.opt.step, on.opt.step)

    def per_step(name, inside=None, outside=None):
        n = 0
        for i, s in enumerate(rec.spans):
            chain = _chain(rec, i)
            if s.name == name and (inside is None or inside in chain[1:]) \
                    and (outside is None or outside not in chain):
                n += 1
        assert n % 2 == 0, (name, n)
        return n // 2

    L = cfg.n_layers
    assert per_step("step.forward") == 1
    assert per_step("step.backward") == 1
    assert per_step("model.layer", inside="step.forward") == L
    assert per_step("model.layer", inside="step.backward") == L
    assert per_step("model.head", outside="step.backward") == 1
    assert per_step("model.head") == 1
    assert per_step("step.optimizer") == 1
    assert per_step("optim.clip", inside="step.optimizer") == 1
    assert {_chain(rec, i)[-1] for i in range(len(rec.spans))} == \
        {"step.forward", "step.backward", "step.optimizer"}
    assert len(rec.spans) == 2 * (4 + 2 * L + 1)


def test_loader_span_counts_the_bytes_it_read():
    from repro_torch.core import GlobalFS
    from repro_torch.data import DatasetSpec, Loader, write_corpus
    spec = DatasetSpec(7, 512, 5000, 1024)
    fs = GlobalFS()
    try:
        write_corpus(fs, "/d", spec)
        loader = Loader(spec, 4, 32, fs=fs, root="/d")
        with spans.record() as rec:
            loader.batch_at(3)
            loader.batch_at(40)              # wraps around the corpus
        Loader(spec, 4, 32).batch_at(0)      # off: nothing recorded
    finally:
        fs.teardown()
    assert _names(rec) == ["data.batch_at"] * 2
    assert [s.fields for s in rec.spans] == [{"read_bytes": 4 * 33 * 4}] * 2


def test_record_function_events_fall_inside_their_spans():
    from torch.profiler import ProfilerActivity, profile
    _, fresh, step, batch = _phi4_step()
    state = fresh()
    with spans.record(profiler=True) as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, batch)
        with spans.span("sleep"):
            time.sleep(0.005)
    names = set(_names(rec))
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in names),
                    key=lambda e: e.start_ns())
    assert sorted(e.name() for e in events) == sorted(_names(rec))
    slack = 500_000                                        # 0.5 ms
    for name in names:
        evs = [e for e in events if e.name() == name]
        sps = [s for s in rec.spans if s.name == name]
        for e, s in zip(evs, sps):
            assert rec.to_profiler_ns(s.start_ns) - slack <= e.start_ns(), name
            assert e.end_ns() <= rec.to_profiler_ns(s.end_ns) + slack, name
