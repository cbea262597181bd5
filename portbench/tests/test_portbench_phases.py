"""The phase split (``phases.py``) on a synthetic window: program spans of
one step, launch events on the profiler's clock (offset from the spans' and
drifting), and device activities. Each phase metric reads what was launched
in its spans; the phases, unspanned and unmatched time add up to the
window's device time; an idle gap is named by the span that launched the
activity after it, or by the harness's span outside the program's. And
``phase_split.py`` end to end on the CPU at a small size, where no device
work is traced: the spans of each step, the loader's bytes, the windows in
turns."""

import pytest
import torch

from portbench import harness, phase_split, phases
from repro_torch.spans import Recording, Span

from small import small_cell

US = 1000                                  # ns
OFFSET = 1_792_000_000_000_000_000         # profiler clock minus perf_counter, at entry
DRIFT = 2_000                              # ns more by the exit

# (name, parent, start, end) in us on the spans' clock
SPANS = [
    ("data.batch_at", None, 10, 50),
    ("step.forward", None, 100, 400),
    ("model.layer", 1, 110, 200),
    ("model.layer", 1, 200, 290),
    ("model.head", 1, 300, 390),
    ("step.backward", None, 400, 800),
    ("model.layer", 5, 450, 500),
    ("model.layer", 5, 600, 650),
    ("step.optimizer", None, 800, 990),
    ("optim.clip", 8, 810, 850),
]
HARNESS = [("loader", 0, 100 * US), ("train step", 100 * US, 1000 * US)]

# (name, correlation, launched at (us, spans' clock) or None, device start, end (us))
ACTS = [
    ("Memcpy HtoD", 1, 60, 1000, 1002),      # the harness's copy: unspanned
    ("embed", 2, 105, 1002, 1005),           # forward, outside the layers
    ("layer", 3, 120, 1005, 1015),
    ("final_norm", 4, 295, 1015, 1016),
    ("logits", 5, 310, 1030, 1050),          # head, after a 14 us gap
    ("loss_bwd", 6, 420, 1050, 1060),
    ("recompute", 7, 460, 1060, 1070),
    ("layer_bwd", 8, 660, 1070, 1085),
    ("norm", 9, 820, 1085, 1087),            # clip
    ("adamw", 10, 900, 1087, 1120),
    ("orphan", 11, None, 1125, 1126),        # no launch event: unmatched
    ("Memcpy HtoD", 12, 60, 1200, 1201),     # after a 74 us gap, launched in "loader"
]


def _window():
    rec = Recording(profiler=False)
    rec.offsets = [(0, OFFSET), (2000 * US, OFFSET + DRIFT)]
    for name, parent, s, e in SPANS:
        sp = Span(name, parent, s * US, 0)
        sp.end_ns = e * US
        rec.spans.append(sp)
    rec.spans[0].fields = {"read_bytes": 4_000}
    launches = {c: rec.to_profiler_ns(at * US) for _, c, at, _, _ in ACTS if at is not None}
    launches[99] = OFFSET                    # a runtime call that launched nothing
    device = [(n, c, float(s), float(e)) for n, c, _, s, e in ACTS]
    return phases.attribute(rec, launches, device, steps=1, host_spans=HARNESS, top=3)


def test_the_clock_undoes_the_recordings_offsets():
    rec = Recording(profiler=False)
    rec.offsets = [(0, OFFSET), (2000 * US, OFFSET + DRIFT)]
    for t in (0, 1, 777 * US, 2000 * US, 5000 * US):
        assert abs(phases.to_host(rec.offsets, rec.to_profiler_ns(t)) - t) <= 1


def test_each_phase_reads_what_its_spans_launched():
    p = _window()
    ms = 1e-3                                # 1 us in ms
    want = {"forward": (3 + 10 + 1, 3), "head": (20, 1), "recompute": (10, 1),
            "backward": (10 + 15, 2), "optimizer": (2 + 33, 2)}
    for phase, (dev_us, n) in want.items():
        got = p.read(phase)
        assert got["value"] == pytest.approx(dev_us * ms), phase
        assert got["launches"] == n, phase
    assert p.read("optimizer")["clip_ms"] == pytest.approx(2 * ms)
    host_us = {"forward": 300 - 90, "head": 90, "recompute": 100, "backward": 400 - 100,
               "optimizer": 190}
    for phase, us in host_us.items():
        assert p.read(phase)["host_ms"] == pytest.approx(us * ms), phase
    assert p.clip_host_s == pytest.approx(40e-6)
    batch = p.read_batch_at()
    assert batch["value"] == pytest.approx(40 * ms)
    assert batch["read_mb_per_s"] == pytest.approx(4_000 / 1e6 / 40e-6)


def test_phases_unspanned_and_unmatched_add_up_to_the_device_time():
    p = _window()
    total = sum(e - s for *_, s, e in ACTS) / 1e6
    assert p.total_s == pytest.approx(total)
    assert p.unspanned_s == pytest.approx(3e-6)
    assert p.unmatched_s == pytest.approx(1e-6)
    assert sum(p.device_s.values()) + p.unspanned_s + p.unmatched_s == pytest.approx(total)
    assert p.matched_share == pytest.approx(1 - 1 / (total * 1e6))


def test_idle_gaps_are_named_by_the_span_that_launched_the_work_after_them():
    gaps = _window().idle_gaps
    assert [g[0] for g in gaps] == ["host: loader", "host: model.head", "host: unlabelled"]
    assert [g[1] for g in gaps] == pytest.approx([74e-6, 14e-6, 5e-6])


@pytest.mark.parametrize("metric,phase", [
    ("forward_ms_per_step.train", "forward"), ("head_ms_per_step.train", "head"),
    ("recompute_ms_per_step.train", "recompute"), ("backward_ms_per_step.train", "backward"),
    ("optimizer_ms_per_step.train", "optimizer"), ("batch_at_ms_per_step.train", None)])
def test_readers_read_the_window_phases_and_nothing_without_them(metric, phase):
    class W:
        pass
    w = W()
    read = harness.load_reader(metric)
    assert read(w) is None                   # a window without a phase split
    w.phases = _window()
    assert read(w) == (w.phases.read(phase) if phase else w.phases.read_batch_at())
    w.phases = phases.Phases(steps=3)        # nothing traced
    assert read(w) is None


def test_the_split_runs_a_small_cell_on_the_cpu():
    cell = small_cell("phi4-train-s2048")
    lines = phase_split.run(cell, 2**31 + 7, 0.3, 1, 0.2, torch.device("cpu"))
    assert [x["window"] for x in lines] == ["traced", "pair", "pair", "overhead"]
    traced = lines[0]
    # data.batch_at, step.forward/backward/optimizer, optim.clip, model.head, and
    # each layer twice (its forward and its recompute)
    assert traced["spans_per_step"] == 6 + 2 * cell.config["n_layers"]
    assert traced["device_activities"] == 0 and traced["device_ms_per_step"] == 0.0
    metrics = traced["metrics"]
    assert [metrics[m] for m in phase_split.PHASE_METRICS[:5]] == [None] * 5
    assert metrics["batch_at_ms_per_step.train"]["read_mb_per_s"] > 0
    assert [x["spans"] for x in lines[1:3]] == [False, True]
