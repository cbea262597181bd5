"""Which part of the program launched each device activity of a traced
window: the program's own spans (``repro_torch.spans.record``) against the
profiler's launch events.

Under ``ProfilerActivity.CUDA`` alone the profiler records, besides the
device's kernels, copies and sets, the host-side CUDA API calls (``cuda*``,
``cu*``) that launched them; an activity and its launch share a correlation id.
Each activity's device time is charged to the innermost program span open
at its launch's host time, put on the spans' clock by the offsets the
recording read at its entry and exit: by launch, never by when it ran, since
the host runs ahead of the device.

A span's chain (it and the spans around it) decides its phase:

    optimizer   under step.optimizer (``clip``: under optim.clip)
    recompute   model.layer under step.backward (remat "full")
    backward    under step.backward, outside model.layer
    head        under model.head, outside step.backward
    forward     under step.forward, outside model.head
    unspanned   under none of these (the harness's batch copies)

The host's time is split by the same rule, instant by instant. The idle gaps
between device activities are named by the span that launched the activity
ending each gap, or, outside every program span, by the harness's own span.
The phases, unspanned time and unmatched time (no launch event found) add up
to the window's device time."""

from __future__ import annotations

import bisect

PHASES = ("forward", "head", "recompute", "backward", "optimizer")


def phase_of(chain) -> str | None:
    """The phase of a span whose chain of names (it and the spans around
    it) is ``chain``; None outside every phase."""
    if "step.optimizer" in chain:
        return "optimizer"
    if "step.backward" in chain:
        return "recompute" if "model.layer" in chain else "backward"
    if "model.head" in chain:
        return "head"
    if "step.forward" in chain:
        return "forward"
    return None


def profiler_activity(prof) -> tuple[dict, list]:
    """From a finished ``torch.profiler.profile``: ({correlation id: host
    start in the profiler's ns} of every CUDA API call (``cuda*``, ``cu*``),
    [(name, correlation id, start_us, end_us)] of every device activity),
    read from the raw results, as ``trace.device_events`` reads them."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    launches, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            device.append((e.name(), e.correlation_id(), e.start_ns() / 1e3,
                           (e.start_ns() + e.duration_ns()) / 1e3))
        elif e.correlation_id() and e.name().startswith("cu"):
            launches[e.correlation_id()] = e.start_ns()
    return launches, device


def to_host(offsets, p_ns: int) -> int:
    """Profiler-clock time ``p_ns`` on the spans' clock (perf_counter ns).
    ``offsets``: a recording's (perf_counter ns, profiler minus perf_counter)
    at its entry and exit; the t with t + o0 + d (t - t0) / T = p_ns."""
    (t0, o0), (t1, o1) = offsets[0], offsets[-1]
    d, T = o1 - o0, t1 - t0
    if T == 0:
        return p_ns - o0
    return ((p_ns - o0) * T + d * t0) // (T + d)


class Phases:
    """The window's device and host time by phase. Built by ``attribute``;
    read by the ``*_ms_per_step.train`` metrics."""

    def __init__(self, steps: int):
        self.steps = steps
        self.device_s = {p: 0.0 for p in PHASES}
        self.launches = {p: 0 for p in PHASES}
        self.host_s = {p: 0.0 for p in PHASES}
        self.clip_device_s = self.clip_host_s = 0.0
        self.unspanned_s = self.unmatched_s = self.total_s = 0.0
        self.batch_at_s = 0.0
        self.batch_at_bytes = 0
        self.batch_at_calls = 0
        self.idle_gaps: list = []           # [label, seconds], the longest first

    @property
    def matched_share(self) -> float:
        return 1.0 - self.unmatched_s / self.total_s if self.total_s else 0.0

    def read(self, phase: str):
        """A phase's metric: device ms a step, with its kernels a step and
        its host ms a step; None where nothing was traced."""
        if not self.steps or not self.total_s:
            return None
        out = {"value": 1e3 * self.device_s[phase] / self.steps,
               "launches": self.launches[phase] / self.steps,
               "host_ms": 1e3 * self.host_s[phase] / self.steps}
        if phase == "optimizer":
            out["clip_ms"] = 1e3 * self.clip_device_s / self.steps
        return out

    def read_batch_at(self):
        """Host ms a step in ``data.batch_at``, with the MB/s it read."""
        if not self.steps or not self.batch_at_calls:
            return None
        return {"value": 1e3 * self.batch_at_s / self.steps,
                "read_mb_per_s": self.batch_at_bytes / 1e6 / self.batch_at_s
                if self.batch_at_s else 0.0}


def longest_gaps(device: list, top: int) -> list:
    """The ``top`` longest (start_us, end_us) gaps between device
    activities, longest first (``trace.Window.idle_gaps``' walk)."""
    gaps, end = [], None
    for s, e in sorted((s, e) for _, _, s, e in device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    return gaps[:top]


def attribute(recording, launches: dict, device: list, steps: int,
              host_spans: list = (), top: int = 10) -> Phases:
    """Charge each device activity to its phase, and name the ``top``
    longest idle gaps. ``recording``: the program's ``spans.Recording`` over
    the window; ``launches`` and ``device`` as ``profiler_activity`` gives
    them; ``host_spans``: the harness's own (what, start_ns, end_ns) on the
    spans' clock."""
    out = Phases(steps)
    spans = recording.spans
    last = recording.offsets[-1][0]
    # a span still open at the recording's exit ends there; none ends before it starts
    ends = [max(s.end_ns if s.end_ns is not None else last, s.start_ns + 1) for s in spans]
    chains = []
    for s in spans:
        up = chains[s.parent] if s.parent is not None else ()
        chains.append((s.name,) + up)
    phase = [phase_of(c) for c in chains]
    clip = ["optim.clip" in c for c in chains]

    # the innermost open span at each instant: a walk over starts and ends
    marks = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)]
                   + [(ends[i], 0, i) for i in range(len(spans))])
    times, innermost, open_ = [], [], []
    for t, starts, i in marks:
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        times.append(t)
        innermost.append(open_[-1] if open_ else None)
    for k in range(len(times) - 1):
        i, dt = innermost[k], (times[k + 1] - times[k]) / 1e9
        if i is not None and phase[i] is not None:
            out.host_s[phase[i]] += dt
            if clip[i]:
                out.clip_host_s += dt
    for i, s in enumerate(spans):
        if s.name == "data.batch_at":
            out.batch_at_s += (ends[i] - s.start_ns) / 1e9
            out.batch_at_bytes += (s.fields or {}).get("read_bytes", 0)
            out.batch_at_calls += 1

    gaps = longest_gaps(device, top)
    labels = dict.fromkeys((b for _, b in gaps), "host: unlabelled")
    for name, corr, s_us, e_us in device:
        dur = (e_us - s_us) / 1e6
        out.total_s += dur
        launched = launches.get(corr)
        if launched is None:
            out.unmatched_s += dur
            continue
        t = to_host(recording.offsets, launched)
        k = bisect.bisect_right(times, t) - 1
        i = innermost[k] if k >= 0 else None
        p = phase[i] if i is not None else None
        if p is None:
            out.unspanned_s += dur
        else:
            out.device_s[p] += dur
            out.launches[p] += 1
            if clip[i]:
                out.clip_device_s += dur
        if s_us in labels:
            labels[s_us] = f"host: {spans[i].name}" if i is not None else next(
                (f"host: {what}" for what, h0, h1 in host_spans if h0 <= t < h1),
                "host: between the harness's spans")
    out.idle_gaps = [[labels[b], (b - a) / 1e6] for a, b in gaps]
    return out
