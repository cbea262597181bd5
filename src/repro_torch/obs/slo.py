"""SLO engine: declarative objectives, error budgets, multi-window burn rates.

An :class:`SLOSpec` names a *capability the campaign must keep honoring* —
queue-delay p99 under a bound, stage-in cache hit rate above a floor,
node-utilization above a floor, fault-recovery overhead under a cap — as a
measurement over :class:`~repro.obs.metrics.MetricsHub` instruments plus a
compliance objective. The :class:`SLOTracker` turns those specs into
sample-by-sample accounting on the **virtual** clock: every time the
engine's metronome drives a metrics sample (see
:meth:`~repro.obs.trace.TraceRecorder.engine_sample`), each SLO measures
its current value, judges it against the target, and records one
good/bad compliance sample. From those samples fall out:

* **attainment** — the fraction of samples in compliance so far;
* **error budget** — ``1 - objective`` is the allowed bad fraction; budget
  consumed is the observed bad fraction over that allowance;
* **burn rates** — per configured window ``W``, the bad fraction over the
  trailing ``(now - W, now]`` virtual seconds divided by the allowance. A
  burn rate of 1.0 spends the budget exactly at the sustainable pace;
  multi-window rules (fast window for pages, slow window for tickets) are
  the standard alerting construction on top (see :mod:`repro.obs.alerts`).

Like the recorder it rides on, the tracker is strictly read-only: it
never schedules events or mutates simulation state, so campaigns replay
bit-identically with SLO accounting on (``tests/test_obs.py`` holds this).

Measurements come in three shapes:

* ``series=...`` — the latest sample of a hub time series (queue depth,
  pool occupancy, cache hit rate, ...);
* ``series=..., percentile=q`` — the exact q-quantile of the series window
  (trailing ``window_s``, or the whole ring when unset);
* ``histogram=..., percentile=q`` — the bucket-interpolated q-quantile of
  a hub histogram (e.g. ``phase_s/queued`` for queue-delay p99 — the
  per-phase histograms the trace folds in as spans close).

Cold-side module: hot loops never import this (``tools/check_obs_imports``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

__all__ = [
    "SLOSpec",
    "SLOStatus",
    "SLOReport",
    "SLOTracker",
    "format_slo_report",
]

_OPS = ("<=", ">=")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective over a hub instrument.

    The measured value must satisfy ``value <op> target`` on at least
    ``objective`` of all compliance samples; ``burn_windows`` are the
    trailing virtual-time windows burn rates are reported over.
    """

    name: str
    target: float
    op: str = "<="
    series: Optional[str] = None
    histogram: Optional[str] = None
    percentile: Optional[float] = None
    window_s: Optional[float] = None        # series-quantile lookback
    objective: float = 0.99                 # required good fraction, (0, 1)
    burn_windows: tuple[float, ...] = (300.0, 3600.0)
    description: str = ""

    def __post_init__(self) -> None:
        if (self.series is None) == (self.histogram is None):
            raise ValueError(
                f"SLO {self.name!r}: exactly one of series= or histogram= "
                "must be set"
            )
        if self.histogram is not None and self.percentile is None:
            raise ValueError(
                f"SLO {self.name!r}: histogram measurements need percentile="
            )
        if self.op not in _OPS:
            raise ValueError(f"SLO {self.name!r}: op must be one of {_OPS}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1), "
                f"got {self.objective}"
            )
        if self.percentile is not None and not 0.0 <= self.percentile <= 1.0:
            raise ValueError(f"SLO {self.name!r}: percentile must be in [0, 1]")
        if any(w <= 0 for w in self.burn_windows):
            raise ValueError(f"SLO {self.name!r}: burn windows must be > 0")

    @property
    def budget(self) -> float:
        """The error budget: the allowed bad-sample fraction."""
        return 1.0 - self.objective

    def describe_objective(self) -> str:
        src = self.series if self.series is not None else self.histogram
        if self.percentile is not None:
            src = f"p{self.percentile * 100:g}({src})"
        return f"{src} {self.op} {self.target:g} for {self.objective:.1%}"


@dataclasses.dataclass(frozen=True)
class SLOStatus:
    """Point-in-time accounting for one SLO."""

    name: str
    objective_desc: str
    n_samples: int
    n_bad: int
    attainment: float            # good fraction over all samples (1.0 if none)
    objective: float
    budget_consumed: float       # bad fraction / allowed fraction
    burn_rates: dict[str, float]  # str(window_s) -> burn rate over that window
    current_value: Optional[float]
    target: float
    op: str
    ok_now: Optional[bool]       # last sample's verdict (None: unmeasurable)

    @property
    def budget_remaining(self) -> float:
        return 1.0 - self.budget_consumed

    @property
    def breached(self) -> bool:
        """The campaign-to-date attainment has fallen below the objective
        (equivalently: the error budget is overspent)."""
        return self.n_samples > 0 and self.attainment < self.objective


@dataclasses.dataclass(frozen=True)
class SLOReport:
    """All SLO statuses at one instant (what ``summarize(trace=...)``
    attaches to the campaign report)."""

    t: float
    statuses: tuple[SLOStatus, ...]

    @property
    def breached(self) -> tuple[SLOStatus, ...]:
        return tuple(s for s in self.statuses if s.breached)

    def status(self, name: str) -> SLOStatus:
        for s in self.statuses:
            if s.name == name:
                return s
        raise KeyError(name)


class _SLOState:
    """Per-SLO compliance ring + lifetime totals."""

    __slots__ = ("samples", "n", "bad", "last_value", "last_ok")

    def __init__(self, maxlen: int):
        #: trailing ``(t, bad)`` compliance samples for burn-rate windows
        self.samples: deque[tuple[float, int]] = deque(maxlen=maxlen)
        self.n = 0
        self.bad = 0
        self.last_value: Optional[float] = None
        self.last_ok: Optional[bool] = None


class SLOTracker:
    """Evaluates a set of :class:`SLOSpec` against one
    :class:`~repro.obs.metrics.MetricsHub`, one compliance sample per
    :meth:`observe` call (driven from the alert engine's metronome hook, or
    directly in tests).

    ``maxlen`` bounds the per-SLO compliance ring the burn-rate windows
    read from — windows longer than the ring covers degrade gracefully to
    the ring's span, exactly like the hub's series ring buffers.
    """

    def __init__(self, hub, specs, *, maxlen: int = 4096):
        self.hub = hub
        self.specs: tuple[SLOSpec, ...] = tuple(specs)
        names = [s.name for s in self.specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self._state = {s.name: _SLOState(maxlen) for s in self.specs}
        self._needs_trace = any(s.histogram is not None for s in self.specs)
        self.samples_taken = 0
        self.last_t: Optional[float] = None

    # -- measurement ----------------------------------------------------------
    def measure(self, spec: SLOSpec, t: float) -> Optional[float]:
        """The spec's current value at virtual time ``t`` (``None`` when the
        instrument has no data yet — no compliance sample is charged)."""
        if spec.histogram is not None:
            h = self.hub.histograms.get(spec.histogram)
            return h.percentile(spec.percentile) if h is not None else None
        s = self.hub.series.get(spec.series)
        if s is None or len(s) == 0:
            return None
        if spec.percentile is not None:
            t0 = t - spec.window_s if spec.window_s is not None else None
            return s.quantile(spec.percentile, t0=t0, t1=t)
        return s.last()[1]

    def observe(self, t: float, trace=None) -> None:
        """Record one compliance sample per SLO at virtual time ``t``.

        Histogram-backed SLOs read the per-phase histograms the trace folds
        in at materialization, so a recorder handed in is materialized
        first (incremental and read-only — the sanctioned mid-campaign
        read path).
        """
        self.samples_taken += 1
        self.last_t = t
        if self._needs_trace and trace is not None:
            trace._materialize()
        for spec in self.specs:
            st = self._state[spec.name]
            v = self.measure(spec, t)
            st.last_value = v
            if v is None:
                st.last_ok = None
                continue
            ok = (v <= spec.target) if spec.op == "<=" else (v >= spec.target)
            st.last_ok = ok
            bad = 0 if ok else 1
            st.n += 1
            st.bad += bad
            st.samples.append((t, bad))

    # -- accounting -----------------------------------------------------------
    def burn_rate(self, name: str, window_s: float, now: float) -> float:
        """Bad fraction over the trailing ``(now - window_s, now]`` divided
        by the error budget; 0.0 when the window holds no samples."""
        spec = self._spec(name)
        st = self._state[name]
        t0 = now - window_s
        n = bad = 0
        for t, b in reversed(st.samples):
            if t <= t0:
                break
            n += 1
            bad += b
        if n == 0:
            return 0.0
        return (bad / n) / spec.budget

    def status(self, name: str, now: Optional[float] = None) -> SLOStatus:
        spec = self._spec(name)
        st = self._state[name]
        now = now if now is not None else (self.last_t or 0.0)
        attainment = 1.0 - st.bad / st.n if st.n else 1.0
        consumed = (st.bad / st.n) / spec.budget if st.n else 0.0
        return SLOStatus(
            name=spec.name,
            objective_desc=spec.describe_objective(),
            n_samples=st.n,
            n_bad=st.bad,
            attainment=attainment,
            objective=spec.objective,
            budget_consumed=consumed,
            burn_rates={
                f"{w:g}": self.burn_rate(name, w, now) for w in spec.burn_windows
            },
            current_value=st.last_value,
            target=spec.target,
            op=spec.op,
            ok_now=st.last_ok,
        )

    def report(self, now: Optional[float] = None) -> SLOReport:
        now = now if now is not None else (self.last_t or 0.0)
        return SLOReport(
            t=now,
            statuses=tuple(self.status(s.name, now) for s in self.specs),
        )

    def _spec(self, name: str) -> SLOSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(f"unknown SLO {name!r}")


def format_slo_report(report: SLOReport) -> str:
    """Terminal table: one line per SLO with attainment, budget, burns."""
    if not report.statuses:
        return "SLOs: none defined"
    lines = [f"SLOs at t={report.t:,.1f}s (virtual):"]
    for s in report.statuses:
        burns = "  ".join(
            f"burn[{w}s]={r:.2f}" for w, r in s.burn_rates.items()
        )
        cur = "-" if s.current_value is None else f"{s.current_value:g}"
        flag = "BREACHED" if s.breached else "ok"
        lines.append(
            f"  {s.name:<24} {flag:<9} attain={s.attainment:.3%} "
            f"(objective {s.objective:.1%}, {s.n_bad}/{s.n_samples} bad)  "
            f"budget={s.budget_remaining:+.1%}  {burns}  now={cur} "
            f"(want {s.op} {s.target:g})"
        )
    return "\n".join(lines)
