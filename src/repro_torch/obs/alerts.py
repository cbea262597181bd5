"""Alert engine: threshold / rate-of-change / budget-burn rules with
hysteresis, evaluated on the engine's metronome — never on its own events.

The :class:`AlertEngine` is the *active* half of the observability layer:
where the :class:`~repro.obs.trace.TraceRecorder` passively records what
happened, the alert engine judges the live metric streams against rules
while the campaign runs. It stays strictly read-only with respect to the
simulation — evaluation happens inside the recorder's existing 512-event
metronome sample hook (``TraceRecorder._tick``, right after the metrics
hub samples its probes), schedules nothing, and mutates nothing outside
its own state — so campaigns replay bit-identically with alerting on
(``tests/test_obs.py`` holds this).

Rule kinds:

* ``threshold`` — the latest sample of ``series`` compares true against
  ``target`` (e.g. ``queue_depth >= 50``);
* ``rate`` — the series' average slope per virtual second over the
  trailing ``window_s`` compares true against ``target`` (e.g. queue depth
  growing faster than 0.1 jobs/s);
* ``burn`` — the named SLO's error-budget burn rate over ``window_s``
  (see :meth:`~repro.obs.slo.SLOTracker.burn_rate`) compares true against
  ``target`` (the burn *factor*; pair a fast small-window rule with a slow
  large-window one for the classic multi-window burn alert).

Lifecycle per rule — ``PENDING`` → ``FIRING`` → ``RESOLVED``:

* a true condition arms the rule as PENDING (stamped at the first true
  sample); it must *stay* true for ``for_s`` virtual seconds before the
  rule fires — a flapping series keeps re-arming and never fires;
* once FIRING, the rule stays firing without re-notifying while the
  condition holds (a sustained breach fires exactly once) and resolves on
  the first false evaluation.

Every lifecycle transition lands in the bound trace as an ``alert`` event
(kind/severity/value in the args), so firings are visible in the Perfetto
export and to the campaign doctor; :class:`AlertIncident` keeps the
fired→resolved intervals for reports and dashboards — and for the
autoscaling layer the roadmap points at, which should consume
:attr:`AlertEngine.incidents` / :meth:`AlertEngine.firing` rather than
re-deriving breaches from raw series.

Cold-side module: hot loops never import this (``tools/check_obs_imports``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "PENDING",
    "FIRING",
    "RESOLVED",
    "AlertRule",
    "AlertIncident",
    "AlertEngine",
    "format_alerts",
]

#: Lifecycle states (the INACTIVE ground state is implicit).
PENDING = "pending"
FIRING = "firing"
RESOLVED = "resolved"
_INACTIVE = "inactive"

_KINDS = ("threshold", "rate", "burn")
_OPS = ("<=", ">=")
_SEVERITIES = ("info", "warning", "critical")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative alerting rule over hub series / SLO burn rates."""

    name: str
    kind: str = "threshold"
    series: Optional[str] = None     # threshold / rate source
    slo: Optional[str] = None        # burn source (SLOTracker spec name)
    op: str = ">="
    target: float = 0.0
    for_s: float = 0.0               # hysteresis: condition must hold this long
    window_s: float = 300.0          # rate lookback / burn window
    severity: str = "warning"
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                f"alert {self.name!r}: kind must be one of {_KINDS}"
            )
        if self.op not in _OPS:
            raise ValueError(f"alert {self.name!r}: op must be one of {_OPS}")
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"alert {self.name!r}: severity must be one of {_SEVERITIES}"
            )
        if self.kind == "burn":
            if self.slo is None:
                raise ValueError(f"alert {self.name!r}: burn rules need slo=")
        elif self.series is None:
            raise ValueError(
                f"alert {self.name!r}: {self.kind} rules need series="
            )
        if self.for_s < 0 or self.window_s <= 0:
            raise ValueError(
                f"alert {self.name!r}: for_s must be >= 0 and window_s > 0"
            )


@dataclasses.dataclass
class AlertIncident:
    """One fired alert: the FIRING → RESOLVED interval (``t_resolved`` is
    ``None`` while still firing)."""

    rule: str
    severity: str
    t_pending: float
    t_fired: float
    t_resolved: Optional[float] = None
    value_at_fire: Optional[float] = None

    @property
    def open(self) -> bool:
        return self.t_resolved is None


class _RuleState:
    __slots__ = ("state", "pending_since", "incident")

    def __init__(self):
        self.state = _INACTIVE
        self.pending_since: Optional[float] = None
        self.incident: Optional[AlertIncident] = None


class AlertEngine:
    """Evaluates :class:`AlertRule` sets against one
    :class:`~repro.obs.metrics.MetricsHub` (and optional
    :class:`~repro.obs.slo.SLOTracker` for burn rules — the tracker's
    compliance sampling is driven from here too, so attaching the engine is
    all the wiring SLO accounting needs).

    Attach to a recorder either at construction
    (``TraceRecorder(metrics=hub, alerts=engine)``) or with
    :meth:`attach`; the recorder then calls :meth:`evaluate` at its
    metronome sample cadence.
    """

    def __init__(self, hub, rules=(), *, slos=None):
        self.hub = hub
        self.rules: tuple[AlertRule, ...] = tuple(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names in {names}")
        self.slos = slos
        for r in self.rules:
            if r.kind == "burn":
                if slos is None:
                    raise ValueError(
                        f"alert {r.name!r} is a burn rule but no slos= "
                        "tracker was attached"
                    )
                slos._spec(r.slo)           # fail fast on unknown SLO names
        self._state = {r.name: _RuleState() for r in self.rules}
        #: every incident that ever fired, in firing order
        self.incidents: list[AlertIncident] = []
        #: PENDING arms that cleared before ``for_s`` elapsed (flaps)
        self.pending_cancelled = 0
        self.evaluations = 0

    def attach(self, recorder) -> "AlertEngine":
        """Install on a recorder post-construction; returns self."""
        recorder.alerts = self
        return self

    # -- conditions -----------------------------------------------------------
    def _value(self, rule: AlertRule, t: float) -> Optional[float]:
        if rule.kind == "burn":
            return self.slos.burn_rate(rule.slo, rule.window_s, t)
        s = self.hub.series.get(rule.series)
        if s is None or len(s) == 0:
            return None
        if rule.kind == "threshold":
            return s.last()[1]
        # rate: average slope over the trailing window — needs a sample at
        # or before the window start, else the lookback isn't covered yet
        t_now, v_now = s.last()
        past = s.window(None, t_now - rule.window_s)
        if not past:
            return None
        t_then, v_then = past[-1]
        if t_now <= t_then:
            return None
        return (v_now - v_then) / (t_now - t_then)

    def _condition(self, rule: AlertRule, t: float) -> tuple[bool, Optional[float]]:
        v = self._value(rule, t)
        if v is None:
            return False, None
        ok = (v <= rule.target) if rule.op == "<=" else (v >= rule.target)
        return ok, v

    # -- evaluation (called from TraceRecorder._tick) -------------------------
    def evaluate(self, t: float, trace=None) -> None:
        """One metronome tick: sample SLO compliance, then run every rule's
        state machine. ``trace`` (the bound recorder) receives the
        lifecycle transition events."""
        self.evaluations += 1
        if self.slos is not None:
            self.slos.observe(t, trace)
        for rule in self.rules:
            st = self._state[rule.name]
            cond, value = self._condition(rule, t)
            if cond:
                if st.state == _INACTIVE:
                    st.pending_since = t
                    if rule.for_s > 0.0:
                        st.state = PENDING
                        self._event(trace, t, rule, PENDING, value)
                        continue
                    self._fire(trace, t, rule, st, value)
                elif st.state == PENDING and t - st.pending_since >= rule.for_s:
                    self._fire(trace, t, rule, st, value)
            else:
                if st.state == PENDING:
                    st.state = _INACTIVE
                    st.pending_since = None
                    self.pending_cancelled += 1
                elif st.state == FIRING:
                    st.state = _INACTIVE
                    st.pending_since = None
                    st.incident.t_resolved = t
                    st.incident = None
                    self._event(trace, t, rule, RESOLVED, value)

    def _fire(self, trace, t, rule, st, value) -> None:
        st.state = FIRING
        st.incident = AlertIncident(
            rule=rule.name,
            severity=rule.severity,
            t_pending=st.pending_since,
            t_fired=t,
            value_at_fire=value,
        )
        self.incidents.append(st.incident)
        self._event(trace, t, rule, FIRING, value)

    def _event(self, trace, t, rule, state, value) -> None:
        if trace is None or not trace.enabled:
            return
        trace.events.append(
            (
                "alert",
                t,
                rule.name,
                {
                    "state": state,
                    "kind": rule.kind,
                    "severity": rule.severity,
                    "value": value,
                    "target": rule.target,
                },
            )
        )

    # -- introspection --------------------------------------------------------
    def state(self, name: str) -> str:
        """Current lifecycle state of one rule (``inactive`` when quiet)."""
        return self._state[name].state

    def firing(self) -> tuple[str, ...]:
        """Names of the rules currently FIRING."""
        return tuple(r.name for r in self.rules
                     if self._state[r.name].state == FIRING)

    def incidents_for(self, name: str) -> list[AlertIncident]:
        return [i for i in self.incidents if i.rule == name]


def format_alerts(engine: AlertEngine) -> str:
    """Terminal summary: per-rule state plus the incident log."""
    lines = [
        f"alerts: {len(engine.rules)} rules, {len(engine.incidents)} "
        f"incidents, {engine.pending_cancelled} flaps suppressed, "
        f"{engine.evaluations} evaluations"
    ]
    for rule in engine.rules:
        lines.append(
            f"  {rule.name:<24} [{rule.severity}] {engine.state(rule.name):<9}"
            f" {rule.kind} {rule.series or rule.slo} {rule.op} {rule.target:g}"
            + (f" for {rule.for_s:g}s" if rule.for_s else "")
        )
    for inc in engine.incidents:
        end = f"{inc.t_resolved:,.1f}s" if inc.t_resolved is not None else "still firing"
        lines.append(
            f"    fired {inc.rule} [{inc.severity}] at {inc.t_fired:,.1f}s "
            f"(pending from {inc.t_pending:,.1f}s) -> {end}"
        )
    return "\n".join(lines)
