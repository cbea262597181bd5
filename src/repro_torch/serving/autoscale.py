"""Alert-driven autoscaling: incidents in, lease attaches/drains out.

The PR 7 ``AlertEngine`` was built so consumers would react to its
PENDING -> FIRING -> RESOLVED lifecycle instead of re-deriving thresholds;
this module is the first such consumer. A control loop on the virtual clock
polls one queue-delay burn-rate rule:

* **FIRING** and under ``max_replicas`` and past the up-cooldown: scale up
  one replica — a warm pool lease attach, so capacity arrives in a
  cold-start, not a re-deploy.
* **not firing** and over ``min_replicas``: drain at most one replica per
  tick, and only one that has been idle past ``idle_ttl_s`` — the
  hysteresis pair (cooldown up, TTL + one-per-tick down) that keeps a
  flapping alert from thrashing the fleet.

The alert engine itself stays passive: each control tick samples the hub
and calls ``alerts.evaluate`` on the virtual clock — the same read-only
evaluation the recorder metronome drives, just on the control cadence, so
a campaign replays bit-identically.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..obs.trace import NULL_RECORDER

#: ``AlertEngine.state()`` value this scaler keys on. A string literal —
#: serving is a hot package and may not import ``repro.obs.alerts`` at
#: module level (see tools/check_obs_imports.py).
_FIRING = "firing"


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    rule: str                        # alert rule name to watch
    min_replicas: int = 1
    max_replicas: int = 4
    control_every_s: float = 15.0
    scale_up_cooldown_s: float = 90.0
    idle_ttl_s: float = 120.0

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min <= max, got [{self.min_replicas}, {self.max_replicas}]"
            )
        if self.control_every_s <= 0:
            raise ValueError("control_every_s must be positive")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One control-tick outcome, recorded for replay comparison."""

    t: float
    action: str          # "up" | "down" | "hold"
    replica: Optional[str]
    reason: str
    n_live: int          # fleet size after the decision


class Autoscaler:
    """SLO-aware fleet controller over a :class:`ReplicaSet`.

    ``alerts`` is duck-typed: anything with ``state(rule) -> str`` works
    (the hysteresis unit tests script one); a real ``AlertEngine`` (which
    also has ``hub`` and ``evaluate``) is additionally re-evaluated each
    tick so incident lifecycle keeps pace with the control loop.
    """

    def __init__(self, alerts, cfg: AutoscalerConfig, *, recorder=NULL_RECORDER):
        self.alerts = alerts
        self.cfg = cfg
        self.recorder = recorder
        self.decisions: List[ScaleDecision] = []
        self.scale_ups = 0
        self.scale_downs = 0
        self.denied_ups = 0
        self._last_up = float("-inf")
        self._rset = None
        self._engine = None
        self._stop_when = None

    # -- wiring ---------------------------------------------------------------
    def bind(self, rset, engine, *, stop_when=None) -> "Autoscaler":
        """Attach the fleet and clock; ``stop_when()`` (optional) ends the
        control loop — without it the loop would keep the heap alive
        forever and the campaign could never drain."""
        self._rset = rset
        self._engine = engine
        self._stop_when = stop_when
        return self

    def start(self, t0: float) -> None:
        self._engine.at(t0, self._control)

    # -- control loop ---------------------------------------------------------
    def _control(self) -> None:
        now = self._engine.now
        self._refresh(now)
        self.decide(now)
        if self._stop_when is not None and self._stop_when():
            return
        self._engine.after(self.cfg.control_every_s, self._control)

    def _refresh(self, now: float) -> None:
        """Bring the alert engine up to date on the control cadence: sample
        the hub's probes, then run the (read-only) rule evaluation. Scripted
        fakes without ``hub``/``evaluate`` are simply polled as-is."""
        hub = getattr(self.alerts, "hub", None)
        evaluate = getattr(self.alerts, "evaluate", None)
        if hub is not None:
            hub.sample(now)
        if evaluate is not None:
            trace = self.recorder if self.recorder.enabled else None
            evaluate(now, trace)

    def decide(self, now: float) -> ScaleDecision:
        """One pure control decision against the current alert state —
        factored out so hysteresis is unit-testable without an engine."""
        cfg = self.cfg
        rset = self._rset
        if rset.n_live < cfg.min_replicas:
            # involuntary scale-down (node loss killed replicas): restoring
            # the floor is not a load decision, so it bypasses the
            # up-cooldown — but still competes for cluster capacity
            r = rset.scale_up(now, reason="floor-restore")
            if r is not None:
                self._last_up = now
                self.scale_ups += 1
                d = ScaleDecision(now, "up", r.name, "floor-restore", rset.n_live)
            else:
                self.denied_ups += 1
                d = ScaleDecision(now, "hold", None,
                                  "floor-restore denied: cluster busy", rset.n_live)
            self.decisions.append(d)
            rec = self.recorder
            if rec.enabled and d.action != "hold":
                rec.events.append((
                    "autoscale", now, d.action,
                    {"replica": d.replica, "reason": d.reason, "n_live": d.n_live},
                ))
            return d
        firing = self.alerts.state(cfg.rule) == _FIRING
        if firing:
            if (
                rset.n_live < cfg.max_replicas
                and now - self._last_up >= cfg.scale_up_cooldown_s
            ):
                r = rset.scale_up(now, reason=f"alert {cfg.rule} firing")
                if r is not None:
                    self._last_up = now
                    self.scale_ups += 1
                    d = ScaleDecision(now, "up", r.name,
                                      f"alert {cfg.rule} firing", rset.n_live)
                else:
                    self.denied_ups += 1
                    d = ScaleDecision(now, "hold", None,
                                      "scale-up denied: cluster busy", rset.n_live)
            else:
                why = ("at max_replicas" if rset.n_live >= cfg.max_replicas
                       else "up-cooldown")
                d = ScaleDecision(now, "hold", None, why, rset.n_live)
        else:
            victims = (
                rset.idle_replicas(now, cfg.idle_ttl_s)
                if rset.n_live > cfg.min_replicas else []
            )
            if victims:
                victim = victims[0]
                rset.scale_down(victim, now, reason="alert resolved + idle TTL")
                self.scale_downs += 1
                d = ScaleDecision(now, "down", victim.name,
                                  "alert resolved + idle TTL", rset.n_live)
            else:
                d = ScaleDecision(now, "hold", None, "steady", rset.n_live)
        self.decisions.append(d)
        rec = self.recorder
        if rec.enabled and d.action != "hold":
            rec.events.append((
                "autoscale", now, d.action,
                {"replica": d.replica, "reason": d.reason, "n_live": d.n_live},
            ))
        return d
