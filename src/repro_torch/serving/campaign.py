"""The serving campaign driver: requests + fleet + autoscaler on one clock.

Rides the orchestrator's :class:`SimEngine` rather than hand-rolling an
event loop — arrivals, prefill/decode steps, replica activations and the
autoscaler's control ticks are all heap events on the same virtual clock,
so a campaign with tracing, alerting and scaling attached replays
bit-identically for a fixed seed.

Wiring order inside :meth:`ServingCampaign.run`:

1. stage weights once into the PERSISTENT pool (``ReplicaSet.stage_weights``),
2. spin up the initial fleet the moment the weights are RESIDENT,
3. feed arrivals into a FIFO queue; idle replicas are woken per arrival,
   busy replicas pull at their next step boundary,
4. (optional) start the autoscaler's control loop,
5. drain the heap and report.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence

from ..obs.trace import NULL_RECORDER
from ..orchestrator.engine import SimEngine
from ..provision.service import ProvisioningService
from .replica import ModelProfile, ReplicaSet
from .workload import Request

#: histogram bounds tuned to serving latencies (the hub's defaults start
#: at 100 ms — too coarse for TPOT)
TTFT_BOUNDS = (0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0, 60.0, 180.0, 600.0)
TPOT_BOUNDS = (0.005, 0.01, 0.015, 0.02, 0.03, 0.05, 0.1, 0.25, 1.0)


def _quantile(sorted_vals: Sequence[float], q: float) -> float:
    """Exact linear-interpolation quantile over a pre-sorted sample."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """End-of-campaign rollup; percentiles are exact (per-request), not
    histogram-interpolated — the bench gates compare these."""

    n_requests: int
    n_completed: int
    weights_ready_at: float
    makespan_s: float
    ttft_p50_s: float
    ttft_p95_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p99_s: float
    queue_delay_p99_s: float
    e2e_p99_s: float
    tokens_generated: int
    tokens_prefilled: int
    tokens_per_s: float
    mean_occupancy: float
    replica_seconds: float
    peak_replicas: int
    n_replicas_final: int
    scale_ups: int
    scale_downs: int


def format_serving_report(r: ServingReport) -> str:
    lines = [
        f"requests      : {r.n_completed}/{r.n_requests} completed, "
        f"makespan {r.makespan_s:,.0f} s (weights ready at {r.weights_ready_at:,.0f} s)",
        f"TTFT          : p50 {r.ttft_p50_s:.2f} s | p95 {r.ttft_p95_s:.2f} s | "
        f"p99 {r.ttft_p99_s:.2f} s",
        f"TPOT          : p50 {r.tpot_p50_s * 1e3:.1f} ms | p99 {r.tpot_p99_s * 1e3:.1f} ms",
        f"queue delay   : p99 {r.queue_delay_p99_s:.2f} s   e2e p99 {r.e2e_p99_s:.2f} s",
        f"tokens        : {r.tokens_generated:,} generated "
        f"({r.tokens_per_s:,.0f} tok/s sustained), "
        f"{r.tokens_prefilled:,} prefilled, "
        f"mean batch occupancy {r.mean_occupancy:.2f}",
        f"fleet         : peak {r.peak_replicas}, final {r.n_replicas_final}, "
        f"{r.scale_ups} up / {r.scale_downs} down, "
        f"{r.replica_seconds:,.0f} replica-seconds",
    ]
    return "\n".join(lines)


class ServingCampaign:
    """One serving run: a request trace against a pool-backed fleet.

    Implements the replica ``source`` protocol (``pull`` /
    ``request_done``) and the :class:`ReplicaSet` listener protocol
    (``replica_active`` / ``replica_stopped``).
    """

    def __init__(
        self,
        cluster,
        model: ModelProfile,
        requests: Sequence[Request],
        *,
        initial_replicas: int = 1,
        autoscaler=None,
        recorder=NULL_RECORDER,
        pool_nodes: int = 2,
        n_compute_per_replica: int = 1,
        scratch_bytes: float = 0.0,
        sample_every: int = 64,
    ):
        if initial_replicas < 1:
            raise ValueError("initial_replicas must be >= 1")
        self.engine = SimEngine()
        # serving campaigns run far fewer heap events per virtual second
        # than a 50k-job batch campaign; tighten the metronome stride so the
        # alert engine sees bursts while they are live
        self.engine.SAMPLE_EVERY = sample_every
        self.service = ProvisioningService(cluster, clock=lambda: self.engine.now)
        self.recorder = recorder
        if recorder.enabled:
            recorder.bind_engine(self.engine, self.service)
        self.model = model
        self.requests = list(requests)
        self.initial_replicas = initial_replicas
        self.autoscaler = autoscaler
        self.rset = ReplicaSet(
            self.service, self.engine, model,
            pool_nodes=pool_nodes,
            n_compute_per_replica=n_compute_per_replica,
            scratch_bytes=scratch_bytes,
            recorder=recorder,
            source=self, listener=self,
        )
        self._queue: deque = deque()
        self.completed: List[Request] = []
        #: ``(rid, t_done)`` in completion-event order — the determinism
        #: regression compares this list across replays
        self.completion_order: list = []
        self._hub = recorder.metrics if recorder.enabled else None
        self._hist_ttft = None
        self._hist_tpot = None
        if self._hub is not None:
            self._register_metrics()

    # -- metrics --------------------------------------------------------------
    def _register_metrics(self) -> None:
        hub = self._hub
        engine = self.engine
        queue = self._queue
        rset = self.rset
        hub.add_probe("serving/queue_depth", lambda: len(queue))
        hub.add_probe(
            "serving/queue_delay_s",
            lambda: engine.now - queue[0].t_submit if queue else 0.0,
        )
        hub.add_probe("serving/n_replicas", lambda: rset.n_live)
        hub.add_probe(
            "serving/active_slots",
            lambda: sum(r.batch.n_active for r in rset.live),
        )
        self._hist_ttft = hub.histogram("serving/ttft_s", bounds=TTFT_BOUNDS)
        self._hist_tpot = hub.histogram("serving/tpot_s", bounds=TPOT_BOUNDS)

    # -- replica source protocol ----------------------------------------------
    def pull(self) -> Optional[Request]:
        if not self._queue:
            return None
        return self._queue.popleft()

    def requeue(self, req: Request) -> None:
        """A killed replica hands its in-flight requests back (chaos path):
        reset the measured lifecycle and put the request at the *front* of
        the queue — it was admitted first, it re-admits first."""
        req.replica = None
        req.t_admitted = None
        req.t_first_token = None
        req.t_done = None
        req.generated = 0
        self._queue.appendleft(req)
        self.rset.wake_one()

    def request_done(self, req: Request) -> None:
        self.completed.append(req)
        self.completion_order.append((req.rid, req.t_done))
        hub = self._hub
        if hub is not None:
            hub.counter("serving/requests_completed").inc()
            self._hist_ttft.observe(req.ttft_s)
            if req.tpot_s is not None:
                self._hist_tpot.observe(req.tpot_s)

    # -- replica-set listener protocol ----------------------------------------
    def replica_active(self, r) -> None:
        if self._queue:
            r.wake()

    def replica_stopped(self, r) -> None: ...

    # -- arrivals -------------------------------------------------------------
    def _arrive(self, req: Request) -> None:
        self._queue.append(req)
        if self._hub is not None:
            self._hub.counter("serving/requests_submitted").inc()
        self.rset.wake_one()

    # -- run ------------------------------------------------------------------
    def _quiescent(self) -> bool:
        floor = (
            self.autoscaler.cfg.min_replicas
            if self.autoscaler is not None else self.initial_replicas
        )
        return (
            len(self.completed) >= len(self.requests)
            and self.rset.n_live <= floor
        )

    def run(self, *, max_events: Optional[int] = None) -> ServingReport:
        rset = self.rset
        t_ready = rset.stage_weights(0.0)

        def bootstrap():
            now = self.engine.now
            for _ in range(self.initial_replicas):
                rset.scale_up(now, reason="initial fleet")

        self.engine.at(t_ready, bootstrap)
        self.engine.at_many(
            (req.t_submit, (lambda r=req: self._arrive(r)))
            for req in self.requests
        )
        if self.autoscaler is not None:
            self.autoscaler.bind(rset, self.engine, stop_when=self._quiescent)
            self.autoscaler.start(t_ready + self.autoscaler.cfg.control_every_s)
        if max_events is None:
            # generous backstop: every request costs a handful of heap
            # events (arrival, prefill, its share of decode steps)
            max_events = 10_000 + 400 * len(self.requests)
        self.engine.run(max_events=max_events)
        rset.finalize(self.engine.now)
        return self.report()

    # -- reporting ------------------------------------------------------------
    def report(self) -> ServingReport:
        done = self.completed
        ttfts = sorted(r.ttft_s for r in done) if done else []
        tpots = sorted(r.tpot_s for r in done if r.tpot_s is not None)
        qdels = sorted(r.queue_delay_s for r in done) if done else []
        e2es = sorted(r.e2e_s for r in done) if done else []
        tokens_gen = sum(b.tokens_generated for b in self._batches())
        tokens_pre = sum(b.tokens_prefilled for b in self._batches())
        steps = sum(b.decode_steps for b in self._batches())
        slot_steps = sum(b.decode_slot_steps for b in self._batches())
        t_first = min(
            (r.active_at for r in self.rset.replicas if r.active_at is not None),
            default=0.0,
        )
        t_last = max((r.t_done for r in done), default=t_first)
        window = max(t_last - t_first, 1e-9)
        return ServingReport(
            n_requests=len(self.requests),
            n_completed=len(done),
            weights_ready_at=self.rset.weights_ready_at or 0.0,
            makespan_s=t_last,
            ttft_p50_s=_quantile(ttfts, 0.50),
            ttft_p95_s=_quantile(ttfts, 0.95),
            ttft_p99_s=_quantile(ttfts, 0.99),
            tpot_p50_s=_quantile(tpots, 0.50),
            tpot_p99_s=_quantile(tpots, 0.99),
            queue_delay_p99_s=_quantile(qdels, 0.99),
            e2e_p99_s=_quantile(e2es, 0.99),
            tokens_generated=tokens_gen,
            tokens_prefilled=tokens_pre,
            tokens_per_s=tokens_gen / window,
            mean_occupancy=(slot_steps / steps) if steps else 0.0,
            replica_seconds=self.rset.replica_seconds,
            peak_replicas=self.rset.peak_replicas,
            n_replicas_final=self.rset.n_live,
            scale_ups=sum(1 for e in self.rset.scale_events if e[1] == "up") -
            self.initial_replicas,
            scale_downs=sum(1 for e in self.rset.scale_events if e[1] == "down"),
        )

    def _batches(self):
        return [r.batch for r in self.rset.replicas]
