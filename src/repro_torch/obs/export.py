"""Trace exporters: Chrome trace-event JSON (Perfetto) and JSONL.

The Chrome export lays a campaign out on four process tracks:

* ``jobs`` — one thread per job, ``X`` (complete) spans per lifecycle
  phase, ``i`` instants for terminal DONE/FAILED markers and faults, and
  ``s``/``f`` flow arrows from each fault/preemption to the grant of the
  requeued attempt it caused (the parent → resume causal link).
* ``storage sessions`` — one thread per negotiated backend, a span per
  granted session (grant → release), plus negotiation instants carrying
  per-backend rejection reasons.
* ``storage pools`` — one thread per pool: its lifetime span
  (create → teardown, or trace end while still live), lease
  attach/release instants, and eviction instants.
* ``metrics`` — every :class:`~repro.obs.metrics.MetricsHub` time series
  as Chrome ``C`` counter events (rendered as area charts).

Timestamps are virtual seconds scaled to microseconds (the unit the
trace-event format mandates). Load the file at https://ui.perfetto.dev
or ``chrome://tracing``.

The JSONL export is the programmatic twin: one self-describing record per
line (``span`` / ``session`` / ``event`` / ``count``), for pandas-style
analysis without a trace viewer.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

_PID_JOBS = 1
_PID_SESSIONS = 2
_PID_POOLS = 3
_PID_METRICS = 4

#: Stable colors per phase (Chrome trace color names).
_PHASE_COLOR = {
    "queued": "grey",
    "allocated": "thread_state_runnable",
    "provisioning": "thread_state_iowait",
    "staging_in": "rail_load",
    "running": "thread_state_running",
    "staging_out": "rail_response",
    "teardown": "terrible",
}


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def _meta(pid: int, tid: int, field: str, name: str) -> dict:
    return {
        "ph": "M",
        "pid": pid,
        "tid": tid,
        "name": field,
        "args": {"name": name},
    }


def chrome_trace(trace, metrics=None) -> dict:
    """Render a :class:`~repro.obs.trace.TraceRecorder` (and optional
    :class:`~repro.obs.metrics.MetricsHub`) as a trace-event JSON dict."""
    ev: list[dict] = []
    ev.append(_meta(_PID_JOBS, 0, "process_name", "jobs"))
    ev.append(_meta(_PID_SESSIONS, 0, "process_name", "storage sessions"))
    ev.append(_meta(_PID_POOLS, 0, "process_name", "storage pools"))
    ev.append(_meta(_PID_METRICS, 0, "process_name", "metrics"))

    _, t_end = trace.t_range()

    # -- job phase spans ------------------------------------------------------
    for jid in sorted(trace.spans):
        meta = trace.job_meta.get(jid, {})
        label = meta.get("name", f"job {jid}")
        ev.append(_meta(_PID_JOBS, jid, "thread_name", f"{label} #{jid}"))
        for phase, t0, t1 in trace.spans[jid]:
            if phase in ("done", "failed"):
                ev.append(
                    {
                        "ph": "i",
                        "pid": _PID_JOBS,
                        "tid": jid,
                        "ts": _us(t0),
                        "s": "t",
                        "name": phase,
                        "cat": "terminal",
                    }
                )
                continue
            span = {
                "ph": "X",
                "pid": _PID_JOBS,
                "tid": jid,
                "ts": _us(t0),
                "dur": _us(t1 - t0),
                "name": phase,
                "cat": "phase",
                "args": {"job_id": jid, "backend": meta.get("backend")},
            }
            color = _PHASE_COLOR.get(phase)
            if color is not None:
                span["cname"] = color
            ev.append(span)

    # -- requeue causal links: fault/preempt -> next grant of the same job ----
    grants_by_job: dict[int, list[float]] = {}
    for kind, t, _label, args in trace.events:
        if kind == "grant":
            grants_by_job.setdefault(args["job_id"], []).append(t)
    flow_id = 0
    for kind, t, label, args in trace.events:
        if kind not in ("fault", "preempt"):
            continue
        jid = args["job_id"]
        ev.append(
            {
                "ph": "i",
                "pid": _PID_JOBS,
                "tid": jid,
                "ts": _us(t),
                "s": "t",
                "name": kind,
                "cat": kind,
                "args": args,
            }
        )
        if kind == "fault" and not args.get("requeued"):
            continue
        nxt = next((g for g in grants_by_job.get(jid, ()) if g >= t), None)
        if nxt is None:
            continue
        flow_id += 1
        common = {"pid": _PID_JOBS, "tid": jid, "cat": "requeue", "id": flow_id}
        ev.append({"ph": "s", "ts": _us(t), "name": f"{kind} requeue", **common})
        ev.append(
            {
                "ph": "f",
                "ts": _us(nxt),
                "name": f"{kind} requeue",
                "bp": "e",
                **common,
            }
        )

    # -- per-backend session tracks ------------------------------------------
    backend_tid: dict[Optional[str], int] = {}

    def _btid(backend: Optional[str]) -> int:
        tid = backend_tid.get(backend)
        if tid is None:
            tid = backend_tid[backend] = len(backend_tid) + 1
            ev.append(
                _meta(_PID_SESSIONS, tid, "thread_name", str(backend or "unknown"))
            )
        return tid

    for jid, backend, pool_id, t0, t1 in trace.sessions:
        name = trace.job_meta.get(jid, {}).get("name", f"job {jid}")
        ev.append(
            {
                "ph": "X",
                "pid": _PID_SESSIONS,
                "tid": _btid(backend),
                "ts": _us(t0),
                "dur": _us(t1 - t0),
                "name": name,
                "cat": "session",
                "args": {"job_id": jid, "pool_id": pool_id},
            }
        )
    for kind, t, label, args in trace.events:
        if kind != "negotiation":
            continue
        ev.append(
            {
                "ph": "i",
                "pid": _PID_SESSIONS,
                "tid": _btid(args.get("backend")),
                "ts": _us(t),
                "s": "t",
                "name": f"negotiate {label}",
                "cat": "negotiation",
                "args": args,
            }
        )

    # -- per-pool tracks ------------------------------------------------------
    pool_open: dict[int, tuple[float, dict]] = {}
    pool_named: set[int] = set()

    def _pool_track(pool_id: int) -> int:
        if pool_id not in pool_named:
            pool_named.add(pool_id)
            ev.append(_meta(_PID_POOLS, pool_id, "thread_name", f"pool {pool_id}"))
        return pool_id

    for kind, t, label, args in trace.events:
        pid = args.get("pool_id")
        if pid is None:
            continue
        if kind == "pool_created":
            pool_open[pid] = (t, args)
            _pool_track(pid)
        elif kind == "pool_torn_down":
            opened = pool_open.pop(pid, (t, {}))
            ev.append(
                {
                    "ph": "X",
                    "pid": _PID_POOLS,
                    "tid": _pool_track(pid),
                    "ts": _us(opened[0]),
                    "dur": _us(t - opened[0]),
                    "name": f"pool {pid}",
                    "cat": "pool",
                    "args": opened[1],
                }
            )
        elif kind in ("lease_attached", "lease_released", "eviction", "pool_retired"):
            ev.append(
                {
                    "ph": "i",
                    "pid": _PID_POOLS,
                    "tid": _pool_track(pid),
                    "ts": _us(t),
                    "s": "t",
                    "name": f"{kind} {label}",
                    "cat": kind,
                    "args": args,
                }
            )
    for pid, (t0, args) in pool_open.items():   # still live at trace end
        ev.append(
            {
                "ph": "X",
                "pid": _PID_POOLS,
                "tid": _pool_track(pid),
                "ts": _us(t0),
                "dur": _us(max(t_end, t0) - t0),
                "name": f"pool {pid} (live)",
                "cat": "pool",
                "args": args,
            }
        )

    # -- metrics counter tracks ----------------------------------------------
    if metrics is None:
        metrics = getattr(trace, "metrics", None)
    if metrics is not None:
        for name, series in metrics.series.items():
            for t, v in series.items():
                ev.append(
                    {
                        "ph": "C",
                        "pid": _PID_METRICS,
                        "tid": 0,
                        "ts": _us(t),
                        "name": name,
                        "args": {name: v},
                    }
                )

    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_chrome_trace(path, trace, metrics=None) -> dict:
    """Serialize :func:`chrome_trace` to ``path``; returns the dict."""
    doc = chrome_trace(trace, metrics)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def jsonl_records(trace) -> Iterator[dict]:
    """Flat self-describing records for programmatic analysis."""
    for jid in sorted(trace.spans):
        meta = trace.job_meta.get(jid, {})
        for phase, t0, t1 in trace.spans[jid]:
            yield {
                "type": "span",
                "job_id": jid,
                "name": meta.get("name"),
                "phase": phase,
                "t0": t0,
                "t1": t1,
                "dur_s": t1 - t0,
            }
    for jid, backend, pool_id, t0, t1 in trace.sessions:
        yield {
            "type": "session",
            "job_id": jid,
            "backend": backend,
            "pool_id": pool_id,
            "t0": t0,
            "t1": t1,
        }
    for kind, t, label, args in trace.events:
        yield {"type": "event", "kind": kind, "t": t, "label": label, **args}
    for key, n in sorted(trace.counts.items()):
        yield {"type": "count", "key": key, "n": n}


def write_jsonl(path, trace) -> int:
    """Write one JSON record per line; returns the record count."""
    n = 0
    with open(path, "w") as f:
        for rec in jsonl_records(trace):
            f.write(json.dumps(rec))
            f.write("\n")
            n += 1
    return n
