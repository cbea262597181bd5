"""Observability: campaign tracing, time-series metrics, trace exporters,
and critical-path profiling.

Opt-in by construction: every hot component defaults to the shared no-op
:data:`~repro_torch.obs.trace.NULL_RECORDER`, and the only obs module the hot
loops may import is :mod:`repro_torch.obs.trace` (the recorder interface —
``tests/test_torch_imports.py`` guards this with
``tools/check_obs_imports.py``'s rule). Turning tracing on is one
argument::

    from repro_torch.obs import MetricsHub, TraceRecorder

    hub = MetricsHub()
    rec = TraceRecorder(metrics=hub, sample_every_s=120.0)
    orch = Orchestrator(cluster, recorder=rec)
    orch.run_campaign(specs)

    from repro_torch.obs.export import write_chrome_trace
    from repro_torch.obs.profile import critical_path, format_critical_path

    write_chrome_trace("trace.json", rec, hub)     # open in Perfetto
    print(format_critical_path(critical_path(rec)))
"""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsHub,
    TimeSeries,
)
from .trace import NULL_RECORDER, NullRecorder, TraceRecorder
from .export import chrome_trace, jsonl_records, write_chrome_trace, write_jsonl
from .profile import (
    CriticalPath,
    PathSegment,
    critical_path,
    format_critical_path,
)
from .slo import SLOReport, SLOSpec, SLOStatus, SLOTracker, format_slo_report
from .alerts import (
    FIRING,
    PENDING,
    RESOLVED,
    AlertEngine,
    AlertIncident,
    AlertRule,
    format_alerts,
)
from .diagnose import Advisory, diagnose, format_advisories
from .dashboard import build_dashboard, format_dashboard, write_dashboard

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsHub",
    "TimeSeries",
    "NULL_RECORDER",
    "NullRecorder",
    "TraceRecorder",
    "chrome_trace",
    "jsonl_records",
    "write_chrome_trace",
    "write_jsonl",
    "CriticalPath",
    "PathSegment",
    "critical_path",
    "format_critical_path",
    "SLOSpec",
    "SLOStatus",
    "SLOReport",
    "SLOTracker",
    "format_slo_report",
    "PENDING",
    "FIRING",
    "RESOLVED",
    "AlertRule",
    "AlertIncident",
    "AlertEngine",
    "format_alerts",
    "Advisory",
    "diagnose",
    "format_advisories",
    "build_dashboard",
    "write_dashboard",
    "format_dashboard",
]
