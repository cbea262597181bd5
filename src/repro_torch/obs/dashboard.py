"""Campaign dashboard: one self-contained static HTML report, zero deps.

:func:`write_dashboard` renders everything the observability layer knows
about one campaign — stat tiles, the critical-path breakdown, SLO /
error-budget accounting, the alert timeline, sparklines for every hub
series, and the campaign doctor's advisories — into a **single HTML file
with no external requests**: styles inline, charts as inline SVG, no
scripts, no fonts, no network. Open it from disk, attach it to a CI run,
mail it around; it renders the same everywhere, honors the viewer's
light/dark preference via ``prefers-color-scheme`` (with a ``data-theme``
override), and degrades to readable tables when SVG is unavailable.

:func:`format_dashboard` is the same report for a terminal: it composes
the section formatters (:func:`~repro.obs.profile.format_critical_path`,
:func:`~repro.obs.slo.format_slo_report`,
:func:`~repro.obs.alerts.format_alerts`,
:func:`~repro.obs.diagnose.format_advisories`) under one header.

Both entry points auto-derive what they are not handed: metrics from
``trace.metrics``, the alert engine from ``trace.alerts``, the SLO report
from the engine's tracker, advisories from :func:`~repro.obs.diagnose.diagnose`.

Cold-side module: hot loops never import this (``tools/check_obs_imports``).
"""

from __future__ import annotations

import html as _html
from typing import Optional

from .diagnose import diagnose, format_advisories
from .profile import PHASES, critical_path, format_critical_path

__all__ = ["build_dashboard", "write_dashboard", "format_dashboard"]

#: Max points per sparkline path (deterministic even-stride down-sample).
_SPARK_POINTS = 240

# Categorical slots (fixed order, never cycled) and chrome, light/dark —
# the reference palette instance from the dataviz method; phases and
# severities map to fixed slots so color follows the entity, never rank.
_SERIES_LIGHT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                 "#e87ba4", "#008300", "#4a3aa7", "#e34948")
_SERIES_DARK = ("#3987e5", "#d95926", "#199e70", "#c98500",
                "#d55181", "#008300", "#9085e9", "#e66767")
#: Status palette (fixed, never themed; icon + label always ride along).
_STATUS = {"good": "#0ca30c", "warning": "#fab219",
           "serious": "#ec835a", "critical": "#d03b3b"}
_SEV_STATUS = {"info": "good", "warning": "warning", "critical": "critical"}

# Per-phase categorical assignment in PHASES display order; `unattributed`
# deliberately wears muted ink, not a series color — it is the "Other" bin.
_PHASE_SLOT = {p: i for i, p in enumerate(p for p in PHASES if p != "unattributed")}

_CSS = """
:root { color-scheme: light dark; }
body {
  margin: 0; padding: 24px;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: var(--page); color: var(--ink);
  --page: #f9f9f7; --surface: #fcfcfb; --ink: #0b0b0b;
  --ink-2: #52514e; --muted: #898781; --grid: #e1e0d9;
  --baseline: #c3c2b7; --border: rgba(11,11,11,0.10);
  --s1: #2a78d6; --s2: #eb6834; --s3: #1baf7a; --s4: #eda100;
  --s5: #e87ba4; --s6: #008300; --s7: #4a3aa7; --s8: #e34948;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) body {
    color-scheme: dark;
    --page: #0d0d0d; --surface: #1a1a19; --ink: #ffffff;
    --ink-2: #c3c2b7; --muted: #898781; --grid: #2c2c2a;
    --baseline: #383835; --border: rgba(255,255,255,0.10);
    --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
    --s5: #d55181; --s6: #008300; --s7: #9085e9; --s8: #e66767;
  }
}
:root[data-theme="dark"] body {
  color-scheme: dark;
  --page: #0d0d0d; --surface: #1a1a19; --ink: #ffffff;
  --ink-2: #c3c2b7; --muted: #898781; --grid: #2c2c2a;
  --baseline: #383835; --border: rgba(255,255,255,0.10);
  --s1: #3987e5; --s2: #d95926; --s3: #199e70; --s4: #c98500;
  --s5: #d55181; --s6: #008300; --s7: #9085e9; --s8: #e66767;
}
h1 { font-size: 20px; margin: 0 0 4px; }
h2 { font-size: 14px; margin: 28px 0 10px; color: var(--ink-2);
     text-transform: uppercase; letter-spacing: 0.06em; }
.sub { color: var(--muted); font-size: 12px; margin-bottom: 20px; }
.card { background: var(--surface); border: 1px solid var(--border);
        border-radius: 8px; padding: 14px 16px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--surface); border: 1px solid var(--border);
        border-radius: 8px; padding: 10px 16px; min-width: 110px; }
.tile .v { font-size: 22px; font-weight: 600; }
.tile .k { font-size: 11px; color: var(--muted); margin-top: 2px; }
table { border-collapse: collapse; width: 100%; font-size: 13px; }
th { text-align: left; color: var(--muted); font-weight: 500;
     font-size: 11px; padding: 4px 10px 4px 0;
     border-bottom: 1px solid var(--grid); }
td { padding: 5px 10px 5px 0; border-bottom: 1px solid var(--grid);
     font-variant-numeric: tabular-nums; }
.chip { display: inline-block; font-size: 11px; padding: 1px 8px;
        border-radius: 9px; border: 1px solid var(--border); }
.chip .dot { display: inline-block; width: 8px; height: 8px;
             border-radius: 4px; margin-right: 5px; }
.legend { display: flex; flex-wrap: wrap; gap: 6px 14px;
          font-size: 12px; color: var(--ink-2); margin-top: 8px; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
              border-radius: 3px; margin-right: 5px; vertical-align: -1px; }
.sparks { display: grid; gap: 12px;
          grid-template-columns: repeat(auto-fill, minmax(280px, 1fr)); }
.spark .name { font-size: 12px; color: var(--ink-2); }
.spark .now { font-size: 13px; font-weight: 600; float: right; }
.adv { margin: 10px 0; padding: 10px 14px; border-left: 3px solid var(--muted);
       background: var(--surface); border-radius: 0 8px 8px 0; }
.adv .head { font-weight: 600; font-size: 13px; }
.adv .rec { color: var(--ink-2); font-size: 13px; margin-top: 3px; }
.adv .why { color: var(--muted); font-size: 12px; margin-top: 3px; }
.none { color: var(--muted); font-size: 13px; }
svg text { font-family: inherit; }
"""


def _esc(v) -> str:
    return _html.escape(str(v), quote=True)


def _fmt_s(s: float) -> str:
    if s >= 3600:
        return f"{s / 3600:,.1f}h"
    if s >= 60:
        return f"{s / 60:,.1f}m"
    return f"{s:,.1f}s"


def _downsample(pts, cap):
    n = len(pts)
    if n <= cap:
        return pts
    idx = sorted({round(i * (n - 1) / (cap - 1)) for i in range(cap)})
    return [pts[i] for i in idx]


def _phase_color(phase: str) -> str:
    slot = _PHASE_SLOT.get(phase)
    return "var(--muted)" if slot is None else f"var(--s{slot % 8 + 1})"


def _tiles(items) -> str:
    cells = "".join(
        f'<div class="tile"><div class="v">{_esc(v)}</div>'
        f'<div class="k">{_esc(k)}</div></div>'
        for k, v in items
    )
    return f'<div class="tiles">{cells}</div>'


# -- sections -----------------------------------------------------------------

def _section_critical_path(cp) -> str:
    if cp is None or cp.makespan_s <= 0:
        return '<p class="none">no spans recorded</p>'
    present = [p for p in PHASES if cp.phase_s.get(p, 0.0) > 0]
    w, h = 720.0, 34.0
    x = 0.0
    segs = []
    for p in present:
        frac = cp.fraction(p)
        sw = max(0.0, frac * w - 2.0)            # 2px surface gap between fills
        segs.append(
            f'<rect x="{x:.1f}" y="4" width="{sw:.1f}" height="22" rx="3" '
            f'fill="{_phase_color(p)}"><title>{_esc(p)}: '
            f'{_fmt_s(cp.phase_s[p])} ({frac:.1%})</title></rect>'
        )
        x += frac * w
    legend = "".join(
        f'<span><span class="sw" style="background:{_phase_color(p)}"></span>'
        f"{_esc(p)} {cp.fraction(p):.0%}</span>"
        for p in present
    )
    return (
        f'<div class="card"><svg viewBox="0 0 {w:g} {h:g}" role="img" '
        f'aria-label="critical path by phase" width="100%" height="{h:g}">'
        f'{"".join(segs)}</svg>'
        f'<div class="legend">{legend}</div>'
        f'<div class="sub" style="margin:6px 0 0">makespan '
        f"{_fmt_s(cp.makespan_s)} across {len(cp.segments)} path segments; "
        "buckets tile the makespan exactly</div></div>"
    )


def _chip(status: str, label: str) -> str:
    color = _STATUS[status]
    icon = {"good": "&#10003;", "warning": "&#9888;",
            "serious": "&#9888;", "critical": "&#10007;"}[status]
    return (
        f'<span class="chip"><span class="dot" '
        f'style="background:{color}"></span>{icon} {_esc(label)}</span>'
    )


def _section_slos(slo) -> str:
    if slo is None or not slo.statuses:
        return '<p class="none">no SLOs defined</p>'
    rows = []
    for s in slo.statuses:
        burns = "  ".join(f"{w}s: {r:.2f}" for w, r in s.burn_rates.items())
        # budget bar: share spent, clamped; state colors carry icon+label
        spent = min(1.0, max(0.0, s.budget_consumed))
        state = "critical" if s.breached else ("warning" if spent > 0.5 else "good")
        bar = (
            '<svg width="120" height="10" viewBox="0 0 120 10">'
            '<rect x="0" y="2" width="120" height="6" rx="3" fill="var(--grid)"/>'
            f'<rect x="0" y="2" width="{120 * spent:.1f}" height="6" rx="3" '
            f'fill="{_STATUS[state]}"><title>error budget '
            f"{s.budget_consumed:.0%} spent</title></rect></svg>"
        )
        rows.append(
            "<tr>"
            f"<td>{_esc(s.name)}</td>"
            f"<td>{_esc(s.objective_desc)}</td>"
            f"<td>{s.attainment:.2%} <span class=\"sub\">({s.n_bad}/"
            f"{s.n_samples} bad)</span></td>"
            f"<td>{bar}</td>"
            f"<td>{_esc(burns)}</td>"
            f"<td>{_chip(state, 'breached' if s.breached else 'ok')}</td>"
            "</tr>"
        )
    return (
        '<div class="card"><table><thead><tr>'
        "<th>SLO</th><th>objective</th><th>attainment</th>"
        "<th>error budget spent</th><th>burn rates</th><th>state</th>"
        f'</tr></thead><tbody>{"".join(rows)}</tbody></table></div>'
    )


def _node_outages(events, t_end: float):
    """Pair ``node_down``/``node_repair`` trace events into per-node outage
    windows; an unrepaired node's window runs to the end of the trace."""
    open_: dict[str, float] = {}
    out = []
    for kind, t, _label, args in events:
        if kind == "node_down":
            open_.setdefault(args["node_id"], t)
        elif kind == "node_repair":
            t_down = open_.pop(args["node_id"], None)
            if t_down is not None:
                out.append((args["node_id"], t_down, t))
    for nid, t_down in open_.items():
        out.append((nid, t_down, max(t_end, t_down)))
    out.sort(key=lambda o: (o[1], o[0]))
    return out


def _section_alerts(engine, t0: float, t1: float, outages=()) -> str:
    rules = list(engine.rules) if engine is not None else []
    if not rules and not outages:
        return '<p class="none">no alert rules registered</p>'
    span = max(t1 - t0, 1e-9)
    w, row_h, label_w = 720.0, 22.0, 170.0
    rows, marks = [], []
    for i, rule in enumerate(rules):
        y = i * row_h
        sev = _SEV_STATUS.get(rule.severity, "warning")
        rows.append(
            f'<text x="0" y="{y + 15:.1f}" font-size="12" '
            f'fill="var(--ink-2)">{_esc(rule.name)}</text>'
        )
        marks.append(
            f'<line x1="{label_w}" y1="{y + 11:.1f}" x2="{w}" '
            f'y2="{y + 11:.1f}" stroke="var(--grid)" stroke-width="1"/>'
        )
        for inc in engine.incidents_for(rule.name):
            a = label_w + (inc.t_fired - t0) / span * (w - label_w)
            end_t = inc.t_resolved if inc.t_resolved is not None else t1
            b = label_w + (end_t - t0) / span * (w - label_w)
            state = "fired, still open" if inc.open else "resolved"
            marks.append(
                f'<rect x="{a:.1f}" y="{y + 5:.1f}" '
                f'width="{max(3.0, b - a):.1f}" height="12" rx="3" '
                f'fill="{_STATUS[sev]}" stroke="var(--surface)" '
                f'stroke-width="2"><title>{_esc(rule.name)} '
                f"[{_esc(rule.severity)}] fired {_fmt_s(inc.t_fired)} "
                f"({state})</title></rect>"
            )
    if outages:
        y = len(rows) * row_h
        rows.append(
            f'<text x="0" y="{y + 15:.1f}" font-size="12" '
            f'fill="var(--ink-2)">node outages</text>'
        )
        marks.append(
            f'<line x1="{label_w}" y1="{y + 11:.1f}" x2="{w}" '
            f'y2="{y + 11:.1f}" stroke="var(--grid)" stroke-width="1"/>'
        )
        for nid, t_down, t_up in outages:
            a = label_w + (t_down - t0) / span * (w - label_w)
            b = label_w + (t_up - t0) / span * (w - label_w)
            marks.append(
                f'<rect x="{a:.1f}" y="{y + 5:.1f}" '
                f'width="{max(3.0, b - a):.1f}" height="12" rx="3" '
                f'fill="{_STATUS["critical"]}" stroke="var(--surface)" '
                f'stroke-width="2"><title>{_esc(nid)} down '
                f"{_fmt_s(t_down)} &#8594; {_fmt_s(t_up)}</title></rect>"
            )
    h = len(rows) * row_h + 4
    parts = []
    if engine is not None:
        parts.append(
            f"{len(engine.incidents)} incident(s), "
            f"{engine.pending_cancelled} flap(s) suppressed by hysteresis, "
            f"{engine.evaluations} evaluations on the virtual clock"
        )
    if outages:
        parts.append(f"{len(outages)} storage-node outage window(s)")
    summary = "; ".join(parts)
    legend = "".join(
        f'<span><span class="sw" style="background:{_STATUS[s]}"></span>'
        f"{lbl}</span>"
        for lbl, s in (("info", "good"), ("warning", "warning"),
                       ("critical", "critical"))
    )
    return (
        f'<div class="card"><svg viewBox="0 0 {w:g} {h:g}" width="100%" '
        f'height="{h:g}" role="img" aria-label="alert incident timeline">'
        f'{"".join(marks)}{"".join(rows)}</svg>'
        f'<div class="legend">{legend}</div>'
        f'<div class="sub" style="margin:6px 0 0">{_esc(summary)}</div></div>'
    )


def _spark(name: str, series) -> str:
    pts = _downsample(series.items(), _SPARK_POINTS)
    w, h, pad = 280.0, 56.0, 4.0
    if len(pts) < 2:
        body = (
            f'<text x="{w / 2}" y="{h / 2}" text-anchor="middle" '
            f'font-size="11" fill="var(--muted)">not enough samples</text>'
        )
        now = "" if not pts else f"{pts[-1][1]:g}"
    else:
        ts = [t for t, _ in pts]
        vs = [v for _, v in pts]
        t0, t1 = ts[0], ts[-1]
        lo, hi = min(vs), max(vs)
        tspan = (t1 - t0) or 1.0
        vspan = (hi - lo) or 1.0
        xy = [
            (
                pad + (t - t0) / tspan * (w - 2 * pad),
                h - pad - (v - lo) / vspan * (h - 2 * pad),
            )
            for t, v in pts
        ]
        line = " ".join(f"{x:.1f},{y:.1f}" for x, y in xy)
        area = (
            f"{xy[0][0]:.1f},{h - pad:.1f} " + line
            + f" {xy[-1][0]:.1f},{h - pad:.1f}"
        )
        lx, ly = xy[-1]
        body = (
            f'<line x1="{pad}" y1="{h - pad}" x2="{w - pad}" y2="{h - pad}" '
            'stroke="var(--baseline)" stroke-width="1"/>'
            f'<polygon points="{area}" fill="var(--s1)" opacity="0.10"/>'
            f'<polyline points="{line}" fill="none" stroke="var(--s1)" '
            'stroke-width="2" stroke-linejoin="round"/>'
            f'<circle cx="{lx:.1f}" cy="{ly:.1f}" r="4" fill="var(--s1)" '
            'stroke="var(--surface)" stroke-width="2">'
            f"<title>{_esc(name)}: {vs[-1]:g} at {_fmt_s(t1)}</title></circle>"
        )
        now = f"{vs[-1]:g}"
    truncated = " (ring truncated)" if series.appended > len(series) else ""
    return (
        '<div class="card spark">'
        f'<span class="now">{_esc(now)}</span>'
        f'<div class="name">{_esc(name)}{truncated}</div>'
        f'<svg viewBox="0 0 {w:g} {h:g}" width="100%" height="{h:g}" '
        f'role="img" aria-label="{_esc(name)} over virtual time">{body}</svg>'
        "</div>"
    )


def _section_series(hub) -> str:
    if hub is None or not hub.series:
        return '<p class="none">no metric series recorded</p>'
    sparks = "".join(
        _spark(name, hub.series[name]) for name in sorted(hub.series)
    )
    return f'<div class="sparks">{sparks}</div>'


def _section_advisories(advisories) -> str:
    if not advisories:
        return '<p class="none">campaign doctor: nothing to flag</p>'
    out = []
    for i, a in enumerate(advisories, 1):
        sev = ("critical" if a.severity >= 0.6
               else "serious" if a.severity >= 0.4 else "warning")
        out.append(
            f'<div class="adv" style="border-left-color:{_STATUS[sev]}">'
            f'<div class="head">{i}. {_esc(a.code)} '
            f"{_chip(sev, f'severity {a.severity:.2f}')}</div>"
            f'<div class="rec">{_esc(a.summary)}</div>'
            f'<div class="rec">&#8594; {_esc(a.recommendation)}</div>'
            f'<div class="why">evidence: {_esc(a.evidence)}</div></div>'
        )
    return "".join(out)


# -- entry points -------------------------------------------------------------

def build_dashboard(
    trace,
    *,
    metrics=None,
    slo=None,
    alerts=None,
    advisories=None,
    report=None,
    title: str = "Campaign observability report",
) -> str:
    """Render the HTML report and return it as a string.

    Everything except ``trace`` is optional and auto-derived when omitted:
    ``metrics`` from ``trace.metrics``, ``alerts`` from ``trace.alerts``,
    ``slo`` from the engine's tracker, ``advisories`` from
    :func:`~repro.obs.diagnose.diagnose`.
    """
    if metrics is None:
        metrics = getattr(trace, "metrics", None)
    if alerts is None:
        alerts = getattr(trace, "alerts", None)
    if slo is None and alerts is not None and alerts.slos is not None:
        slo = alerts.slos.report()
    if advisories is None:
        advisories = diagnose(trace, metrics=metrics, report=report, slos=slo)
    trace._materialize()
    cp = critical_path(trace)
    t0, t1 = trace.t_range() if trace.spans else (0.0, 0.0)
    outages = _node_outages(trace.events, t1)
    if outages:
        t1 = max(t1, max(o[2] for o in outages))

    n_jobs = len(trace.spans)
    n_events = len(trace.events)
    n_fired = 0 if alerts is None else len(alerts.incidents)
    n_breached = 0 if slo is None else len(slo.breached)
    tiles = _tiles(
        [
            ("jobs traced", f"{n_jobs:,}"),
            ("makespan", _fmt_s(t1 - t0)),
            ("trace events", f"{n_events:,}"),
            ("alerts fired", f"{n_fired:,}"),
            ("SLOs breached", f"{n_breached:,}"),
            ("advisories", f"{len(advisories):,}"),
        ]
    )
    return (
        "<!DOCTYPE html>\n"
        '<html lang="en"><head><meta charset="utf-8">\n'
        f"<title>{_esc(title)}</title>\n"
        f"<style>{_CSS}</style>\n"
        "</head><body>\n"
        f"<h1>{_esc(title)}</h1>\n"
        f'<div class="sub">virtual time {_fmt_s(t0)} &#8594; {_fmt_s(t1)} '
        "&#183; self-contained report, no external requests</div>\n"
        f"{tiles}\n"
        f"<h2>Campaign doctor</h2>\n{_section_advisories(advisories)}\n"
        f"<h2>Critical path</h2>\n{_section_critical_path(cp)}\n"
        f"<h2>SLOs &amp; error budgets</h2>\n{_section_slos(slo)}\n"
        f"<h2>Alert timeline</h2>\n{_section_alerts(alerts, t0, t1, outages)}\n"
        f"<h2>Metric series</h2>\n{_section_series(metrics)}\n"
        "</body></html>\n"
    )


def write_dashboard(path, trace, **kwargs) -> str:
    """Write :func:`build_dashboard` output to ``path``; returns the path."""
    doc = build_dashboard(trace, **kwargs)
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)
    return str(path)


def format_dashboard(
    trace, *, metrics=None, slo=None, alerts=None, advisories=None, report=None
) -> str:
    """The same report, composed for a terminal."""
    if metrics is None:
        metrics = getattr(trace, "metrics", None)
    if alerts is None:
        alerts = getattr(trace, "alerts", None)
    if slo is None and alerts is not None and alerts.slos is not None:
        slo = alerts.slos.report()
    if advisories is None:
        advisories = diagnose(trace, metrics=metrics, report=report, slos=slo)
    trace._materialize()
    cp = critical_path(trace)
    t0, t1 = trace.t_range() if trace.spans else (0.0, 0.0)
    parts = [
        f"campaign observability report  ({len(trace.spans)} jobs, "
        f"virtual {_fmt_s(t0)} -> {_fmt_s(t1)})",
        format_advisories(advisories),
    ]
    if cp is not None:
        parts.append(format_critical_path(cp))
    if slo is not None:
        from .slo import format_slo_report

        parts.append(format_slo_report(slo))
    if alerts is not None:
        from .alerts import format_alerts

        parts.append(format_alerts(alerts))
    return "\n\n".join(parts)
