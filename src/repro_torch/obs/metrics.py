"""Time-series metrics: counters, gauges, histograms, ring-buffer series.

A :class:`MetricsHub` is the one handle a :class:`~repro.obs.trace.TraceRecorder`
carries. Probes (zero-arg callables reading live orchestrator state) are
registered once and sampled on a virtual-time cadence; every sample lands
in a bounded ring buffer, so a 50k-job campaign's dashboard series stay
O(maxlen) regardless of length. Nothing here schedules engine events or
mutates simulation state — sampling is pull-only.

Pure stdlib, no ``repro`` imports: usable from any layer without cycles.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Callable, Iterable, Optional

#: Default histogram bucket upper bounds (seconds-flavored, but buckets are
#: unit-agnostic); one overflow bucket is implied past the last bound.
DEFAULT_BOUNDS: tuple[float, ...] = (0.1, 1.0, 10.0, 60.0, 300.0, 1800.0, 7200.0)


class Counter:
    """Monotonically increasing total."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram: counts per upper bound plus an overflow
    bucket; tracks total/sum/min/max for cheap summary stats."""

    __slots__ = ("name", "bounds", "counts", "total", "sum", "min", "max")

    def __init__(self, name: str, bounds: Iterable[float] = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(sorted(bounds))
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.total if self.total else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile estimate, ``q`` in [0, 1].

        Walks the cumulative counts to the bucket holding rank ``q * total``
        and interpolates linearly inside it; the first bucket's lower edge
        is the observed minimum and the overflow bucket's upper edge the
        observed maximum, and the result is clamped to ``[min, max]`` (so a
        degenerate one-value histogram answers exactly). The error is
        bounded by the width of the bucket the quantile lands in. ``None``
        when nothing was observed.
        """
        if self.total == 0:
            return None
        q = min(1.0, max(0.0, q))
        target = q * self.total
        cum = 0
        bounds = self.bounds
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = bounds[i - 1] if i > 0 else self.min
                hi = bounds[i] if i < len(bounds) else self.max
                frac = (target - cum) / c
                v = lo + frac * (hi - lo)
                return min(self.max, max(self.min, v))
            cum += c
        return self.max


@dataclasses.dataclass(frozen=True)
class SeriesWindowAgg:
    """Summary of the samples of one :class:`TimeSeries` window."""

    n: int
    min: float
    max: float
    mean: float
    t_first: float
    t_last: float


class TimeSeries:
    """Bounded ``(t, value)`` ring buffer — old samples fall off the front.

    ``appended`` counts every sample ever appended, so consumers can tell a
    full campaign history from a ring that has dropped its oldest samples
    (``appended > len(series)`` means the front fell off).
    """

    __slots__ = ("name", "_buf", "appended")

    def __init__(self, name: str, maxlen: int = 4096):
        self.name = name
        self._buf: deque[tuple[float, float]] = deque(maxlen=maxlen)
        self.appended = 0

    def append(self, t: float, v: float) -> None:
        self.appended += 1
        self._buf.append((t, v))

    def items(self) -> list[tuple[float, float]]:
        return list(self._buf)

    def last(self) -> Optional[tuple[float, float]]:
        return self._buf[-1] if self._buf else None

    def __len__(self) -> int:
        return len(self._buf)

    # -- windowed reads (timestamps are appended in nondecreasing order) ------
    def window(
        self, t0: Optional[float] = None, t1: Optional[float] = None
    ) -> list[tuple[float, float]]:
        """Samples with ``t0 <= t <= t1`` (either bound optional)."""
        items = list(self._buf)
        if not items:
            return items
        times = [t for t, _ in items]
        lo = 0 if t0 is None else bisect.bisect_left(times, t0)
        hi = len(items) if t1 is None else bisect.bisect_right(times, t1)
        return items[lo:hi]

    def agg(
        self, t0: Optional[float] = None, t1: Optional[float] = None
    ) -> Optional[SeriesWindowAgg]:
        """Min/max/mean summary of the window; ``None`` when it is empty."""
        win = self.window(t0, t1)
        if not win:
            return None
        vals = [v for _, v in win]
        return SeriesWindowAgg(
            n=len(vals),
            min=min(vals),
            max=max(vals),
            mean=sum(vals) / len(vals),
            t_first=win[0][0],
            t_last=win[-1][0],
        )

    def quantile(
        self,
        q: float,
        t0: Optional[float] = None,
        t1: Optional[float] = None,
    ) -> Optional[float]:
        """Exact linear-interpolated quantile of the window's sample values
        (the series keeps raw samples, so no bucket error here); ``None``
        when the window is empty."""
        win = self.window(t0, t1)
        if not win:
            return None
        vals = sorted(v for _, v in win)
        if len(vals) == 1:
            return vals[0]
        q = min(1.0, max(0.0, q))
        pos = q * (len(vals) - 1)
        i = int(pos)
        frac = pos - i
        if frac == 0.0 or i + 1 >= len(vals):
            return vals[i]
        return vals[i] + frac * (vals[i + 1] - vals[i])


class MetricsHub:
    """Registry of named instruments plus the probe-sampling driver."""

    def __init__(self, *, maxlen: int = 4096):
        self.maxlen = maxlen
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.series: dict[str, TimeSeries] = {}
        self._probes: list[tuple[str, Callable[[], float]]] = []
        self.samples_taken = 0

    # -- instruments (get-or-create) ------------------------------------------
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(
        self, name: str, bounds: Iterable[float] = DEFAULT_BOUNDS
    ) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, bounds)
        return h

    # -- time series ----------------------------------------------------------
    def record(self, name: str, t: float, v: float) -> None:
        """Append one ``(t, v)`` sample to the named series."""
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = TimeSeries(name, maxlen=self.maxlen)
        s.append(t, v)

    # -- probes ---------------------------------------------------------------
    def add_probe(self, name: str, fn: Callable[[], float]) -> None:
        """Register a zero-arg read-only callable sampled by :meth:`sample`."""
        self._probes.append((name, fn))

    def sample(self, t: float) -> None:
        """Read every probe once and append to its series (and gauge)."""
        self.samples_taken += 1
        for name, fn in self._probes:
            v = fn()
            self.record(name, t, v)
            self.gauge(name).value = v

    # -- export ---------------------------------------------------------------
    def snapshot(self, *, max_points: Optional[int] = None) -> dict:
        """Plain-data summary (JSON-serializable).

        Histograms carry interpolated ``p50``/``p95``/``p99`` next to the
        raw buckets. Each series exports as a dict — not a bare point list —
        so consumers can't mistake a truncated series for the full campaign:

        * ``points`` — ``[t, v]`` pairs, at most ``max_points`` of them
          (default: the hub's ring ``maxlen``). Longer series are
          down-sampled deterministically on an even index stride that always
          keeps the first and last sample.
        * ``n_points`` / ``n_appended`` — exported vs ever-recorded counts.
        * ``truncated`` — ``True`` when ``points`` is not the full history
          (the ring dropped old samples and/or the export down-sampled).
        """
        cap = self.maxlen if max_points is None else max_points
        series: dict[str, dict] = {}
        for k, s in self.series.items():
            pts = s.items()
            downsampled = False
            if cap > 0 and len(pts) > cap:
                downsampled = True
                if cap == 1:
                    pts = [pts[-1]]
                else:
                    n = len(pts)
                    idx = sorted({round(i * (n - 1) / (cap - 1)) for i in range(cap)})
                    pts = [pts[i] for i in idx]
            series[k] = {
                "points": [[t, v] for t, v in pts],
                "n_points": len(pts),
                "n_appended": s.appended,
                "truncated": downsampled or s.appended > len(s),
            }
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.value for k, g in self.gauges.items()},
            "histograms": {
                k: {
                    "bounds": list(h.bounds),
                    "counts": list(h.counts),
                    "total": h.total,
                    "mean": h.mean,
                    "min": h.min,
                    "max": h.max,
                    "p50": h.percentile(0.50),
                    "p95": h.percentile(0.95),
                    "p99": h.percentile(0.99),
                }
                for k, h in self.histograms.items()
            },
            "series": series,
        }
