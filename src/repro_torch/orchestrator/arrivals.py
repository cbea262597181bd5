"""Arrival processes for provisioning campaigns.

The first ROADMAP orchestrator follow-up: instead of dumping every job on the
queue at t=0 (worst-case burst), campaigns can draw arrivals from a seeded
Poisson process — the standard open-system model for batch submissions — or
replay a recorded trace deterministically. Both produce a ``submit_times``
list for :meth:`Orchestrator.run_campaign`.

Seeding uses a private ``random.Random`` instance, so two campaigns with the
same (rate, n, seed) see byte-identical arrival sequences regardless of any
global RNG state.
"""

from __future__ import annotations

import math
import random
from typing import Iterable, Sequence


def exponential_interarrivals(
    rate_per_s: float, n: int, *, seed: int = 0
) -> list[float]:
    """``n`` i.i.d. Exp(rate) gaps — the memoryless inter-arrival law."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be positive, got {rate_per_s}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = random.Random(seed)
    return [rng.expovariate(rate_per_s) for _ in range(n)]


def poisson_arrivals(
    rate_per_s: float, n: int, *, seed: int = 0, start: float = 0.0
) -> list[float]:
    """``n`` absolute arrival times of a Poisson process with the given rate,
    beginning at ``start``. Monotone non-decreasing by construction."""
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    times = []
    t = start
    for gap in exponential_interarrivals(rate_per_s, n, seed=seed):
        t += gap
        times.append(t)
    return times


def _thinned_arrivals(
    rate_fn, peak_rate: float, n: int, *, seed: int, start: float
) -> list[float]:
    """``n`` arrivals of a non-homogeneous Poisson process by Lewis-Shedler
    thinning: candidate points arrive at ``peak_rate`` and survive with
    probability ``rate_fn(t) / peak_rate``. Exact for any rate function
    bounded by ``peak_rate``; deterministic for a fixed seed because the
    private RNG draws exactly two variates per candidate."""
    if peak_rate <= 0:
        raise ValueError(f"peak rate must be positive, got {peak_rate}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if start < 0:
        raise ValueError(f"start must be >= 0, got {start}")
    rng = random.Random(seed)
    out: list[float] = []
    t = start
    while len(out) < n:
        t += rng.expovariate(peak_rate)
        if rng.random() * peak_rate <= rate_fn(t):
            out.append(t)
    return out


def diurnal_arrivals(
    n: int,
    *,
    base_rate: float,
    peak_rate: float,
    period_s: float = 86_400.0,
    seed: int = 0,
    start: float = 0.0,
) -> list[float]:
    """``n`` arrival times following a sinusoidal day/night profile:

        rate(t) = base + (peak - base) * (1 - cos(2*pi*(t - start)/period)) / 2

    The process starts at the trough (``base_rate`` at ``t = start``), climbs
    to ``peak_rate`` half a period in, and returns — the serving subsystem's
    "queue that breathes". Mean rate over whole periods is
    ``(base_rate + peak_rate) / 2``.
    """
    if base_rate < 0:
        raise ValueError(f"base_rate must be >= 0, got {base_rate}")
    if peak_rate < base_rate or peak_rate <= 0:
        raise ValueError(
            f"peak_rate must be positive and >= base_rate, got {peak_rate}"
        )
    if period_s <= 0:
        raise ValueError(f"period_s must be positive, got {period_s}")

    def rate(t: float) -> float:
        swing = 0.5 * (1.0 - math.cos(2.0 * math.pi * (t - start) / period_s))
        return base_rate + (peak_rate - base_rate) * swing

    return _thinned_arrivals(rate, peak_rate, n, seed=seed, start=start)


def burst_arrivals(
    n: int,
    *,
    base_rate: float,
    burst_rate: float,
    burst_t0: float,
    burst_t1: float,
    seed: int = 0,
    start: float = 0.0,
) -> list[float]:
    """``n`` arrival times at ``base_rate`` with a piecewise-constant burst:
    the rate jumps to ``burst_rate`` on ``[burst_t0, burst_t1)`` and falls
    back after. The flash crowd that trips a queue-delay alert."""
    if base_rate <= 0:
        raise ValueError(f"base_rate must be positive, got {base_rate}")
    if burst_rate <= 0:
        raise ValueError(f"burst_rate must be positive, got {burst_rate}")
    if burst_t1 <= burst_t0:
        raise ValueError(
            f"burst window is empty: [{burst_t0}, {burst_t1})"
        )

    def rate(t: float) -> float:
        return burst_rate if burst_t0 <= t < burst_t1 else base_rate

    peak = max(base_rate, burst_rate)
    return _thinned_arrivals(rate, peak, n, seed=seed, start=start)


def replay_trace(times: Iterable[float], *, start: float = 0.0) -> list[float]:
    """Validate a recorded arrival trace for deterministic replay.

    Returns the times sorted (submission order is by time, whatever order the
    trace file listed them in) and shifted by ``start``. Negative times are
    rejected — the virtual clock cannot schedule into the past.
    """
    out = sorted(float(t) for t in times)
    if out and out[0] < 0:
        raise ValueError(f"trace has negative arrival time {out[0]}")
    return [t + start for t in out]


def mean_interarrival(times: Sequence[float]) -> float:
    """Empirical mean gap of an arrival sequence (trace sanity checks)."""
    if len(times) < 2:
        return 0.0
    return (times[-1] - times[0]) / (len(times) - 1)
