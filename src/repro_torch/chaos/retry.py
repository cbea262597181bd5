"""Deterministic exponential backoff shared by every self-healing path.

Pool backfill after a node loss and ``ProvisioningService`` session-open
retries both need the same thing: a bounded, *replayable* sequence of
retry delays. Wallclock-seeded jitter would break the repo's bit-for-bit
campaign determinism, so the jitter stream is seeded from
``f"{seed}:{key}"`` — string seeding hashes through SHA-512, which is
stable across processes and Python versions (unlike ``hash()``-based
object seeding). Same policy + same key -> same delays, forever.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``delays(key)`` yields at most ``max_attempts`` waits: attempt ``i``
    waits ``min(base_s * factor**i, max_delay_s)`` scaled by a jitter
    factor in ``[1, 1 + jitter]`` drawn from the key's stream. A
    ``deadline_s`` truncates the sequence where cumulative waiting would
    exceed it — a retry that could not start before the deadline is not
    offered at all.
    """

    max_attempts: int = 6
    base_s: float = 5.0
    factor: float = 2.0
    max_delay_s: float = 300.0
    deadline_s: Optional[float] = None
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_s <= 0:
            raise ValueError(f"base_s must be positive, got {self.base_s}")
        if self.factor < 1.0:
            raise ValueError(f"factor must be >= 1, got {self.factor}")
        if self.max_delay_s < self.base_s:
            raise ValueError("max_delay_s must be >= base_s")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (or None)")

    def delays(self, key: str) -> tuple[float, ...]:
        """The per-attempt wait sequence for ``key`` (deterministic)."""
        rng = random.Random(f"{self.seed}:{key}")
        out: list[float] = []
        elapsed = 0.0
        for i in range(self.max_attempts):
            d = min(self.base_s * self.factor**i, self.max_delay_s)
            if self.jitter:
                d *= 1.0 + self.jitter * rng.random()
            elapsed += d
            if self.deadline_s is not None and elapsed > self.deadline_s:
                break
            out.append(d)
        return tuple(out)


def drive_retries(
    engine,
    policy: RetryPolicy,
    key: str,
    attempt: Callable[[], bool],
    *,
    give_up: Optional[Callable[[], None]] = None,
) -> None:
    """Run ``attempt`` on ``policy``'s backoff cadence over a ``SimEngine``.

    ``attempt()`` returns True on success (stop) or False to back off and
    retry; after the policy's last delay is exhausted, ``give_up`` (if any)
    fires once. The engine is duck-typed (needs only ``after``), the first
    attempt already waits ``delays[0]`` — a failure was just observed *now*
    — and everything is pre-computed from ``(policy, key)``, so the retry
    trail replays bit-identically.
    """
    delays = policy.delays(key)

    def arm(i: int) -> None:
        if i >= len(delays):
            if give_up is not None:
                give_up()
            return
        engine.after(delays[i], lambda: arm(i + 1) if not attempt() else None)

    arm(0)
