"""Request-level serving workloads: seeded traffic over the arrival laws.

The orchestrator's arrival module (``repro.orchestrator.arrivals``) supplies
*when* requests land — Poisson, diurnal, burst — and this module supplies
*what* lands: per-request prompt and generation token counts drawn from a
seeded lognormal, the standard heavy-tailed shape for LLM traffic. Every
draw comes from a private ``random.Random``, so a (arrivals, lengths) seed
pair replays a campaign bit-identically.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Optional, Sequence


@dataclasses.dataclass(slots=True)
class Request:
    """One inference request and its measured lifecycle.

    The submit time and token counts are the workload's inputs; the
    remaining timestamps are written by the batch engine as the request
    moves queue -> prefill -> decode -> done on the virtual clock.
    """

    rid: int
    t_submit: float
    prompt_tokens: int
    gen_tokens: int
    # measured by the serving stack
    replica: Optional[str] = None
    t_admitted: Optional[float] = None     # prefill start (leaves the queue)
    t_first_token: Optional[float] = None  # prefill end
    t_done: Optional[float] = None
    generated: int = 0

    @property
    def queue_delay_s(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token: submit -> end of prefill."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token over the decode phase (None until done,
        and for single-token requests, which never decode)."""
        if self.t_done is None or self.gen_tokens <= 1:
            return None
        return (self.t_done - self.t_first_token) / (self.gen_tokens - 1)

    @property
    def e2e_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Clamped lognormal token-length distribution.

    ``mean`` is the target mean of the *unclamped* lognormal; ``sigma`` is
    the log-space spread (0 degenerates to the constant ``mean``).
    """

    mean: float
    sigma: float = 0.6
    lo: int = 1
    hi: int = 8192

    def __post_init__(self):
        if self.mean <= 0:
            raise ValueError(f"mean must be positive, got {self.mean}")
        if self.sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {self.sigma}")
        if not (0 < self.lo <= self.hi):
            raise ValueError(f"need 0 < lo <= hi, got [{self.lo}, {self.hi}]")

    def sample(self, rng: random.Random) -> int:
        if self.sigma == 0:
            raw = self.mean
        else:
            # mu chosen so E[lognormal] == mean
            mu = math.log(self.mean) - 0.5 * self.sigma * self.sigma
            raw = rng.lognormvariate(mu, self.sigma)
        return max(self.lo, min(self.hi, round(raw)))


def synthesize_requests(
    times: Sequence[float],
    *,
    seed: int = 0,
    prompt: LengthDist = LengthDist(mean=512.0, hi=4096),
    gen: LengthDist = LengthDist(mean=96.0, hi=1024),
) -> list[Request]:
    """One :class:`Request` per arrival time, lengths drawn from ``seed``.

    Times must be non-decreasing (feed them straight from an arrival law or
    ``sorted(...)`` a merged trace first).
    """
    rng = random.Random(seed)
    out: list[Request] = []
    prev = float("-inf")
    for rid, t in enumerate(times):
        if t < prev:
            raise ValueError(
                f"arrival times must be non-decreasing: t[{rid}]={t} < {prev}"
            )
        prev = t
        out.append(
            Request(
                rid=rid,
                t_submit=float(t),
                prompt_tokens=prompt.sample(rng),
                gen_tokens=gen.sample(rng),
            )
        )
    return out
