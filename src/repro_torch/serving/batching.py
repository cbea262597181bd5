"""Continuous batching with a prefill/decode phase split.

Models one replica's token loop the way the MaxText MLPerf offline-inference
harness drives a decode engine: a fixed array of KV-cache *slots*, prefill
admission that fills one free slot at a time (prefill has priority — it
bounds TTFT), and global decode steps that advance every active slot by one
token. Requests enter a slot when their prefill finishes and leave the
moment their last token is generated, so the batch composition changes
continuously instead of draining batch-at-a-time.

The engine is pure bookkeeping on the virtual clock — it computes phase
durations and token/occupancy accounting; the :class:`~repro.serving.replica.Replica`
owns the event scheduling around it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .workload import Request


@dataclasses.dataclass(frozen=True)
class ServingPerf:
    """Replica-level timing model.

    Prefill is compute-bound and roughly linear in prompt tokens; a decode
    step pays a fixed base (kernel launch + sampling) plus a per-active-slot
    term (attention over each sequence's KV cache), so batching raises
    throughput while gently raising per-token latency — the continuous
    batching trade the subsystem exists to model.
    """

    prefill_tok_per_s: float = 24_000.0
    prefill_overhead_s: float = 0.015
    decode_base_s: float = 0.012
    decode_per_slot_s: float = 0.0015

    def prefill_s(self, prompt_tokens: int) -> float:
        return self.prefill_overhead_s + prompt_tokens / self.prefill_tok_per_s

    def decode_step_s(self, n_active: int) -> float:
        return self.decode_base_s + self.decode_per_slot_s * n_active


class BatchEngine:
    """Slotted continuous batcher for a single replica."""

    def __init__(self, n_slots: int, perf: ServingPerf):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.perf = perf
        self.slots: List[Optional[Request]] = [None] * n_slots
        # descending so .pop() hands out the lowest free slot (determinism)
        self._free = list(range(n_slots - 1, -1, -1))
        self.n_active = 0
        # accounting
        self.prefills = 0
        self.decode_steps = 0
        self.decode_slot_steps = 0   # sum of n_active over steps
        self.tokens_prefilled = 0
        self.tokens_generated = 0

    def has_free_slot(self) -> bool:
        return bool(self._free)

    # -- prefill --------------------------------------------------------------
    def begin_prefill(self, req: Request, t: float) -> float:
        """Admit ``req`` (it leaves the queue now); returns the prefill
        duration the caller should advance the clock by."""
        req.t_admitted = t
        self.prefills += 1
        self.tokens_prefilled += req.prompt_tokens
        return self.perf.prefill_s(req.prompt_tokens)

    def finish_prefill(self, req: Request, t: float) -> Optional[Request]:
        """Prefill produced the first token at ``t``. Single-token requests
        complete here (returned); the rest take a slot and decode."""
        req.t_first_token = t
        req.generated = 1
        self.tokens_generated += 1
        if req.gen_tokens <= 1:
            req.t_done = t
            return req
        slot = self._free.pop()
        self.slots[slot] = req
        self.n_active += 1
        return None

    # -- decode ---------------------------------------------------------------
    def decode_step_s(self) -> float:
        return self.perf.decode_step_s(self.n_active)

    def advance_decode(self, t: float) -> List[Request]:
        """One decode step ending at ``t``: every active slot gains a token;
        requests that hit their generation budget free their slot. Returns
        the completions, in slot order (deterministic)."""
        self.decode_steps += 1
        self.decode_slot_steps += self.n_active
        done: List[Request] = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated += 1
            self.tokens_generated += 1
            if req.generated >= req.gen_tokens:
                req.t_done = t
                self.slots[i] = None
                self._free.append(i)
                self.n_active -= 1
                done.append(req)
        if done:
            self._free.sort(reverse=True)
        return done

    # -- failure domain (chaos engine) ----------------------------------------
    def abort_all(self) -> List[Request]:
        """Evacuate every active slot (replica killed by a node loss):
        returns the aborted requests in slot order and resets the batch.
        Token accounting of work already done is kept — it was really
        computed, then lost with the replica."""
        aborted = [req for req in self.slots if req is not None]
        self.slots = [None] * self.n_slots
        self._free = list(range(self.n_slots - 1, -1, -1))
        self.n_active = 0
        return aborted

    # -- introspection --------------------------------------------------------
    @property
    def mean_occupancy(self) -> float:
        """Mean active slots per decode step (batch efficiency)."""
        if self.decode_steps == 0:
            return 0.0
        return self.decode_slot_steps / self.decode_steps
