"""Deterministic synthetic token corpus.

Tokens are a seeded counter-mode hash so any (shard, step) batch is
reproducible without materializing a dataset — and the same generator writes
the corpus files used by the stage-in path, so staged bytes equal generated
bytes (tested).
"""

from __future__ import annotations

import numpy as np

_MOD = (1 << 31) - 1


def token_block(seed: int, start: int, count: int, vocab: int) -> np.ndarray:
    """Deterministic pseudo-tokens for positions [start, start+count)."""
    idx = np.arange(start, start + count, dtype=np.uint64)
    # splitmix64-ish (64-bit wraparound is intended)
    mix = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    with np.errstate(over="ignore"):
        z = idx + np.uint64(mix)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(vocab)).astype(np.int32)


def corpus_bytes(seed: int, start: int, count: int, vocab: int) -> bytes:
    return token_block(seed, start, count, vocab).tobytes()


def batch_for_step(
    seed: int, step: int, batch: int, seq: int, vocab: int,
    *, shard: int = 0, n_shards: int = 1,
) -> dict[str, np.ndarray]:
    """Next-token-prediction batch for a (step, data shard)."""
    assert batch % n_shards == 0
    per = batch // n_shards
    base = (step * batch + shard * per) * (seq + 1)
    toks = token_block(seed, base, per * (seq + 1), vocab).reshape(per, seq + 1)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
