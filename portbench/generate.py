"""The one generator of traffic: it reads a mix's parameters
(``traffic/<name>.json``) and makes its inputs from a seed.

A training mix is a stream of packed documents: lengths drawn log-normal
around ``documents.median_tokens`` and clipped, each followed by
``eos_id``; tokens drawn from a Zipf law over the rest of the vocabulary
(ranks spread over the ids by a permutation from the seed). Batch ``k`` is
the ``k``-th run of ``batch`` rows of ``seq + 1`` tokens, tokens and labels
one apart, the layout the program's loader reads the staged shards in. The
seed changes the tokens and never the sizes: every seed gives the same
batches' shapes and the same number of them."""

from __future__ import annotations

import math

import numpy as np


def steps_for(traffic: dict, seconds: float) -> int:
    """Batches a run may read: the first steps, and the window at the mix's
    fastest step rate."""
    return traffic["check_steps"] + math.ceil(seconds * traffic["max_steps_per_s"]) + 1


def corpus(traffic: dict, vocab: int, seed: int, steps: int) -> np.ndarray:
    """int32 tokens of ``steps`` batches."""
    rng = np.random.default_rng([seed, 0x70B])
    n = steps * traffic["batch"] * (traffic["seq"] + 1)
    docs = traffic["documents"]
    k = 4 * n // docs["median_tokens"] + 16
    lengths = np.clip(np.rint(rng.lognormal(math.log(docs["median_tokens"]), docs["sigma"], k)),
                      docs["min_tokens"], docs["max_tokens"]).astype(np.int64)
    ends = np.cumsum(lengths + 1) - 1
    if ends[-1] < n:
        raise ValueError("too few documents drawn for the corpus")
    eos = traffic["eos_id"]
    ids = np.delete(np.arange(vocab, dtype=np.int64), eos)
    ranks = np.arange(1, ids.size + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -traffic["tokens"]["zipf_exponent"])
    cdf /= cdf[-1]
    by_rank = rng.permutation(ids)
    toks = by_rank[np.minimum(np.searchsorted(cdf, rng.random(n)), ids.size - 1)]
    toks[ends[ends < n]] = eos
    return toks.astype(np.int32)


def batch(tokens: np.ndarray, traffic: dict, step: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, labels) of batch ``step``, (batch, seq) each."""
    B, S = traffic["batch"], traffic["seq"]
    rows = tokens[step * B * (S + 1):(step + 1) * B * (S + 1)].reshape(B, S + 1)
    return rows[:, :-1], rows[:, 1:]
