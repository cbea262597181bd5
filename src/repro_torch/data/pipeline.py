"""Data pipeline: corpus files on the global FS, staged into the provisioned
burst tier (the paper's stage-in, §V), then served as training batches.

The loader reads token shards through the FS client API, so the whole
train-input path exercises the provisioned storage exactly like the paper's
IOR runs exercise BeeGFS — plus a fallback pure-generator mode when no
storage deployment is in play (dry-runs, unit tests).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.client import FSClient
from ..core.datamanager import DataManager
from ..core.staging import StageReport, stage
from ..spans import spanned, tally
from .synthetic import batch_for_step, corpus_bytes, token_block

TOKEN_BYTES = 4  # int32


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    seed: int
    vocab: int
    n_tokens: int                    # corpus length
    shard_tokens: int = 1 << 20      # tokens per corpus file


def write_corpus(fs: DataManager, root: str, spec: DatasetSpec) -> list[str]:
    """Materialize the corpus as shard files on a file system (global FS)."""
    client = FSClient(fs, "corpus-writer")
    client.makedirs(root)
    paths = []
    for i, start in enumerate(range(0, spec.n_tokens, spec.shard_tokens)):
        count = min(spec.shard_tokens, spec.n_tokens - start)
        p = f"{root}/shard-{i:05d}.tok"
        client.write_file(p, corpus_bytes(spec.seed, start, count, spec.vocab))
        paths.append(p)
    return paths


def stage_in(
    src_fs: DataManager, dst_fs: DataManager, root: str, dst_root: str,
    **kw,
) -> StageReport:
    client = FSClient(src_fs, "stager")
    names = client.readdir(root)
    pairs = [(f"{root}/{n}", f"{dst_root}/{n}") for n in names]
    return stage(src_fs, dst_fs, pairs, direction="in", **kw)


class Loader:
    """Yields next-token batches; reads token shards via an FS client when a
    deployment is given, else generates directly (identical values either
    way — synthetic corpus is position-deterministic)."""

    def __init__(
        self,
        spec: DatasetSpec,
        batch: int,
        seq: int,
        *,
        fs: Optional[DataManager] = None,
        root: str = "/data",
        shard: int = 0,
        n_shards: int = 1,
    ):
        self.spec = spec
        self.batch = batch
        self.seq = seq
        self.fs = fs
        self.root = root
        self.shard = shard
        self.n_shards = n_shards
        self._client = FSClient(fs, f"loader{shard}") if fs is not None else None

    def _read_tokens(self, start: int, count: int) -> np.ndarray:
        """Read [start, start+count) tokens through the FS."""
        assert self._client is not None
        out = np.empty((count,), np.int32)
        got = 0
        while got < count:
            pos = start + got
            si, off = divmod(pos, self.spec.shard_tokens)
            take = min(count - got, self.spec.shard_tokens - off)
            raw = self._client.pread(
                f"{self.root}/shard-{si:05d}.tok", off * TOKEN_BYTES, take * TOKEN_BYTES
            )
            tally(read_bytes=len(raw))
            out[got: got + take] = np.frombuffer(raw, np.int32)
            got += take
        return out

    @spanned("data.batch_at")
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        if self._client is None:
            return batch_for_step(
                self.spec.seed, step, self.batch, self.seq, self.spec.vocab,
                shard=self.shard, n_shards=self.n_shards,
            )
        per = self.batch // self.n_shards
        base = (step * self.batch + self.shard * per) * (self.seq + 1)
        need = per * (self.seq + 1)
        toks = self._read_tokens(base % self.spec.n_tokens, min(need, self.spec.n_tokens - base % self.spec.n_tokens))
        if toks.size < need:  # wrap around the corpus
            toks = np.concatenate([toks, self._read_tokens(0, need - toks.size)])
        toks = toks.reshape(per, self.seq + 1)
        return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
