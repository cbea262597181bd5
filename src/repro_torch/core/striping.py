"""Chunk/stripe layout math (BeeGFS-style round-robin striping).

A file is split into ``stripe_size`` chunks; chunk *i* lives on storage target
``(i + shift) % n_targets`` where ``shift`` is derived from the file id so that
different files start on different targets (load spreading). The paper uses a
1 MiB stripe size on both file systems (§IV-A).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

MiB = 1 << 20
DEFAULT_STRIPE = 1 * MiB


@dataclasses.dataclass(frozen=True)
class StripeConfig:
    stripe_size: int
    n_targets: int
    shift: int = 0

    def __post_init__(self) -> None:
        if self.stripe_size <= 0:
            raise ValueError("stripe_size must be positive")
        if self.n_targets <= 0:
            raise ValueError("n_targets must be positive")

    def target_of_chunk(self, chunk_id: int) -> int:
        return (chunk_id + self.shift) % self.n_targets


@dataclasses.dataclass(frozen=True)
class Extent:
    """One contiguous piece of a logical byte range, landed on one chunk."""

    target: int          # storage-target index
    chunk_id: int        # global chunk index within the file
    chunk_offset: int    # offset within the chunk
    length: int
    file_offset: int     # where this piece starts in the logical file


def extents_for_range(cfg: StripeConfig, offset: int, length: int) -> Iterator[Extent]:
    """Split [offset, offset+length) into per-chunk extents."""
    if offset < 0 or length < 0:
        raise ValueError("negative offset/length")
    pos = offset
    end = offset + length
    while pos < end:
        chunk_id = pos // cfg.stripe_size
        chunk_off = pos % cfg.stripe_size
        take = min(cfg.stripe_size - chunk_off, end - pos)
        yield Extent(
            target=cfg.target_of_chunk(chunk_id),
            chunk_id=chunk_id,
            chunk_offset=chunk_off,
            length=take,
            file_offset=pos,
        )
        pos += take


def targets_touched(cfg: StripeConfig, offset: int, length: int) -> set[int]:
    return {e.target for e in extents_for_range(cfg, offset, length)}


def bytes_per_target(cfg: StripeConfig, offset: int, length: int) -> dict[int, int]:
    out: dict[int, int] = {}
    for e in extents_for_range(cfg, offset, length):
        out[e.target] = out.get(e.target, 0) + e.length
    return out
