"""Query planner — ragged batches onto a small set of padded shapes.

A copy of ``repro.engine.planner``'s batch bucketing and candidate bucket. The batch axis is padded
to the next power of two inside ``[min_batch, max_batch]`` and oversized
batches split into ``max_batch`` chunks, so the kernels see a bounded set of
shapes. Pad rows are all ``-1`` indices: they sketch to zero rows, score 0
everywhere, and are cropped before results leave the engine.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["QueryPlanner", "QueryChunk"]

# the least padded row count of a candidate gather: small unions share one shape
_CANDIDATE_FLOOR = 64


@dataclasses.dataclass(frozen=True)
class QueryChunk:
    """One padded slice of a query batch: rows [start, start+rows) padded up
    to ``padded`` before scoring."""

    start: int
    rows: int
    padded: int


@dataclasses.dataclass
class QueryPlanner:
    min_batch: int = 8
    max_batch: int = 1024

    def __post_init__(self):
        if self.min_batch < 1 or self.max_batch < self.min_batch:
            raise ValueError(f"bad bucket range [{self.min_batch}, {self.max_batch}]")

    def bucket(self, n: int) -> int:
        """Smallest power-of-two bucket >= n, clamped to the configured range."""
        b = self.min_batch
        while b < n and b < self.max_batch:
            b *= 2
        return min(b, self.max_batch)

    def plan(self, n_queries: int) -> List[QueryChunk]:
        """Split a batch of ``n_queries`` rows into padded chunks."""
        chunks: List[QueryChunk] = []
        start = 0
        while start < n_queries:
            rows = min(self.max_batch, n_queries - start)
            chunks.append(QueryChunk(start, rows, self.bucket(rows)))
            start += rows
        return chunks

    def shapes(self, sizes) -> Tuple[int, ...]:
        """Distinct padded shapes a stream of batch sizes produces."""
        seen = set()
        for n in sizes:
            seen.update(c.padded for c in self.plan(n))
        return tuple(sorted(seen))

    def candidate_bucket(self, n: int, cap: int) -> int:
        """Padded row count of a banded-prefilter candidate gather: the next
        power of two >= ``n``, floored at ``_CANDIDATE_FLOOR`` (small unions
        share one shape) and capped at ``cap``, the segment's row count."""
        if cap < 1:
            return 0
        b = max(min(_CANDIDATE_FLOOR, cap), 1)
        while b < n and b < cap:
            b *= 2
        return min(b, cap)
