"""Banded LSH prefilter over packed sketch words (the port of
``repro.engine.banding``).

BinSketch's packed words are hash-like signatures of the underlying set, so
LSH banding applies to the sketch itself: the W words split into ``n_bands``
groups of contiguous words, each group hashes to one uint32 key
(``core.packed.band_hash``, ``Backend.band_hash``, the ``band_hash`` kernel,
bit-identical), and rows are bucketed by key per band. Two rows share a
bucket of band ``t`` iff they agree on every bin of that word group, so
near-duplicates collide on most bands and unrelated docs almost never. A
query scores only the union of its colliding buckets.

A doc survives the prefilter iff it matches the query on at least one whole
band: more bands (fewer words each) raise recall and grow the candidate
sets. The escape hatch caps the downside: a segment whose candidate union
exceeds ``max_candidate_frac`` of its rows is scanned in full instead.

:class:`BandIndex` is a host-side CSR inverted index per band, built once
per sealed segment (at seal, compaction, distillation and carry-over from
the reference) and immutable afterwards. Tombstones do not touch it: dead
rows stay in their buckets and are dropped from the candidates at query time
against the segment's live bitmap, so a stale bucket never resurrects a
deleted doc.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import faults
from ..core import packed as pk

__all__ = ["BandIndex", "BandPolicy"]


@dataclasses.dataclass(frozen=True)
class BandPolicy:
    """Knobs of the banded prefilter.

    ``n_bands``: requested bands a row, clamped to the segment's word count
    (the effective count is ``core.packed.band_shape``'s ``nb_eff``).
    ``max_candidate_frac``: the escape hatch; a segment whose candidate union
    exceeds this fraction of its rows is scanned in full. ``min_rows``:
    segments smaller than this are never indexed.
    """

    n_bands: int = 8
    max_candidate_frac: float = 0.25
    min_rows: int = 256

    def __post_init__(self):
        if self.n_bands < 1:
            raise ValueError(f"n_bands must be >= 1, got {self.n_bands}")
        if not 0.0 < self.max_candidate_frac <= 1.0:
            raise ValueError(
                f"max_candidate_frac must be in (0, 1], got {self.max_candidate_frac}")
        if self.min_rows < 0:
            raise ValueError(f"min_rows must be >= 0, got {self.min_rows}")

    def wants_index(self, n_rows: int) -> bool:
        return n_rows >= self.min_rows

    def to_aux(self) -> dict:
        """JSON-safe dict, as the reference's checkpoint manifest holds it."""
        return {"n_bands": int(self.n_bands),
                "max_candidate_frac": float(self.max_candidate_frac),
                "min_rows": int(self.min_rows)}

    @classmethod
    def from_aux(cls, d: Optional[dict]) -> Optional["BandPolicy"]:
        return None if d is None else cls(**d)


@dataclasses.dataclass
class BandIndex:
    """Immutable per-segment bucket index: one CSR inverted list per band.

    ``orders[t]`` holds the segment's rows sorted by band-``t`` key;
    ``uniq[t]`` / ``starts[t]`` are the sorted distinct keys and their CSR
    offsets, so bucket ``b`` of band ``t`` is ``orders[t, starts[t][b] :
    starts[t][b+1]]``.
    """

    n_rows: int
    n_bands: int  # effective band count (keys.shape[1] at build)
    orders: np.ndarray  # (n_bands, n_rows) int32
    uniq: List[np.ndarray]  # per band: sorted distinct uint32 keys
    starts: List[np.ndarray]  # per band: (len(uniq) + 1,) int64 CSR offsets

    @classmethod
    def build(cls, keys: np.ndarray) -> "BandIndex":
        """``keys (n_rows, n_bands)`` uint32 (or int32 holding the same bits,
        as ``Backend.band_hash`` returns them: the cast keeps the bits) -> the
        index. Fault point ``band.build``."""
        faults.inject("band.build")
        keys = np.ascontiguousarray(keys, dtype=np.uint32)
        n_rows, n_bands = keys.shape
        orders = np.empty((n_bands, n_rows), np.int32)
        uniq: List[np.ndarray] = []
        starts: List[np.ndarray] = []
        for t in range(n_bands):
            o = np.argsort(keys[:, t], kind="stable").astype(np.int32)
            orders[t] = o
            u, s = np.unique(keys[o, t], return_index=True)
            uniq.append(u)
            starts.append(np.append(s, n_rows).astype(np.int64))
        return cls(n_rows, n_bands, orders, uniq, starts)

    @classmethod
    def build_from_packed(cls, sketches: np.ndarray, n_bands: int) -> "BandIndex":
        """Host build straight from a packed (n, W) uint32 host slab, keys
        from the plain host hash (the store hashes its slabs on their device
        and calls :meth:`build`)."""
        return cls.build(pk.band_hash_host(sketches, n_bands))

    def stats(self) -> dict:
        """JSON-safe index shape: bucket count and the largest bucket."""
        sizes = [np.diff(s) for s in self.starts]
        return {"n_rows": int(self.n_rows), "n_bands": int(self.n_bands),
                "buckets": int(sum(len(u) for u in self.uniq)),
                "max_bucket": int(max((int(s.max()) for s in sizes if len(s)), default=0))}

    def candidates(self, qkeys: np.ndarray) -> np.ndarray:
        """Union of colliding buckets over a query batch.

        ``qkeys (nq, n_bands)`` uint32 -> sorted unique rows (int64)
        colliding with any query on any band. Ascending order keeps a
        gathered slab in the segment's id order, so ``Backend.topk``'s
        positional tie-break stays the id tie-break. Fault point
        ``band.lookup``.
        """
        faults.inject("band.lookup")
        qkeys = np.asarray(qkeys, dtype=np.uint32)
        if qkeys.ndim != 2 or qkeys.shape[1] != self.n_bands:
            raise ValueError(f"qkeys must be (nq, {self.n_bands}), got {qkeys.shape}")
        hits: List[np.ndarray] = []
        for t in range(self.n_bands):
            u = self.uniq[t]
            qk = np.unique(qkeys[:, t])
            pos = np.searchsorted(u, qk)
            ok = pos < len(u)
            pos = pos[ok]
            pos = pos[u[pos] == qk[ok]]
            st, order = self.starts[t], self.orders[t]
            for b in pos:
                hits.append(order[st[b] : st[b + 1]])
        if not hits:
            return np.zeros((0,), np.int64)
        return np.unique(np.concatenate(hits)).astype(np.int64)
