"""SketchStore — packed, capacity-managed sketch corpus with incremental ingest.

The store owns the (C, W) packed corpus plus the *fill-count cache*: the
per-row popcount |a_s| every estimator epilogue needs, computed once at ingest
so queries stream it into the scorer instead of popcounting the corpus again.

Ingest is incremental: ``add`` writes rows in place into preallocated
capacity, which grows by amortized doubling, so a streaming producer pays
O(1) amortized copies per document. Rows live on the mapping's device.
BinSketch is an OR-homomorphism, so growing an existing document and merging
two shard-local stores are plain bitwise ORs (``merge_rows``, ``merge``).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, TYPE_CHECKING

import numpy as np
import torch

from ..core import binsketch, packed as pk

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .backends import Backend

__all__ = ["SegmentView", "SketchStore", "as_index_tensor"]


class SegmentView(NamedTuple):
    """One scoreable slab of corpus, as the query path sees it.

    An append-only ``SketchStore`` is a single view whose row index *is* the
    doc id; a ``SegmentedStore`` yields one view per sealed segment plus the
    mutable head. ``ids is None`` means identity mapping, ``valid is None``
    means every row is retrievable, ``n_bins is None`` means the store's base
    sketch width (a distilled segment carries its smaller width, and the
    engine folds the query sketches to match)."""

    sketches: torch.Tensor  # (n, W) int32 packed rows
    fills: torch.Tensor  # (n,) int32 ingest-time fill cache
    ids: Optional[torch.Tensor]  # (n,) int32 global doc ids, or None
    valid: Optional[torch.Tensor]  # (n,) int32/bool mask, or None
    n_bins: Optional[int] = None  # sketch width, or None = store base width


def as_index_tensor(idx, device: torch.device) -> torch.Tensor:
    """Padded sparse rows (numpy or tensor) as an int32 tensor on ``device``."""
    if isinstance(idx, np.ndarray):
        idx = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32))
    return idx.to(device=device, dtype=torch.int32)


def _grow(t: torch.Tensor, capacity: int, size: int) -> torch.Tensor:
    out = torch.zeros((capacity,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    out[:size] = t[:size]
    return out


@dataclasses.dataclass
class SketchStore:
    """Packed sketch corpus + fill-count cache, doc id == row index."""

    cfg: binsketch.BinSketchConfig
    mapping: torch.Tensor
    _sketches: torch.Tensor  # (capacity, W) int32; rows >= size are zero
    _fills: torch.Tensor  # (capacity,) int32; rows >= size are zero
    size: int = 0

    # ------------------------------------------------------------ construct
    @classmethod
    def create(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
               capacity: int = 1024) -> "SketchStore":
        capacity = max(int(capacity), 1)
        dev = mapping.device
        return cls(cfg, mapping,
                   torch.zeros((capacity, cfg.n_words), dtype=torch.int32, device=dev),
                   torch.zeros((capacity,), dtype=torch.int32, device=dev), 0)

    @classmethod
    def from_indices(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
                     corpus_idx, *, backend: Optional["Backend"] = None,
                     batch: int = 4096) -> "SketchStore":
        """Batch build: sketch (C, P) padded sparse rows in ``batch`` chunks."""
        store = cls.create(cfg, mapping, capacity=max(int(corpus_idx.shape[0]), 1))
        store.add(corpus_idx, backend=backend, batch=batch)
        return store

    @classmethod
    def from_sketches(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
                      sketches: torch.Tensor) -> "SketchStore":
        """Wrap pre-built packed int32 rows (fills computed here, once)."""
        if sketches.dtype != torch.int32:
            raise TypeError(f"packed sketches must be int32 words, got {sketches.dtype}")
        sketches = sketches.to(mapping.device).contiguous()
        return cls(cfg, mapping, sketches, pk.row_popcount(sketches), sketches.shape[0])

    # ------------------------------------------------------------ properties
    @property
    def device(self) -> torch.device:
        return self._sketches.device

    @property
    def capacity(self) -> int:
        return int(self._sketches.shape[0])

    @property
    def sketches(self) -> torch.Tensor:
        """(size, W) packed corpus view."""
        return self._sketches[: self.size]

    @property
    def fills(self) -> torch.Tensor:
        """(size,) cached |row_s| fill counts — computed at ingest."""
        return self._fills[: self.size]

    def segment_views(self, now: Optional[float] = None) -> List[SegmentView]:
        """The whole store as one segment (row index == doc id, no mask).
        ``now`` is accepted for surface parity with the reference's segmented
        store and ignored: an append-only store has no lifecycle clock."""
        if self.size == 0:
            return []
        return [SegmentView(self.sketches, self.fills, None, None)]

    # ---------------------------------------------------------------- ingest
    def _ensure_capacity(self, n: int) -> None:
        cap = self.capacity
        if n <= cap:
            return
        while cap < n:
            cap *= 2  # amortized doubling
        self._sketches = _grow(self._sketches, cap, self.size)
        self._fills = _grow(self._fills, cap, self.size)

    def _sketch_rows(self, idx: torch.Tensor, backend: Optional["Backend"]) -> torch.Tensor:
        if backend is not None:
            return backend.sketch(self.cfg, self.mapping, idx)
        return binsketch.sketch_indices(self.cfg, self.mapping, idx)

    def add(self, idx, *, backend: Optional["Backend"] = None, batch: int = 4096) -> range:
        """Sketch (B, P) padded sparse rows and append; returns assigned ids.

        Each chunk is moved to the device and written straight into capacity,
        so peak memory during a large ingest is one batch, not the corpus."""
        lo = self.size
        for s in range(0, idx.shape[0], batch):
            rows = as_index_tensor(idx[s : s + batch], self.device)
            self.add_sketches(self._sketch_rows(rows, backend))
        return range(lo, self.size)

    def merge_rows(self, doc_ids, idx, *, backend: Optional["Backend"] = None) -> None:
        """OR new content into existing docs: ``doc_ids (B,)`` row ids,
        ``idx (B, P)`` padded sparse rows. One OR and a fill refresh on the
        touched rows; duplicate ids are OR-combined first (``segment_or``),
        since an indexed write keeps one value per row."""
        upd = self._sketch_rows(as_index_tensor(idx, self.device), backend)
        uniq, inv = np.unique(np.asarray(doc_ids, np.int64), return_inverse=True)
        if len(uniq) < len(inv):
            upd = pk.segment_or(upd, torch.from_numpy(inv), len(uniq))
        rows = torch.from_numpy(uniq).to(self.device)
        merged = self._sketches[rows] | upd
        self._sketches[rows] = merged
        self._fills[rows] = pk.row_popcount(merged)

    def merge(self, other: "SketchStore") -> "SketchStore":
        """OR-merge ``other`` into this store row by row (the sketch of each
        row's union); the shorter store's missing rows count as empty sets."""
        n = max(self.size, other.size)
        self._ensure_capacity(n)
        self._sketches[: other.size] |= other.sketches.to(self.device)
        self.size = n
        self._fills[:n] = pk.row_popcount(self._sketches[:n])
        return self

    def add_sketches(self, sketches: torch.Tensor) -> range:
        """Append pre-built packed rows in place; fills enter the cache here."""
        b = int(sketches.shape[0])
        if b == 0:
            return range(self.size, self.size)
        if sketches.dtype != torch.int32:
            raise TypeError(f"packed sketches must be int32 words, got {sketches.dtype}")
        self._ensure_capacity(self.size + b)
        lo = self.size
        self._sketches[lo : lo + b] = sketches
        self._fills[lo : lo + b] = pk.row_popcount(sketches)
        self.size += b
        return range(lo, self.size)
