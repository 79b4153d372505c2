"""SketchStore — packed, capacity-managed sketch corpus with incremental ingest.

The store owns the (C, W) packed corpus plus the *fill-count cache*: the
per-row popcount |a_s| every estimator epilogue needs, computed once at ingest
so queries stream it into the scorer instead of popcounting the corpus again.

Ingest is incremental: ``add`` writes rows in place into preallocated
capacity, which grows by amortized doubling, so a streaming producer pays
O(1) amortized copies per document. Rows live on the mapping's device.
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
    doc id: ``ids is None`` means identity mapping, ``valid is None`` means
    every row is retrievable."""

    sketches: torch.Tensor  # (n, W) int32 packed rows
    fills: torch.Tensor  # (n,) int32 ingest-time fill cache
    ids: Optional[torch.Tensor]  # (n,) int32 global doc ids, or None
    valid: Optional[torch.Tensor]  # (n,) int32/bool mask, or None


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
                     corpus_idx, *, backend: Optional["Backend"] = None) -> "SketchStore":
        """Batch build: sketch (C, P) padded sparse rows, chunk by chunk."""
        store = cls.create(cfg, mapping, capacity=max(int(corpus_idx.shape[0]), 1))
        store.add(corpus_idx, backend=backend)
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
