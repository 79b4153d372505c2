"""SketchEngine — build and serve over an append-only store through one backend.

The paper's §IV-B ranking experiment as a service, composed of:

  * :class:`~repro_torch.engine.store.SketchStore` — packed corpus,
    incremental ingest, ingest-time fill-count cache;
  * a :class:`~repro_torch.engine.backends.Backend` — the sketch, score and
    top-k kernels behind one name;
  * a :class:`~repro_torch.engine.planner.QueryPlanner` — ragged query
    batches onto a bounded set of padded shapes.

``query`` streams: each planner chunk goes through ``Backend.topk`` per
segment view, so on the ``cuda`` backend at serving sizes no (Q, C) score
matrix is ever stored. This slice serves an append-only store only: the
mutable lifecycle, prefilter, placement and telemetry of the JAX engine come
in later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core import binsketch
from . import backends as backends_mod
from .backends import Backend
from .planner import QueryPlanner
from .store import SegmentView, SketchStore, as_index_tensor

__all__ = ["SketchEngine", "merge_segment_topk"]


def merge_segment_topk(parts_s, parts_i, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-segment (Q, k) top-k partials into one global (Q, k).

    Segments may hold interleaved id ranges, so ties must break toward the
    lower **global id** explicitly: two stable sorts (id ascending, then score
    descending). ``-inf`` slots carry id -1 and sink to the tail.
    """
    sc = torch.cat(parts_s, dim=1)
    ids = torch.cat(parts_i, dim=1)
    order = torch.sort(ids, dim=1, stable=True).indices
    sc = torch.gather(sc, 1, order)
    ids = torch.gather(ids, 1, order)
    order = torch.sort(sc, dim=1, descending=True, stable=True).indices
    sc = torch.gather(sc, 1, order)[:, :k]
    ids = torch.gather(ids, 1, order)[:, :k]
    return sc, torch.where(torch.isneginf(sc), torch.full_like(ids, -1), ids)


@dataclasses.dataclass
class SketchEngine:
    """Build + serve over a :class:`SketchStore` through one backend."""

    store: SketchStore
    backend: Backend
    measure: str = "jaccard"
    planner: QueryPlanner = dataclasses.field(default_factory=QueryPlanner)

    # ------------------------------------------------------------ construct
    @classmethod
    def build(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
              corpus_idx=None, *, backend=None, measure: str = "jaccard",
              planner: Optional[QueryPlanner] = None,
              capacity: int = 1024) -> "SketchEngine":
        """Create an engine on ``mapping``'s device; ``corpus_idx`` (C, P) is
        ingested if given, otherwise the engine starts empty and is fed via
        :meth:`add`."""
        be = backends_mod.get_backend(backend)
        if corpus_idx is not None:
            store = SketchStore.from_indices(cfg, mapping, corpus_idx, backend=be)
        else:
            store = SketchStore.create(cfg, mapping, capacity=capacity)
        return cls(store, be, measure, planner or QueryPlanner())

    @property
    def cfg(self) -> binsketch.BinSketchConfig:
        return self.store.cfg

    @property
    def device(self) -> torch.device:
        return self.store.device

    # ---------------------------------------------------------------- ingest
    def add(self, idx, *, batch: int = 4096) -> range:
        """Stream (B, P) padded sparse docs into the corpus; returns ids."""
        return self.store.add(idx, backend=self.backend, batch=batch)

    # ----------------------------------------------------------------- query
    def _padded_query_sketches(self, query_idx: torch.Tensor, padded: int) -> torch.Tensor:
        q = query_idx.shape[0]
        if padded > q:
            pad = torch.full((padded - q, query_idx.shape[1]), -1, dtype=query_idx.dtype,
                             device=query_idx.device)
            query_idx = torch.cat([query_idx, pad], dim=0)
        return self.backend.sketch(self.cfg, self.store.mapping, query_idx)

    def score_all(self, query_idx) -> torch.Tensor:
        """(Q, P) padded query rows -> full (Q, C) similarity matrix.

        Materializes O(Q·C) — an analysis surface; the serving path is
        :meth:`query`. Column ``j`` is doc ``j``."""
        query_idx = as_index_tensor(query_idx, self.device)
        if query_idx.shape[0] == 0:
            return torch.zeros((0, self.store.size), dtype=torch.float32, device=self.device)
        out = []
        for chunk in self.planner.plan(query_idx.shape[0]):
            qs = self._padded_query_sketches(
                query_idx[chunk.start : chunk.start + chunk.rows], chunk.padded)
            s = self.backend.score(qs, self.store.sketches, self.cfg.n_bins, self.measure,
                                   corpus_fills=self.store.fills)
            out.append(s[: chunk.rows])
        return torch.cat(out, dim=0)

    def _views_topk(self, qs: torch.Tensor, views, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming top-k over the segment views + k-slot merge."""
        if not views:
            return (torch.full((qs.shape[0], k), -math.inf, device=qs.device),
                    torch.full((qs.shape[0], k), -1, dtype=torch.int32, device=qs.device))
        parts = [self._view_part(qs, v, k) for v in views]
        if len(parts) == 1:
            return parts[0]
        return merge_segment_topk([p[0] for p in parts], [p[1] for p in parts], k)

    def _view_part(self, qs: torch.Tensor, v: SegmentView, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One view's (Q, k) partial: ``Backend.topk``, local rows mapped to
        global doc ids."""
        sc, ix = self.backend.topk(qs, v.sketches, self.cfg.n_bins, self.measure, k,
                                   corpus_fills=v.fills, corpus_valid=v.valid)
        if v.ids is not None:
            ix = torch.where(ix >= 0, v.ids[ix.clamp_min(0).to(torch.int64)], ix)
        return sc, ix

    def query(self, query_idx, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, P) padded query rows -> (scores (Q, k) float32, ids (Q, k) int32).

        Each planner chunk is sketched and streamed through ``Backend.topk``;
        if ``k`` exceeds the corpus the tail slots hold score -inf / id -1."""
        query_idx = as_index_tensor(query_idx, self.device)
        n_q = int(query_idx.shape[0])
        if n_q == 0:
            return (torch.zeros((0, k), dtype=torch.float32, device=self.device),
                    torch.full((0, k), -1, dtype=torch.int32, device=self.device))
        views = self.store.segment_views(now=None)
        out_s, out_i = [], []
        for chunk in self.planner.plan(n_q):
            qs = self._padded_query_sketches(
                query_idx[chunk.start : chunk.start + chunk.rows], chunk.padded)
            sc, ix = self._views_topk(qs, views, k)
            out_s.append(sc[: chunk.rows])
            out_i.append(ix[: chunk.rows])
        return torch.cat(out_s, dim=0), torch.cat(out_i, dim=0)
