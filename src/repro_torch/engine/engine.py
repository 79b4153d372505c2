"""SketchEngine — build and serve over a sketch store through one backend.

The paper's §IV-B ranking experiment as a service, composed of:

  * :class:`~repro_torch.engine.store.SketchStore` — packed corpus,
    incremental ingest, ingest-time fill-count cache — or, with
    ``mutable=True``, :class:`~repro_torch.engine.segments.SegmentedStore`:
    counting head plus sealed segments, with delete, update, seal, compact,
    expiry and distillation;
  * a :class:`~repro_torch.engine.backends.Backend` — the sketch, score and
    top-k kernels behind one name;
  * a :class:`~repro_torch.engine.planner.QueryPlanner` — ragged query
    batches onto a bounded set of padded shapes.

``query`` streams: each planner chunk goes through ``Backend.topk`` per
segment view, so on the ``cuda`` backend at serving sizes no (Q, C) score
matrix is ever stored. Serving is mixed-width: a distilled segment lives at
a smaller width N', and the chunk's query sketches are folded to N' once per
distinct width (``Backend.rebucket``) before that view is scored. With a
:class:`~repro_torch.engine.banding.BandPolicy` on a mutable store, indexed
sealed segments score only the rows that share a band key with a query of
the chunk (the banded prefilter, ``query(prefilter=...)``).

Maintenance runs under a :class:`~repro_torch.engine.supervision.JobSupervisor`
(the mutable store's own, or one the engine keeps): ``compact`` and
``distill`` run synchronously or as background jobs, and ``query`` swaps in a
finished job before it scores. The prefilter is an accelerator, as in the
reference: a failed bucket lookup, a failed index build or a failed
prefiltered chunk degrades that segment or chunk to the exhaustive scan (the
same answers, more rows), and each fallback, the escape hatch included, is
recorded in :meth:`SketchEngine.health`. A kernel that fails to build or
launch, a kernel wrapper that refuses its input, or an error of the card is
never such a fallback: it propagates (``hopper.build.is_device_fault``).

Telemetry, as in the reference: one injected clock (``build(clock=)``)
resolves ``now`` for queries that carry none; every query counts
``query.calls`` / ``query.rows`` / ``query.k_overflow`` in the armed
registry (:meth:`SketchEngine.enable_metrics`), a sampled query records a
:class:`~repro_torch.obs.trace.QueryTrace` over the stages ``rebucket``
(the chunk's query sketch), ``band_lookup``, ``candidate_gather``,
``kernel_score`` and ``merge`` (timed with CUDA events on the card), and
every scored segment and the head count a hit on the host.
:meth:`SketchEngine.metrics` composes it all into one JSON-safe snapshot.
Placement of the JAX engine comes in a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..core import binsketch
from ..hopper.build import is_device_fault
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from . import backends as backends_mod
from .backends import Backend
from .banding import BandPolicy
from .planner import QueryPlanner
from .segments import DistillPolicy, SealedSegment, SegmentedStore
from .store import SegmentView, SketchStore, as_index_tensor
from .supervision import JobSupervisor

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
    # the injected clock: queries with no explicit ``now`` resolve TTL against
    # it (else the store's), and metrics and traces stamp their times with it
    clock: Optional[Callable[[], float]] = None
    # the last prefiltered query's candidate accounting (rows of indexed
    # segments, candidate rows, and the segments scanned banded, through the
    # escape hatch, or unindexed); None until a prefiltered query runs
    last_prefilter_stats: Optional[dict] = dataclasses.field(default=None, init=False,
                                                             repr=False)
    # the supervisor of an engine over an append-only store, which has no
    # background jobs but still records degraded modes (see :attr:`supervisor`)
    _own_supervisor: Optional[JobSupervisor] = dataclasses.field(default=None, init=False,
                                                                 repr=False)
    # the attached LifecycleController (engine/lifecycle.py), set by the
    # controller itself so that ``metrics()`` shows its state; the engine
    # never calls into it
    controller: Optional[object] = dataclasses.field(default=None, init=False, repr=False)

    # ------------------------------------------------------------ construct
    @classmethod
    def build(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
              corpus_idx=None, *, backend=None, measure: str = "jaccard",
              planner: Optional[QueryPlanner] = None, capacity: int = 1024,
              batch: int = 4096, mutable: bool = False, seal_rows: Optional[int] = None,
              ttl: Optional[float] = None, band_policy: Optional[BandPolicy] = None,
              supervisor: Optional[JobSupervisor] = None,
              clock: Optional[Callable[[], float]] = None) -> "SketchEngine":
        """Create an engine on ``mapping``'s device; ``corpus_idx`` (C, P) is
        ingested if given, otherwise the engine starts empty and is fed via
        :meth:`add`. ``mutable=True`` builds over a :class:`SegmentedStore`;
        ``seal_rows`` auto-seals its head at that many rows, ``ttl`` arms
        lazy expiry for queries that carry a ``now``, and ``band_policy``
        arms the banded prefilter: sealed segments grow bucket indexes and
        queries scan only colliding buckets. ``supervisor`` governs
        background jobs and degraded modes (default: a fresh
        :class:`JobSupervisor` on the real clock; give it a ``ManualClock``
        to drive backoff, deadlines and probation by hand). ``clock`` is the
        engine's and the mutable store's clock (and the default supervisor's):
        queries without ``now`` resolve lazy TTL against it."""
        be = backends_mod.get_backend(backend)
        if (seal_rows is not None or ttl is not None
                or band_policy is not None) and not mutable:
            raise ValueError("seal_rows/ttl/band_policy require mutable=True (an "
                             "append-only SketchStore has no head to seal, no clock, "
                             "no sealed segments to band)")
        if mutable:
            kw = {"seal_rows": seal_rows, "ttl": ttl, "band_policy": band_policy,
                  "supervisor": supervisor, "clock": clock}
            if corpus_idx is not None:
                store = SegmentedStore.from_indices(cfg, mapping, corpus_idx, backend=be,
                                                    batch=batch, **kw)
            else:
                store = SegmentedStore.create(cfg, mapping, capacity=capacity, **kw)
        elif corpus_idx is not None:
            store = SketchStore.from_indices(cfg, mapping, corpus_idx, backend=be, batch=batch)
        else:
            store = SketchStore.create(cfg, mapping, capacity=capacity)
        eng = cls(store, be, measure, planner or QueryPlanner(), clock=clock)
        if supervisor is not None and not mutable:
            eng._own_supervisor = supervisor
        return eng

    # -------------------------------------------------------- observability
    @property
    def supervisor(self) -> JobSupervisor:
        """The supervisor of this engine's background jobs and degraded
        modes: the mutable store's own, or one the engine keeps for an
        append-only store."""
        sup = getattr(self.store, "supervisor", None)
        if sup is not None:
            return sup
        if self._own_supervisor is None:
            self._own_supervisor = JobSupervisor(clock=self.clock)
        return self._own_supervisor

    def health(self) -> dict:
        """The supervisor's JSON-safe snapshot: job counters per operation
        (launched, succeeded, failed, retries, abandoned, refused),
        quarantines, degraded query-path components with their reasons, the
        last error and job latencies."""
        return self.supervisor.health()

    def _injected_clock(self) -> Optional[Callable[[], float]]:
        """The engine's clock, else the store's; None when neither has one."""
        return self.clock if self.clock is not None else getattr(self.store, "clock", None)

    def _auto_now(self, now: Optional[float]) -> Optional[float]:
        """Explicit ``now`` wins; else the injected clock; else None."""
        if now is not None:
            return float(now)
        c = self._injected_clock()
        return float(c()) if c is not None else None

    def enable_metrics(self, *, sample: int = 1, capacity: int = 64):
        """Arm the telemetry plane (module-global, like ``faults``) on this
        engine's clock; returns the fresh
        :class:`~repro_torch.obs.metrics.MetricsRegistry`. Disarm with
        ``obs.disable()``."""
        return obs.enable(clock=self._injected_clock(), sample=sample, capacity=capacity)

    def metrics(self, now: Optional[float] = None) -> dict:
        """One JSON-safe telemetry snapshot: the armed registry's counters,
        gauges and histograms (empty while disarmed), ``health`` (the
        supervisor's), ``probe`` (the latest online recall reading),
        ``lifecycle`` (per-segment live/tombstone/width/age/hits, width mix,
        tombstone density, from host bookkeeping), and ``controller`` (an
        attached lifecycle controller's state), ``prefilter`` and
        ``last_trace`` when there are any. Reads nothing off the device."""
        now = self._auto_now(now)
        reg = obs_metrics.active()
        snap = (reg.snapshot() if reg is not None
                else {"at": 0.0, "counters": {}, "gauges": {}, "histograms": {}})
        out = {
            "at": float(now) if now is not None else float(snap["at"]),
            "armed": reg is not None,
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": snap["histograms"],
            "health": self.health(),
            "probe": {
                "recall": snap["gauges"].get("probe.recall"),
                "at": snap["gauges"].get("probe.at"),
                "runs": int(snap["counters"].get("probe.runs", 0)),
            },
        }
        if isinstance(self.store, SegmentedStore):
            out["lifecycle"] = self.store.lifecycle_snapshot(now=now)
        else:
            n = int(self.store.size)
            out["lifecycle"] = {"segments": [], "head": None, "live_docs": n,
                                "tombstone_density": 0.0,
                                "width_mix": {str(self.cfg.n_bins): n} if n else {}}
        if self.controller is not None:
            out["controller"] = self.controller.controller_state()
        if self.last_prefilter_stats is not None:
            out["prefilter"] = dict(self.last_prefilter_stats)
        col = obs_trace.active()
        if col is not None:
            out["last_trace"] = col.last()
        return out

    def _count_view_hits(self) -> None:
        """One hit for every non-empty segment and the head, per exhaustive
        scoring pass (the banded pass counts inline, since it skips
        segments)."""
        st = self.store
        if not isinstance(st, SegmentedStore):
            return
        for seg in st.sealed:
            if seg.n_rows:
                seg.hits += 1
        if st.head.size:
            st.head_hits += 1

    @property
    def cfg(self) -> binsketch.BinSketchConfig:
        return self.store.cfg

    @property
    def device(self) -> torch.device:
        return self.store.device

    # ---------------------------------------------------------------- ingest
    def add(self, idx, *, batch: int = 4096, now: float = 0.0) -> range:
        """Stream (B, P) padded sparse docs into the corpus; returns ids.
        ``now`` stamps the docs' birth time on a mutable store (TTL measures
        age against it); an append-only store ignores it."""
        if isinstance(self.store, SegmentedStore):
            return self.store.add(idx, backend=self.backend, batch=batch, now=now)
        return self.store.add(idx, backend=self.backend, batch=batch)

    def merge_rows(self, doc_ids, idx) -> None:
        """OR new content into existing docs (see ``SketchStore.merge_rows``)."""
        self.store.merge_rows(doc_ids, idx, backend=self.backend)

    # ------------------------------------------------- lifecycle (mutable)
    def _mutable_store(self) -> SegmentedStore:
        if not isinstance(self.store, SegmentedStore):
            raise TypeError("this engine serves an append-only SketchStore; build with "
                            "mutable=True for delete/update/seal/compact/expire/distill")
        return self.store

    def delete(self, doc_ids) -> int:
        """Tombstone docs (head rows zeroed, sealed rows masked)."""
        return self._mutable_store().delete(doc_ids)

    def update(self, doc_ids, idx, *, now: float = 0.0) -> None:
        """Replace doc contents, keeping ids (sealed docs relocate into the head)."""
        self._mutable_store().update(doc_ids, idx, backend=self.backend, now=now)

    def retract_rows(self, doc_ids, idx) -> None:
        """Decrement elements out of head-resident docs (counting sketch)."""
        self._mutable_store().retract_rows(doc_ids, idx, backend=self.backend)

    def seal(self):
        """Freeze the counting head into a packed sealed segment (its band
        index, if the policy wants one, hashed through this backend)."""
        return self._mutable_store().seal(backend=self.backend)

    def compact(self, *, background: bool = False, _hold=None):
        """Merge sealed segments per width, dropping tombstones.

        ``background=False``: synchronous, on the device; returns stats.
        ``background=True``: start the merge as a supervised background job
        and return None; queries keep serving the old segments and swap the
        result in the moment it is ready (or call :meth:`wait_compaction` for
        the stats). Either way, fresh band indexes are hashed through this
        backend."""
        store = self._mutable_store()
        if not background:
            return store.compact(backend=self.backend)
        store.compact_async(backend=self.backend, _hold=_hold)
        return None

    def poll_compaction(self) -> bool:
        """Non-blocking: swap in a finished background job."""
        return self._mutable_store().poll_compaction()

    def wait_compaction(self):
        """Drive the background job to its end and swap it in; its stats."""
        return self._mutable_store().wait_compaction()

    def expire(self, ttl: float, now: float) -> int:
        """Tombstone docs with ``born + ttl <= now``."""
        return self._mutable_store().expire(ttl, now)

    def distill(self, policy: Optional[DistillPolicy] = None, *, widths=None,
                now: float = 0.0, background: bool = False, _hold=None):
        """Re-sketch policy-eligible sealed segments to their next smaller
        width tier, folded on the host by a supervised background job (band
        indexes hashed through this backend in the swap). ``widths`` is
        shorthand for an unconditional policy over those tiers.

        ``background=False`` (this package's default; the reference defaults
        to True) waits for the job and returns the swap's stats, or None when
        nothing was eligible or the job failed. ``background=True`` returns
        whether a job started; queries swap it in when it is ready. Queries
        afterwards are served mixed-width."""
        store = self._mutable_store()
        if policy is None:
            if widths is None:
                raise ValueError("pass a DistillPolicy or widths=(N', ...)")
            policy = DistillPolicy(widths=tuple(widths))
        started = store.distill_async(policy, now=now, backend=self.backend, _hold=_hold)
        if not background:
            return store.wait_compaction() if started else None
        return started

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
        :meth:`query`. Column ``j`` is doc ``j``; on a segmented store, the
        j-th live doc in ascending id (``store.live_ids[j]``)."""
        query_idx = as_index_tensor(query_idx, self.device)
        if query_idx.shape[0] == 0:
            return torch.zeros((0, self.store.size), dtype=torch.float32, device=self.device)
        if isinstance(self.store, SegmentedStore):
            corpus, fills, _ = self.store.live()  # one gather, not two
        else:
            corpus, fills = self.store.sketches, self.store.fills
        out = []
        for chunk in self.planner.plan(query_idx.shape[0]):
            qs = self._padded_query_sketches(
                query_idx[chunk.start : chunk.start + chunk.rows], chunk.padded)
            s = self.backend.score(qs, corpus, self.cfg.n_bins, self.measure,
                                   corpus_fills=fills)
            out.append(s[: chunk.rows])
        return torch.cat(out, dim=0)

    def _rebucket_queries(self, qs: torch.Tensor, n_bins: int, cache: dict) -> torch.Tensor:
        """Base-width query sketches folded to ``n_bins``, once per distinct
        width per chunk (``cache``: width -> folded batch). The fold of the
        base sketch is the sketch under ``pi mod n_bins``, so the raw query
        rows are never read again."""
        if n_bins == self.cfg.n_bins:
            return qs
        got = cache.get(n_bins)
        if got is None:
            got = cache[n_bins] = self.backend.rebucket(qs, self.cfg.n_bins, n_bins)
        return got

    def _views_topk(self, qs: torch.Tensor, views, k: int, tr=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming top-k over the segment views + k-slot merge; each view is
        scored at its own width."""
        if not views:
            return (torch.full((qs.shape[0], k), -math.inf, device=qs.device),
                    torch.full((qs.shape[0], k), -1, dtype=torch.int32, device=qs.device))
        width_cache: dict = {}
        parts = [self._view_part(qs, v, k, width_cache, tr) for v in views]
        if len(parts) == 1:
            return parts[0]
        t0 = tr.begin() if tr is not None else None
        got = merge_segment_topk([p[0] for p in parts], [p[1] for p in parts], k)
        if tr is not None:
            tr.end("merge", t0)
        return got

    def _view_part(self, qs: torch.Tensor, v: SegmentView, k: int, width_cache: dict,
                   tr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One view's (Q, k) partial: ``Backend.topk`` at the view's width,
        local rows mapped to global doc ids. The width fold runs outside every
        trace stage, as in the reference."""
        nb = v.n_bins if v.n_bins is not None else self.cfg.n_bins
        q_w = self._rebucket_queries(qs, nb, width_cache)
        t0 = tr.begin() if tr is not None else None
        sc, ix = self.backend.topk(q_w, v.sketches, nb, self.measure, k,
                                   corpus_fills=v.fills, corpus_valid=v.valid)
        if tr is not None:
            tr.end("kernel_score", t0)
            tr.note_width(nb)
        if v.ids is not None:
            ix = torch.where(ix >= 0, v.ids[ix.clamp_min(0).to(torch.int64)], ix)
        return sc, ix

    # -------------------------------------------------------- banded prefilter
    def _query_band_keys(self, qs: torch.Tensor, n_bins: int, rows: int, width_cache: dict,
                         qkeys_cache: dict) -> np.ndarray:
        """(rows, nb_eff) uint32 host band keys of the chunk's first ``rows``
        query rows at width ``n_bins``, hashed once per width per chunk
        (``qkeys_cache``: width -> keys of the whole padded chunk). Only real
        rows are returned: a pad row's zero sketch hashes like an empty word
        group and would pull that bucket into every padded chunk."""
        got = qkeys_cache.get(n_bins)
        if got is None:
            q_w = self._rebucket_queries(qs, n_bins, width_cache)
            keys = self.backend.band_hash(q_w, self.store.band_policy.n_bands)
            got = qkeys_cache[n_bins] = keys.cpu().numpy().view(np.uint32)
        return got[:rows]

    def _segment_candidates(self, seg: SealedSegment, qkeys: np.ndarray,
                            now: Optional[float], tr=None) -> Optional[np.ndarray]:
        """Live candidate rows of one indexed segment for the chunk, ascending;
        None when the escape hatch fires (the union outgrew
        ``max_candidate_frac`` of the segment, and the exhaustive scan is the
        better deal). Dead and TTL-expired rows stay in their buckets and are
        dropped here against the current host bitmaps, the predicate the
        exhaustive views apply. A failed lookup returns None too, recorded
        as ``band_lookup``; the hatch is recorded as ``prefilter_hatch``."""
        store: SegmentedStore = self.store
        try:
            cand = seg.band_index.candidates(qkeys)
        except Exception as e:
            # a broken bucket lookup must not break the query: this segment
            # serves exhaustively and the degradation lands in health()
            self.supervisor.record_degraded("band_lookup", f"{e}")
            if tr is not None:
                tr.note_degraded("band_lookup")
            return None
        if len(cand):
            cand = cand[seg.valid[cand]]
            if store.ttl is not None and now is not None:
                cand = cand[seg.born[cand] + store.ttl > now]
        if len(cand) > store.band_policy.max_candidate_frac * seg.n_rows:
            # the escape hatch is a degraded mode too: the same fallback for
            # another cause (selectivity), recorded so that a query pattern
            # defeating the prefilter shows in health()
            self.supervisor.record_degraded(
                "prefilter_hatch",
                f"candidate union {len(cand)}/{seg.n_rows} rows exceeded "
                f"max_candidate_frac={store.band_policy.max_candidate_frac}")
            if tr is not None:
                tr.note_degraded("prefilter_hatch")
            return None
        return cand

    def _gathered_part(self, qs: torch.Tensor, seg: SealedSegment, cand: np.ndarray, k: int,
                       width_cache: dict, tr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k over a gather of one segment's candidate rows.

        The rows are padded to the planner's candidate bucket (a bounded set
        of slab shapes; pad rows repeat row 0 and are masked out) and
        gathered into a compact slab, so the scoring kernel reads
        O(|candidates|) rows, not O(C). ``cand`` ascends and segment rows
        ascend in id, so the slab keeps position order == id order, and a
        surviving id scores exactly as in the exhaustive scan (same kernel
        path, width and fills)."""
        nb = seg.n_bins if seg.n_bins is not None else self.cfg.n_bins
        q_w = self._rebucket_queries(qs, nb, width_cache)
        t0 = tr.begin() if tr is not None else None
        n = len(cand)
        padded = self.planner.candidate_bucket(n, seg.n_rows)
        rows_np = np.zeros(padded, np.int64)
        rows_np[:n] = cand
        rows = torch.from_numpy(rows_np).to(self.device)
        sub, fills = seg.sketches.index_select(0, rows), seg.fills.index_select(0, rows)
        vmask = torch.from_numpy((np.arange(padded) < n).astype(np.int32)).to(self.device)
        if tr is not None:
            tr.end("candidate_gather", t0)
            t0 = tr.begin()
        sc, ix = self.backend.topk(q_w, sub, nb, self.measure, k, corpus_fills=fills,
                                   corpus_valid=vmask)
        if tr is not None:
            tr.end("kernel_score", t0)
            tr.note_width(nb)
        gids = np.full(padded, -1, np.int32)
        gids[:n] = seg.ids[cand]
        gid_dev = torch.from_numpy(gids).to(self.device)
        return sc, torch.where(ix >= 0, gid_dev[ix.clamp_min(0).to(torch.int64)], ix)

    def _prefiltered_topk(self, qs: torch.Tensor, rows: int, k: int, *,
                          now: Optional[float], width_cache: dict, qkeys_cache: dict,
                          stats: dict, tr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One planner chunk, banded: indexed sealed segments score only their
        candidates; unindexed segments (below ``min_rows``, or sealed before
        the policy), escape-hatch segments and the head score in full. The
        parts merge under the one (score desc, id asc) order: the prefilter
        changes which rows score, never how they score. Each scored segment,
        and the head, counts a hit."""
        store: SegmentedStore = self.store
        parts_s, parts_i = [], []
        for seg_i, seg in enumerate(store.sealed):
            if seg.n_rows == 0:
                continue
            if seg.band_index is None:
                stats["unindexed_segments"] += 1
                sc, ix = self._view_part(qs, seg.view(store.ttl, now), k, width_cache, tr)
            else:
                nb = seg.n_bins if seg.n_bins is not None else self.cfg.n_bins
                t0 = tr.begin() if tr is not None else None
                qkeys = self._query_band_keys(qs, nb, rows, width_cache, qkeys_cache)
                cand = self._segment_candidates(seg, qkeys, now, tr)
                if tr is not None:
                    tr.end("band_lookup", t0)
                stats["seg_rows"] += seg.n_rows
                if cand is None:
                    stats["exhaustive_segments"] += 1
                    stats["cand_rows"] += seg.n_rows
                    if tr is not None:
                        tr.note_segment(f"seg{seg_i}", seg.n_rows, seg.n_rows)
                    sc, ix = self._view_part(qs, seg.view(store.ttl, now), k, width_cache, tr)
                else:
                    stats["banded_segments"] += 1
                    stats["cand_rows"] += len(cand)
                    if tr is not None:
                        tr.note_segment(f"seg{seg_i}", seg.n_rows, len(cand))
                    if len(cand) == 0:
                        continue  # nothing scored: no hit for this segment
                    sc, ix = self._gathered_part(qs, seg, cand, k, width_cache, tr)
            seg.hits += 1  # scored in this pass
            parts_s.append(sc)
            parts_i.append(ix)
        hv = store.head_view(now)
        if hv is not None:  # head rows are unbanded: always scored
            sc, ix = self._view_part(qs, hv, k, width_cache, tr)
            store.head_hits += 1
            parts_s.append(sc)
            parts_i.append(ix)
        if not parts_s:
            return (torch.full((qs.shape[0], k), -math.inf, device=qs.device),
                    torch.full((qs.shape[0], k), -1, dtype=torch.int32, device=qs.device))
        if len(parts_s) == 1:
            return parts_s[0], parts_i[0]
        t0 = tr.begin() if tr is not None else None
        got = merge_segment_topk(parts_s, parts_i, k)
        if tr is not None:
            tr.end("merge", t0)
        return got

    def _resolve_prefilter(self, prefilter: Optional[bool]) -> bool:
        on = isinstance(self.store, SegmentedStore) and self.store.band_policy is not None
        if prefilter is None:
            return on
        if prefilter and not on:
            raise ValueError("prefilter=True needs a mutable store built with a band_policy "
                             "(SketchEngine.build(..., mutable=True, "
                             "band_policy=BandPolicy(...)))")
        return bool(prefilter)

    @staticmethod
    def _fresh_prefilter_stats() -> dict:
        return {"seg_rows": 0, "cand_rows": 0, "banded_segments": 0,
                "exhaustive_segments": 0, "unindexed_segments": 0}

    def query(self, query_idx, k: int, *, now: Optional[float] = None,
              prefilter: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, P) padded query rows -> (scores (Q, k) float32, ids (Q, k) int32).

        Each planner chunk is sketched and streamed through ``Backend.topk``
        per view; ids are global doc ids, stable across seal, compaction and
        distillation. If ``k`` exceeds the live corpus the tail slots hold
        score -inf / id -1. ``now`` is the query-time clock of lazy TTL expiry
        on a mutable store with a ``ttl``; without it, the injected clock's
        time (:meth:`_auto_now`).

        ``prefilter`` gates the banded prefilter: ``None`` turns it on when
        the store carries a band policy, ``False`` forces the exhaustive scan
        (the recall baseline), ``True`` insists and raises without a policy.
        When on, results are the exact top-k over the candidate rows, with the
        exhaustive scan's scores for every surviving id, and
        :attr:`last_prefilter_stats` holds the candidate accounting."""
        query_idx = as_index_tensor(query_idx, self.device)
        n_q = int(query_idx.shape[0])
        if n_q == 0:
            return (torch.zeros((0, k), dtype=torch.float32, device=self.device),
                    torch.full((0, k), -1, dtype=torch.int32, device=self.device))
        now = self._auto_now(now)
        if isinstance(self.store, SegmentedStore):
            self.store.poll_compaction()  # adopt a finished background job
        banded = self._resolve_prefilter(prefilter)
        obs_metrics.inc("query.calls")
        obs_metrics.inc("query.rows", n_q)
        tr = obs_trace.start("query", n_q, k, self.device)
        try:
            views = None if banded else self.store.segment_views(now=now)
            stats = self._fresh_prefilter_stats() if banded else None
            out_s, out_i = [], []
            for chunk in self.planner.plan(n_q):
                t0 = tr.begin() if tr is not None else None
                qs = self._padded_query_sketches(
                    query_idx[chunk.start : chunk.start + chunk.rows], chunk.padded)
                if tr is not None:
                    tr.end("rebucket", t0)
                if banded:
                    # per-chunk caches: the folded and hashed query blocks
                    # belong to this chunk's rows
                    try:
                        sc, ix = self._prefiltered_topk(qs, chunk.rows, k, now=now,
                                                        width_cache={}, qkeys_cache={},
                                                        stats=stats, tr=tr)
                    except Exception as e:
                        # the prefilter is an accelerator: a failure degrades
                        # this chunk to the exhaustive scan (same answers, more
                        # rows), unless a kernel or its wrapper raised, or the
                        # card
                        if is_device_fault(e):
                            raise
                        self.supervisor.record_degraded("prefilter", f"{e}")
                        if tr is not None:
                            tr.note_degraded("prefilter")
                        if views is None:
                            views = self.store.segment_views(now=now)
                        sc, ix = self._views_topk(qs, views, k, tr)
                        self._count_view_hits()
                else:
                    sc, ix = self._views_topk(qs, views, k, tr)
                    self._count_view_hits()
                out_s.append(sc[: chunk.rows])
                out_i.append(ix[: chunk.rows])
            if banded:
                self.last_prefilter_stats = stats
            if k > self.store.size:
                obs_metrics.inc("query.k_overflow")
                if tr is not None:
                    tr.k_overflow = True
            return torch.cat(out_s, dim=0), torch.cat(out_i, dim=0)
        finally:
            obs_trace.finish(tr)
