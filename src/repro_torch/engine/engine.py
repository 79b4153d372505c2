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

``query_sharded`` serves over a :class:`~repro_torch.parallel.DeviceMesh`
from this one process. On a :class:`SegmentedStore` the **segment is the
shard unit**: a :class:`~repro_torch.engine.placement.SegmentPlacer` puts
whole sealed segments on shards (balanced by live rows), each shard's rows
sit in one id-ascending slab per width on its device, built once per layout,
and the head is scored once, off the mesh. Per query the batch's sketches are
copied to each shard device once per width, every shard's streaming top-k is
launched before anything waits, and the (Q, k) partials are gathered onto
``mesh.devices[0]`` and merged under the one (score desc, id asc) order. A
failed placement build or mask refresh degrades the call to the **sliced
path** (every segment cut into equal row ranges across the shards, the
reference's baseline and the only path of an append-only store), unless a
kernel or the card failed. After a sharded query, a background compaction
merges each shard's resident segments apart (device-local groups).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import binsketch
from ..hopper import ref
from ..hopper.build import is_device_fault
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..parallel.sharding import DeviceMesh, all_gather
from . import backends as backends_mod
from .backends import Backend
from .banding import BandPolicy
from .placement import SegmentPlacement, SegmentPlacer, WidthSlab
from .planner import QueryPlanner
from .segments import DistillPolicy, SealedSegment, SegmentedStore
from .store import SegmentView, SketchStore, as_index_tensor
from .supervision import JobSupervisor

__all__ = ["SketchEngine", "merge_segment_topk", "shard_topk"]


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


def _shard_partials(qs: torch.Tensor, cand: Sequence[torch.Tensor], n_bins: int, measure: str,
                    k: int, mesh: DeviceMesh, backend: Backend,
                    cand_fills: Optional[Sequence[torch.Tensor]] = None,
                    cand_ids: Optional[Sequence[torch.Tensor]] = None,
                    cand_valid: Optional[Sequence[Optional[torch.Tensor]]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard's (Q, k) top-k, gathered shard-major onto
    ``mesh.devices[0]`` as (Q, k·shards) scores and global ids.

    The query batch is copied to each distinct shard device once; each
    shard's ``Backend.topk`` is launched in turn and nothing waits inside the
    loop, so shards on separate cards overlap. Local rows map to
    ``cand_ids[d]`` (default: the shard's offset plus the local row); masked
    rows never surface, and empty slots hold -inf / -1."""
    q_on = {}
    parts_s, parts_i = [], []
    lo = 0
    for d, dev in enumerate(mesh.devices):
        q = q_on.get(dev)
        if q is None:
            q = q_on[dev] = qs.to(dev)
        sc, ix = backend.topk(q, cand[d], n_bins, measure, k,
                              corpus_fills=None if cand_fills is None else cand_fills[d],
                              corpus_valid=None if cand_valid is None else cand_valid[d])
        if cand_ids is None:
            gids = torch.where(ix >= 0, ix + lo, ix)
        else:  # -1 slots index row 0 and are masked back to -1
            gids = torch.where(ix >= 0, cand_ids[d][ix.clamp_min(0).long()], ix)
        lo += cand[d].shape[0]
        parts_s.append(sc)
        parts_i.append(gids.to(torch.int32))
    dev0 = mesh.devices[0]
    return all_gather(parts_s, dev0), all_gather(parts_i, dev0)


def shard_topk(qs: torch.Tensor, cand: Sequence[torch.Tensor], n_bins: int, measure: str,
               k: int, mesh: DeviceMesh, *, backend: Optional[Backend] = None,
               cand_fills: Optional[Sequence[torch.Tensor]] = None,
               cand_ids: Optional[Sequence[torch.Tensor]] = None,
               cand_valid: Optional[Sequence[Optional[torch.Tensor]]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard streaming top-k, then the O(k·shards) gather and merge.

    The counterpart of the reference's ``shard_topk``, which runs inside
    ``shard_map``: here ``cand`` is the sequence of shard slices in mesh
    order, ``cand[d]`` (C_loc, W) on ``mesh.devices[d]``, and ``qs`` (Q, W)
    is copied to each shard device. ``cand_fills``, ``cand_ids`` (global doc
    ids; default: the shard's row offset plus the local row) and
    ``cand_valid`` (pad rows masked out; an entry may be None) are per-shard
    sequences alike. Each local pass goes through ``Backend.topk``, so no
    shard stores its (Q, C_loc) score matrix; the merge on
    ``mesh.devices[0]`` keeps the lower shard-major position among ties, as
    ``jax.lax.top_k`` does. Returns (scores (Q, k), ids (Q, k) int32)."""
    be = backend if backend is not None else backends_mod.ReferenceBackend()
    sc_all, ids_all = _shard_partials(qs, cand, n_bins, measure, k, mesh, be, cand_fills,
                                      cand_ids, cand_valid)
    return ref.select_topk(sc_all, ids_all, k)


@dataclasses.dataclass
class SketchEngine:
    """Build + serve over a :class:`SketchStore` through one backend."""

    store: SketchStore
    backend: Backend
    measure: str = "jaccard"
    planner: QueryPlanner = dataclasses.field(default_factory=QueryPlanner)
    placer: SegmentPlacer = dataclasses.field(default_factory=SegmentPlacer)
    # the injected clock: queries with no explicit ``now`` resolve TTL against
    # it (else the store's), and metrics and traces stamp their times with it
    clock: Optional[Callable[[], float]] = None
    # the placement of the last placed ``query_sharded``, rebuilt when the
    # sealed-segment set or the mesh changes (see :meth:`_ensure_placement`)
    _placement: Optional[SegmentPlacement] = dataclasses.field(default=None, init=False,
                                                               repr=False)
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

    def _count_slab_hits(self, n_bins: int) -> None:
        """One hit for every non-empty sealed segment of width ``n_bins``:
        the placed path scores a width slab whole, never a single segment of
        it (the replicated head is counted once, by the caller)."""
        st = self.store
        if not isinstance(st, SegmentedStore):
            return
        base = self.cfg.n_bins
        for seg in st.sealed:
            if seg.n_rows and (seg.n_bins if seg.n_bins is not None else base) == n_bins:
                seg.hits += 1

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
        backend. While a placement is live (a placed ``query_sharded`` ran on
        the current layout), the background merge is **device-local**: one
        group per shard over exactly its resident segments, so each merged
        segment lands back on its shard at the next placement."""
        store = self._mutable_store()
        if not background:
            return store.compact(backend=self.backend)
        # adopt a pending job *before* reading the placement: its swap
        # renumbers the sealed list, and groups read earlier would be stale
        store.wait_compaction()
        groups = None
        p = self._placement
        if p is not None and p.layout_epoch == store._layout_epoch:
            groups = [g for g in p.assign if g]
        store.compact_async(groups=groups, backend=self.backend, _hold=_hold)
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
    def _sketch_queries(self, query_idx: torch.Tensor) -> torch.Tensor:
        return self.backend.sketch(self.cfg, self.store.mapping, query_idx)

    def _padded_query_sketches(self, query_idx: torch.Tensor, padded: int) -> torch.Tensor:
        q = query_idx.shape[0]
        if padded > q:
            pad = torch.full((padded - q, query_idx.shape[1]), -1, dtype=query_idx.dtype,
                             device=query_idx.device)
            query_idx = torch.cat([query_idx, pad], dim=0)
        return self._sketch_queries(query_idx)

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

    # --------------------------------------------------------------- sharded
    def query_sharded(self, mesh: DeviceMesh, axis: str, query_idx, k: int, *,
                      now: Optional[float] = None, use_placement: bool = True,
                      prefilter: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Candidate-sharded retrieval over ``mesh``: each shard's top-k, then
        the O(k·shards) merge; answers on ``mesh.devices[0]``.

        On a :class:`SegmentedStore` the segment is the shard unit: whole
        sealed segments are placed on shards (balanced by live rows, resident
        across queries), the head is scored once, and each shard streams only
        its resident rows; the partials merge under the global lower-id
        tie-break, so the answers are :meth:`query`'s. ``use_placement=False``
        forces the sliced path (every segment cut across the shards per
        query, the benchmark baseline). An append-only :class:`SketchStore`
        is always sliced; pad rows of a C the shard count does not divide
        score -inf / id -1. A placement that fails to build or refresh its
        mask is recorded as the ``placement`` degraded mode and the call is
        served sliced, with the same answers; a fault of a kernel or the card
        propagates.

        ``prefilter`` as in :meth:`query`: on the placed path each shard
        gathers and scores only the candidate slots resident in its slab; the
        bucket lookup runs once per segment on the host, and candidates
        route to their shard through the placement's row-to-slot map."""
        query_idx = as_index_tensor(query_idx, self.device)
        dev0 = mesh.devices[0]
        n_q = int(query_idx.shape[0])
        if n_q == 0:
            return (torch.zeros((0, k), dtype=torch.float32, device=dev0),
                    torch.full((0, k), -1, dtype=torch.int32, device=dev0))
        now = self._auto_now(now)
        obs_metrics.inc("query.calls")
        obs_metrics.inc("query.rows", n_q)
        tr = obs_trace.start("query_sharded", n_q, k, self.device)
        try:
            if k > self.store.size:
                obs_metrics.inc("query.k_overflow")
                if tr is not None:
                    tr.k_overflow = True
            if isinstance(self.store, SegmentedStore):
                self.store.poll_compaction()
                if use_placement:
                    pf = self._resolve_prefilter(prefilter)  # misuse raises here
                    try:
                        sc, ix = self._query_placed(mesh, axis, query_idx, k, now=now,
                                                    prefilter=pf, tr=tr)
                        return sc.to(dev0), ix.to(dev0)
                    except Exception as e:
                        # placement (its build or mask refresh) is an
                        # accelerator: drop it and serve this call sliced,
                        # the same answers; a kernel or the card failing is
                        # not such a fault
                        if is_device_fault(e):
                            raise
                        self.supervisor.record_degraded("placement", f"{e}")
                        if tr is not None:
                            tr.note_degraded("placement")
                        self._placement = None
            views = self.store.segment_views(now=now)
            t0 = tr.begin() if tr is not None else None
            qs = self._sketch_queries(query_idx)
            if tr is not None:
                tr.end("rebucket", t0)
            if not views:
                return (torch.full((n_q, k), -math.inf, device=dev0),
                        torch.full((n_q, k), -1, dtype=torch.int32, device=dev0))
            self._count_view_hits()
            cache: dict = {}
            t0 = tr.begin() if tr is not None else None
            parts = [self._sharded_view_topk(mesh, axis, qs, v, k, width_cache=cache)
                     for v in views]
            if tr is not None:
                tr.end("kernel_score", t0)
                for v in views:
                    tr.note_width(v.n_bins if v.n_bins is not None else self.cfg.n_bins)
            if len(parts) == 1:
                return parts[0]
            t0 = tr.begin() if tr is not None else None
            got = merge_segment_topk([p[0] for p in parts], [p[1] for p in parts], k)
            if tr is not None:
                tr.end("merge", t0)
            return got
        finally:
            obs_trace.finish(tr)

    def _ensure_placement(self, mesh: DeviceMesh, axis: str) -> SegmentPlacement:
        """The current placement, rebuilt only when the sealed-segment set
        changed (seal, compaction, a background swap) or the mesh did; a
        tombstone flip rebuilds only a validity mask, never a slab."""
        store = self.store
        p = self._placement
        if (p is None or p.mesh != mesh or p.axis != axis
                or p.layout_epoch != store._layout_epoch):
            p = self._placement = self.placer.place(store, mesh, axis)
        return p

    def _slab_candidates(self, slab: WidthSlab, qkeys: np.ndarray, now: Optional[float],
                         stats: dict, tr=None) -> Optional[np.ndarray]:
        """Slot candidates of one width slab for the batch (ascending, live
        only), or None when a resident indexed segment trips the escape hatch:
        the whole slab then takes the exhaustive pass (a per-segment fallback
        would stream the whole slab anyway). An unindexed segment (under
        ``min_rows``) adds all its live rows, keeping one pass per slab.
        Candidates are filtered on the host against the tombstone and TTL
        predicate, so the pass needs no validity mask beyond its pads."""
        store: SegmentedStore = self.store
        base = self.cfg.n_bins
        segs = [(i, s) for i, s in enumerate(store.sealed)
                if s.n_rows > 0 and (s.n_bins if s.n_bins is not None else base) == slab.n_bins]
        pend = []  # (seg_i, seg, candidate rows); stats commit only without a hatch
        seg_rows = cand_rows = banded = unindexed = 0
        for seg_i, seg in segs:
            if seg.band_index is None:
                cand = np.nonzero(seg.valid)[0].astype(np.int64)
                if store.ttl is not None and now is not None:
                    cand = cand[seg.born[cand] + store.ttl > now]
                unindexed += 1
            else:
                cand = self._segment_candidates(seg, qkeys, now, tr)
                if cand is None:  # the escape hatch: the whole slab goes exhaustive
                    for s_i, s in segs:
                        if s.band_index is not None:
                            stats["seg_rows"] += s.n_rows
                            stats["cand_rows"] += s.n_rows
                            stats["exhaustive_segments"] += 1
                        else:
                            stats["unindexed_segments"] += 1
                        if tr is not None:
                            tr.note_segment(f"seg{s_i}", s.n_rows, s.n_rows)
                    return None
                seg_rows += seg.n_rows
                cand_rows += len(cand)
                banded += 1
            if tr is not None:
                tr.note_segment(f"seg{seg_i}", seg.n_rows, len(cand))
            pend.append((seg_i, seg, cand))
        stats["seg_rows"] += seg_rows
        stats["cand_rows"] += cand_rows
        stats["banded_segments"] += banded
        stats["unindexed_segments"] += unindexed
        slots = []
        for seg_i, seg, cand in pend:
            if len(cand):
                s = slab.row_slots(seg_i, seg.n_rows)[cand]
                slots.append(s[s >= 0])
        if not slots:
            return np.zeros((0,), np.int64)
        # slots of distinct segments are disjoint; ascending slots keep each
        # shard's gather id-ascending (the slabs are id-sorted)
        return np.sort(np.concatenate(slots))

    def _prefiltered_slab_topk(self, q_w: torch.Tensor, slab: WidthSlab, slots: np.ndarray,
                               k: int, tr=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One width slab's gathered (Q, k·shards) partial over ``slots``
        only: each shard gathers the candidate slots resident in its own slab
        (O(|local candidates|) rows streamed, no corpus bytes moved), padded
        to a planner bucket. The host split and every upload happen before
        the first launch; per-shard slots ascend, so each gathered sub-slab
        keeps the slab's id-ascending tie order."""
        t0 = tr.begin() if tr is not None else None
        n_dev, n_local = len(slab.mesh.devices), slab.n_local
        shard_of, loc = slots // n_local, slots % n_local
        counts = np.bincount(shard_of, minlength=n_dev)
        l_c = self.planner.candidate_bucket(int(counts.max()), n_local)
        idx = np.zeros((n_dev, l_c), np.int64)
        msk = np.zeros((n_dev, l_c), np.int32)
        for d in range(n_dev):
            ld = loc[shard_of == d]  # ascending: the slots are sorted
            idx[d, : len(ld)] = ld
            msk[d, : len(ld)] = 1
        sub, fills, ids, valid = [], [], [], []
        for d, dev in enumerate(slab.mesh.devices):
            rows = torch.from_numpy(idx[d]).to(dev)
            sub.append(slab.sketches[d].index_select(0, rows))
            fills.append(slab.fills[d].index_select(0, rows))
            ids.append(slab.ids[d].index_select(0, rows))
            valid.append(torch.from_numpy(msk[d]).to(dev))
        if tr is not None:
            tr.end("candidate_gather", t0)
            t0 = tr.begin()
        got = _shard_partials(q_w, sub, slab.n_bins, self.measure, k, slab.mesh, self.backend,
                              fills, ids, valid)
        if tr is not None:
            tr.end("kernel_score", t0)
        return got

    def _query_placed(self, mesh: DeviceMesh, axis: str, query_idx: torch.Tensor, k: int, *,
                      now: Optional[float] = None, prefilter: bool = False, tr=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The segment-placed body of :meth:`query_sharded`.

        One pass per resident width (base and every distilled tier): each
        shard streams the top-k over its width slab against the batch folded
        to that width, and the per-shard (Q, k) partials are gathered onto
        ``mesh.devices[0]``. The head partial (scored once) and every width
        partial then merge under the global (score desc, id asc) order.

        Exact, scores and ids: each shard's width slab is sorted by global
        id, so ``Backend.topk``'s positional tie-break is the id tie-break
        there, and among ties a slab keeps exactly its lowest ids; the global
        top-k holds at most k docs of any one slab, so the union of the
        partials (and the head's) always contains it. With ``prefilter`` the
        shape is the same, but each pass gathers only the candidate slots of
        the batch's colliding buckets (:meth:`_slab_candidates`)."""
        store: SegmentedStore = self.store
        placement = self._ensure_placement(mesh, axis)
        t0 = tr.begin() if tr is not None else None
        qs = self._sketch_queries(query_idx)
        if tr is not None:
            tr.end("rebucket", t0)
        hv = store.head_view(now)
        if not placement.slabs:  # nothing sealed: the head is the corpus
            if hv is not None:
                store.head_hits += 1
            return self._views_topk(qs, [hv] if hv is not None else [], k, tr)
        cache: dict = {}
        qkeys_cache: dict = {}
        stats = self._fresh_prefilter_stats() if prefilter else None
        parts_s, parts_i = [], []
        for slab in placement.slabs:
            q_w = self._rebucket_queries(qs, slab.n_bins, cache)
            if tr is not None:
                tr.note_width(slab.n_bins)
            if prefilter:
                t0 = tr.begin() if tr is not None else None
                qkeys = self._query_band_keys(qs, slab.n_bins, qs.shape[0], cache, qkeys_cache)
                slots = self._slab_candidates(slab, qkeys, now, stats, tr)
                if tr is not None:
                    tr.end("band_lookup", t0)
                if slots is not None:
                    if len(slots) == 0:
                        continue
                    self._count_slab_hits(slab.n_bins)
                    sc_all, ids_all = self._prefiltered_slab_topk(q_w, slab, slots, k, tr)
                    parts_s.append(sc_all)
                    parts_i.append(ids_all)
                    continue
            self._count_slab_hits(slab.n_bins)
            valid = slab.valid_mask(store, now=now)
            t0 = tr.begin() if tr is not None else None
            sc_all, ids_all = _shard_partials(q_w, slab.sketches, slab.n_bins, self.measure, k,
                                              mesh, self.backend, slab.fills, slab.ids, valid)
            if tr is not None:
                tr.end("kernel_score", t0)
            parts_s.append(sc_all)
            parts_i.append(ids_all)
        dev0 = mesh.devices[0]
        if hv is not None:  # the replicated head: scored once, counted once
            store.head_hits += 1
            h_sc, h_ids = self._views_topk(qs, [hv], k, tr)
            parts_s.append(h_sc.to(dev0))
            parts_i.append(h_ids.to(dev0))
        if prefilter:
            self.last_prefilter_stats = stats
        if not parts_s:  # the prefilter skipped every slab and the head is empty
            return (torch.full((qs.shape[0], k), -math.inf, device=dev0),
                    torch.full((qs.shape[0], k), -1, dtype=torch.int32, device=dev0))
        # always merge: the slab partials hold k·shards columns each
        t0 = tr.begin() if tr is not None else None
        got = merge_segment_topk(parts_s, parts_i, k)
        if tr is not None:
            tr.end("merge", t0)
        return got

    def _sharded_view_topk(self, mesh: DeviceMesh, axis: str, qs: torch.Tensor,
                           view: SegmentView, k: int, *, width_cache: Optional[dict] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One view cut into ``ceil(C / shards)`` rows a shard, shard ``d``'s
        rows on ``mesh.devices[d]``; the tail shard's missing rows are zero
        pads masked out (the reference pads C to a multiple of the shard
        count), so every doc of a C the shard count does not divide stays
        retrievable. A shard already on the view's device reads a view of its
        rows, with no copy."""
        c = int(view.sketches.shape[0])
        shards = int(mesh.shape[axis])
        n_local = -(-c // shards)
        cand, fills, ids, valid = [], [], [], []
        for d, dev in enumerate(mesh.devices):
            lo, hi = min(d * n_local, c), min((d + 1) * n_local, c)
            sk, fl = view.sketches[lo:hi], view.fills[lo:hi]
            gid = view.ids[lo:hi] if view.ids is not None else None
            vm = view.valid[lo:hi] if view.valid is not None else None
            pad = n_local - (hi - lo)
            if pad:
                sk = torch.nn.functional.pad(sk, (0, 0, 0, pad))
                fl = torch.nn.functional.pad(fl, (0, pad))
                if gid is not None:
                    gid = torch.nn.functional.pad(gid.to(torch.int32), (0, pad), value=-1)
                in_range = (vm.to(torch.int32) if vm is not None
                            else torch.ones(hi - lo, dtype=torch.int32, device=sk.device))
                vm = torch.nn.functional.pad(in_range, (0, pad))
            cand.append(sk.to(dev))
            fills.append(fl.to(dev))
            ids.append(gid.to(dev) if gid is not None else None)
            valid.append(vm.to(dev) if vm is not None else None)
        n_bins = view.n_bins if view.n_bins is not None else self.cfg.n_bins
        q_w = self._rebucket_queries(qs, n_bins, width_cache if width_cache is not None else {})
        return shard_topk(q_w, cand, n_bins, self.measure, k, mesh, backend=self.backend,
                          cand_fills=fills, cand_ids=None if view.ids is None else ids,
                          cand_valid=valid)
