"""SegmentedStore — LSM-style mutable corpus lifecycle (the port of
``repro.engine.segments``).

An append-only ``SketchStore`` cannot delete or update a document: the OR
that built a sketch cannot be undone. This module keeps the corpus in the
log-structured layout of the reference:

  * a **mutable head** backed by the counting BinSketch
    (:mod:`repro_torch.core.counting`): per-doc, per-bin occupancy counters
    over the same Ψ map, stored in 16 bits and clamped at ``COUNTER_MAX`` as
    the reference's u16. The binary sketch
    every estimator and kernel reads is ``counters > 0``, so insert is an
    increment, retraction a decrement and replacement an overwrite, in place;
  * **sealed segments**, packed-only (n, W) slabs plus their fill cache.
    Deleting a sealed doc flips a bit in a host-side tombstone bitmap that
    reaches ``Backend.topk`` as ``corpus_valid``; no data moves;
  * **compaction**, which merges sealed segments (per sketch width),
    dropping tombstoned rows — the only rewrite of sealed bytes, never a
    re-sketch. :meth:`SegmentedStore.compact` is the synchronous pass on the
    device; :meth:`SegmentedStore.compact_async` runs the merge as a
    supervised background job (snapshot to the host, merge off-thread in
    numpy, swap on the caller's thread with tombstone reconciliation);
  * **TTL expiry** over per-doc birth stamps: eagerly by :meth:`expire`,
    lazily at query time when the store has a ``ttl`` and the query a ``now``;
  * **distillation** (:meth:`SegmentedStore.distill_async`): a sealed
    segment re-sketched from width N to a smaller N' by OR-folding bin ``j``
    into ``j mod N'`` over the packed slab alone, as a :class:`DistillPolicy`
    decides, on the same background pattern. Serving becomes mixed-width:
    each view carries its ``n_bins``;
  * the **banded prefilter** (:mod:`.banding`): with a ``band_policy``, every
    sealed segment of at least ``min_rows`` rows gets a :class:`BandIndex`
    over its slab when it is made (seal, ``seal_sketches``, compaction,
    distillation), its keys hashed on the store's device through the
    engine's backend, and the engine's queries scan only colliding buckets;
  * **telemetry** on host bookkeeping: an injected ``clock`` (queries with
    no ``now`` expire TTL by it; it is also the default supervisor's), a
    ``hits`` count per sealed segment and ``head_hits`` for the head (bumped
    by the engine's query paths), and :meth:`SegmentedStore.lifecycle_snapshot`.

Invariants, as in the reference: ``_loc[gid] == (segment, row)`` for exactly
the live docs; a row is retrievable iff ``valid and (ttl is None or now is
None or born + ttl > now)``, the one predicate both the query views and
:meth:`expire` apply; rows inside every segment ascend in global id (the head
re-sorts lazily); global ids are assigned once and never reused, so a mutated
store answers queries exactly as a fresh build over its survivors.

Counters, packed rows, fills and the saturation flags live on the mapping's
device; per-row bookkeeping (ids, tombstones, birth stamps, exactness) is
host numpy. Background jobs run under the store's
:class:`~repro_torch.engine.supervision.JobSupervisor`, so a failed merge or
fold is retried or dropped and never reaches a query; their workers touch
only host copies (``.cpu()`` before the job, ``.to(device)`` at the swap), so
no CUDA work runs off the caller's thread. :meth:`SegmentedStore.save` and
:meth:`SegmentedStore.restore` go through
:class:`~repro_torch.checkpoint.manager.CheckpointManager` on the
reference's on-disk layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults, resolve_device
from ..core import binsketch, counting
from ..core import packed as pk
from ..hopper.build import is_device_fault
from ..obs import metrics as obs_metrics
from .banding import BandIndex, BandPolicy
from .store import SegmentView, _grow, as_index_tensor
from .supervision import JobSupervisor, SupervisedJob

__all__ = ["DistillPolicy", "SealedSegment", "SegmentedStore"]

_HEAD = -1  # segment index of the mutable head in the location map


def _check_rows_match(ids: np.ndarray, idx) -> None:
    """One content row per doc id, or the bookkeeping goes out of step."""
    if idx.shape[0] != len(ids):
        raise ValueError(f"got {idx.shape[0]} content rows for {len(ids)} doc ids")


def _grow_host(arr: np.ndarray, new_capacity: int) -> np.ndarray:
    out = np.zeros((new_capacity,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's own host copy as numpy (never a view of a CPU tensor that
    may change while a worker or a checkpoint writer reads it)."""
    return t.detach().to("cpu", copy=True).numpy()


def _host_words(t: torch.Tensor) -> np.ndarray:
    """Packed int32 words -> a host uint32 copy with the same bits."""
    return _host(t).view(np.uint32)


def _fold_packed_host(sk: np.ndarray, n_bins: int, n_bins_new: int):
    """Numpy twin of ``core.packed.fold_packed`` plus the fill re-gather, for
    distillation (pure host math, no device work contending with serving).
    Returns ``(folded (n, W') uint32, fills (n,) int32)``. Little-endian byte
    order assumed (bin ``j`` at byte ``j // 8``, bit ``j % 8`` of the
    uint32-word row)."""
    raw = np.ascontiguousarray(sk).view(np.uint8)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, :n_bins]
    n_chunks = -(-n_bins // n_bins_new)
    pad = n_chunks * n_bins_new - n_bins
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    folded = bits.reshape(-1, n_chunks, n_bins_new).max(axis=1)
    out = np.packbits(folded, axis=1, bitorder="little")
    w_bytes = pk.num_words(n_bins_new) * 4
    if out.shape[1] < w_bytes:
        out = np.pad(out, ((0, 0), (0, w_bytes - out.shape[1])))
    return (np.ascontiguousarray(out).view(np.uint32),
            folded.sum(axis=1, dtype=np.int32))


@dataclasses.dataclass(frozen=True)
class DistillPolicy:
    """Which sealed segments drop to which smaller sketch width, and when.

    ``widths`` are the tiers (applied descending): an eligible segment at
    width ``w`` is re-sketched to the largest tier strictly below ``w``, one
    tier per pass. A segment qualifies when its youngest live row is at least
    ``min_age`` old, or when it has ``live_floor`` or fewer live rows; with
    both thresholds ``None`` every sealed segment qualifies.
    """

    widths: Tuple[int, ...]
    min_age: Optional[float] = None
    live_floor: Optional[int] = None

    def __post_init__(self):
        if not self.widths or any(int(w) < 1 for w in self.widths):
            raise ValueError(f"widths must be positive ints, got {self.widths}")
        object.__setattr__(self, "widths",
                           tuple(sorted((int(w) for w in self.widths), reverse=True)))

    def target_width(self, n_bins_cur: int, age: float, n_live: int) -> Optional[int]:
        """Next tier for a segment, or None if ineligible or at the bottom."""
        gated = self.min_age is not None or self.live_floor is not None
        if gated and not (
            (self.min_age is not None and age >= self.min_age)
            or (self.live_floor is not None and n_live <= self.live_floor)
        ):
            return None
        for w in self.widths:
            if w < n_bins_cur:
                return w
        return None


def _gather_live(parts):
    """Live rows of segment ``parts`` merge-sorted by global id.

    ``parts``: ``(sketches, fills, ids, valid, born)`` per segment, device
    tensors for the first two, host numpy for the rest. Returns ``(sketches,
    fills, ids, born)``, or None if nothing is live. The one implementation
    behind ``live()``, ``seal()`` and ``compact()``."""
    sk, fl, ids, born = [], [], [], []
    for sketches, fills, ids_np, valid_np, born_np in parts:
        keep = np.nonzero(valid_np)[0]
        if len(keep) == 0:
            continue
        rows = torch.from_numpy(keep).to(sketches.device)
        sk.append(sketches.index_select(0, rows))
        fl.append(fills.index_select(0, rows))
        ids.append(ids_np[keep])
        born.append(born_np[keep])
    if not ids:
        return None
    ids_c = np.concatenate(ids)
    order = np.argsort(ids_c, kind="stable")
    order_dev = torch.from_numpy(order).to(sk[0].device)
    return (torch.cat(sk).index_select(0, order_dev),
            torch.cat(fl).index_select(0, order_dev),
            ids_c[order], np.concatenate(born)[order])


@dataclasses.dataclass
class SealedSegment:
    """Immutable packed slab plus tombstone bitmap; rows ascend in global id.

    ``n_bins`` is None at the store's base width and the smaller width of a
    distilled segment, whose ``sketches`` then have ``num_words(n_bins)``
    words a row."""

    sketches: torch.Tensor  # (n, W) int32
    fills: torch.Tensor  # (n,) int32
    ids: np.ndarray  # (n,) int64 global doc ids, ascending
    valid: np.ndarray  # (n,) bool; False = tombstoned
    born: np.ndarray  # (n,) float64 birth stamps
    n_bins: Optional[int] = None  # sketch width; None = store base width
    # the banded prefilter's index over this slab's rows, built with the
    # segment and immutable with it: tombstones leave it alone (dead
    # candidates are dropped at query time against ``valid``), and every
    # rewrite makes a new segment with a fresh index
    band_index: Optional[BandIndex] = None
    # query passes that scored this segment (one per planner chunk that
    # scanned it; a banded pass with no candidates does not count). A host
    # int, always on and outside the metrics registry, so it survives a
    # registry swap; a rewrite (compaction, distillation) starts at 0
    hits: int = 0

    def __post_init__(self):
        self._ids_dev: Optional[torch.Tensor] = None
        self._valid_dev: Optional[torch.Tensor] = None
        self._ttl_cache: Optional[tuple] = None  # ((now, ttl), device mask)
        # a gap-free segment (row == id) skips the id gather at query time
        self._ids_identity = bool(np.array_equal(self.ids, np.arange(len(self.ids))))
        self._all_valid = bool(self.valid.all())

    @property
    def n_rows(self) -> int:
        return len(self.ids)

    @property
    def n_live(self) -> int:
        return int(self.valid.sum())

    def tombstone(self, row: int) -> None:
        self.valid[row] = False
        self._valid_dev = None  # the device-side masks are stale now
        self._ttl_cache = None
        self._all_valid = False

    def view(self, ttl: Optional[float] = None, now: Optional[float] = None) -> SegmentView:
        """The segment as the query path sees it. Tombstone-free segments pass
        ``valid=None`` and gap-free ones ``ids=None``; with ``ttl`` and
        ``now``, rows with ``born + ttl <= now`` are masked lazily (cached
        for one (now, ttl) at a time)."""
        dev = self.sketches.device
        if self._ids_identity:
            ids_dev = None
        else:
            if self._ids_dev is None:
                self._ids_dev = torch.from_numpy(self.ids.astype(np.int32)).to(dev)
            ids_dev = self._ids_dev
        if ttl is not None and now is not None:
            expired = self.born + ttl <= now
            if expired.any():
                if self._ttl_cache is None or self._ttl_cache[0] != (now, ttl):
                    mask = torch.from_numpy((self.valid & ~expired).astype(np.int32)).to(dev)
                    self._ttl_cache = ((now, ttl), mask)
                return SegmentView(self.sketches, self.fills, ids_dev, self._ttl_cache[1],
                                   self.n_bins)
        if self._all_valid:
            valid_dev = None
        else:
            if self._valid_dev is None:
                self._valid_dev = torch.from_numpy(self.valid.astype(np.int32)).to(dev)
            valid_dev = self._valid_dev
        return SegmentView(self.sketches, self.fills, ids_dev, valid_dev, self.n_bins)


@dataclasses.dataclass
class _Head:
    """Mutable counting segment: 16-bit occupancy counters plus the packed
    rows and fills derived from them. The counters hold the reference's u16
    bits in int16 (``counting.to_stored``) and are widened to int32 on every
    read (``counting.widen``), so they take 2 bytes a bin as in the
    reference.

    ``exact`` marks rows whose counters carry true element multiplicity
    (built from indices); rows re-entered from packed form are occupancy-1
    and refuse retraction. ``sat_dev`` marks rows where a counter passed
    ``COUNTER_MAX`` and was clamped; it stays on the device so that ingest
    never waits for the host, and is read back only where retraction is
    refused.
    """

    counters: torch.Tensor  # (cap, N) int16 holding u16 bits
    packed: torch.Tensor  # (cap, W) int32
    fills: torch.Tensor  # (cap,) int32
    ids: np.ndarray  # (cap,) int64
    valid: np.ndarray  # (cap,) bool
    born: np.ndarray  # (cap,) float64
    exact: np.ndarray  # (cap,) bool
    sat_dev: torch.Tensor  # (cap,) bool: counters clamped, retraction unsafe
    size: int = 0
    is_sorted: bool = True  # ids[:size] ascending?
    # query-view (ids, valid) device pair with its None fast paths; rebuilt
    # on mutation
    _meta_cache: Optional[Tuple] = dataclasses.field(default=None, init=False, repr=False)
    # ((now, ttl), device mask), apart from _meta_cache so a TTL query
    # cannot pollute the TTL-free view
    _ttl_cache: Optional[Tuple] = dataclasses.field(default=None, init=False, repr=False)

    @classmethod
    def create(cls, n_bins: int, n_words: int, capacity: int, device) -> "_Head":
        capacity = max(int(capacity), 1)
        return cls(
            torch.zeros((capacity, n_bins), dtype=counting.COUNTER_DTYPE, device=device),
            torch.zeros((capacity, n_words), dtype=torch.int32, device=device),
            torch.zeros((capacity,), dtype=torch.int32, device=device),
            np.zeros((capacity,), np.int64),
            np.zeros((capacity,), bool),
            np.zeros((capacity,), np.float64),
            np.zeros((capacity,), bool),
            torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @property
    def saturated(self) -> np.ndarray:
        """(cap,) host copy of the clamp flags: one sync, for consumers only."""
        return self.sat_dev.cpu().numpy()

    @property
    def capacity(self) -> int:
        return int(self.counters.shape[0])

    def ensure_capacity(self, n: int) -> None:
        cap = self.capacity
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        for name in ("counters", "packed", "fills", "sat_dev"):
            t = getattr(self, name)
            setattr(self, name, _grow(t, cap, t.shape[0]))
        for name in ("ids", "valid", "born", "exact"):
            setattr(self, name, _grow_host(getattr(self, name), cap))

    def _write_rows(self, rows, counts: torch.Tensor) -> torch.Tensor:
        """Overwrite counter ``rows`` (a slice or unique positions) and refresh
        their packed rows and fills. Returns the per-row device flag of
        whether the clamp lost information."""
        limit = counting.COUNTER_MAX
        sat = (counts > limit).any(dim=-1)
        clamped = counts.clamp(0, limit)
        self.counters[rows] = counting.to_stored(clamped)
        self.packed[rows] = counting.counters_to_packed(clamped)
        self.fills[rows] = counting.counter_fills(clamped)
        return sat

    def append(self, counts: torch.Tensor, ids: np.ndarray, born, exact: bool) -> range:
        """``born``: a scalar (fresh inserts) or a (B,) array (relocated rows
        keeping their birth stamps)."""
        b = int(counts.shape[0])
        if b == 0:
            return range(self.size, self.size)
        self.ensure_capacity(self.size + b)
        lo = self.size
        rows = slice(lo, lo + b)
        self.sat_dev[rows] = self._write_rows(rows, counts.to(torch.int32))
        self.ids[rows] = ids
        self.valid[rows] = True
        self.born[rows] = born
        self.exact[rows] = exact
        if self.is_sorted:
            # appends only extend the tail: O(b), not a rescan of the prefix
            ok = bool(np.all(np.diff(ids) > 0)) if b > 1 else True
            if lo > 0:
                ok = ok and self.ids[lo - 1] < ids[0]
            self.is_sorted = ok
        self.size += b
        self._meta_cache = None
        self._ttl_cache = None
        return range(lo, lo + b)

    def _rows_dev(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int64)).to(self.counters.device)

    def add_counts(self, rows: np.ndarray, deltas: torch.Tensor) -> None:
        """Saturating ``counters[rows] += deltas`` (unique rows). Saturation
        is sticky: only an overwrite clears the flag."""
        r = self._rows_dev(rows)
        sat = self._write_rows(r, counting.widen(self.counters[r]) + deltas)
        self.sat_dev[r] = self.sat_dev[r] | sat

    def set_counts(self, rows: np.ndarray, counts: torch.Tensor) -> None:
        r = self._rows_dev(rows)
        self.sat_dev[r] = self._write_rows(r, counts.to(torch.int32))

    def zero_rows(self, rows: np.ndarray) -> None:
        r = self._rows_dev(rows)
        zeros = torch.zeros((len(rows), self.counters.shape[1]), dtype=torch.int32,
                            device=self.counters.device)
        self.sat_dev[r] = self._write_rows(r, zeros)
        self.valid[rows] = False
        self._meta_cache = None
        self._ttl_cache = None

    def meta_dev(self) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(ids, valid) of the head's query view, cached until a mutation:
        ``None`` ids when row == id, ``None`` valid when nothing is
        tombstoned."""
        if self._meta_cache is None:
            dev = self.counters.device
            ids = self.ids[: self.size]
            ids_dev = (None if np.array_equal(ids, np.arange(self.size))
                       else torch.from_numpy(ids.astype(np.int32)).to(dev))
            valid = self.valid[: self.size]
            valid_dev = (None if valid.all()
                         else torch.from_numpy(valid.astype(np.int32)).to(dev))
            self._meta_cache = (ids_dev, valid_dev)
        return self._meta_cache


@dataclasses.dataclass
class _CompactionJob:
    """A pending background job: the supervised worker plus the sealed
    segments it snapshot, which its swap replaces."""

    job: SupervisedJob
    segments: List[SealedSegment]
    backend: object = None  # hashes the band keys the swap still needs


@dataclasses.dataclass
class SegmentedStore:
    """Mutable, segmented counterpart of :class:`SketchStore`.

    The same ``add`` / ``add_sketches`` / ``merge`` / ``merge_rows`` surface,
    plus ``delete`` / ``update`` / ``retract_rows`` / ``seal`` / ``compact``
    / ``expire``, the background ``compact_async`` / ``distill_async`` with
    ``poll_compaction`` / ``wait_compaction`` / ``abandon_compaction``, and
    ``save`` / ``restore``. Doc ids are global, assigned at insert, and never
    reused.
    """

    cfg: binsketch.BinSketchConfig
    mapping: torch.Tensor
    sealed: List[SealedSegment]
    head: _Head
    next_id: int = 0
    seal_rows: Optional[int] = None  # auto-seal the head at this many rows
    ttl: Optional[float] = None  # lazy query-time expiry horizon (units of `now`)
    # arms the banded prefilter: sealed segments >= min_rows get a BandIndex
    # (the head stays unbanded and is always scored)
    band_policy: Optional[BandPolicy] = None
    # the injected clock (None: callers pass ``now``): queries with no
    # explicit ``now`` resolve lazy TTL against it, and ages read it
    clock: Optional[Callable[[], float]] = None
    # query passes that scored the head (the head's SealedSegment.hits; the
    # head survives seals, so this counts over the store's whole life)
    head_hits: int = 0
    _loc: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    _n_live: int = 0
    # bumps whenever the set of sealed segments changes (seal, compaction,
    # a background swap): segment indexes shift then, so per-index state
    # (the lifecycle controller's hits baseline) is valid within one epoch
    _layout_epoch: int = 0
    _compaction: Optional[_CompactionJob] = dataclasses.field(default=None, repr=False)
    # every background job goes through it: failures are retried or
    # quarantined here and never raised into a query
    supervisor: JobSupervisor = dataclasses.field(default_factory=JobSupervisor, repr=False)

    # ------------------------------------------------------------ construct
    @classmethod
    def create(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
               capacity: int = 1024, seal_rows: Optional[int] = None,
               ttl: Optional[float] = None, band_policy: Optional[BandPolicy] = None,
               supervisor: Optional[JobSupervisor] = None,
               clock: Optional[Callable[[], float]] = None) -> "SegmentedStore":
        head = _Head.create(cfg.n_bins, cfg.n_words, capacity, mapping.device)
        # the store's clock is also its default supervisor's: one injected
        # ManualClock drives TTL, ages, backoff and probation together
        return cls(cfg, mapping, [], head, seal_rows=seal_rows, ttl=ttl,
                   band_policy=band_policy, clock=clock,
                   supervisor=supervisor or JobSupervisor(clock=clock))

    @classmethod
    def from_indices(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
                     corpus_idx, *, backend=None, batch: int = 4096, now: float = 0.0,
                     seal_rows: Optional[int] = None, ttl: Optional[float] = None,
                     band_policy: Optional[BandPolicy] = None,
                     supervisor: Optional[JobSupervisor] = None,
                     clock: Optional[Callable[[], float]] = None) -> "SegmentedStore":
        store = cls.create(cfg, mapping, capacity=max(int(corpus_idx.shape[0]), 1),
                           seal_rows=seal_rows, ttl=ttl, band_policy=band_policy,
                           supervisor=supervisor, clock=clock)
        store.add(corpus_idx, backend=backend, batch=batch, now=now)
        return store

    # ------------------------------------------------------------ properties
    @property
    def device(self) -> torch.device:
        return self.mapping.device

    @property
    def size(self) -> int:
        """Number of live (retrievable) documents."""
        return self._n_live

    def resolve_now(self, now: Optional[float] = None) -> Optional[float]:
        """Explicit ``now`` wins; else the injected clock; else None (no TTL
        masking, ages unreported)."""
        if now is not None:
            return float(now)
        return float(self.clock()) if self.clock is not None else None

    @property
    def sketches(self) -> torch.Tensor:
        """(size, W) packed rows of every live doc, ascending id. Gathers a
        copy: an analysis surface; serving iterates :meth:`segment_views`."""
        return self.live()[0]

    @property
    def fills(self) -> torch.Tensor:
        return self.live()[1]

    @property
    def live_ids(self) -> np.ndarray:
        return self.live()[2]

    def _parts(self, *, sealed: bool = True, head: bool = True):
        parts = [(seg.sketches, seg.fills, seg.ids, seg.valid, seg.born)
                 for seg in (self.sealed if sealed else ())]
        if head:
            h = self.head
            parts.append((h.packed[: h.size], h.fills[: h.size], h.ids[: h.size],
                          h.valid[: h.size], h.born[: h.size]))
        return parts

    def _assert_base_width(self, what: str) -> None:
        off = [i for i, s in enumerate(self.sealed) if s.n_bins is not None and s.n_live > 0]
        if off:
            raise ValueError(
                f"{what} needs every row at the base width N={self.cfg.n_bins}, but "
                f"sealed segment(s) {off} are distilled to a smaller N' (the fold is "
                "lossy; rows cannot be widened back). Use the engine's mixed-width "
                "query path, or update()/delete() the docs instead.")

    def live(self) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """(sketches (L, W), fills (L,), ids (L,) int64) of the live docs in id
        order. Base width only: a store holding distilled segments has no
        common row width, so this raises."""
        self._assert_base_width("live()")
        got = _gather_live(self._parts())
        if got is None:
            return (torch.zeros((0, self.cfg.n_words), dtype=torch.int32, device=self.device),
                    torch.zeros((0,), dtype=torch.int32, device=self.device),
                    np.zeros((0,), np.int64))
        return got[0], got[1], got[2]

    def segment_views(self, now: Optional[float] = None) -> List[SegmentView]:
        """Sealed slabs, then the id-sorted head: the engine's query list. With
        a store ``ttl`` and a query ``now``, every view also masks rows with
        ``born + ttl <= now``."""
        views = [seg.view(self.ttl, now) for seg in self.sealed if seg.n_rows > 0]
        hv = self.head_view(now)
        if hv is not None:
            views.append(hv)
        return views

    def head_view(self, now: Optional[float] = None) -> Optional[SegmentView]:
        """The mutable head as one scoreable view (None while empty)."""
        h = self.head
        if h.size == 0:
            return None
        self._sort_head()
        ids_dev, valid_dev = h.meta_dev()
        if self.ttl is not None and now is not None:
            expired = h.born[: h.size] + self.ttl <= now
            if expired.any():
                if h._ttl_cache is None or h._ttl_cache[0] != (now, self.ttl):
                    mask = torch.from_numpy((h.valid[: h.size] & ~expired).astype(np.int32))
                    h._ttl_cache = ((now, self.ttl), mask.to(self.device))
                valid_dev = h._ttl_cache[1]
        return SegmentView(h.packed[: h.size], h.fills[: h.size], ids_dev, valid_dev)

    # ------------------------------------------------------------- telemetry
    def lifecycle_snapshot(self, now: Optional[float] = None) -> dict:
        """JSON-safe lifecycle gauges: per segment live/tombstone/width/age/
        hits/banded, the width mix (live rows per sketch width), the head and
        the store-wide tombstone density. Host bookkeeping only: nothing is
        read off the device."""
        now = self.resolve_now(now)
        base = int(self.cfg.n_bins)
        segs: List[dict] = []
        rows_total = live_total = 0
        width_mix: Dict[str, int] = {}
        for i, s in enumerate(self.sealed):
            w = int(s.n_bins) if s.n_bins is not None else base
            live = s.n_live
            ent = {"segment": i, "rows": int(s.n_rows), "live": int(live),
                   "tombstones": int(s.n_rows - live), "width": w, "hits": int(s.hits),
                   "banded": s.band_index is not None}
            if now is not None and s.n_rows:
                ent["age_min"] = float(now - s.born.max())
                ent["age_max"] = float(now - s.born.min())
            segs.append(ent)
            rows_total += s.n_rows
            live_total += live
            width_mix[str(w)] = width_mix.get(str(w), 0) + int(live)
        h = self.head
        head_live = int(h.valid[: h.size].sum())
        if h.size:
            width_mix[str(base)] = width_mix.get(str(base), 0) + head_live
        rows_total += h.size
        live_total += head_live
        return {
            "segments": segs,
            "head": {"rows": int(h.size), "live": head_live, "capacity": int(h.capacity),
                     "hits": int(self.head_hits)},
            "live_docs": int(self.size),
            "next_id": int(self.next_id),
            "tombstone_density": float(rows_total - live_total) / float(max(rows_total, 1)),
            "width_mix": width_mix,
            "compaction_running": self._compaction is not None,
        }

    # ---------------------------------------------------------------- ingest
    def _count_rows(self, idx, backend) -> torch.Tensor:
        # documents are sets: collapse duplicates before the occupancy count,
        # or an insert -> retract round trip would leave phantom counts
        idx = counting.dedup_padded(as_index_tensor(idx, self.device))
        if backend is not None:
            return backend.count(self.cfg, self.mapping, idx)
        return counting.count_indices_dense(self.cfg, self.mapping, idx)

    def _insert_counts(self, counts: torch.Tensor, *, ids: Optional[np.ndarray] = None,
                       now, exact: bool, backend=None) -> range:
        b = int(counts.shape[0])
        if b == 0:
            return range(self.next_id, self.next_id)
        if ids is None:
            ids = np.arange(self.next_id, self.next_id + b, dtype=np.int64)
            self.next_id += b
        rows = self.head.append(counts, ids, now, exact)
        self._loc.update(zip(ids.tolist(), ((_HEAD, row) for row in rows)))
        self._n_live += b
        if self.seal_rows is not None and self.head.size >= self.seal_rows:
            self.seal(backend=backend)
        return rows

    def add(self, idx, *, backend=None, batch: int = 4096, now: float = 0.0) -> range:
        """Count-sketch (B, P) padded sparse rows into the head; returns the
        fresh, contiguous global ids."""
        lo = self.next_id
        for s in range(0, idx.shape[0], batch):
            self._insert_counts(self._count_rows(idx[s : s + batch], backend),
                                now=now, exact=True, backend=backend)
        return range(lo, self.next_id)

    def add_sketches(self, sketches: torch.Tensor, *, now: float = 0.0) -> range:
        """Append pre-packed int32 rows (occupancy-1 counters: the binary
        sketch is exact, retraction is refused on these rows)."""
        lo = self.next_id
        counts = counting.packed_to_counters(sketches.to(self.device), self.cfg.n_bins)
        self._insert_counts(counts, now=now, exact=False)
        return range(lo, self.next_id)

    # ------------------------------------------------------------- mutation
    def _locate(self, gid: int) -> Tuple[int, int]:
        try:
            return self._loc[int(gid)]
        except KeyError:
            raise KeyError(f"doc id {int(gid)} is not live in this store") from None

    def _gather_packed(self, doc_ids: np.ndarray) -> torch.Tensor:
        """(B, W) current packed rows of live docs, in ``doc_ids`` order: one
        gather per segment touched."""
        if len(doc_ids) == 0:
            return torch.zeros((0, self.cfg.n_words), dtype=torch.int32, device=self.device)
        by_seg: Dict[int, Tuple[list, list]] = {}
        for i, gid in enumerate(doc_ids):
            seg_i, row = self._locate(gid)
            if seg_i != _HEAD and self.sealed[seg_i].n_bins is not None:
                raise ValueError(
                    f"doc {int(gid)} lives in a distilled segment (width "
                    f"{self.sealed[seg_i].n_bins} < base {self.cfg.n_bins}); its "
                    "base-width bits are gone, so merge_rows/merge cannot grow it — "
                    "use update() for a full replacement")
            by_seg.setdefault(seg_i, ([], []))[0].append(i)
            by_seg[seg_i][1].append(row)
        parts, order = [], []
        for seg_i, (positions, rows) in by_seg.items():
            src = self.head.packed if seg_i == _HEAD else self.sealed[seg_i].sketches
            parts.append(src.index_select(0, torch.tensor(rows, device=self.device)))
            order.extend(positions)
        inv = np.empty(len(doc_ids), np.int64)
        inv[np.asarray(order)] = np.arange(len(doc_ids))
        return torch.cat(parts).index_select(0, torch.from_numpy(inv).to(self.device))

    def delete(self, doc_ids: Sequence[int]) -> int:
        """Tombstone documents: head rows are zeroed, sealed rows flip their
        bitmap bit. Unknown or already deleted ids raise ``KeyError`` before
        anything changes. Returns the number deleted."""
        uniq = list(dict.fromkeys(int(g) for g in np.asarray(doc_ids, np.int64)))
        locs = [self._locate(g) for g in uniq]
        head_rows = []
        for gid, (seg_i, row) in zip(uniq, locs):
            del self._loc[gid]
            if seg_i == _HEAD:
                head_rows.append(row)
            else:
                self.sealed[seg_i].tombstone(row)
        if head_rows:
            self.head.zero_rows(np.asarray(head_rows, np.int64))
        self._n_live -= len(uniq)
        return len(uniq)

    def _relocate(self, ids: np.ndarray, locs, sel: np.ndarray) -> None:
        """Tombstone the sealed rows of ``ids[sel]`` and drop them from the
        location map: the first half of moving a sealed doc into the head."""
        for i in sel:
            seg_i, row = locs[i]
            self.sealed[seg_i].tombstone(row)
            del self._loc[int(ids[i])]
        self._n_live -= len(sel)

    def update(self, doc_ids: Sequence[int], idx, *, backend=None, now: float = 0.0) -> None:
        """Replace document contents, keeping their ids. Head docs are
        overwritten in place (exact counters again); sealed docs relocate:
        the sealed row is tombstoned and the new content enters the head
        under the old id."""
        ids = np.asarray(doc_ids, np.int64)
        if len(np.unique(ids)) != len(ids):
            raise ValueError("duplicate doc ids in one update batch are ambiguous")
        _check_rows_match(ids, idx)
        counts = self._count_rows(idx, backend)
        locs = [self._locate(g) for g in ids]
        in_head = np.array([s == _HEAD for s, _ in locs], bool)
        if in_head.any():
            sel = np.nonzero(in_head)[0]
            rows = np.asarray([locs[i][1] for i in sel], np.int64)
            self.head.set_counts(rows, counts[torch.from_numpy(sel).to(self.device)])
            self.head.born[rows] = now
            self.head.exact[rows] = True
            self.head._ttl_cache = None  # born moved: the lazy-expiry mask is stale
        if (~in_head).any():
            sel = np.nonzero(~in_head)[0]
            self._relocate(ids, locs, sel)
            self._insert_counts(counts[torch.from_numpy(sel).to(self.device)],
                                ids=ids[sel], now=now, exact=True, backend=backend)

    def _combine_duplicates(self, ids: np.ndarray, deltas: torch.Tensor):
        """Sum the deltas of repeated ids in one batch: ``(unique ids, deltas)``."""
        uniq, inv = np.unique(ids, return_inverse=True)
        if len(uniq) == len(ids):
            return ids, deltas
        out = torch.zeros((len(uniq), deltas.shape[1]), dtype=deltas.dtype,
                          device=deltas.device)
        return uniq, out.index_add_(0, torch.from_numpy(inv).to(deltas.device), deltas)

    def merge_rows(self, doc_ids: Sequence[int], idx, *, backend=None) -> None:
        """OR new content into existing docs. Head docs take a counter
        increment in place; sealed docs relocate into the head carrying their
        old bits as occupancy-1 counters plus the new counts, and keep their
        birth stamps (a merge grows a doc, it does not re-create it). A merged
        row loses its exact mark: the new content may overlap the old, so a
        shared element would be double-counted."""
        ids = np.asarray(doc_ids, np.int64)
        _check_rows_match(ids, idx)
        ids, deltas = self._combine_duplicates(ids, self._count_rows(idx, backend))
        locs = [self._locate(g) for g in ids]
        in_head = np.array([s == _HEAD for s, _ in locs], bool)
        if in_head.any():
            sel = np.nonzero(in_head)[0]
            rows = np.asarray([locs[i][1] for i in sel], np.int64)
            self.head.add_counts(rows, deltas[torch.from_numpy(sel).to(self.device)])
            self.head.exact[rows] = False
        if (~in_head).any():
            sel = np.nonzero(~in_head)[0]
            old = self._gather_packed(ids[sel])
            merged = (counting.packed_to_counters(old, self.cfg.n_bins)
                      + deltas[torch.from_numpy(sel).to(self.device)])
            born = np.array([self.sealed[locs[i][0]].born[locs[i][1]] for i in sel])
            self._relocate(ids, locs, sel)
            self._insert_counts(merged, ids=ids[sel], now=born, exact=False, backend=backend)

    def retract_rows(self, doc_ids: Sequence[int], idx, *, backend=None) -> None:
        """Decrement elements out of head docs: a bin clears exactly when its
        last mapped element goes. Only exact, unsaturated head rows allow it;
        ``update`` covers the rest."""
        ids = np.asarray(doc_ids, np.int64)
        _check_rows_match(ids, idx)
        ids, deltas = self._combine_duplicates(ids, self._count_rows(idx, backend))
        sat = self.head.saturated  # one device sync, on this rare path only
        rows = []
        for gid in ids:
            seg_i, row = self._locate(gid)
            if seg_i != _HEAD or not self.head.exact[row]:
                raise ValueError(
                    f"doc {int(gid)} is not an exact head row; retraction needs "
                    "element multiplicity (use update() for full replacement)")
            if sat[row]:
                raise ValueError(
                    f"doc {int(gid)} has saturated counters (a bin occupancy exceeded "
                    f"COUNTER_MAX={counting.COUNTER_MAX} and was clamped); a decrement "
                    "would silently under-count — use update() for full replacement")
            rows.append(row)
        self.head.add_counts(np.asarray(rows, np.int64), -deltas)

    def merge(self, other: "SegmentedStore", *, now: float = 0.0) -> "SegmentedStore":
        """OR-merge by global doc id: shared ids OR together (relocating into
        the head), ids only in ``other`` enter under their own ids."""
        sk_o, _, ids_o = other.live()
        if len(ids_o) == 0:
            return self
        counts_o = counting.packed_to_counters(sk_o.to(self.device), self.cfg.n_bins)
        known = np.array([int(g) in self._loc for g in ids_o], bool)
        if known.any():
            sel = np.nonzero(known)[0]
            ours = self._gather_packed(ids_o[sel])
            merged = (counting.packed_to_counters(ours, self.cfg.n_bins)
                      + counts_o[torch.from_numpy(sel).to(self.device)])
            self.delete(ids_o[sel])
            self._insert_counts(merged, ids=ids_o[sel], now=now, exact=False)
        if (~known).any():
            sel = np.nonzero(~known)[0]
            self._insert_counts(counts_o[torch.from_numpy(sel).to(self.device)],
                                ids=ids_o[sel], now=now, exact=False)
        self.next_id = max(self.next_id, int(ids_o.max()) + 1)
        return self

    # -------------------------------------------------------------- lifecycle
    def _sort_head(self) -> None:
        """Restore ascending ids in the head after a relocation (lazy: queries
        and seals sort; plain appends never need it)."""
        h = self.head
        if h.is_sorted or h.size <= 1:
            return
        perm = np.argsort(h.ids[: h.size], kind="stable")
        p = torch.from_numpy(perm).to(self.device)
        for name in ("counters", "packed", "fills", "sat_dev"):
            t = getattr(h, name)
            t[: h.size] = t[: h.size].index_select(0, p)
        for name in ("ids", "valid", "born", "exact"):
            arr = getattr(h, name)
            arr[: h.size] = arr[: h.size][perm]
        h.is_sorted = True
        h._meta_cache = None
        h._ttl_cache = None
        rows = np.nonzero(h.valid[: h.size])[0]
        self._loc.update(zip(h.ids[rows].tolist(), ((_HEAD, int(r)) for r in rows)))

    def _index_segment(self, seg_i: int) -> None:
        seg = self.sealed[seg_i]
        rows = np.nonzero(seg.valid)[0]
        self._loc.update(zip(seg.ids[rows].tolist(), ((seg_i, int(r)) for r in rows)))

    def _band_keys(self, sketches: torch.Tensor, backend=None) -> np.ndarray:
        """(rows, nb_eff) host band keys of a slab on the store's device, as
        int32 holding the uint32 bits: ``backend.band_hash`` when a backend is
        given (the engine passes its own, so on the ``cuda`` backend the
        kernel hashes), else the plain ``pk.band_hash``, as the reference's
        oracle; bit-identical either way."""
        hash_fn = backend.band_hash if backend is not None else pk.band_hash
        return hash_fn(sketches, self.band_policy.n_bands).cpu().numpy()

    def _band_index_for(self, sketches: torch.Tensor, n_rows: int,
                        backend=None) -> Optional[BandIndex]:
        """A :class:`BandIndex` over a freshly made slab when the band policy
        wants one, else None; the keys from :meth:`_band_keys`.

        The index is an accelerator, not a dependency: a failed bucket build
        (host numpy) leaves the segment unindexed (it serves through the
        exhaustive scan) and is recorded as the ``band_index`` degraded mode,
        as in the reference. The hash is not inside that catch: a kernel that
        refuses its input, fails to build or launch, or an error of the card
        propagates."""
        bp = self.band_policy
        if bp is None or not bp.wants_index(n_rows):
            return None
        keys = self._band_keys(sketches, backend)
        try:
            return BandIndex.build(keys)
        except Exception as e:
            self.supervisor.record_degraded("band_index", f"build failed: {e}")
            return None

    def seal(self, *, backend=None) -> Optional[SealedSegment]:
        """Freeze the head into a sealed segment (its tombstoned rows are
        dropped here) and start a fresh head of the same capacity. Counters
        are discarded: sealed rows live packed-only from now on. With a band
        policy the new segment's index is built here, over exactly its rows."""
        h = self.head
        if h.size == 0:
            return None
        got = _gather_live(self._parts(sealed=False))
        seg = None
        if got is not None:
            sk, fl, ids, born = got
            seg = SealedSegment(sk, fl, ids, np.ones(len(ids), bool), born,
                                band_index=self._band_index_for(sk, len(ids), backend))
            self.sealed.append(seg)
            self._index_segment(len(self.sealed) - 1)
            obs_metrics.inc("lifecycle.seal.runs")
            obs_metrics.inc("lifecycle.seal.rows", seg.n_rows)
        self.head = _Head.create(self.cfg.n_bins, self.cfg.n_words, h.capacity, self.device)
        self._layout_epoch += 1
        return seg

    def seal_sketches(self, sketches: torch.Tensor, *, now: float = 0.0,
                      backend=None) -> range:
        """Bulk-ingest pre-packed int32 rows straight into a sealed segment,
        bypassing the counting head (whose counters cost ``2*N`` bytes a
        doc); returns the fresh ids, assigned in row order. The band index,
        policy permitting, is built here as at a seal."""
        b = int(sketches.shape[0])
        if b == 0:
            return range(self.next_id, self.next_id)
        if sketches.dtype != torch.int32:
            raise TypeError(f"packed sketches must be int32 words, got {sketches.dtype}")
        if sketches.shape[1] != self.cfg.n_words:
            raise ValueError(f"expected (B, {self.cfg.n_words}) packed rows at the base "
                             f"width, got {tuple(sketches.shape)}")
        sketches = sketches.to(self.device).contiguous()
        ids = np.arange(self.next_id, self.next_id + b, dtype=np.int64)
        self.next_id += b
        self.sealed.append(SealedSegment(
            sketches, pk.row_popcount(sketches), ids, np.ones(b, bool), np.full(b, float(now)),
            band_index=self._band_index_for(sketches, b, backend)))
        self._index_segment(len(self.sealed) - 1)
        self._n_live += b
        self._layout_epoch += 1
        obs_metrics.inc("lifecycle.seal.runs")
        obs_metrics.inc("lifecycle.seal.rows", b)
        return range(int(ids[0]), int(ids[-1]) + 1)

    def _widths_present(self) -> List[Optional[int]]:
        """Distinct sealed widths, base (None) first, then descending."""
        seen = {s.n_bins for s in self.sealed}
        narrow = sorted((x for x in seen if x is not None), reverse=True)
        return [w for w in (None, *narrow) if w in seen]

    def compact(self, *, backend=None) -> Dict[str, int]:
        """Merge sealed segments per sketch width, dropping tombstoned rows;
        rows come out sorted by global id, one segment per width, each with a
        fresh band index, hashed through ``backend``, when the policy wants
        one. The head is untouched (seal first for a full compaction).
        Synchronous, on the device; :meth:`compact_async` is the background
        variant."""
        self.wait_compaction()  # never two compactions over the same slabs
        stats = {"segments_in": len(self.sealed),
                 "rows_in": sum(s.n_rows for s in self.sealed), "rows_out": 0, "groups": 0}
        if not self.sealed:
            return stats
        new_sealed: List[SealedSegment] = []
        for width in self._widths_present():
            stats["groups"] += 1
            got = _gather_live([(s.sketches, s.fills, s.ids, s.valid, s.born)
                                for s in self.sealed if s.n_bins == width])
            if got is None:
                continue
            sk, fl, ids, born = got
            new_sealed.append(SealedSegment(sk, fl, ids, np.ones(len(ids), bool), born,
                                            n_bins=width,
                                            band_index=self._band_index_for(sk, len(ids),
                                                                            backend)))
        self._layout_epoch += 1
        self.sealed = new_sealed
        for seg_i in range(len(self.sealed)):
            self._index_segment(seg_i)
            stats["rows_out"] += self.sealed[seg_i].n_rows
        obs_metrics.inc("lifecycle.compact.runs")
        obs_metrics.inc("lifecycle.compact.rows_in", stats["rows_in"])
        obs_metrics.inc("lifecycle.compact.rows_out", stats["rows_out"])
        return stats

    # ------------------------------------------------ background maintenance
    def compact_async(self, groups: Optional[Sequence[Sequence[int]]] = None, *,
                      backend=None, _hold=None) -> bool:
        """Start a compaction on a supervised worker thread; serving goes on.

          1. **snapshot to the host**: the grouped segments' words, fills and
             row metadata are copied to host memory on the caller's thread
             (the only part it waits for); when the band policy wants an
             index over the merged rows, each segment's band keys are hashed
             there on the device through ``backend`` (:meth:`_band_keys`: on
             the ``cuda`` backend the kernel) and copied with them;
          2. **merge off-thread**: live rows of each group merge-sort by
             global id in numpy against the snapshot, and the keys, permuted
             the same way, are bucketed into the band index there; the worker
             touches no live state and no device;
          3. **swap on the caller's thread**: :meth:`poll_compaction` (the
             query path calls it) or :meth:`wait_compaction` uploads the
             result, reconciles tombstones that landed during the merge
             (:meth:`_swap_compaction`) and replaces the group's segments.

        ``groups`` partitions sealed-segment indexes into merge groups
        (default: one global group); groups split by sketch width, and a
        group of one tombstone-free segment is skipped. Returns False when
        there is nothing to do or the pair is quarantined. ``_hold`` (a test
        seam) is an event the worker waits on before returning, pinning the
        job in the running state."""
        self.wait_compaction()
        if groups is None:
            groups = [list(range(len(self.sealed)))]
        groups = [[int(i) for i in g] for g in groups]
        seen: set = set()
        for g in groups:
            for i in g:
                if not 0 <= i < len(self.sealed) or i in seen:
                    raise ValueError(f"compaction group index {i} is out of range or "
                                     "duplicated; groups must partition the current "
                                     "sealed segments")
                seen.add(i)
        by_width: List[List[int]] = []
        for g in groups:
            tiers: Dict[Optional[int], List[int]] = {}
            for i in g:
                tiers.setdefault(self.sealed[i].n_bins, []).append(i)
            by_width.extend(tiers.values())
        groups = [g for g in by_width
                  if g and not (len(g) == 1 and self.sealed[g[0]]._all_valid)]
        if not groups:
            return False
        snap = []
        for group in groups:
            segs = [self.sealed[i] for i in group]
            indexed = (self.band_policy is not None
                       and self.band_policy.wants_index(sum(s.n_live for s in segs)))
            parts = [(_host_words(s.sketches), s.fills.cpu().numpy().copy(), s.ids.copy(),
                      s.valid.copy(), s.born.copy(),
                      self._band_keys(s.sketches, backend) if indexed else None)
                     for s in segs]
            snap.append((group, parts, segs[0].n_bins, indexed))
        sup = self.supervisor

        def work():
            faults.inject("compact.work")
            out = []
            for group, parts, width, indexed in snap:
                sk, fl, ids, born, keys, src_seg, src_row = [], [], [], [], [], [], []
                for seg_i, (s_sk, s_fl, s_ids, s_valid, s_born, s_keys) in zip(group, parts):
                    keep = np.nonzero(s_valid)[0]
                    sk.append(s_sk[keep])
                    fl.append(s_fl[keep])
                    ids.append(s_ids[keep])
                    born.append(s_born[keep])
                    if indexed:
                        keys.append(s_keys[keep])
                    src_seg.append(np.full(len(keep), seg_i, np.int64))
                    src_row.append(keep.astype(np.int64))
                ids_c = np.concatenate(ids)
                order = np.argsort(ids_c, kind="stable")
                # a failed index build must not fail the merge: the segment
                # comes out unindexed and the degradation is recorded
                band_index = None
                if indexed:
                    try:
                        band_index = BandIndex.build(np.concatenate(keys, axis=0)[order])
                    except Exception as e:
                        sup.record_degraded("band_index",
                                            f"build failed during compaction: {e}")
                out.append({
                    "group": group, "n_bins": width, "rows_in": sum(len(p[2]) for p in parts),
                    "sketches": np.concatenate(sk, axis=0)[order],
                    "fills": np.concatenate(fl)[order],
                    "ids": ids_c[order], "born": np.concatenate(born)[order],
                    "src_seg": np.concatenate(src_seg)[order],
                    "src_row": np.concatenate(src_row)[order], "band_index": band_index,
                    "index_at_swap": False,
                })
            if _hold is not None:
                _hold.wait()
            return out

        key = tuple(sorted(i for g in groups for i in g))
        job = sup.submit("compact", key, work)
        if job is None:  # quarantined: keep serving the current segments
            return False
        self._compaction = _CompactionJob(job, [self.sealed[i] for g in groups for i in g],
                                          backend)
        return True

    def distill_async(self, policy: DistillPolicy, *, now: float = 0.0,
                      only: Optional[Sequence[int]] = None, backend=None,
                      _hold=None) -> bool:
        """Re-sketch each policy-eligible sealed segment to its next smaller
        width tier on a supervised worker thread, and swap it in.

        The pattern of :meth:`compact_async`, with a fold for the merge: the
        words are snapshot to the host here; the worker drops dead rows,
        OR-folds N -> N' (:func:`_fold_packed_host`) and re-counts fills, in
        host numpy; the swap uploads and reconciles on the caller's thread.
        The folded words exist only after the worker, so their band index
        (the base-width buckets never serve the narrower rows) is built in
        the swap: hashed on the device through ``backend``, bucketed on the
        host (:meth:`_band_index_for`). Each segment folds on its own.
        ``only`` restricts eligibility to those sealed indexes. Returns False
        when no segment is eligible or the pair is quarantined."""
        self.wait_compaction()  # one background job over the slabs at a time
        base = self.cfg.n_bins
        allow = None if only is None else {int(i) for i in only}
        plan: List[Tuple[int, int]] = []
        for i, seg in enumerate(self.sealed):
            if seg.n_live == 0 or (allow is not None and i not in allow):
                continue
            cur = seg.n_bins if seg.n_bins is not None else base
            age = float(now) - float(seg.born[seg.valid].max())
            tgt = policy.target_width(cur, age, seg.n_live)
            if tgt is not None and tgt < cur:
                plan.append((i, tgt))
        if not plan:
            return False
        snap = []
        for i, tgt in plan:
            seg = self.sealed[i]
            cur = seg.n_bins if seg.n_bins is not None else base
            snap.append((i, cur, tgt, _host_words(seg.sketches), seg.ids.copy(),
                         seg.valid.copy(), seg.born.copy()))

        def work():
            faults.inject("distill.work")
            out = []
            for i, cur, tgt, sk, ids, valid, born in snap:
                keep = np.nonzero(valid)[0]  # ascending rows: ids stay in order
                folded, fills = _fold_packed_host(sk[keep], cur, tgt)
                if faults.fire("distill.corrupt"):
                    # silent corruption: the fold "succeeds" with garbage,
                    # which only a recall probe can see
                    folded = np.zeros_like(folded)
                    fills = np.zeros_like(fills)
                out.append({
                    "group": [i], "n_bins": tgt, "rows_in": len(ids), "sketches": folded,
                    "fills": fills, "ids": ids[keep], "born": born[keep],
                    "src_seg": np.full(len(keep), i, np.int64),
                    "src_row": keep.astype(np.int64), "band_index": None,
                    "index_at_swap": True,
                })
            if _hold is not None:
                _hold.wait()
            return out

        key = tuple(sorted(i for i, _ in plan))
        job = self.supervisor.submit("distill", key, work)
        if job is None:  # quarantined: the tier stays at its current width
            return False
        self._compaction = _CompactionJob(job, [self.sealed[i] for i, _ in plan], backend)
        return True

    @property
    def job_pending(self) -> Optional[str]:
        """The op (``"compact"`` or ``"distill"``) of the background job not
        yet swapped in, or None."""
        return None if self._compaction is None else self._compaction.job.op

    def poll_compaction(self) -> bool:
        """Swap in a finished background job, without blocking; True when a
        swap happened. The query path calls it, so it never raises a
        maintenance error: the supervisor retries transient failures (each
        poll advances its state machine), and a job that failed for good is
        dropped, leaving the store serving the state it never stopped
        serving. Failures show in ``supervisor.health()``."""
        job = self._compaction
        if job is None:
            return False
        state = self.supervisor.poll(job.job)
        if state == "running":
            return False
        self._compaction = None
        if state != "succeeded":
            return False  # logged and counted by the supervisor
        return self._apply_swap(job) is not None

    def wait_compaction(self) -> Optional[Dict[str, int]]:
        """Drive the background job (if any) to its end, sleeping through
        retry backoff, and apply its swap; returns its stats, or None when no
        job was pending or it failed (never raises a job's error)."""
        job = self._compaction
        if job is None:
            return None
        self._compaction = None
        state = self.supervisor.wait(job.job)
        if state != "succeeded":
            return None
        return self._apply_swap(job)

    def abandon_compaction(self, op: Optional[str] = None) -> bool:
        """Abandon the pending background job now, with no swap and no wait.
        ``op`` filters by operation name (None: whatever is pending). The
        supervisor drops every reference to the worker's future result, so a
        fold that finishes later is never swapped in. True iff a pending job
        was discarded."""
        pending = self._compaction
        if pending is None:
            return False
        if op is not None and pending.job.op != op:
            return False
        self._compaction = None
        self.supervisor.abandon(pending.job)
        return True

    def _apply_swap(self, job: "_CompactionJob") -> Optional[Dict[str, int]]:
        """The guard between a finished worker and the query path: a swap that
        fails (it mutates only at its very end, so the store stays
        consistent) is recorded as the ``compaction_swap`` degraded mode,
        never raised. A fault of the card or a kernel while uploading or
        hashing is not a degraded mode and propagates."""
        try:
            return self._swap_compaction(job, job.job.result)
        except Exception as e:
            if is_device_fault(e):
                raise
            self.supervisor.record_degraded("compaction_swap", str(e))
            return None

    def _swap_compaction(self, job: "_CompactionJob", results) -> Dict[str, int]:
        """Upload the rewritten segments in ``results`` and put them in place
        of ``job.segments``, on the caller's thread.

        The worker ran on a snapshot; the store may have moved on. A
        rewritten row stays live only if its source row is live now: every
        mutation that kills a sealed doc mid-job (delete, relocating update or
        merge, expiry) flips exactly that source bit, and a dead sealed row
        never comes back (ids are never reused), so liveness is one gather per
        source segment (``src_seg``/``src_row``). Rows that died mid-job come
        out as tombstones in the new segment; segments sealed after the
        snapshot stay. The uint32 words of the host result are the same bits
        as the device's int32 ones. A result whose index the worker could not
        build (a distillation's) gets it here, from the uploaded words."""
        for seg in job.segments:  # seal() only appends; jobs are serialized
            if not any(s is seg for s in self.sealed):
                raise RuntimeError("a sealed segment vanished before its swap")
        replaced = {id(s) for s in job.segments}
        stats = {"segments_in": sum(len(r["group"]) for r in results),
                 "rows_in": sum(r["rows_in"] for r in results), "rows_out": 0,
                 "groups": len(results)}
        new_sealed: List[SealedSegment] = []
        for r in results:
            n = len(r["ids"])
            if n == 0:
                continue
            live = np.zeros(n, bool)
            for s in np.unique(r["src_seg"]):
                sel = r["src_seg"] == s
                live[sel] = self.sealed[int(s)].valid[r["src_row"][sel]]
            words = torch.from_numpy(np.ascontiguousarray(r["sketches"]).view(np.int32))
            words = words.to(self.device)
            band_index = (self._band_index_for(words, n, job.backend) if r["index_at_swap"]
                          else r["band_index"])
            new_sealed.append(SealedSegment(
                words, torch.from_numpy(r["fills"]).to(self.device), r["ids"], live, r["born"],
                n_bins=r["n_bins"], band_index=band_index))
            stats["rows_out"] += n
        new_sealed.extend(s for s in self.sealed if id(s) not in replaced)
        self.sealed = new_sealed
        self._layout_epoch += 1
        self._loc = {g: loc for g, loc in self._loc.items() if loc[0] == _HEAD}
        for seg_i in range(len(self.sealed)):
            self._index_segment(seg_i)
        op = job.job.op
        obs_metrics.inc(f"lifecycle.{op}.runs")
        obs_metrics.inc(f"lifecycle.{op}.rows_in", stats["rows_in"])
        obs_metrics.inc(f"lifecycle.{op}.rows_out", stats["rows_out"])
        return stats

    def expire(self, ttl: float, now: float) -> int:
        """Tombstone every live doc with ``born + ttl <= now`` — the predicate
        the lazy query mask applies. Space returns at the next seal or
        compaction."""
        h = self.head
        hits = np.nonzero(h.valid[: h.size] & (h.born[: h.size] + ttl <= now))[0]
        dead = [int(g) for g in h.ids[: h.size][hits]]
        for seg in self.sealed:
            hits = np.nonzero(seg.valid & (seg.born + ttl <= now))[0]
            dead.extend(int(g) for g in seg.ids[hits])
        if dead:
            self.delete(dead)
            obs_metrics.inc("lifecycle.expired", len(dead))
        return len(dead)

    # ------------------------------------------------------------ checkpoint
    def checkpoint_tree(self) -> Tuple[dict, dict]:
        """(tree of host arrays, aux metadata) for ``CheckpointManager.save``,
        leaf for leaf and dtype for dtype the reference's: packed words as
        uint32, head counters as uint16, Ψ table int32 (hash coefficients
        uint32), fills int32, ids int64, flags bool. ``born`` stamps travel in
        aux (JSON doubles are exact float64). A finished background job is
        swapped in first; a running one is not waited for, so the snapshot
        is the consistent state before its swap."""
        self.poll_compaction()
        self._sort_head()
        h, n = self.head, self.head.size
        mapping = _host(self.mapping)
        tree = {
            "mapping": mapping if self.cfg.mode == "table" else mapping.astype(np.uint32),
            "head": {
                "counters": _host(h.counters[:n]).view(np.uint16),
                "packed": _host_words(h.packed[:n]),
                "fills": _host(h.fills[:n]),
                "ids": h.ids[:n].copy(),
                "valid": h.valid[:n].copy(),
                "exact": h.exact[:n].copy(),
                "saturated": _host(h.sat_dev[:n]),
            },
            "sealed": [{"sketches": _host_words(s.sketches), "fills": _host(s.fills),
                        "ids": s.ids.copy(), "valid": s.valid.copy()} for s in self.sealed],
        }
        aux = {
            "kind": "segmented_store",
            "cfg": {"d": self.cfg.d, "n_bins": self.cfg.n_bins, "mode": self.cfg.mode},
            "next_id": int(self.next_id),
            "seal_rows": self.seal_rows,
            "ttl": self.ttl,
            "head_rows": int(n),
            "sealed_rows": [s.n_rows for s in self.sealed],
            "sealed_n_bins": [s.n_bins for s in self.sealed],
            "head_born": h.born[:n].tolist(),
            "sealed_born": [s.born.tolist() for s in self.sealed],
            # the band index is derived state, rebuilt from the restored slab
            "band_policy": self.band_policy.to_aux() if self.band_policy else None,
        }
        return tree, aux

    def save(self, manager, step: int, blocking: bool = True) -> None:
        tree, aux = self.checkpoint_tree()
        manager.save(step, tree, aux=aux, blocking=blocking)

    @classmethod
    def restore(cls, manager, step: Optional[int] = None, *, device="cuda", backend=None,
                supervisor: Optional[JobSupervisor] = None) -> "SegmentedStore":
        """Cold-restore a store onto ``device`` from a checkpoint written by
        this package or the reference: shapes come from the aux manifest,
        nothing is re-sketched, and the location map and live count rebuild
        from the restored tombstone bitmaps. The step is pinned first with
        ``manager.resolve_step`` (the newest generation that verifies), so
        aux and arrays come from the same sound checkpoint. Band indexes are
        rebuilt from the slabs, hashed through ``backend`` when given."""
        dev = resolve_device(device)
        step = manager.resolve_step(step)
        aux = manager.load_aux(step)
        if aux.get("kind") != "segmented_store":
            raise ValueError(f"checkpoint is not a SegmentedStore snapshot: {aux.get('kind')!r}")
        cfg = binsketch.BinSketchConfig(**aux["cfg"])
        w, n = cfg.n_words, cfg.n_bins
        hr = int(aux["head_rows"])
        seg_widths = aux.get("sealed_n_bins") or [None] * len(aux["sealed_rows"])
        table = cfg.mode == "table"
        target = {
            "mapping": np.zeros((cfg.d,) if table else (2,), np.int32 if table else np.uint32),
            "head": {
                "counters": np.zeros((hr, n), np.uint16),
                "packed": np.zeros((hr, w), np.uint32),
                "fills": np.zeros((hr,), np.int32),
                "ids": np.zeros((hr,), np.int64),
                "valid": np.zeros((hr,), bool),
                "exact": np.zeros((hr,), bool),
                "saturated": np.zeros((hr,), bool),
            },
            "sealed": [{"sketches": np.zeros((r, pk.num_words(nb) if nb else w), np.uint32),
                        "fills": np.zeros((r,), np.int32),
                        "ids": np.zeros((r,), np.int64),
                        "valid": np.zeros((r,), bool)}
                       for r, nb in zip(aux["sealed_rows"], seg_widths)],
        }
        tree, _ = manager.restore(step, target)
        mapping = torch.from_numpy(tree["mapping"].astype(np.int32 if table else np.int64))
        store = cls.create(cfg, mapping.to(dev), capacity=max(hr, 1),
                           seal_rows=aux["seal_rows"], ttl=aux.get("ttl"),
                           band_policy=BandPolicy.from_aux(aux.get("band_policy")),
                           supervisor=supervisor)
        store.next_id = int(aux["next_id"])
        ht, h = tree["head"], store.head

        def dev_tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        h.counters[:hr] = dev_tensor(ht["counters"].view(np.int16))
        h.packed[:hr] = dev_tensor(ht["packed"].view(np.int32))
        h.fills[:hr] = dev_tensor(ht["fills"])
        h.sat_dev[:hr] = dev_tensor(ht["saturated"])
        h.ids[:hr] = ht["ids"]
        h.valid[:hr] = ht["valid"]
        h.born[:hr] = np.asarray(aux["head_born"], np.float64)
        h.exact[:hr] = ht["exact"]
        h.size = hr
        h.is_sorted = bool(np.all(np.diff(h.ids[:hr]) > 0))
        for st, born, nb in zip(tree["sealed"], aux["sealed_born"], seg_widths):
            sk = dev_tensor(st["sketches"].view(np.int32))
            store.sealed.append(SealedSegment(
                sk, dev_tensor(st["fills"]), st["ids"], st["valid"],
                np.asarray(born, np.float64), n_bins=int(nb) if nb else None,
                band_index=store._band_index_for(sk, int(sk.shape[0]), backend)))
        for seg_i in range(len(store.sealed)):
            store._index_segment(seg_i)
        rows = np.nonzero(h.valid[:hr])[0]
        store._loc.update(zip(h.ids[rows].tolist(), ((_HEAD, int(r)) for r in rows)))
        store._n_live = len(store._loc)
        return store
