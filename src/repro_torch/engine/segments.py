"""SegmentedStore — LSM-style mutable corpus lifecycle (the port of
``repro.engine.segments``).

An append-only ``SketchStore`` cannot delete or update a document: the OR
that built a sketch cannot be undone. This module keeps the corpus in the
log-structured layout of the reference:

  * a **mutable head** backed by the counting BinSketch
    (:mod:`repro_torch.core.counting`): per-doc, per-bin occupancy counters
    over the same Ψ map, int32 clamped at ``COUNTER_MAX``. The binary sketch
    every estimator and kernel reads is ``counters > 0``, so insert is an
    increment, retraction a decrement and replacement an overwrite, in place;
  * **sealed segments**, packed-only (n, W) slabs plus their fill cache.
    Deleting a sealed doc flips a bit in a host-side tombstone bitmap that
    reaches ``Backend.topk`` as ``corpus_valid``; no data moves;
  * **compaction**, which merges sealed segments (per sketch width),
    dropping tombstoned rows — the only rewrite of sealed bytes, never a
    re-sketch;
  * **TTL expiry** over per-doc birth stamps: eagerly by :meth:`expire`,
    lazily at query time when the store has a ``ttl`` and the query a ``now``;
  * **distillation** (:meth:`SegmentedStore.distill`): a sealed segment
    re-sketched from width N to a smaller N' by OR-folding bin ``j`` into
    ``j mod N'`` over the packed slab alone, as a :class:`DistillPolicy`
    decides. Serving becomes mixed-width: each view carries its ``n_bins``;
  * the **banded prefilter** (:mod:`.banding`): with a ``band_policy``, every
    sealed segment of at least ``min_rows`` rows gets a :class:`BandIndex`
    over its slab when it is made (seal, ``seal_sketches``, compaction,
    distillation), and the engine's queries scan only colliding buckets.

Invariants, as in the reference: ``_loc[gid] == (segment, row)`` for exactly
the live docs; a row is retrievable iff ``valid and (ttl is None or now is
None or born + ttl > now)``, the one predicate both the query views and
:meth:`expire` apply; rows inside every segment ascend in global id (the head
re-sorts lazily); global ids are assigned once and never reused, so a mutated
store answers queries exactly as a fresh build over its survivors.

Counters, packed rows, fills and the saturation flags live on the mapping's
device; per-row bookkeeping (ids, tombstones, birth stamps, exactness) is
host numpy. Distillation runs synchronously here: its fold is pure host
numpy over a snapshot, applied through the same reconciling swap a
background job would use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import binsketch, counting
from ..core import packed as pk
from .banding import BandIndex, BandPolicy
from .store import SegmentView, _grow, as_index_tensor

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
    """Mutable counting segment: int32 occupancy counters plus the packed rows
    and fills derived from them.

    ``exact`` marks rows whose counters carry true element multiplicity
    (built from indices); rows re-entered from packed form are occupancy-1
    and refuse retraction. ``sat_dev`` marks rows where a counter passed
    ``COUNTER_MAX`` and was clamped; it stays on the device so that ingest
    never waits for the host, and is read back only where retraction is
    refused.
    """

    counters: torch.Tensor  # (cap, N) int32
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
            torch.zeros((capacity, n_bins), dtype=torch.int32, device=device),
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
        self.counters[rows] = clamped
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
        sat = self._write_rows(r, self.counters[r] + deltas)
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
class SegmentedStore:
    """Mutable, segmented counterpart of :class:`SketchStore`.

    The same ``add`` / ``add_sketches`` / ``merge`` / ``merge_rows`` surface,
    plus ``delete`` / ``update`` / ``retract_rows`` / ``seal`` / ``compact``
    / ``expire`` / ``distill``. Doc ids are global, assigned at insert, and
    never reused.
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
    _loc: Dict[int, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    _n_live: int = 0

    # ------------------------------------------------------------ construct
    @classmethod
    def create(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
               capacity: int = 1024, seal_rows: Optional[int] = None,
               ttl: Optional[float] = None,
               band_policy: Optional[BandPolicy] = None) -> "SegmentedStore":
        head = _Head.create(cfg.n_bins, cfg.n_words, capacity, mapping.device)
        return cls(cfg, mapping, [], head, seal_rows=seal_rows, ttl=ttl,
                   band_policy=band_policy)

    @classmethod
    def from_indices(cls, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
                     corpus_idx, *, backend=None, batch: int = 4096, now: float = 0.0,
                     seal_rows: Optional[int] = None, ttl: Optional[float] = None,
                     band_policy: Optional[BandPolicy] = None) -> "SegmentedStore":
        store = cls.create(cfg, mapping, capacity=max(int(corpus_idx.shape[0]), 1),
                           seal_rows=seal_rows, ttl=ttl, band_policy=band_policy)
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

    def _band_index_for(self, sketches: torch.Tensor, n_rows: int,
                        backend=None) -> Optional[BandIndex]:
        """A :class:`BandIndex` over a freshly made slab when the band policy
        wants one, else None. The keys come from ``backend.band_hash`` when a
        backend is given (the engine passes its own, so on the ``cuda``
        backend the kernel hashes) and from the plain ``pk.band_hash``
        otherwise, as the reference's oracle: bit-identical either way. A
        failure propagates."""
        bp = self.band_policy
        if bp is None or not bp.wants_index(n_rows):
            return None
        hash_fn = backend.band_hash if backend is not None else pk.band_hash
        keys = hash_fn(sketches, bp.n_bands)
        return BandIndex.build(keys.cpu().numpy())

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
        self.head = _Head.create(self.cfg.n_bins, self.cfg.n_words, h.capacity, self.device)
        return seg

    def seal_sketches(self, sketches: torch.Tensor, *, now: float = 0.0,
                      backend=None) -> range:
        """Bulk-ingest pre-packed int32 rows straight into a sealed segment,
        bypassing the counting head (whose counters cost ``4*N`` bytes a
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
        one. The head is untouched (seal first for a full compaction)."""
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
        self.sealed = new_sealed
        for seg_i in range(len(self.sealed)):
            self._index_segment(seg_i)
            stats["rows_out"] += self.sealed[seg_i].n_rows
        return stats

    def distill(self, policy: DistillPolicy, *, now: float = 0.0) -> Optional[Dict[str, int]]:
        """Re-sketch each policy-eligible sealed segment to its next smaller
        width tier and swap it in; returns the swap's stats, or None when no
        segment is eligible.

        Each segment folds on its own (no cross-segment merge): dead rows
        are dropped, the live rows OR-folded N -> N' on the host
        (:func:`_fold_packed_host`), fills re-counted, and, with a band
        policy, a fresh index built on the host from the folded words (the
        base-width buckets never serve the narrower rows). The result goes in
        through :meth:`_swap`, which reconciles against the source
        tombstones (the uint32 words the fold returns are the same bits as
        the device's int32 ones).
        """
        base = self.cfg.n_bins
        plan: List[Tuple[int, int]] = []
        for i, seg in enumerate(self.sealed):
            if seg.n_live == 0:
                continue
            cur = seg.n_bins if seg.n_bins is not None else base
            age = float(now) - float(seg.born[seg.valid].max())
            tgt = policy.target_width(cur, age, seg.n_live)
            if tgt is not None and tgt < cur:
                plan.append((i, tgt))
        if not plan:
            return None
        results = []
        for i, tgt in plan:
            seg = self.sealed[i]
            cur = seg.n_bins if seg.n_bins is not None else base
            keep = np.nonzero(seg.valid)[0]  # ascending rows: ids stay in order
            host = seg.sketches.cpu().numpy().view(np.uint32)
            folded, fills = _fold_packed_host(host[keep], cur, tgt)
            bp = self.band_policy
            results.append({
                "group": [i], "n_bins": tgt, "rows_in": seg.n_rows,
                "sketches": folded, "fills": fills,
                "ids": seg.ids[keep], "born": seg.born[keep].copy(),
                "src_seg": np.full(len(keep), i, np.int64), "src_row": keep.astype(np.int64),
                "band_index": (BandIndex.build_from_packed(folded, bp.n_bands)
                               if bp is not None and bp.wants_index(len(keep)) else None),
            })
        return self._swap([self.sealed[i] for i, _ in plan], results)

    def _swap(self, segments: List[SealedSegment], results) -> Dict[str, int]:
        """Replace ``segments`` by the rewritten ones in ``results``.

        A rewritten row stays live only if its source row is live now: every
        mutation that kills a sealed doc flips exactly that source bit, and a
        dead sealed row never comes back, so liveness is one gather per
        source segment. Rows that died after the snapshot come out as
        tombstones in the new segment; segments not in ``segments`` stay."""
        for seg in segments:
            if not any(s is seg for s in self.sealed):
                raise RuntimeError("a sealed segment vanished before its swap")
        replaced = {id(s) for s in segments}
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
            new_sealed.append(SealedSegment(
                words.to(self.device), torch.from_numpy(r["fills"]).to(self.device),
                r["ids"], live, r["born"], n_bins=r["n_bins"], band_index=r["band_index"]))
            stats["rows_out"] += n
        new_sealed.extend(s for s in self.sealed if id(s) not in replaced)
        self.sealed = new_sealed
        self._loc = {g: loc for g, loc in self._loc.items() if loc[0] == _HEAD}
        for seg_i in range(len(self.sealed)):
            self._index_segment(seg_i)
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
        return len(dead)
