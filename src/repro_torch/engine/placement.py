"""SegmentPlacer — whole sealed segments placed on mesh shards (the port of
``repro.engine.placement``).

The sliced sharded path cuts *every* segment across the mesh at every query:
each shard reads a slice of each segment, and the corpus is re-cut per call.
This module places **whole segments on shards** instead:

  * Sealed segments are balanced across the mesh axis by live-row count
    (longest processing time first: the heaviest segment onto the currently
    lightest shard, ties to the lower shard index).
  * The mutable head is *replicated*: it is small and churns on every
    mutation, so the engine scores it once, off the mesh, and merges it once.
  * Each shard's resident rows are packed into **one id-ascending slab per
    sketch width** on the shard's device, built once per placement. Queries
    then move only the query sketches in and O(k) partial rows per shard out.
    A distilled segment lives at a smaller width N', and rows of two widths
    cannot share a slab, so the placement keeps one :class:`WidthSlab` per
    distinct width (base width first, then the tiers descending).

Why id-ascending: ``Backend.topk`` breaks score ties toward the lower local
position. With each shard's slab sorted by global id, position order is id
order, so a slab's local top-k keeps exactly the lowest-id candidates among
ties, the set the global (score desc, id asc) merge needs.

**The validity mask.** Tombstones and lazy TTL expiry move no rows. Each slab
keeps host provenance ``(segment, row, born)`` per slot (numpy, one entry per
slot of every shard, shard-major, exactly the reference's arrays) and rebuilds
only its per-shard validity masks when the store's tombstone epoch
(``SegmentedStore._valid_epoch``) or the query's ``now`` moved. The mask is
the predicate every query view applies, ``row valid and (ttl is None or now
is None or born + ttl > now)``, with pad slots (id -1) never valid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import faults
from ..obs import metrics as obs_metrics
from ..parallel.sharding import DeviceMesh, shard_put

__all__ = ["SegmentPlacement", "SegmentPlacer", "WidthSlab"]


@dataclasses.dataclass
class WidthSlab:
    """All resident rows of one sketch width, one padded slab per shard.

    ``sketches[d]`` (L, W) int32, ``fills[d]`` (L,) int32 and ``ids[d]`` (L,)
    int32 global doc ids (-1 on pad slots) live on ``mesh.devices[d]`` and
    stay fixed for the placement's life; only the validity masks change, and
    :meth:`valid_mask` rebuilds them from the host provenance. Slot ``s`` of
    the provenance arrays is row ``s % n_local`` of shard ``s // n_local``."""

    mesh: DeviceMesh
    axis: str
    n_bins: int  # sketch width of every row in this slab (base or a tier)
    n_local: int  # L: padded rows per shard
    sketches: List[torch.Tensor]
    fills: List[torch.Tensor]
    ids: List[torch.Tensor]
    src_seg: np.ndarray  # (D*L,) source sealed index, -1 on pad slots
    src_row: np.ndarray  # (D*L,) row within the source segment, -1 on pad slots
    born: np.ndarray  # (D*L,) float64 birth stamps (0 on pads)
    _valid_key: Optional[Tuple] = dataclasses.field(default=None, init=False, repr=False)
    _valid_dev: Optional[List[torch.Tensor]] = dataclasses.field(default=None, init=False,
                                                                 repr=False)
    _slot_lut: Optional[dict] = dataclasses.field(default=None, init=False, repr=False)

    @property
    def n_slots(self) -> int:
        return int(self.src_seg.shape[0])

    @property
    def nbytes(self) -> int:
        """Bytes of the slab's device tensors (words, fills and ids)."""
        return sum(t.element_size() * t.numel()
                   for part in (self.sketches, self.fills, self.ids) for t in part)

    def ids_host(self) -> np.ndarray:
        """(D*L,) int32 global ids of every slot, shard-major (the layout of
        the reference's sharded ``ids``)."""
        return np.concatenate([t.cpu().numpy() for t in self.ids])

    def row_slots(self, seg_i: int, n_rows: int) -> np.ndarray:
        """(n_rows,) slab slot of each row of sealed segment ``seg_i`` (-1
        where the row is not resident at this width), built once per
        (placement, segment). The banded prefilter maps a segment's bucket
        candidates onto the shards' local rows through it."""
        if self._slot_lut is None:
            self._slot_lut = {}
        got = self._slot_lut.get(seg_i)
        if got is None:
            sel = np.nonzero(self.src_seg == seg_i)[0]
            got = np.full(n_rows, -1, np.int64)
            got[self.src_row[sel]] = sel
            self._slot_lut[seg_i] = got
        return got

    def valid_mask(self, store, now: Optional[float] = None) -> List[torch.Tensor]:
        """Per-shard (L,) int32 validity, tombstones and lazy TTL, rebuilt
        only when the store's tombstone epoch or (with a store ``ttl``) the
        query's ``now`` moved. A delete, a relocating update or merge, an
        expiry sweep or a background swap lands here without touching the
        slabs."""
        faults.inject("placement.refresh")
        ttl = getattr(store, "ttl", None)
        key = (store._valid_epoch, now if ttl is not None else None)
        if self._valid_key == key and self._valid_dev is not None:
            return self._valid_dev
        obs_metrics.inc("placement.mask_refreshes")
        eff = np.zeros(self.n_slots, bool)
        for seg_i in {int(s) for s in np.unique(self.src_seg) if s >= 0}:
            sel = self.src_seg == seg_i
            eff[sel] = store.sealed[seg_i].valid[self.src_row[sel]]
        if ttl is not None and now is not None:
            eff &= ~(self.born + ttl <= now)
        self._valid_dev = shard_put(torch.from_numpy(eff.astype(np.int32)), self.mesh)
        self._valid_key = key
        return self._valid_dev


@dataclasses.dataclass
class SegmentPlacement:
    """One frozen assignment of sealed segments to mesh shards.

    ``assign`` is the per-shard list of sealed-segment indexes at build time
    (every width together: it feeds device-local compaction, which splits by
    width again); ``slabs`` holds one :class:`WidthSlab` per resident width,
    base width first, then descending."""

    mesh: DeviceMesh
    axis: str
    assign: List[List[int]]  # shard -> sealed segment indexes at build time
    layout_epoch: int  # store._layout_epoch this placement was built from
    slabs: List[WidthSlab]

    @property
    def n_devices(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def segments_per_device(self) -> int:
        return max((len(g) for g in self.assign), default=0)

    @property
    def widths(self) -> List[int]:
        return [s.n_bins for s in self.slabs]

    @property
    def nbytes(self) -> int:
        """Device bytes resident in every slab of the placement."""
        return sum(s.nbytes for s in self.slabs)


@dataclasses.dataclass
class SegmentPlacer:
    """Balanced whole-segment placement policy (LPT by live-row count)."""

    def place(self, store, mesh: DeviceMesh, axis: str) -> SegmentPlacement:
        faults.inject("placement.build")
        n_dev = int(mesh.shape[axis])
        base = store.cfg.n_bins
        segs = [(i, s) for i, s in enumerate(store.sealed) if s.n_rows > 0]
        # LPT: heaviest (by live rows) first, onto the lightest shard. Widths
        # share the budget: a live row costs query work whatever its width
        segs.sort(key=lambda t: (-t[1].n_live, t[0]))
        loads = [0] * n_dev
        assign: List[List[int]] = [[] for _ in range(n_dev)]
        for i, seg in segs:
            d = min(range(n_dev), key=lambda j: (loads[j], j))
            assign[d].append(i)
            loads[d] += seg.n_live
        widths: List[int] = []
        for _, seg in segs:
            w_s = seg.n_bins if seg.n_bins is not None else base
            if w_s not in widths:
                widths.append(w_s)
        widths.sort(key=lambda w_s: (w_s != base, -w_s))  # base first, tiers descending
        slabs = [self._build_slab(store, mesh, axis, assign, w_s) for w_s in widths]
        obs_metrics.inc("placement.builds")
        obs_metrics.inc("placement.rows_placed", sum(seg.n_rows for _, seg in segs))
        return SegmentPlacement(mesh=mesh, axis=axis, assign=assign,
                                layout_epoch=store._layout_epoch, slabs=slabs)

    def _build_slab(self, store, mesh: DeviceMesh, axis: str, assign, n_bins: int) -> WidthSlab:
        """Pack each shard's resident rows *of one width* into its own
        id-ascending slab on the shard's device (the module docstring says
        why ascending); an empty shard gets a zero slab of pads."""
        base = store.cfg.n_bins
        n_dev = len(assign)
        groups = [[i for i in g
                   if (store.sealed[i].n_bins or base) == n_bins and store.sealed[i].n_rows > 0]
                  for g in assign]
        n_local = max((sum(store.sealed[i].n_rows for i in g) for g in groups), default=0)
        n_local = max(n_local, 1)  # every shard scores a non-empty slab
        w = (n_bins + 31) // 32
        sketches, fills, ids = [], [], []
        src_seg = np.full((n_dev, n_local), -1, np.int64)
        src_row = np.full((n_dev, n_local), -1, np.int64)
        born = np.zeros((n_dev, n_local), np.float64)
        for d, group in enumerate(groups):
            dev = mesh.devices[d]
            sk = torch.zeros((n_local, w), dtype=torch.int32, device=dev)
            fl = torch.zeros((n_local,), dtype=torch.int32, device=dev)
            gid = np.full(n_local, -1, np.int32)
            if group:
                ids_c = np.concatenate([store.sealed[i].ids for i in group])
                order = np.argsort(ids_c, kind="stable")
                n = len(ids_c)
                order_t = torch.from_numpy(order).to(store.device)
                sk[:n] = torch.cat([store.sealed[i].sketches for i in group]
                                   ).index_select(0, order_t).to(dev)
                fl[:n] = torch.cat([store.sealed[i].fills for i in group]
                                   ).index_select(0, order_t).to(dev)
                gid[:n] = ids_c[order]
                src_seg[d, :n] = np.concatenate(
                    [np.full(store.sealed[i].n_rows, i, np.int64) for i in group])[order]
                src_row[d, :n] = np.concatenate(
                    [np.arange(store.sealed[i].n_rows, dtype=np.int64) for i in group])[order]
                born[d, :n] = np.concatenate([store.sealed[i].born for i in group])[order]
            sketches.append(sk)
            fills.append(fl)
            ids.append(torch.from_numpy(gid).to(dev))
        return WidthSlab(mesh=mesh, axis=axis, n_bins=n_bins, n_local=n_local,
                         sketches=sketches, fills=fills, ids=ids,
                         src_seg=src_seg.reshape(-1), src_row=src_row.reshape(-1),
                         born=born.reshape(-1))
