"""Counting BinSketch — the mutable lift of the paper's OR-sketch.

A packed sketch is an OR over the bins of the random map ``pi``: once a bit is
set nothing can be removed. The counting variant stores, per document, the
occupancy of every bin, ``c_s[j] = |{i in a : pi(i) = j}|``; insertion
increments a bin, retraction decrements it, and the binary sketch every
estimator and kernel consumes is ``c_s > 0`` at any moment — bit for bit the
paper's sketch. The same algebra as ``repro.core.counting``.

**Counters are computed in int32 and stored in 16 bits**, clamped at
:data:`COUNTER_MAX`, the reference's u16 range. PyTorch's ``uint16`` lacks
index assignment, comparisons and ``clamp`` on the CPU, so the stored dtype is
:data:`COUNTER_DTYPE` (int16) holding the u16 bit patterns: :func:`to_stored`
writes them, :func:`widen` reads them back as int32. Arithmetic saturates: an
occupancy past the clamp loses its true value for good, so the mutable head
(:mod:`repro_torch.engine.segments`) flags the row and refuses retraction on
it. The binary sketch is never wrong under saturation (``clamped > 0`` iff
``true > 0``).

The dense occupancy on the card comes from the ``count_bins`` Hopper kernel
(``Backend.count``); :func:`count_indices_dense` here is the plain scatter-add.
"""

from __future__ import annotations

import torch

from . import binsketch, packed as pk

__all__ = [
    "COUNTER_DTYPE",
    "COUNTER_MAX",
    "count_indices_dense",
    "counters_to_packed",
    "counter_fills",
    "dedup_padded",
    "fold_counters",
    "packed_to_counters",
    "to_stored",
    "widen",
]

COUNTER_MAX = 65535  # saturating clamp, the reference's u16 range
COUNTER_DTYPE = torch.int16  # stored counters: the reference's u16 bits


def to_stored(counts: torch.Tensor) -> torch.Tensor:
    """int32 occupancy already clamped to ``[0, 65535]`` -> int16 holding the
    same 16 bits. Values from 32768 up are shifted down by 2^16 before the
    cast, so no out-of-range conversion is left to the platform."""
    return torch.where(counts >= 32768, counts - 65536, counts).to(COUNTER_DTYPE)


def widen(stored: torch.Tensor) -> torch.Tensor:
    """Stored int16 counters -> their u16 values as int32 (a plain cast would
    read 65535 as -1)."""
    return stored.to(torch.int32) & 0xFFFF


def dedup_padded(idx: torch.Tensor) -> torch.Tensor:
    """Collapse duplicate indices within each padded sparse row to one.

    Documents are sets: a multiset row would have every repeat counted by the
    occupancy scatter, and an insert of ``[x, x]`` followed by a retract of
    ``[x]`` would leave a phantom count. Rows come back sorted with repeats
    blanked to the pad value -1, exactly as the reference returns them."""
    s = torch.sort(idx, dim=-1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[..., 1:] = (s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)
    return torch.where(dup, torch.full_like(s, -1), s)


def count_indices_dense(cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Padded sparse rows ``idx: (B, P)`` (pad -1) -> occupancy ``(B, N)`` int32.

    Scatter-add; elements count with multiplicity, so callers holding sets
    run rows through :func:`dedup_padded` first."""
    bins = binsketch.map_indices(cfg, mapping, idx)
    valid = bins >= 0
    safe = torch.where(valid, bins, torch.zeros_like(bins)).to(torch.int64)
    dense = torch.zeros((idx.shape[0], cfg.n_bins), dtype=torch.int32, device=idx.device)
    return dense.scatter_add_(1, safe, valid.to(torch.int32))


def counters_to_packed(counters: torch.Tensor) -> torch.Tensor:
    """Occupancy ``(B, N)`` -> packed binary sketch ``(B, W)`` int32 words."""
    return pk.pack_bits((counters > 0).to(torch.uint8))


def counter_fills(counters: torch.Tensor) -> torch.Tensor:
    """Occupancy ``(B, N)`` -> fill counts ``(B,)`` int32 (bins occupied)."""
    return (counters > 0).sum(dim=-1, dtype=torch.int32)


def fold_counters(counters: torch.Tensor, n_bins_new: int) -> torch.Tensor:
    """Re-bucket occupancy ``(B, N)`` to ``(B, N')`` by adding bin ``j`` into
    ``j mod N'``, clamped at :data:`COUNTER_MAX`.

    The counter image of :func:`~repro_torch.core.packed.fold_packed`:
    ``fold_counters(c) > 0`` packs to ``fold_packed(counters_to_packed(c))``."""
    n_bins = int(counters.shape[-1])
    if n_bins_new > n_bins:
        raise ValueError(f"cannot fold {n_bins} bins up to {n_bins_new}")
    if n_bins_new == n_bins:
        return counters
    n_chunks = -(-n_bins // n_bins_new)
    pad = n_chunks * n_bins_new - n_bins
    wide = counters.to(torch.int64)
    if pad:
        wide = torch.nn.functional.pad(wide, (0, pad))
    folded = wide.reshape(wide.shape[:-1] + (n_chunks, n_bins_new)).sum(dim=-2)
    return folded.clamp(0, COUNTER_MAX).to(torch.int32)


def packed_to_counters(packed: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Packed rows -> occupancy with every set bin at count 1.

    Lossy re-entry for rows that exist only in OR form (sealed relocation,
    ``add_sketches``): the binary sketch is exact, element multiplicity is
    gone, so retraction on such rows is refused by the store."""
    return pk.unpack_bits(packed, n_bins).to(torch.int32)
