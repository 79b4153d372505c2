"""DOPH — Densified One-Permutation Hashing [Shrivastava 2017].

One pass: every element is hashed once to one of k bins; each bin keeps the
min hash value. Empty bins are *densified* by borrowing the value of the
nearest non-empty bin to the right (cyclic) plus an offset per step of
distance (the rotation scheme of ``repro.core.baselines.doph``).

The reference densifies with two sequential scans over the k columns. Here
the same values come in closed form, with no loop over columns: an empty
column c whose nearest non-empty column to the right (cyclically) lies at
distance t takes that column's value plus ``t * OFFSET mod 2^32``, and in a
row with no non-empty column, column c takes ``(2k - c) * OFFSET mod 2^32``
(the two scans' carry started from 0). A bin whose minimum hash value is
``0xFFFFFFFF`` counts as empty, as in the reference.

Estimator: identical to MinHash over the k densified bins.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ... import resolve_device
from ._hashing import INF, U32, draw_u32, elements, generator
from .minhash import estimates  # same estimator — re-exported for symmetry

__all__ = ["make_hashes", "sketch_indices", "densify", "estimates"]

_OFFSET = 2654435761  # Knuth multiplicative constant, per-rotation offset
_DENSIFY_ELEMS = 1 << 25  # int64 elements of one (rows, 2k) densify block


def make_hashes(seed: int = 0, device="cuda") -> torch.Tensor:
    """(4,) int64 uint32 values: bin-hash (a1|1, b1), value-hash (a2|1, b2)."""
    dev = resolve_device(device)
    c = draw_u32((4,), generator(seed))
    c[0] |= 1
    c[2] |= 1
    return c.to(dev)


def densify(bins: torch.Tensor) -> torch.Tensor:
    """Cyclic right-rotation fill of empty (``0xFFFFFFFF``) bins, (B, k) int64,
    in the closed form of the module docstring."""
    bsz, k = bins.shape
    out = torch.empty_like(bins)
    col = torch.arange(k, device=bins.device)
    pos = torch.arange(2 * k, device=bins.device)
    step = max(1, _DENSIFY_ELEMS // (2 * k))
    for lo in range(0, bsz, step):
        blk = bins[lo : lo + step]
        full = blk != INF
        # the first non-empty position at or after each of 2k positions of
        # the row read twice: a suffix minimum over the flipped row
        where = torch.where(full.repeat(1, 2), pos, 2 * k)
        nxt = torch.flip(torch.cummin(torch.flip(where, [1]), dim=1).values, [1])[:, :k]
        t = nxt - col  # distance to the source column; 0 where the bin is full
        src = torch.gather(blk, 1, torch.remainder(nxt, k))
        filled = (src + t * _OFFSET) & U32
        empty_row = ((2 * k - col) * _OFFSET) & U32
        out[lo : lo + step] = torch.where(full.any(dim=1, keepdim=True), filled, empty_row)
    return out


def sketch_indices(hashes: torch.Tensor, k: int, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded sparse rows (B, P) -> ((B, k) int64 densified values, (B,) int32 |a|)."""
    a1, b1, a2, b2 = hashes[0], hashes[1], hashes[2], hashes[3]
    valid, x = elements(idx.to(hashes.device))
    which = ((a1 * x + b1) & U32) % int(k)  # bin per element
    val = torch.where(valid, (a2 * x + b2) & U32, INF)
    bins = torch.full((x.shape[0], int(k)), INF, dtype=torch.int64, device=x.device)
    bins.scatter_reduce_(1, which, val, "amin")
    return densify(bins), valid.sum(dim=1, dtype=torch.int32)
