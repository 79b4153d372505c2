"""Packed-bit utilities for binary sketches.

Sketches are stored packed: 32 sketch bins per word, little-endian within the
word (bin ``j`` lives in word ``j // 32`` at bit ``j % 32``), the layout of
``repro.core.packed``. Words are **int32 tensors holding the reference's uint32
bits**: PyTorch has no right shift on uint32 and an arithmetic one on int32, so
every logical right shift here is masked, and the popcount widens to int64
where uint32 wraparound would matter. The CUDA kernels read the same storage as
``uint32_t``.
"""

from __future__ import annotations

import torch

__all__ = [
    "num_words",
    "pack_bits",
    "unpack_bits",
    "popcount",
    "row_popcount",
    "and_popcount_pairwise",
    "segment_or",
    "fold_packed",
    "or_rows",
]

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101
_U32 = 0xFFFFFFFF

# elements of the (Q, chunk, W) int64 intermediate of and_popcount_pairwise
_PAIRWISE_CHUNK_ELEMS = 1 << 25


def num_words(n_bins: int) -> int:
    """Number of 32-bit words needed for an ``n_bins``-bit sketch."""
    return (int(n_bins) + 31) // 32


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits(dense: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., N)`` {0,1} bits into ``(..., ceil(N/32))`` int32 words."""
    n = dense.shape[-1]
    w = num_words(n)
    pad = w * 32 - n
    if pad:
        dense = torch.nn.functional.pad(dense, (0, pad))
    bits = dense.reshape(dense.shape[:-1] + (w, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dense.device)
    return _to_int32_bits((bits << shifts).sum(dim=-1))


def unpack_bits(packed: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns ``(..., n_bins)`` uint8 bits."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1  # the & 1 drops sign-extended bits
    flat = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 32,))
    return flat[..., :n_bins].to(torch.uint8)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words (int32 holding uint32 bits) -> int32."""
    x = x.to(torch.int64) & _U32
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    return (((x * _H01) & _U32) >> 24).to(torch.int32)


def row_popcount(packed: torch.Tensor) -> torch.Tensor:
    """Total set-bit count along the trailing word axis -> int32."""
    return popcount(packed).sum(dim=-1, dtype=torch.int32)


def and_popcount_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(Q, W) x (C, W) -> (Q, C)`` int32 popcount(AND) matrix.

    The plain version of the Hopper score kernel's contraction. The
    (Q, chunk, W) intermediate is bounded by scoring the corpus in chunks.
    """
    q, w = a.shape
    c = b.shape[0]
    out = torch.empty((q, c), dtype=torch.int32, device=a.device)
    chunk = max(1, _PAIRWISE_CHUNK_ELEMS // max(q * w, 1))
    for lo in range(0, c, chunk):
        both = a[:, None, :] & b[None, lo : lo + chunk, :]
        out[:, lo : lo + chunk] = popcount(both).sum(dim=-1, dtype=torch.int32)
    return out


def _or_reduce_bits(bit_of, out_shape, device) -> torch.Tensor:
    """OR of 32-bit words assembled one bit position at a time: ``bit_of(b)``
    returns the reduced {0,1} bit ``b`` (int64), and the words are rebuilt
    from the 32 of them. No (rows, W, 32) unpacked intermediate is built."""
    acc = torch.zeros(out_shape, dtype=torch.int64, device=device)
    for b in range(32):
        acc |= bit_of(b) << b
    return _to_int32_bits(acc)


def segment_or(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """OR-reduce rows of ``data`` (B, ...) int32 words into (num_segments, ...).

    The bitwise-OR ``segment_max`` of ``repro.core.packed.segment_or``:
    each bit position is reduced with a scatter-max over the segment ids, so
    memory stays O(B·W). Empty segments come back all-zero (the sketch of
    the empty union)."""
    out_shape = (int(num_segments),) + tuple(data.shape[1:])
    if data.shape[0] == 0:
        return torch.zeros(out_shape, dtype=torch.int32, device=data.device)
    wide = data.to(torch.int64)
    ids = torch.as_tensor(segment_ids, device=data.device).to(torch.int64)
    ids = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(wide)

    def bit_of(b):
        zero = torch.zeros(out_shape, dtype=torch.int64, device=data.device)
        return zero.scatter_reduce_(0, ids, (wide >> b) & 1, "amax")

    return _or_reduce_bits(bit_of, out_shape, data.device)


def fold_packed(packed: torch.Tensor, n_bins: int, n_bins_new: int) -> torch.Tensor:
    """Re-bucket packed rows from ``n_bins`` to ``n_bins_new`` bins by
    OR-folding bin ``j`` into bin ``j mod n_bins_new``.

    ``fold(sketch_N(x)) == sketch_N'(x)`` under the derived map
    ``pi'(i) = pi(i) mod N'`` (``repro.core.packed.fold_packed``). Bits at or
    above ``n_bins`` in the last word are ignored."""
    if n_bins_new > n_bins:
        raise ValueError(f"cannot fold {n_bins} bins up to {n_bins_new}")
    if n_bins_new == n_bins:
        return packed
    bits = unpack_bits(packed, n_bins)
    n_chunks = -(-n_bins // n_bins_new)
    pad = n_chunks * n_bins_new - n_bins
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    folded = bits.reshape(bits.shape[:-1] + (n_chunks, n_bins_new)).amax(dim=-2)
    return pack_bits(folded)


def or_rows(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Bitwise-OR reduce packed words along ``axis`` (the sketch of the union:
    BinSketch is an OR-homomorphism). An empty axis reduces to zero words."""
    axis = axis % packed.ndim
    out_shape = packed.shape[:axis] + packed.shape[axis + 1:]
    if packed.shape[axis] == 0:
        return torch.zeros(out_shape, dtype=torch.int32, device=packed.device)
    wide = packed.to(torch.int64)
    return _or_reduce_bits(lambda b: ((wide >> b) & 1).amax(dim=axis), out_shape,
                           packed.device)
