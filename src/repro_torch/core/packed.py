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
    "band_hash",
    "band_hash_host",
    "band_shape",
    "mul_u32",
]

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_H01 = 0x01010101
_U32 = 0xFFFFFFFF

_BAND_SEED = 0x9E3779B9  # golden-ratio odd constant; per-band seeds derive from it
_BAND_PRIME = 0x85EBCA6B  # murmur3 fmix multiplier

# float64 elements of one unpacked (rows, 32W) corpus block of and_popcount_pairwise
_PAIRWISE_BLOCK_ELEMS = 1 << 25


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

    The plain version of the Hopper score kernel's contraction: the words
    unpack to {0, 1} bits and one float64 matrix product counts the bits two
    rows share. It is exact: every partial sum is an integer of at most 32W,
    far below 2^53, and float64 products have no reduced-precision mode. The
    corpus unpacks a block of rows at a time.
    """
    q, w = a.shape
    c = b.shape[0]
    out = torch.empty((q, c), dtype=torch.int32, device=a.device)
    ua = unpack_bits(a, 32 * w).to(torch.float64)
    step = max(1, _PAIRWISE_BLOCK_ELEMS // max(32 * w, 1))
    for lo in range(0, c, step):
        ub = unpack_bits(b[lo : lo + step], 32 * w).to(torch.float64)
        out[:, lo : lo + step] = (ua @ ub.T).to(torch.int32)
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


def band_shape(n_words: int, n_bands: int):
    """``(nb_eff, wpb)`` of the band hash over ``n_words`` words: ``n_bands``
    clamps to ``[1, n_words]``, ``wpb = ceil(W / n_bands)`` words a band, and
    ``nb_eff = ceil(W / wpb)`` bands, the count the keys really have."""
    w = int(n_words)
    n_bands = max(1, min(int(n_bands), w))
    wpb = -(-w // n_bands)
    return -(-w // wpb), wpb


def mul_u32(h: torch.Tensor, c) -> torch.Tensor:
    """``h * c mod 2^32`` for int64 ``h`` and ``c`` (an int or an int64
    tensor) in ``[0, 2^32)``. The full product reaches 2^64 and would
    overflow int64, so ``c`` is split into 16-bit halves: ``h*lo < 2^48``
    and ``(h*hi mod 2^16) << 16 < 2^32``."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _U32


def band_hash(packed: torch.Tensor, n_bands: int) -> torch.Tensor:
    """Hash contiguous word groups of packed (B, W) rows -> (B, nb_eff) band keys.

    Band ``t`` covers words ``[t*wpb, (t+1)*wpb)`` (see :func:`band_shape`),
    words past W read as zero, and the chain is, in uint32 wraparound,

        h = SEED * (t + 1);  for each word: h = (h ^ word) * PRIME; h ^= h >> 15

    as ``repro.core.packed.band_hash``. Two rows share band ``t``'s key iff
    they agree on that whole word group (up to 2^-32 collisions). The keys
    come back as int32 holding the uint32 bits, like packed words; the
    arithmetic runs on int64 values in ``[0, 2^32)``, so ``>> 15`` is a
    logical shift and the multiply is :func:`mul_u32`'s."""
    bsz, w = packed.shape
    nb_eff, wpb = band_shape(w, n_bands)
    words = packed.to(torch.int64) & _U32
    pad = nb_eff * wpb - w
    if pad:
        words = torch.nn.functional.pad(words, (0, pad))
    grp = words.reshape(bsz, nb_eff, wpb)
    band = torch.arange(1, nb_eff + 1, dtype=torch.int64, device=packed.device)
    h = ((band * _BAND_SEED) & _U32).expand(bsz, nb_eff)
    for t in range(wpb):
        h = mul_u32(h ^ grp[:, :, t], _BAND_PRIME)
        h = h ^ (h >> 15)
    return _to_int32_bits(h)


def band_hash_host(packed, n_bands: int):
    """Numpy twin of :func:`band_hash` for host-side index builds: uint32
    words in (a ``(B, W)`` array of uint32, or of int32 with the same bits),
    ``(B, nb_eff)`` uint32 keys out, bit for bit the same."""
    import numpy as np

    packed = np.asarray(packed, dtype=np.uint32)  # int32 words: the cast keeps the bits
    bsz, w = packed.shape
    nb_eff, wpb = band_shape(w, n_bands)
    pad = nb_eff * wpb - w
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    grp = packed.reshape(bsz, nb_eff, wpb)
    seeds = np.uint32(_BAND_SEED) * (np.arange(nb_eff, dtype=np.uint32) + np.uint32(1))
    with np.errstate(over="ignore"):
        h = np.broadcast_to(seeds.reshape(1, nb_eff), (bsz, nb_eff)).copy()
        for t in range(wpb):
            h = (h ^ grp[:, :, t]) * np.uint32(_BAND_PRIME)
            h ^= h >> np.uint32(15)
    return h
