"""Public wrappers of the Hopper kernels, with the contract of ``repro.kernels.ops``.

* :func:`build_sketch` — mapped bin ids -> packed words.
* :func:`sketch_score` — (Q, C) float32 similarity, fused epilogue.
* :func:`sketch_topk` — streaming top-k; the (Q, C) matrix is never stored.
* :func:`count_bins` — mapped bin ids -> dense per-bin occupancy (the
  counting head's insert and retract deltas).
* :func:`rebucket` — packed rows folded from N to N' bins (queries meeting a
  distilled segment).
* :func:`band_hash` — banded LSH keys of packed rows (the prefilter's index
  and query keys).
* :func:`hash_build_sketch` — raw indices -> packed words in hash mode, the
  multiply-shift map fused into the build.

Packed words are int32 tensors holding uint32 bits; any other dtype raises
``TypeError`` (the reference raises on non-uint32). ``a_fills``/``b_fills``
pass precomputed fill counts through (the store's ingest-time cache); ``None``
popcounts that side here. A tensor on the CPU runs the plain version in
:mod:`.ref`; a CUDA tensor launches the kernel, or raises — nothing falls back.

:data:`launches` counts kernel launches per wrapper (CPU calls do not count);
``chip_smoke.py`` zeroes it before the main path and reads it after.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..core import packed as pk
from . import band_hash as band_hash_mod
from . import count_bins as count_bins_mod
from . import hash_build, popcount_sim, ref, sketch_build, topk_stream
from . import rebucket as rebucket_mod

__all__ = ["MAX_K", "band_hash", "build_sketch", "count_bins", "hash_build_sketch",
           "launches", "rebucket", "reset_launches", "sketch_score", "sketch_topk"]

# largest k the streaming kernel takes (its per-query lists live in shared memory)
MAX_K = topk_stream.MAX_K_PAD

launches: Dict[str, int] = {"build_sketch": 0, "sketch_score": 0, "sketch_topk": 0,
                            "count_bins": 0, "rebucket": 0, "band_hash": 0, "hash_build": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_words(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"packed sketches must be int32 words, got {t.dtype}")


def _check_measure(measure: str) -> None:
    if measure not in ref.MEASURES:
        raise ValueError(f"unknown measure {measure!r}; have {ref.MEASURES}")


def _fills(fills: Optional[torch.Tensor], words: torch.Tensor) -> torch.Tensor:
    f = fills if fills is not None else pk.row_popcount(words)
    return f.to(device=words.device, dtype=torch.int32).contiguous()


def build_sketch(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Pre-mapped padded bin ids (B, P) int32 -> packed sketches (B, ceil(N/32)).

    Pads (-1) and ids ``>= n_bins`` set no bit."""
    if bins.dtype != torch.int32:
        raise TypeError(f"bin ids must be int32, got {bins.dtype}")
    if bins.device.type == "cpu":
        return ref.build_sketch_ref(bins, n_bins)
    if bins.shape[0] == 0:
        return torch.empty((0, pk.num_words(n_bins)), dtype=torch.int32, device=bins.device)
    out = sketch_build.launch(bins, n_bins)
    launches["build_sketch"] += 1
    return out


def hash_build_sketch(idx: torch.Tensor, coeffs: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Raw padded indices (B, P) int32 and multiply-shift coefficients ``(a,
    b)`` -> packed sketches (B, ceil(N/32)), each index mapped to ``((a*i + b)
    mod 2^32) mod N`` inside the kernel: the path for huge d, where no Ψ table
    exists. ``coeffs`` is a (2,) integer tensor of uint32 values (the port's
    hash-mode mapping: int64). Pads (-1) set no bit; bits ``>= N`` stay zero."""
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")
    if tuple(coeffs.shape) != (2,) or coeffs.is_floating_point():
        raise TypeError(f"coeffs must be a (2,) integer tensor, got {coeffs.dtype} "
                        f"{tuple(coeffs.shape)}")
    if idx.device.type == "cpu":
        return ref.hash_build_ref(idx, coeffs, n_bins)
    if idx.shape[0] == 0:
        return torch.empty((0, pk.num_words(n_bins)), dtype=torch.int32, device=idx.device)
    out = hash_build.launch(idx, coeffs, n_bins)
    launches["hash_build"] += 1
    return out


def count_bins(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Pre-mapped padded bin ids (B, P) int32 -> dense occupancy (B, n_bins) int32.

    ``out[b, t] = #{p : bins[b, p] == t}``; pads (-1) and ids ``>= n_bins``
    never count. Rows are counted with multiplicity: the store dedups first.
    The counters are not clamped here; the store clamps them."""
    if bins.dtype != torch.int32:
        raise TypeError(f"bin ids must be int32, got {bins.dtype}")
    if bins.device.type == "cpu":
        return ref.count_bins_ref(bins, n_bins)
    if bins.shape[0] == 0:
        return torch.empty((0, int(n_bins)), dtype=torch.int32, device=bins.device)
    out = count_bins_mod.launch(bins, n_bins)
    launches["count_bins"] += 1
    return out


def rebucket(packed: torch.Tensor, n_bins: int, n_bins_new: int) -> torch.Tensor:
    """Packed (B, W) words at ``n_bins`` -> (B, W') at ``n_bins_new`` bins,
    bin ``j`` ORed into ``j mod n_bins_new``.

    The result is the sketch under the derived map ``pi mod n_bins_new``.
    Source bits ``>= n_bins`` in the last word are ignored. ``n_bins_new ==
    n_bins`` returns the input and launches nothing; fills of folded rows
    change, and the caller popcounts them again."""
    _check_words(packed)
    if not 1 <= n_bins_new <= n_bins:
        raise ValueError(f"need 1 <= n_bins_new <= n_bins, got {n_bins_new} vs {n_bins}")
    if n_bins_new == n_bins:
        return packed
    if packed.device.type == "cpu":
        return ref.rebucket_ref(packed, n_bins, n_bins_new)
    if packed.shape[0] == 0:
        return torch.empty((0, pk.num_words(n_bins_new)), dtype=torch.int32,
                           device=packed.device)
    out = rebucket_mod.launch(packed, n_bins, n_bins_new)
    launches["rebucket"] += 1
    return out


def band_hash(packed: torch.Tensor, n_bands: int) -> torch.Tensor:
    """Packed (B, W) words -> (B, nb_eff) band keys, int32 holding uint32 bits.

    Band ``t`` hashes words ``[t*wpb, (t+1)*wpb)`` with ``wpb = ceil(W /
    n_bands)``; ``n_bands`` clamps to ``[1, W]`` and the key count is ``nb_eff
    = ceil(W / wpb)`` (``core.packed.band_shape``): size indexes off the
    output, not the request. Two rows share a key iff that word group is
    identical (up to 2^-32 collisions)."""
    _check_words(packed)
    nb_eff, wpb = pk.band_shape(packed.shape[1], n_bands)
    if packed.device.type == "cpu":
        return ref.band_hash_ref(packed, n_bands)
    if packed.shape[0] == 0:
        return torch.empty((0, nb_eff), dtype=torch.int32, device=packed.device)
    out = band_hash_mod.launch(packed, nb_eff, wpb)
    launches["band_hash"] += 1
    return out


def sketch_score(a: torch.Tensor, b: torch.Tensor, n_bins: int, measure: str = "jaccard",
                 *, a_fills: Optional[torch.Tensor] = None,
                 b_fills: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed (Q, W) x (C, W) -> (Q, C) float32 similarity (``measure="counts"``:
    the raw AND-popcounts as float32)."""
    _check_words(a, b)
    _check_measure(measure)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"word counts differ: {a.shape} vs {b.shape}")
    na, nb = _fills(a_fills, a), _fills(b_fills, b)
    if a.device.type == "cpu":
        return ref.sketch_score_ref(a, b, n_bins, measure, a_fills=na, b_fills=nb)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return torch.zeros((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
    out = popcount_sim.launch(a.contiguous(), b.contiguous(), na, nb, n_bins, measure)
    launches["sketch_score"] += 1
    return out


def sketch_topk(a: torch.Tensor, b: torch.Tensor, n_bins: int, measure: str = "jaccard",
                *, k: int, a_fills: Optional[torch.Tensor] = None,
                b_fills: Optional[torch.Tensor] = None,
                b_valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed (Q, W) x (C, W) -> top-k (scores (Q, k) float32, ids (Q, k) int32).

    Rows sorted by score descending, ties to the lower id. ``b_valid`` (C,)
    masks corpus rows out entirely; slots past the retrievable rows (k > C,
    or masked rows) hold score -inf / id -1. On the card ``k`` is at most
    :data:`MAX_K`."""
    _check_words(a, b)
    _check_measure(measure)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"word counts differ: {a.shape} vs {b.shape}")
    q, c = a.shape[0], b.shape[0]
    if c == 0:  # no docs: every slot is the empty sentinel
        return (torch.full((q, k), -math.inf, dtype=torch.float32, device=a.device),
                torch.full((q, k), -1, dtype=torch.int32, device=a.device))
    na, nb = _fills(a_fills, a), _fills(b_fills, b)
    valid = None if b_valid is None else b_valid.to(device=b.device, dtype=torch.int32).contiguous()
    if a.device.type == "cpu":
        return ref.sketch_topk_ref(a, b, n_bins, measure, k=k, a_fills=na, b_fills=nb,
                                   b_valid=valid)
    if k > MAX_K:
        raise ValueError(f"sketch_topk: k={k} exceeds the kernel's limit of {MAX_K}")
    if q == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=a.device),
                torch.empty((0, k), dtype=torch.int32, device=a.device))
    out_s, out_i = topk_stream.launch(a.contiguous(), b.contiguous(), na, nb, valid,
                                      n_bins, measure, topk_stream.next_pow2(k))
    launches["sketch_topk"] += 1
    return out_s[:, :k], out_i[:, :k]
