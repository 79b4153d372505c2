"""Plain PyTorch versions of the Hopper kernels.

Each function computes exactly what its kernel computes, with ordinary tensor
operations. On a CPU tensor the wrappers in :mod:`repro_torch.hopper.ops` run
these; on the card ``chip_smoke.py`` holds each kernel against them.

* :func:`build_sketch_ref` — scatter construction (``kernels/ref.py``'s).
* :func:`hash_build_ref` — the multiply-shift hash of ``map_indices`` in hash
  mode, then :func:`build_sketch_ref`.
* :func:`band_hash_ref` — the band keys of ``core.packed.band_hash``.
* :func:`count_bins_ref` — per-bin occupancy by ``scatter_add_``.
* :func:`rebucket_ref` — the N -> N' fold as the kernel's funnel shift, on
  int64 words.
* :func:`sketch_score_ref` — AND-popcount plus the epilogue of
  ``kernels/popcount_sim.py::_epilogue``; each count's log term comes from
  :func:`log_ratio_table`, which the kernels read too.
* :func:`sketch_topk_ref` — chunked score, then stable descending sorts over
  ascending ids, so ties break toward the lower id. ``torch.topk`` is not
  used: it promises no order among ties.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import binsketch
from ..core import packed as pk

__all__ = [
    "MEASURES",
    "band_hash_ref",
    "build_sketch_ref",
    "hash_build_ref",
    "count_bins_ref",
    "log_ratio_table",
    "log_f32",
    "rebucket_ref",
    "score_epilogue",
    "select_topk",
    "sketch_score_ref",
    "sketch_topk_ref",
]

MEASURES = ("counts", "ip", "hamming", "jaccard", "cosine")

# corpus rows scored per step of sketch_topk_ref
_TOPK_CHUNK = 4096


def build_sketch_ref(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bins: (B, P)`` int32 mapped bin ids (pad -1) -> ``(B, ceil(N/32))``
    int32 words. Bit ``t`` is set iff some ``bins[b, p] == t``; ids outside
    ``[0, n_bins)`` set nothing."""
    keep = (bins >= 0) & (bins < n_bins)
    rows = torch.arange(bins.shape[0], device=bins.device)[:, None].expand_as(bins)
    dense = torch.zeros((bins.shape[0], n_bins), dtype=torch.uint8, device=bins.device)
    dense[rows[keep], bins[keep].to(torch.int64)] = 1
    return pk.pack_bits(dense)


def hash_build_ref(idx: torch.Tensor, coeffs: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``idx: (B, P)`` int32 raw indices (pad -1) and ``coeffs: (2,)`` uint32
    values ``(a, b)`` -> ``(B, ceil(N/32))`` int32 words: each index maps to
    ``((a*idx + b) mod 2^32) mod N`` (``map_indices`` in hash mode, where
    the dimension d plays no part), then the scatter build."""
    cfg = binsketch.BinSketchConfig(d=1 << 31, n_bins=int(n_bins), mode="hash")
    coeffs = coeffs.to(device=idx.device, dtype=torch.int64) & pk._U32
    return build_sketch_ref(binsketch.map_indices(cfg, coeffs, idx), n_bins)


def band_hash_ref(packed: torch.Tensor, n_bands: int) -> torch.Tensor:
    """``(B, W)`` int32 words -> ``(B, nb_eff)`` int32 band keys (uint32 bits):
    ``core.packed.band_hash``, which widens to int64 and splits the prime."""
    return pk.band_hash(packed, n_bands)


def count_bins_ref(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bins: (B, P)`` int32 mapped bin ids (pad -1) -> ``(B, n_bins)`` int32
    occupancy; ids outside ``[0, n_bins)`` never count."""
    keep = (bins >= 0) & (bins < n_bins)
    safe = torch.where(keep, bins, torch.zeros_like(bins)).to(torch.int64)
    out = torch.zeros((bins.shape[0], n_bins), dtype=torch.int32, device=bins.device)
    return out.scatter_add_(1, safe, keep.to(torch.int32))


def rebucket_ref(packed: torch.Tensor, n_bins: int, n_bins_new: int) -> torch.Tensor:
    """``(B, ceil(N/32))`` int32 words at N bins -> ``(B, ceil(N'/32))`` at
    ``N' <= N``, bin ``j`` ORed into ``j mod N'``.

    Chunk ``q`` of N' source bits is two word slices funnel-shifted by
    ``q*N' mod 32``; in int64 a shift by 32 is defined (it gives bits the
    final mask drops), so ``s == 0`` needs no branch. Source bits ``>= N``
    are zeroed first, output bits ``>= N'`` last."""
    b, w = packed.shape
    w_new = pk.num_words(n_bins_new)
    n_chunks = -(-n_bins // n_bins_new)
    src = packed.to(torch.int64) & pk._U32
    if n_bins % 32:
        src[:, -1] &= (1 << (n_bins % 32)) - 1
    w_need = ((n_chunks - 1) * n_bins_new) // 32 + w_new + 1
    src = torch.nn.functional.pad(src, (0, max(w_need - w, 0)))
    acc = torch.zeros((b, w_new), dtype=torch.int64, device=packed.device)
    for q in range(n_chunks):
        lo, s = divmod(q * n_bins_new, 32)
        acc |= (src[:, lo : lo + w_new] >> s) | (src[:, lo + 1 : lo + 1 + w_new] << (32 - s))
    bits_left = n_bins_new - 32 * torch.arange(w_new, dtype=torch.int64, device=packed.device)
    mask = torch.where(bits_left >= 32, torch.full_like(bits_left, pk._U32),
                       (torch.ones_like(bits_left) << bits_left.clamp(0, 31)) - 1)
    return pk._to_int32_bits(acc & mask)


# Cephes coefficients of log(1 + x) on [sqrt(1/2) - 1, sqrt(2) - 1]
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))


def log_f32(x) -> np.ndarray:
    """Natural log of positive float32 values, evaluated step by step in float32.

    The Cephes polynomial that XLA uses for float32 ``log`` on the CPU; each
    step here rounds as XLA's does, which reproduces the reference bit for bit
    on every argument the epilogue can take (0.5 and the integers 1..11047
    were checked exhaustively). A correctly rounded log differs from it by one
    ulp on about 1% of arguments, and the epilogue's cancellation
    (``card_a + card_b - card_u``) turns one ulp into ~5e-5 relative error.
    """
    f = np.float32
    m, e = np.frexp(np.asarray(x, dtype=f))
    m, e = m.astype(f), e.astype(f)
    small = m < f(0.707106781186547524)  # shift m into [sqrt(1/2), sqrt(2))
    m = (m - f(1)) + np.where(small, m, f(0))
    e = e - small.astype(f)
    p = _LOG_P
    x2 = m * m
    x3 = x2 * m
    y, y1, y2 = p[0] * m + p[1], p[3] * m + p[4], p[6] * m + p[7]
    y, y1, y2 = y * m + p[2], y1 * m + p[5], y2 * m + p[8]
    y = (y * x3 + y1) * x3 + y2
    y = y * x3 + e * f(-2.12194440e-4)
    m = (m - x2 * f(0.5)) + y
    return (m + e * f(0.693359375)).astype(f)


@functools.lru_cache(maxsize=16)
def log_ratio_table(n_bins: int) -> Tuple[np.ndarray, float]:
    """``(d, inv)``: ``d[c] = ln(max(N - c', 0.5)) - ln N`` in float32 for every
    count ``c`` in ``[0, N]`` (c' = c clipped to ``[0, N - 0.5]``), and
    ``inv = 1 / log1p(-1/N)``, so that ``card(c) = d[c] * inv``.

    ``ln N`` and ``inv`` are rounded to float32 from float64, as
    ``kernels/popcount_sim.py::_cardinality`` does. Fill and union counts are
    integers in ``[0, N]``, so the epilogue reads this table, on the card and
    off it, instead of taking three logs per pair. Read-only.
    """
    if n_bins < 2:
        raise ValueError(f"the estimator epilogue needs n_bins >= 2, got {n_bins}")
    f = np.float32
    n = f(n_bins)
    c = np.minimum(np.arange(n_bins + 1, dtype=f), n - f(0.5))
    d = log_f32(np.maximum(n - c, f(0.5))) - f(math.log(n_bins))
    d.setflags(write=False)
    return d, float(f(1.0 / math.log1p(-1.0 / n_bins)))


def _fma(x: torch.Tensor, y, z: torch.Tensor) -> torch.Tensor:
    """float32 ``x * y + z`` rounded once, as a fused multiply-add: the float32
    product is exact in float64, so only the sum rounds (twice, which moves
    the result only on ties, about once in 2^29)."""
    return (x.to(torch.float64) * y + z.to(torch.float64)).to(torch.float32)


def score_epilogue(counts: torch.Tensor, na: torch.Tensor, nb: torch.Tensor,
                   n_bins: int, measure: str) -> torch.Tensor:
    """(Q, C) int32 AND-counts and (Q,), (C,) int32 fills -> (Q, C) float32.

    ``_epilogue`` as XLA compiles it in the reference kernel: the fills'
    estimates ``card_a = d_a * inv`` etc., then ``IP = card_a + card_b -
    card_u`` with the multiply-adds XLA fuses for each measure. The sum
    cancels most of its digits, so those single roundings decide the result
    to ~1e-5; the CUDA kernel uses the same fused multiply-adds.
    """
    if measure == "counts":
        return counts.to(torch.float32)
    if measure not in MEASURES:
        raise ValueError(f"unknown measure {measure!r}")
    table, inv = log_ratio_table(n_bins)
    table = torch.from_numpy(table.copy()).to(counts.device)

    def d(c):
        return table[c.clamp(0, n_bins).to(torch.int64)]

    na = na.to(torch.int32)[:, None]
    nb = nb.to(torch.int32)[None, :]
    d_a, d_b, d_u = torch.broadcast_tensors(d(na), d(nb), d(na + nb - counts))
    card_a, card_b, card_u = d_a * inv, d_b * inv, d_u * inv
    if measure == "cosine":
        ip = torch.clamp_min(_fma(-d_u, inv, card_a + card_b), 0.0)
        return torch.clamp(ip / torch.sqrt(torch.clamp_min(card_a * card_b, 1e-18)), 0.0, 1.0)
    sum_ab = _fma(d_b, inv, card_a)
    if measure == "jaccard":
        ip = torch.clamp_min(sum_ab - card_u, 0.0)
        return torch.clamp(ip / torch.clamp_min(card_u, 1e-9), 0.0, 1.0)
    ip = torch.clamp_min(_fma(-d_u, inv, sum_ab), 0.0)
    if measure == "ip":
        return ip
    return torch.clamp_min(sum_ab - 2.0 * ip, 0.0)  # hamming


def sketch_score_ref(a: torch.Tensor, b: torch.Tensor, n_bins: int,
                     measure: str = "jaccard", *,
                     a_fills: Optional[torch.Tensor] = None,
                     b_fills: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Packed (Q, W) x (C, W) -> (Q, C) float32 similarity (or raw counts)."""
    counts = pk.and_popcount_pairwise(a, b)
    if measure == "counts":
        return counts.to(torch.float32)
    na = a_fills if a_fills is not None else pk.row_popcount(a)
    nb = b_fills if b_fills is not None else pk.row_popcount(b)
    return score_epilogue(counts, na, nb, n_bins, measure)


def select_topk(sc: torch.Tensor, ids: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best (score, id) candidates of each row, by score descending.

    A stable sort keeps the candidates' own order among equal scores, so
    candidates must ascend in id among ties (as a score row or a concatenation
    of id-ordered chunks does). Slots past the candidates, and -inf scores,
    come back as -inf / -1; ids are int32."""
    sc, order = torch.sort(sc, dim=1, descending=True, stable=True)
    ids = torch.gather(ids, 1, order)
    kk = min(int(k), sc.shape[1])
    sc = torch.nn.functional.pad(sc[:, :kk], (0, int(k) - kk), value=-math.inf)
    ids = torch.nn.functional.pad(ids[:, :kk], (0, int(k) - kk), value=-1)
    return sc, torch.where(torch.isneginf(sc), torch.full_like(ids, -1), ids).to(torch.int32)


def sketch_topk_ref(a: torch.Tensor, b: torch.Tensor, n_bins: int,
                    measure: str = "jaccard", *, k: int,
                    a_fills: Optional[torch.Tensor] = None,
                    b_fills: Optional[torch.Tensor] = None,
                    b_valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (Q, k) float32, ids (Q, k) int32), rows ordered by (score desc,
    id asc); masked rows never appear; empty slots hold -inf / -1."""
    q, c = a.shape[0], b.shape[0]
    na = a_fills if a_fills is not None else pk.row_popcount(a)
    nb = b_fills if b_fills is not None else pk.row_popcount(b)
    parts_s = [torch.empty((q, 0), device=a.device)]
    parts_i = [torch.empty((q, 0), dtype=torch.int32, device=a.device)]
    for lo in range(0, c, _TOPK_CHUNK):
        hi = min(lo + _TOPK_CHUNK, c)
        s = sketch_score_ref(a, b[lo:hi], n_bins, measure, a_fills=na, b_fills=nb[lo:hi])
        if b_valid is not None:
            s = torch.where(b_valid[lo:hi][None, :] != 0, s, torch.full_like(s, -math.inf))
        ids = torch.arange(lo, hi, dtype=torch.int32, device=a.device).expand_as(s)
        sc, ix = select_topk(s, ids, min(k, hi - lo))
        parts_s.append(sc)
        parts_i.append(ix)
    # chunks concatenate in ascending id order and each is id-ascending among
    # ties, so the final stable sort keeps the lower id first
    return select_topk(torch.cat(parts_s, dim=1), torch.cat(parts_i, dim=1), k)
