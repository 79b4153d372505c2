"""Algorithms 1-4: similarity estimators operating on BinSketch sketches.

The same algebra as ``repro.core.estimators``: with
``card(c) = ln(1 - c/N) / ln(1 - 1/N)`` estimating a set's size from its
sketch fill count, the inner-product estimator of Algorithm 1 is
``card(|a_s|) + card(|b_s|) - card(|a_s OR b_s|)``, and ``|a_s OR b_s|``
follows from the AND-popcount by inclusion-exclusion.

Hamming convention: symmetric difference ``|a| + |b| - 2 IP`` by default; the
paper's literal Algorithm 2 (``n_a + n_b - n_ab``) behind
``convention="paper"``. Everything is float32, with the constants ``log N``
and ``log1p(-1/N)`` rounded to float32 and evaluated there, as the reference
does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import packed as pk

__all__ = [
    "cardinality_from_fill",
    "estimates_from_counts",
    "pairwise_counts",
    "pairwise_similarity",
]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cardinality_from_fill(count: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Estimate |a| from the sketch fill count |a_s| (Alg 1 line 3).

    ``card = (ln(N - c) - ln N) / log1p(-1/N)``; a full sketch (c == N) is
    clipped to c = N - 0.5, so the estimate saturates.
    """
    n = float(n_bins)
    n32 = _f32(n, count)
    c = count.to(torch.float32).clamp(0.0, n - 0.5)
    remaining = torch.clamp_min(n32 - c, 0.5)
    return (torch.log(remaining) - torch.log(n32)) / torch.log1p(_f32(-1.0 / n, count))


def estimates_from_counts(
    na_s: torch.Tensor,
    nb_s: torch.Tensor,
    nab_s: torch.Tensor,
    n_bins: int,
    convention: str = "symmetric",
) -> Dict[str, torch.Tensor]:
    """All four estimators from sketch statistics (broadcastable int counts).

    Returns a dict with "ip", "hamming", "jaccard", "cosine".
    """
    n_a = cardinality_from_fill(na_s, n_bins)
    n_b = cardinality_from_fill(nb_s, n_bins)
    union_s = na_s + nb_s - nab_s  # |a_s OR b_s|
    n_union = cardinality_from_fill(union_s, n_bins)

    ip = torch.clamp_min(n_a + n_b - n_union, 0.0)  # Alg 1
    union = torch.clamp_min(n_union, 1e-9)
    if convention == "symmetric":
        hamming = torch.clamp_min(n_a + n_b - 2.0 * ip, 0.0)
    elif convention == "paper":
        hamming = torch.clamp_min(n_a + n_b - ip, 0.0)
    else:
        raise ValueError(f"unknown convention {convention!r}")
    jaccard = torch.clamp(ip / union, 0.0, 1.0)
    cosine = torch.clamp(ip / torch.sqrt(torch.clamp_min(n_a * n_b, 1e-18)), 0.0, 1.0)
    return {"ip": ip, "hamming": hamming, "jaccard": jaccard, "cosine": cosine}


def pairwise_counts(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    a_fills: Optional[torch.Tensor] = None,
    b_fills: Optional[torch.Tensor] = None,
):
    """(|a_s| (Q,), |b_s| (C,), <a_s,b_s> (Q,C)); ``None`` fills popcount here."""
    na = a_fills if a_fills is not None else pk.row_popcount(a_packed)
    nb = b_fills if b_fills is not None else pk.row_popcount(b_packed)
    nab = pk.and_popcount_pairwise(a_packed, b_packed)
    return na, nb, nab


def pairwise_similarity(
    a_packed: torch.Tensor,
    b_packed: torch.Tensor,
    n_bins: int,
    measure: str = "jaccard",
    convention: str = "symmetric",
    *,
    a_fills: Optional[torch.Tensor] = None,
    b_fills: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(Q, C) estimated similarity matrix from packed sketches (plain path)."""
    na, nb, nab = pairwise_counts(a_packed, b_packed, a_fills, b_fills)
    est = estimates_from_counts(na[:, None], nb[None, :], nab, n_bins, convention)
    if measure not in est:
        raise ValueError(f"unknown measure {measure!r}; have {sorted(est)}")
    return est[measure]
