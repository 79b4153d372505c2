"""MinHash [Broder et al. 1998] with k multiply-shift hash functions.

``h_i(x) = (a_i * x + b_i) mod 2^32`` with odd ``a_i`` stands in for the
random permutation (``repro.core.baselines.minhash``).

Estimators:
  * Jaccard: collision fraction (Definition 2 / eq. after it).
  * Cosine (via [25]): JS and exact |a|,|b| stored alongside (the asymmetric
    trick of [26]): cos = IP / sqrt(|a||b|), IP = JS/(1+JS) * (|a|+|b|).
  * Inner product (asymmetric MinHash [26]): same IP formula.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ... import resolve_device
from ._hashing import INF, blocks, elements, generator, hash_lanes, odd_pairs

__all__ = ["make_hashes", "sketch_indices", "estimates"]


def make_hashes(k: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """(2, k) int64 multiply-shift coefficients in ``[0, 2^32)``; row 0 odd."""
    return odd_pairs(k, generator(seed)).to(resolve_device(device))


def sketch_indices(hashes: torch.Tensor, idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded sparse rows (B, P) [pad=-1] -> ((B, k) int64 min-hash values in
    ``[0, 2^32)``, an empty row all ``0xFFFFFFFF``; (B,) int32 exact |a|)."""
    a, b = hashes[0], hashes[1]
    valid, x = elements(idx.to(hashes.device))
    bsz, p = x.shape
    vals = torch.empty((bsz, a.shape[0]), dtype=torch.int64, device=x.device)
    for rows, fns in blocks(bsz, p, a.shape[0]):
        h = hash_lanes(x[rows], a[fns], b[fns])
        h.masked_fill_(~valid[rows, :, None], INF)
        vals[rows, fns] = h.amin(dim=1)
    return vals, valid.sum(dim=1, dtype=torch.int32)


def estimates(mh_a: torch.Tensor, mh_b: torch.Tensor, size_a: torch.Tensor,
              size_b: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-pair estimates for aligned rows of (B, k) min-hash sketches."""
    js = (mh_a == mh_b).to(torch.float32).mean(dim=-1)
    sa = size_a.to(torch.float32)
    sb = size_b.to(torch.float32)
    ip = js / torch.clamp(1.0 + js, min=1e-9) * (sa + sb)
    return {
        "jaccard": js,
        "ip": ip,
        "hamming": torch.clamp(sa + sb - 2.0 * ip, min=0.0),
        "cosine": torch.clamp(ip / torch.sqrt(torch.clamp(sa * sb, min=1e-18)), 0.0, 1.0),
    }
