"""SimHash [Charikar 2002] for cosine similarity.

For sparse binary input, bit t of the sketch is
``sign( sum_{i in a} R[i, t] )`` with Rademacher ``R``; ``R[i, t]`` is -1
where the top bit of the multiply-shift hash ``(a_t * i + b_t) mod 2^32`` is
set (``repro.core.baselines.simhash``). The (d, k) sign matrix is never
stored: every one of the B·P·k hash lanes is evaluated, the O(dN) cost of
the paper's Table I. A zero projection gives bit 1, as ``proj >= 0`` does in
the reference.

Estimator: Pr[bit match] = 1 - theta/pi  =>  cos_est = cos(pi*(1 - match)).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ... import resolve_device
from ._hashing import blocks, elements, generator, hash_lanes, odd_pairs

__all__ = ["make_hashes", "sketch_indices", "estimates"]


def make_hashes(k: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """(2, k) int64 per-projection multiply-shift coefficients (row 0 odd)."""
    return odd_pairs(k, generator(seed)).to(resolve_device(device))


def sketch_indices(hashes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Padded sparse rows (B, P) -> (B, k) uint8 sign bits."""
    a, b = hashes[0], hashes[1]
    valid, x = elements(idx.to(hashes.device))
    bsz, p = x.shape
    n_valid = valid.sum(dim=1, dtype=torch.int64)[:, None]
    bits = torch.empty((bsz, a.shape[0]), dtype=torch.uint8, device=x.device)
    for rows, fns in blocks(bsz, p, a.shape[0]):
        h = hash_lanes(x[rows], a[fns], b[fns])
        h >>= 31  # the top bit of a value in [0, 2^32): a logical shift
        h.masked_fill_(~valid[rows, :, None], 0)
        # sum of +-1 over the row = (#valid) - 2 * (#valid with the top bit set)
        bits[rows, fns] = (n_valid[rows] - 2 * h.sum(dim=1) >= 0).to(torch.uint8)
    return bits


def estimates(bits_a: torch.Tensor, bits_b: torch.Tensor) -> Dict[str, torch.Tensor]:
    match = (bits_a == bits_b).to(torch.float32).mean(dim=-1)
    cos = torch.cos(math.pi * (1.0 - match))
    return {"cosine": torch.clamp(cos, -1.0, 1.0)}
