"""Odd Sketch [Mitzenmacher, Pagh, Pham 2014].

Two-step: run k-function MinHash first, then XOR each (i, minhash_i) pair
into an N-bit parity sketch (``repro.core.baselines.oddsketch``). The
MinHash stage really runs, which is why its compression time is the worst
in the paper's Fig. 3.

The pair hash ``pa * (value ^ (slot * 0x9E3779B9)) + pb mod 2^32``
multiplies two full 32-bit words, whose product overflows int64, so it goes
through :func:`repro_torch.core.packed.mul_u32`.

Estimator (their eq. for sets of k samples):
    J_est = 1 + (N / (4k)) * ln(1 - 2 * Ham(odd_a, odd_b) / N)

Parameter heuristic from the paper (§I.B): k = N / (4 (1 - J)) for a
similarity-threshold J, capped (the paper caps at 5500).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ... import resolve_device
from .. import packed as pk
from . import minhash
from ._hashing import U32, draw_u32, generator, odd_pairs

__all__ = ["suggested_k", "make_hashes", "sketch_indices", "estimates"]

_SLOT_MIX = 0x9E3779B9


def suggested_k(n_bins: int, j_threshold: float, cap: int = 5500) -> int:
    k = int(n_bins / (4.0 * max(1.0 - j_threshold, 1e-3)))
    return max(1, min(k, cap))


def make_hashes(k: int, seed: int = 0, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """((2, k) MinHash coefficients, (2,) pair hash ``(pa|1, pb)``), int64."""
    dev = resolve_device(device)
    gen = generator(seed)
    mh = odd_pairs(k, gen)
    pair = draw_u32((2,), gen)
    pair[0] |= 1
    return mh.to(dev), pair.to(dev)


def sketch_indices(hashes, n_bins: int, idx: torch.Tensor) -> torch.Tensor:
    """Padded sparse rows (B, P) -> packed (B, ceil(N/32)) int32 odd sketch."""
    mh_hashes, pair = hashes
    vals, _ = minhash.sketch_indices(mh_hashes, idx)  # (B, k) int64 uint32 values
    k = vals.shape[1]
    # hash the (slot, value) pair into [N]; mixing the slot id in keeps
    # distinct slots with equal values independent
    slot = (torch.arange(k, dtype=torch.int64, device=vals.device) * _SLOT_MIX) & U32
    h = (pk.mul_u32(vals ^ slot, pair[0]) + pair[1]) & U32
    pos = h % int(n_bins)
    dense = torch.zeros((vals.shape[0], int(n_bins)), dtype=torch.int32, device=vals.device)
    dense.scatter_add_(1, pos, torch.ones_like(pos, dtype=torch.int32))
    return pk.pack_bits((dense & 1).to(torch.uint8))


def estimates(odd_a: torch.Tensor, odd_b: torch.Tensor, n_bins: int,
              k: int) -> Dict[str, torch.Tensor]:
    ham = pk.row_popcount(odd_a ^ odd_b).to(torch.float32)
    n = float(n_bins)
    inner = torch.clamp(1.0 - 2.0 * ham / n, 1e-6, 1.0)
    js = 1.0 + n / (4.0 * k) * torch.log(inner)
    return {"jaccard": torch.clamp(js, 0.0, 1.0)}
