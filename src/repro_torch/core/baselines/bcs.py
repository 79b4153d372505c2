"""BCS (Binary Compressed Sensing-style parity sketch) [Pratap et al. 2018].

Definition 3 of the paper: same random bucketing as BinSketch but the bucket
aggregator is XOR (parity) instead of OR:

    u_s[j] = sum_{i: b(i)=j} u[i]  (mod 2)

Estimator inversion (``repro.core.baselines.bcs``): a bucket receiving w of
the relevant balls is odd with probability ``(1 - (1 - 2/N)^w) / 2``, so a
parity-sketch popcount c inverts to

    w_est = ln(1 - 2 c / N) / ln(1 - 2/N),

in float32. Because XOR is linear, ``u_s XOR v_s`` *is* the BCS sketch of
``u XOR v``, which gives Hamming directly; |u| from |u_s| the same way; IP /
JS / Cos follow from (|u|, |v|, Ham).
"""

from __future__ import annotations

from typing import Dict

import torch

from ... import resolve_device
from .. import packed as pk
from ._hashing import elements, generator

__all__ = ["make_mapping", "sketch_indices", "estimates"]


def make_mapping(d: int, n_bins: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """(d,) int32 uniform buckets in ``[0, n_bins)``."""
    dev = resolve_device(device)
    return torch.randint(0, int(n_bins), (int(d),), generator=generator(seed),
                         dtype=torch.int32).to(dev)


def sketch_indices(mapping: torch.Tensor, n_bins: int, idx: torch.Tensor) -> torch.Tensor:
    """Padded sparse rows (B, P) [pad=-1] -> packed (B, W) int32 parity sketch."""
    valid, x = elements(idx.to(mapping.device))
    bins = mapping[x].to(torch.int64)
    dense = torch.zeros((x.shape[0], int(n_bins)), dtype=torch.int32, device=x.device)
    dense.scatter_add_(1, bins, valid.to(torch.int32))
    return pk.pack_bits((dense & 1).to(torch.uint8))


def _invert(count: torch.Tensor, n_bins: int) -> torch.Tensor:
    n = float(n_bins)
    c = torch.clamp(count.to(torch.float32), 0.0, n / 2.0 - 0.5)
    base = torch.log1p(torch.tensor(-2.0 / n, dtype=torch.float32, device=count.device))
    return torch.log1p(-2.0 * c / n) / base


def estimates(a_packed: torch.Tensor, b_packed: torch.Tensor,
              n_bins: int) -> Dict[str, torch.Tensor]:
    """Per-pair estimates for aligned rows of packed parity sketches."""
    n_a = _invert(pk.row_popcount(a_packed), n_bins)
    n_b = _invert(pk.row_popcount(b_packed), n_bins)
    ham = _invert(pk.row_popcount(a_packed ^ b_packed), n_bins)
    ip = torch.clamp((n_a + n_b - ham) / 2.0, min=0.0)
    union = torch.clamp(n_a + n_b - ip, min=1e-9)
    return {
        "ip": ip,
        "hamming": torch.clamp(ham, min=0.0),
        "jaccard": torch.clamp(ip / union, 0.0, 1.0),
        "cosine": torch.clamp(ip / torch.sqrt(torch.clamp(n_a * n_b, min=1e-18)), 0.0, 1.0),
    }
