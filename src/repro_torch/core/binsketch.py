"""BinSketch (Pratap, Bera, Revanuru 2019) — core sketching primitives.

Definition 4: a random map ``pi: [d] -> [N]``; ``a_s[j] = OR_{i: pi(i)=j} a[i]``.

Two mapping modes, as in ``repro.core.binsketch``:
  * ``table``: ``pi`` is an explicit ``(d,)`` int32 tensor of bins.
  * ``hash``: multiply-shift ``((a * i + b) mod 2^32) mod N``; the two
    coefficients are held as an int64 ``(2,)`` tensor of uint32 values.

Sketches come back packed (int32 words, see :mod:`repro_torch.core.packed`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from . import packed as pk

__all__ = [
    "BinSketchConfig",
    "theorem1_N",
    "make_mapping",
    "map_indices",
    "sketch_indices",
    "sketch_indices_dense",
]


def theorem1_N(psi: int, rho: float = 0.1) -> int:
    """Sketch length from Theorem 1: ``N = psi * sqrt((psi / 2) * ln(2 / rho))``."""
    if psi < 1:
        raise ValueError(f"sparsity psi must be >= 1, got {psi}")
    if not 0.0 < rho < 1.0:
        raise ValueError(f"failure probability rho must be in (0, 1), got {rho}")
    return int(math.ceil(psi * math.sqrt(psi / 2.0 * math.log(2.0 / rho))))


@dataclasses.dataclass(frozen=True)
class BinSketchConfig:
    """Static configuration of one BinSketch instance."""

    d: int  # original dimension
    n_bins: int  # sketch length N
    mode: str = "table"  # "table" | "hash"

    def __post_init__(self):
        if self.mode not in ("table", "hash"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.n_bins < 1:
            raise ValueError("n_bins must be >= 1")

    @property
    def n_words(self) -> int:
        return pk.num_words(self.n_bins)

    @staticmethod
    def from_sparsity(d: int, psi: int, rho: float = 0.1, mode: str = "table") -> "BinSketchConfig":
        return BinSketchConfig(d=d, n_bins=theorem1_N(psi, rho), mode=mode)


def make_mapping(cfg: BinSketchConfig, seed: int = 0, device="cuda") -> torch.Tensor:
    """Draw the random map pi from a seeded CPU ``torch.Generator``.

    ``table`` mode: ``(d,)`` int32 of uniform bins. ``hash`` mode: ``(2,)``
    int64 multiply-shift coefficients ``(a|1, b)``, each in ``[0, 2^32)``.
    The draw is made on the CPU, so one seed gives one map on every device;
    it does not reproduce ``jax.random`` (pass the reference's table through
    :func:`repro_torch.convert.mapping_from_reference` for that).
    """
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    if cfg.mode == "table":
        m = torch.randint(0, cfg.n_bins, (cfg.d,), generator=gen, dtype=torch.int32)
    else:
        m = torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64)
        m[0] |= 1  # odd multiplier, as in the reference
    return m.to(dev)


def map_indices(cfg: BinSketchConfig, mapping: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pi(idx) for int32 index tensors; negative indices (padding) map to -1."""
    valid = idx >= 0
    safe = torch.where(valid, idx, torch.zeros_like(idx)).to(torch.int64)
    if cfg.mode == "table":
        bins = mapping[safe]
    else:
        # a < 2^32 and 0 <= safe < 2^31, so a*safe + b < 2^63: exact in int64
        h = (mapping[0] * safe + mapping[1]) & 0xFFFFFFFF
        bins = (h % cfg.n_bins).to(torch.int32)
    return torch.where(valid, bins, torch.full_like(bins, -1))


def sketch_indices_dense(cfg: BinSketchConfig, mapping: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sketch padded sparse rows ``idx: (B, P)`` (pad = -1) -> dense ``(B, N)`` uint8.

    Scatter construction — the plain reference path."""
    bins = map_indices(cfg, mapping, idx)
    keep = bins >= 0
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None].expand_as(bins)
    dense = torch.zeros((idx.shape[0], cfg.n_bins), dtype=torch.uint8, device=idx.device)
    dense[rows[keep], bins[keep].to(torch.int64)] = 1
    return dense


def sketch_indices(cfg: BinSketchConfig, mapping: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Sketch padded sparse rows ``idx: (B, P)`` -> packed ``(B, W)`` int32 words."""
    return pk.pack_bits(sketch_indices_dense(cfg, mapping, idx))
