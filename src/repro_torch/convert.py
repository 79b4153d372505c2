"""Carry state from the JAX package into the port.

The functions take the JAX package's state as plain numpy arrays (the caller
converts with ``np.asarray``) and return the port's. Packed uint32 words become
int32 through ``.view(np.int32)``: the bits, and so every value, stay as they
were. ``torch`` cannot reproduce ``jax.random``, so a Ψ table drawn by
``repro.core.make_mapping`` reaches the port through :func:`mapping_from_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.binsketch import BinSketchConfig
from .engine.store import SketchStore

__all__ = [
    "config_from_reference",
    "mapping_from_reference",
    "packed_from_reference",
    "packed_to_reference",
    "store_from_reference",
]


def config_from_reference(d: int, n_bins: int, mode: str = "table") -> BinSketchConfig:
    """The port's config for a reference ``BinSketchConfig(d, n_bins, mode)``."""
    return BinSketchConfig(d=int(d), n_bins=int(n_bins), mode=mode)


def mapping_from_reference(np_mapping, cfg: BinSketchConfig, device="cuda") -> torch.Tensor:
    """A reference Ψ map as the port's: ``(d,)`` int32 table, or the ``(2,)``
    uint32 hash coefficients held as int64."""
    dev = resolve_device(device)
    m = np.asarray(np_mapping)
    if cfg.mode == "table":
        if m.shape != (cfg.d,):
            raise ValueError(f"table mapping must have shape ({cfg.d},), got {m.shape}")
        return torch.from_numpy(m.astype(np.int32)).to(dev)
    if m.shape != (2,):
        raise ValueError(f"hash mapping must have shape (2,), got {m.shape}")
    return torch.from_numpy(m.astype(np.uint32).astype(np.int64)).to(dev)


def packed_from_reference(np_words, device="cuda") -> torch.Tensor:
    """uint32 packed words -> int32 tensor with the same bits."""
    words = np.ascontiguousarray(np.asarray(np_words, dtype=np.uint32))
    return torch.from_numpy(words.view(np.int32).copy()).to(resolve_device(device))


def packed_to_reference(words: torch.Tensor) -> np.ndarray:
    """int32 packed words -> the reference's uint32 numpy array, same bits."""
    return words.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def store_from_reference(cfg: BinSketchConfig, mapping: torch.Tensor, np_uint32_sketches,
                         np_fills, device="cuda") -> SketchStore:
    """A reference store's ``sketches``/``fills`` as a port :class:`SketchStore`."""
    dev = resolve_device(device)
    sketches = packed_from_reference(np_uint32_sketches, dev)
    fills = torch.from_numpy(np.asarray(np_fills, dtype=np.int32).copy()).to(dev)
    if sketches.shape != (fills.shape[0], cfg.n_words):
        raise ValueError(f"sketches {tuple(sketches.shape)} do not fit fills "
                         f"{tuple(fills.shape)} at {cfg.n_words} words")
    return SketchStore(cfg, mapping.to(dev), sketches, fills, int(fills.shape[0]))
