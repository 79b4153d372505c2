"""Carry state from the JAX package into the port.

The functions take the JAX package's state as plain numpy arrays (the caller
converts with ``np.asarray``) and return the port's. Packed uint32 words become
int32 through ``.view(np.int32)``: the bits, and so every value, stay as they
were. ``torch`` cannot reproduce ``jax.random``, so a Ψ table drawn by
``repro.core.make_mapping`` reaches the port through :func:`mapping_from_reference`.
A mutable store crosses whole through :func:`segmented_store_from_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core import counting, packed as pk
from .core.binsketch import BinSketchConfig
from .engine.banding import BandPolicy
from .engine.segments import _HEAD, SealedSegment, SegmentedStore
from .engine.store import SketchStore

__all__ = [
    "config_from_reference",
    "mapping_from_reference",
    "packed_from_reference",
    "packed_to_reference",
    "segmented_store_from_reference",
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


def segmented_store_from_reference(tree: dict, aux: dict, device="cuda") -> SegmentedStore:
    """A reference ``SegmentedStore.checkpoint_tree()`` as the port's store.

    ``tree`` is the pytree with every leaf already a numpy array, ``aux`` the
    metadata dict. Head counters keep their u16 bits (int16 here), packed words keep
    their bits, distilled segments keep their width (``sealed_n_bins``), and
    the location map and live count are rebuilt from the tombstone bitmaps,
    as the reference's ``restore`` does. A band policy crosses too, and each
    segment's index, which the reference never serializes, is rebuilt from
    its slab (the same rows and hash give the same index)."""
    if aux.get("kind") != "segmented_store":
        raise ValueError(f"not a SegmentedStore snapshot: {aux.get('kind')!r}")
    dev = resolve_device(device)
    cfg = config_from_reference(**aux["cfg"])
    mapping = mapping_from_reference(tree["mapping"], cfg, dev)
    hr = int(aux["head_rows"])
    store = SegmentedStore.create(cfg, mapping, capacity=max(hr, 1),
                                  seal_rows=aux["seal_rows"], ttl=aux.get("ttl"),
                                  band_policy=BandPolicy.from_aux(aux.get("band_policy")))
    store.next_id = int(aux["next_id"])

    def ints(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32).copy()).to(dev)

    ht, h = tree["head"], store.head
    h.counters[:hr] = counting.to_stored(ints(ht["counters"]).reshape(hr, cfg.n_bins))
    h.packed[:hr] = packed_from_reference(ht["packed"], dev).reshape(hr, cfg.n_words)
    h.fills[:hr] = ints(ht["fills"])
    h.sat_dev[:hr] = torch.from_numpy(np.asarray(ht["saturated"], bool).copy()).to(dev)
    h.ids[:hr] = np.asarray(ht["ids"], np.int64)
    h.valid[:hr] = np.asarray(ht["valid"], bool)
    h.born[:hr] = np.asarray(aux["head_born"], np.float64)
    h.exact[:hr] = np.asarray(ht["exact"], bool)
    h.size = hr
    h.is_sorted = bool(np.all(np.diff(h.ids[:hr]) > 0))
    widths = aux.get("sealed_n_bins") or [None] * len(tree["sealed"])
    for st, born, nb in zip(tree["sealed"], aux["sealed_born"], widths):
        n_words = pk.num_words(nb) if nb else cfg.n_words
        sk = packed_from_reference(st["sketches"], dev).reshape(-1, n_words)
        store.sealed.append(SealedSegment(
            sk, ints(st["fills"]), np.array(st["ids"], np.int64), np.array(st["valid"], bool),
            np.asarray(born, np.float64), n_bins=int(nb) if nb else None,
            band_index=store._band_index_for(sk, int(sk.shape[0]))))
    for seg_i in range(len(store.sealed)):
        store._index_segment(seg_i)
    rows = np.nonzero(h.valid[:hr])[0]
    store._loc.update(zip(h.ids[rows].tolist(), ((_HEAD, int(r)) for r in rows)))
    store._n_live = len(store._loc)
    return store
