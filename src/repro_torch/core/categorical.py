"""Categorical-data extension of BinSketch (paper §I.A).

label-encode -> one-hot over concatenated per-feature vocabularies -> the
resulting binary vectors have exactly F ones (F = #features) and

    Ham_sym(onehot(u), onehot(v)) = 2 * D(u, v)

where D is the paper's categorical distance (count of differing features):
each differing feature contributes two set-bit mismatches
(``repro.core.categorical``; DESIGN.md §8).

Fitting and the transform are host numpy, copied from the reference
(vocabulary discovery is data-dependent); :meth:`CategoricalEncoder.sketch`
sketches the one-hot rows on the Ψ map's device through
:func:`repro_torch.core.binsketch.sketch_indices`.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from . import binsketch

__all__ = ["CategoricalEncoder", "categorical_distance"]


@dataclasses.dataclass(frozen=True)
class CategoricalEncoder:
    """Per-feature label encoders + offsets into the one-hot index space."""

    vocabs: List[np.ndarray]  # sorted unique values per feature
    offsets: np.ndarray  # (F,) start of each feature's one-hot block
    d: int  # total one-hot dimension

    @staticmethod
    def fit(data: np.ndarray) -> "CategoricalEncoder":
        """data: (n, F) integer/str-codes array."""
        vocabs = [np.unique(data[:, f]) for f in range(data.shape[1])]
        sizes = np.array([len(v) for v in vocabs], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        return CategoricalEncoder(vocabs=vocabs, offsets=offsets, d=int(sizes.sum()))

    def transform(self, data: np.ndarray) -> np.ndarray:
        """(n, F) categorical -> (n, F) one-hot *index* rows (pad-free)."""
        cols = []
        for f, vocab in enumerate(self.vocabs):
            code = np.searchsorted(vocab, data[:, f])
            code = np.clip(code, 0, len(vocab) - 1)
            # unseen values collapse onto the nearest code; exact for fitted data
            cols.append(self.offsets[f] + code)
        return np.stack(cols, axis=1).astype(np.int32)

    def sketch(self, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
               data: np.ndarray) -> torch.Tensor:
        """(n, F) categorical -> packed (n, W) int32 BinSketches on the
        device of ``mapping``."""
        if cfg.d != self.d:
            raise ValueError(f"config d={cfg.d} != encoder one-hot dim {self.d}")
        idx = torch.from_numpy(self.transform(data)).to(mapping.device)
        return binsketch.sketch_indices(cfg, mapping, idx)


def categorical_distance(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """D(u, v) = #{f : u[f] != v[f]} along the last axis (paper §I.A)."""
    return np.sum(u != v, axis=-1)
