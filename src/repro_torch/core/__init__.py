"""repro_torch.core — packed words, BinSketch construction, its estimators,
the counting variant of the mutable head, the categorical extension
(paper §I.A) and the paper's competitors (``baselines``: BCS, MinHash, DOPH,
OddSketch, SimHash, CBE)."""

from . import baselines, categorical, counting, estimators, packed  # noqa: F401
from .binsketch import (  # noqa: F401
    BinSketchConfig,
    make_mapping,
    map_indices,
    sketch_indices,
    sketch_indices_dense,
    theorem1_N,
)
