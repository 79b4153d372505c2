"""repro_torch.core — packed words, BinSketch construction, its estimators and
the counting variant of the mutable head."""

from . import counting, estimators, packed  # noqa: F401
from .binsketch import (  # noqa: F401
    BinSketchConfig,
    make_mapping,
    map_indices,
    sketch_indices,
    sketch_indices_dense,
    theorem1_N,
)
