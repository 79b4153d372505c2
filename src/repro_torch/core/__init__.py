"""repro_torch.core — packed words, BinSketch construction and its estimators."""

from . import estimators, packed  # noqa: F401
from .binsketch import (  # noqa: F401
    BinSketchConfig,
    make_mapping,
    map_indices,
    sketch_indices,
    sketch_indices_dense,
    theorem1_N,
)
