"""repro_torch.data — synthetic corpora (numpy, host side) and sketch-based
near-duplicate search."""

from . import dedup, synthetic  # noqa: F401
from .dedup import find_near_duplicates  # noqa: F401
from .synthetic import DATASETS, DatasetSpec, generate_corpus, generate_similar_pairs  # noqa: F401
