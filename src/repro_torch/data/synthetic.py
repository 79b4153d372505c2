"""Synthetic sparse-binary corpora with the statistics of the paper's datasets.

A verbatim numpy copy of ``repro.data.synthetic``'s corpus and similar-pair
generators (the same seed gives the same rows), kept here so the port imports
nothing of the JAX package. Word frequencies follow a Zipf power law and
document lengths are log-normal; the pair generator builds pairs at a set
Jaccard level for the estimators' error curves. Outputs are padded int32
index matrices (pad = -1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

__all__ = ["DatasetSpec", "DATASETS", "generate_corpus", "generate_similar_pairs"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Statistics mirroring the paper's §IV datasets."""

    name: str
    n_points: int
    d: int
    mean_nnz: int  # typical document length (distinct words)
    max_nnz: int  # sparsity bound psi
    zipf_a: float = 1.3  # word-frequency power-law exponent


DATASETS: Dict[str, DatasetSpec] = {
    # paper: NYTimes n=300000 d=102660 (5000 sampled), Enron n=39861 d=28102,
    # KOS n=3430 d=6906, BBC n=2225 d=9635
    "nytimes": DatasetSpec("nytimes", 5000, 102660, 230, 870),
    "enron": DatasetSpec("enron", 5000, 28102, 90, 680),
    "kos": DatasetSpec("kos", 3430, 6906, 100, 460),
    "bbc": DatasetSpec("bbc", 2225, 9635, 120, 530),
    # small spec for unit tests
    "tiny": DatasetSpec("tiny", 256, 2048, 40, 96),
}


def _zipf_weights(d: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, d + 1, dtype=np.float64) ** a
    return w / w.sum()


def generate_corpus(spec: DatasetSpec, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (idx (n, P) padded int32 [pad=-1], lengths (n,) int32)."""
    rng = np.random.default_rng(seed)
    probs = _zipf_weights(spec.d, spec.zipf_a)
    sigma = 0.5
    mu = np.log(spec.mean_nnz) - sigma**2 / 2
    lengths = np.clip(rng.lognormal(mu, sigma, spec.n_points), 1, spec.max_nnz).astype(np.int32)
    pad = int(spec.max_nnz)
    idx = np.full((spec.n_points, pad), -1, np.int32)
    # vectorized sampling: draw max_nnz words per doc at once, dedupe per row
    draws = rng.choice(spec.d, size=(spec.n_points, pad), p=probs)
    for i in range(spec.n_points):
        uniq = np.unique(draws[i, : lengths[i]])
        idx[i, : len(uniq)] = uniq
        lengths[i] = len(uniq)
    return idx, lengths


def generate_similar_pairs(
    spec: DatasetSpec, jaccard: float, n_pairs: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pairs (a_idx, b_idx) each (n_pairs, P) with E[JS(a,b)] ~= jaccard.

    Construction: |common| = round(J/(1+J) * 2m), each side padded with
    disjoint unique extras to m elements; exact JS = c / (2m - c).
    """
    rng = np.random.default_rng(seed)
    m = spec.mean_nnz
    c = int(round(2 * m * jaccard / (1.0 + jaccard)))
    c = min(c, m)
    extra = m - c
    pad = int(spec.max_nnz)
    a_idx = np.full((n_pairs, pad), -1, np.int32)
    b_idx = np.full((n_pairs, pad), -1, np.int32)
    probs = _zipf_weights(spec.d, spec.zipf_a)
    for i in range(n_pairs):
        words = rng.choice(spec.d, size=c + 2 * extra + 64, replace=False, p=probs)
        words = words[: c + 2 * extra]
        a = np.sort(np.concatenate([words[:c], words[c : c + extra]]))
        b = np.sort(np.concatenate([words[:c], words[c + extra :]]))
        a_idx[i, : len(a)] = a
        b_idx[i, : len(b)] = b
    true_js = c / max(2 * m - c, 1)
    return a_idx, b_idx, np.full(n_pairs, true_js, np.float64)
