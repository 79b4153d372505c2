"""Backend protocol + registry for the sketch engine.

A backend owns the data path behind one name — *sketch* (construction),
*count* (the counting head's per-bin occupancy), *score* (AND-popcount +
estimator epilogue), *topk* (score -> k best per query), *rebucket* (the
N -> N' fold that meets distilled segments) and *band_hash* (the banded
prefilter's LSH keys):

  * ``reference``     plain PyTorch (scatter build, materialized scoring, a
                      chunked top-k) — the counterpart of the JAX ``oracle``.
  * ``cuda``          the Hopper kernels of :mod:`repro_torch.hopper` — the
                      counterpart of the JAX ``pallas`` backend.
  * ``auto``          alias for ``cuda``.

Further names come in through :func:`register_backend`.

Results follow one order: score descending, ties to the lower doc id;
``corpus_valid`` masks rows out; slots past the retrievable corpus hold
score -inf / id -1. ``torch.topk`` promises no order among ties, so every
top-k here is a stable sort over ascending ids.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Protocol, Tuple

import torch

from ..core import binsketch, counting, estimators, packed as pk
from ..hopper import ops, ref

__all__ = ["Backend", "ReferenceBackend", "CudaBackend", "available_backends",
           "get_backend", "register_backend"]


class Backend(Protocol):
    """The sketch data path behind one name."""

    name: str

    def sketch(self, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
        """(B, P) padded sparse rows -> (B, W) packed int32 words."""
        ...

    def count(self, cfg: binsketch.BinSketchConfig, mapping: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
        """(B, P) padded sparse rows -> (B, N) int32 per-bin occupancy;
        ``counters > 0`` packs to exactly what :meth:`sketch` returns."""
        ...

    def score(self, q: torch.Tensor, corpus: torch.Tensor, n_bins: int, measure: str, *,
              q_fills: Optional[torch.Tensor] = None,
              corpus_fills: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Packed (Q, W) x (C, W) -> (Q, C) float32 similarity; ``None`` fills
        are popcounted by the backend."""
        ...

    def topk(self, q: torch.Tensor, corpus: torch.Tensor, n_bins: int, measure: str,
             k: int, *, q_fills: Optional[torch.Tensor] = None,
             corpus_fills: Optional[torch.Tensor] = None,
             corpus_valid: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Packed (Q, W) x (C, W) -> (scores (Q, k), ids (Q, k) int32)."""
        ...

    def rebucket(self, packed: torch.Tensor, n_bins: int, n_bins_new: int) -> torch.Tensor:
        """Packed (B, W) rows at ``n_bins`` -> (B, W') rows at the smaller
        ``n_bins_new``, bin ``j`` ORed into ``j mod n_bins_new``: the sketch
        under ``pi mod n_bins_new``."""
        ...

    def band_hash(self, packed: torch.Tensor, n_bands: int) -> torch.Tensor:
        """Packed (B, W) rows -> (B, nb_eff) LSH band keys (int32 holding
        uint32 bits). Band ``t`` hashes words ``[t*wpb, (t+1)*wpb)``, ``wpb =
        ceil(W / n_bands)``; two rows collide on a band iff that word group
        is identical. ``n_bands`` clamps to W: size off the output."""
        ...


def _sorted_topk(s: torch.Tensor, k: int, corpus_valid: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k best columns of a materialized (Q, C) score matrix, (score desc,
    column asc), masked columns dropped, the tail padded with -inf / -1."""
    if corpus_valid is not None:
        s = torch.where(corpus_valid[None, :] != 0, s, torch.full_like(s, -math.inf))
    cols = torch.arange(s.shape[1], dtype=torch.int32, device=s.device).expand_as(s)
    return ref.select_topk(s, cols, k)


class ReferenceBackend:
    """Plain PyTorch path (the JAX package's ``oracle`` backend).

    ``topk`` scores ``topk_chunk`` corpus rows at a time, keeps k per chunk and
    merges once, so the transient is O(Q·chunk); below ``topk_crossover`` rows
    it materializes once and sorts. Both give the same result.
    """

    name = "reference"
    topk_chunk = 4096  # corpus rows scored per chunk in the chunked top-k
    topk_crossover = 4096  # below: one materialized sort, no chunk merge

    def sketch(self, cfg, mapping, idx):
        return binsketch.sketch_indices(cfg, mapping, idx)

    def count(self, cfg, mapping, idx):
        return counting.count_indices_dense(cfg, mapping, idx)

    def score(self, q, corpus, n_bins, measure, *, q_fills=None, corpus_fills=None):
        return estimators.pairwise_similarity(
            q, corpus, n_bins, measure, a_fills=q_fills, b_fills=corpus_fills)

    def topk(self, q, corpus, n_bins, measure, k, *, q_fills=None,
             corpus_fills=None, corpus_valid=None):
        nq, c = q.shape[0], corpus.shape[0]
        if c == 0:
            return (torch.full((nq, k), -math.inf, device=q.device),
                    torch.full((nq, k), -1, dtype=torch.int32, device=q.device))
        qf = q_fills if q_fills is not None else pk.row_popcount(q)
        if c < self.topk_crossover:
            s = self.score(q, corpus, n_bins, measure, q_fills=qf, corpus_fills=corpus_fills)
            return _sorted_topk(s, k, corpus_valid)
        parts_s, parts_i = [], []
        for lo in range(0, c, self.topk_chunk):
            hi = min(lo + self.topk_chunk, c)
            cf = corpus_fills[lo:hi] if corpus_fills is not None else None
            s = self.score(q, corpus[lo:hi], n_bins, measure, q_fills=qf, corpus_fills=cf)
            cv = corpus_valid[lo:hi] if corpus_valid is not None else None
            sc, ix = _sorted_topk(s, min(k, hi - lo), cv)
            parts_s.append(sc)
            parts_i.append(torch.where(ix >= 0, ix + lo, ix))
        # parts are in ascending id order: a stable sort keeps the lower id first
        return ref.select_topk(torch.cat(parts_s, dim=1), torch.cat(parts_i, dim=1), k)

    def rebucket(self, packed, n_bins, n_bins_new):
        return pk.fold_packed(packed, n_bins, n_bins_new)

    def band_hash(self, packed, n_bands):
        return pk.band_hash(packed, n_bands)


class CudaBackend:
    """The Hopper kernels (the JAX package's ``pallas`` backend).

    ``topk_crossover``: below this corpus-row count :meth:`topk` scores the
    whole (Q, C) matrix with the score kernel and sorts it; from it up, the
    streaming top-k kernel runs and the matrix is never stored. Both give the
    same result. ``k`` above the streaming kernel's limit takes the first arm
    too. Set ``topk_crossover = 0`` to stream at every size.
    """

    name = "cuda"
    topk_crossover = 8192

    def sketch(self, cfg, mapping, idx):
        bins = binsketch.map_indices(cfg, mapping, idx)
        return ops.build_sketch(bins, cfg.n_bins)

    def count(self, cfg, mapping, idx):
        bins = binsketch.map_indices(cfg, mapping, idx)
        return ops.count_bins(bins, cfg.n_bins)

    def score(self, q, corpus, n_bins, measure, *, q_fills=None, corpus_fills=None):
        return ops.sketch_score(q, corpus, n_bins, measure,
                                a_fills=q_fills, b_fills=corpus_fills)

    def topk(self, q, corpus, n_bins, measure, k, *, q_fills=None,
             corpus_fills=None, corpus_valid=None):
        c = corpus.shape[0]
        if 0 < c and (c < self.topk_crossover or k > ops.MAX_K):
            s = self.score(q, corpus, n_bins, measure, q_fills=q_fills,
                           corpus_fills=corpus_fills)
            return _sorted_topk(s, k, corpus_valid)
        return ops.sketch_topk(q, corpus, n_bins, measure, k=int(k), a_fills=q_fills,
                               b_fills=corpus_fills, b_valid=corpus_valid)

    def rebucket(self, packed, n_bins, n_bins_new):
        return ops.rebucket(packed, int(n_bins), int(n_bins_new))

    def band_hash(self, packed, n_bands):
        return ops.band_hash(packed, int(n_bands))


_REGISTRY: Dict[str, Callable[[], Backend]] = {}


def register_backend(name: str, factory: Callable[[], Backend]) -> None:
    """Make ``get_backend(name)`` return ``factory()``; a name registered
    again takes the new factory."""
    _REGISTRY[name] = factory


def available_backends():
    return sorted(_REGISTRY)


def get_backend(name=None) -> Backend:
    """Resolve a backend by name; ``None``/"auto" -> the Hopper kernels.
    A Backend instance passes through."""
    if name is None:
        name = "auto"
    if isinstance(name, str):
        try:
            return _REGISTRY[name]()
        except KeyError:
            raise ValueError(f"unknown backend {name!r}; have {available_backends()}") from None
    return name


register_backend("reference", ReferenceBackend)
register_backend("cuda", CudaBackend)
register_backend("auto", CudaBackend)
