"""Near-duplicate document detection via BinSketch — the paper's flagship
application (§I.C "Scalable Ranking and deduplication of documents").

The counterpart of ``repro.data.dedup``. Documents are token-id *sets*
(sparse binary over the vocabulary), sketched once into a
:class:`~repro_torch.engine.store.SketchStore` (whose ingest-time fill cache
spares every chunk a popcount of the corpus), and the candidate duplicates
are the pairs whose *estimated* Jaccard reaches the threshold. The corpus is
scored against itself a :class:`~repro_torch.engine.planner.QueryPlanner`
chunk at a time through a named backend's ``score`` (the score kernel on
``cuda``). The threshold and the ``i < j`` filter run on the device, and
only the hits cross to the host: a chunk's (1024, n) score matrix is 1.2 GB
at n = 300,000.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import resolve_device
from ..core import BinSketchConfig, make_mapping
from ..engine import QueryPlanner, SketchStore, get_backend

__all__ = ["find_near_duplicates"]


def find_near_duplicates(
    doc_token_sets,
    vocab_size: int,
    threshold: float = 0.9,
    psi: Optional[int] = None,
    rho: float = 0.05,
    seed: int = 0,
    chunk: int = 1024,
    backend="auto",
    *,
    device="cuda",
    mapping: Optional[torch.Tensor] = None,
) -> List[Tuple[int, int, float]]:
    """doc_token_sets: (n, P) padded unique-token rows (pad = -1), numpy or a
    tensor.

    Returns ``[(i, j, js_est)]`` with ``i < j`` and ``js_est >= threshold``,
    in row-major order of the (i, j) score matrix (the reference's
    ``argwhere`` order). ``psi`` defaults to the longest row; ``mapping`` is a
    Ψ table for ``BinSketchConfig.from_sparsity(vocab_size, psi, rho)``, and
    without one the port draws its own from ``seed``. ``device`` defaults to
    the card and raises without one.
    """
    dev = resolve_device(device)
    n = int(doc_token_sets.shape[0])
    if psi is None:
        psi = int((doc_token_sets >= 0).sum(1).max())
    cfg = BinSketchConfig.from_sparsity(vocab_size, psi, rho)
    if mapping is None:
        mapping = make_mapping(cfg, seed=seed, device=dev)
    elif tuple(mapping.shape) != (cfg.d,):
        raise ValueError(f"Ψ table of shape {tuple(mapping.shape)} for d={cfg.d}")
    be = get_backend(backend)
    store = SketchStore.from_indices(cfg, mapping.to(dev), doc_token_sets, backend=be)
    sk, fills = store.sketches, store.fills

    cols = torch.arange(n, device=dev)
    found_i, found_j, found_s = [], [], []
    planner = QueryPlanner(min_batch=min(chunk, 8), max_batch=max(chunk, 8))
    for piece in planner.plan(n):
        lo, hi = piece.start, piece.start + piece.rows
        q, qf = sk[lo:hi], fills[lo:hi]
        if piece.padded > piece.rows:  # pad to the planner bucket: the pad
            # rows are zero sketches and are cut before the threshold
            pad = piece.padded - piece.rows
            q = torch.nn.functional.pad(q, (0, 0, 0, pad))
            qf = torch.nn.functional.pad(qf, (0, pad))
        sims = be.score(q, sk, cfg.n_bins, "jaccard",
                        q_fills=qf, corpus_fills=fills)[: piece.rows]
        hit = (sims >= threshold) & (cols[None, :] > cols[lo:hi, None])
        qi, cj = torch.nonzero(hit, as_tuple=True)  # row-major, as argwhere
        found_i.append(qi + lo)
        found_j.append(cj)
        found_s.append(sims[qi, cj])
    if not found_i:
        return []
    i, j, s = (torch.cat(t).cpu() for t in (found_i, found_j, found_s))
    return list(zip(i.tolist(), j.tolist(), s.tolist()))
