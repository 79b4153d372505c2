"""Sketch-serving driver — the paper's ranking experiment (§IV-B) as a service.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu

The main arm of ``repro.launch.serve`` on the port: generate the corpus, size
N by Theorem 1, draw the Ψ table, stream the corpus into an append-only store
in ``--ingest-batch`` chunks (fills enter the cache once, at ingest), answer
ragged query batches through the engine's planner and ``Backend.topk``, and
report build and serve throughput and recall@k against exact Jaccard.
All the work is in :func:`serve`; :func:`main` only reads the flags.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core import BinSketchConfig, make_mapping
from ..data.synthetic import DATASETS, DatasetSpec, generate_corpus
from ..engine import QueryPlanner, SketchEngine
from ..obs.probe import exact_topk

__all__ = ["main", "serve"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(spec: DatasetSpec, *, queries: int = 64, topk: int = 10, rho: float = 0.05,
          batch: int = 32, ingest_batch: int = 1024, backend: str = "auto",
          device="cuda", mapping: Optional[torch.Tensor] = None) -> dict:
    """Build a store over ``spec``'s corpus (seed 0), serve ``queries`` corpus
    rows (seed 1) in batches of ``batch``, and check recall@``topk``.

    ``mapping`` replaces the seeded Ψ draw (the tests pass the JAX package's
    table). Returns the numbers printed plus the engine, the corpus and query
    rows, and the served ids."""
    dev = resolve_device(device)
    idx, lens = generate_corpus(spec, seed=0)
    n = idx.shape[0]
    print(f"corpus: {n} docs, d={spec.d}, psi={spec.max_nnz}")
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), rho)
    print(f"sketch: N={cfg.n_bins} bins ({cfg.n_words} words, "
          f"{cfg.n_words * 4} B/doc vs {int(lens.mean()) * 4} B raw avg)")
    if mapping is None:
        mapping = make_mapping(cfg, seed=0, device=dev)
    engine = SketchEngine.build(
        cfg, mapping.to(dev), backend=backend,
        planner=QueryPlanner(min_batch=8, max_batch=max(batch, 8)), capacity=n)

    t0 = time.perf_counter()
    for s in range(0, n, ingest_batch):  # streaming ingest
        engine.add(idx[s : s + ingest_batch], batch=ingest_batch)
    _sync(dev)
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.2f}s ({n / t_build:.0f} docs/s, "
          f"backend={engine.backend.name}, device={dev}, fill cache primed at ingest)")

    rng = np.random.default_rng(1)
    queries = min(queries, n)
    q_rows = idx[rng.choice(n, queries, replace=False)]
    t0 = time.perf_counter()
    all_ids = []
    for s in range(0, queries, batch):
        _, ids = engine.query(q_rows[s : s + batch], topk)
        all_ids.append(ids)
    ids = torch.cat(all_ids).cpu().numpy()  # the copy waits for the device
    t_serve = time.perf_counter() - t0
    print(f"serve: {queries} queries in {t_serve:.2f}s "
          f"({queries / t_serve:.0f} q/s, batch={batch})")

    truth = exact_topk(idx, q_rows, topk, device=dev)
    hits = sum(len(set(ids[i].tolist()) & set(truth[i].tolist())) for i in range(queries))
    recall = hits / (queries * topk)
    print(f"recall@{topk} vs exact Jaccard: {recall:.3f}")
    return {
        "recall": recall, "n_docs": n, "n_bins": cfg.n_bins, "n_words": cfg.n_words,
        "build_s": t_build, "docs_per_s": n / t_build,
        "serve_s": t_serve, "queries_per_s": queries / t_serve,
        "engine": engine, "corpus": idx, "queries": q_rows, "ids": ids,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tiny", choices=sorted(DATASETS))
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--rho", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ingest-batch", type=int, default=1024,
                    help="streaming ingest chunk size (docs per add)")
    ap.add_argument("--backend", default="auto", help="engine backend: auto | cuda | reference")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of the kernels")
    args = ap.parse_args(argv)
    out = serve(DATASETS[args.dataset], queries=args.queries, topk=args.topk,
                rho=args.rho, batch=args.batch, ingest_batch=args.ingest_batch,
                backend=args.backend, device=args.device)
    return out["recall"]


if __name__ == "__main__":
    main()
