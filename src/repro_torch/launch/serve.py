"""Sketch-serving driver — the paper's ranking experiment (§IV-B) as a service.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --mutate-rate 0.3 --distill 212,106
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --prefilter --bands 8

``repro.launch.serve`` on the port: generate the corpus, size N by Theorem 1,
draw the Ψ table, stream the corpus into the store in ``--ingest-batch``
chunks (fills enter the cache once, at ingest), answer ragged query batches
through the engine's planner and ``Backend.topk``, and report build and serve
throughput and recall@k against exact Jaccard.

With ``--mutate-rate r`` (or ``--ttl`` / ``--distill``) the engine is built
over a :class:`~repro_torch.engine.segments.SegmentedStore` and a mutation
phase runs before serving: the build is sealed, half of ``r*n`` docs are
deleted and half updated with fresh content, the head is sealed again and the
sealed segments compacted. ``--distill N1,N2,...`` then folds the sealed
segments down those width tiers and serving is mixed-width; the queries are
also served once before distilling, so recall is reported on both sides of
the fold. Recall is always over the surviving catalog. The lifecycle clock
ticks once per ingest batch: birth stamps, ``--ttl`` and ``--distill-age``
are in those ticks. ``--prefilter`` (which implies the mutable store) arms
the banded LSH prefilter with ``--bands`` bands: sealed segments of 256 rows
or more grow bucket indexes, queries score only colliding buckets, and a
``prefilter:`` line reports the last batch's candidate accounting. All the
work is in :func:`serve`; :func:`main` only reads the flags.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import BinSketchConfig, make_mapping
from ..data.synthetic import DATASETS, DatasetSpec, generate_corpus
from ..engine import BandPolicy, DistillPolicy, QueryPlanner, SketchEngine
from ..obs.probe import exact_topk

__all__ = ["main", "recall_at", "serve"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_queries(engine: SketchEngine, q_rows: np.ndarray, topk: int, batch: int,
                   now: Optional[float]):
    """Query ``q_rows`` in batches; returns (scores, ids) as numpy and seconds."""
    t0 = time.perf_counter()
    all_s, all_i = [], []
    for s in range(0, len(q_rows), batch):
        sc, ids = engine.query(q_rows[s : s + batch], topk, now=now)
        all_s.append(sc)
        all_i.append(ids)
    ids = torch.cat(all_i).cpu().numpy()  # the copy waits for the device
    seconds = time.perf_counter() - t0
    return torch.cat(all_s).cpu().numpy(), ids, seconds


def recall_at(ids: np.ndarray, truth_ids: np.ndarray, topk: int) -> float:
    """Share of the exact top-``topk`` ids found in the served ``ids``."""
    hits = sum(len(set(ids[i].tolist()) & set(truth_ids[i].tolist())) for i in range(len(ids)))
    return hits / (len(ids) * topk)


def serve(spec: DatasetSpec, *, queries: int = 64, topk: int = 10, rho: float = 0.05,
          batch: int = 32, ingest_batch: int = 1024, backend: str = "auto",
          device="cuda", mapping: Optional[torch.Tensor] = None,
          mutate_rate: float = 0.0, seal_rows: Optional[int] = None,
          ttl: Optional[float] = None, distill: Optional[Sequence[int]] = None,
          distill_age: Optional[float] = None, prefilter: bool = False,
          bands: int = 8) -> dict:
    """Build a store over ``spec``'s corpus (seed 0), optionally mutate and
    distill it, serve ``queries`` surviving docs (seed 1) in batches of
    ``batch``, and check recall@``topk``.

    ``mapping`` replaces the seeded Ψ draw (the tests pass the JAX package's
    table). ``prefilter`` arms the banded prefilter with ``bands`` bands (and
    the mutable store). Returns the numbers printed plus the engine, the
    corpus, the surviving catalog, the query rows and their doc ids, their
    exact top-k ids and the served scores and ids; with ``distill``,
    ``pre_distill`` holds the same readings from before the fold and the
    sealed segments as they were; with ``prefilter``, ``prefilter_stats`` the
    last batch's candidate accounting."""
    dev = resolve_device(device)
    idx, lens = generate_corpus(spec, seed=0)
    n = idx.shape[0]
    mutable = mutate_rate > 0.0 or ttl is not None or distill is not None or prefilter
    print(f"corpus: {n} docs, d={spec.d}, psi={spec.max_nnz}"
          + (f", mutate-rate={mutate_rate}" if mutable else ""))
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), rho)
    print(f"sketch: N={cfg.n_bins} bins ({cfg.n_words} words, "
          f"{cfg.n_words * 4} B/doc vs {int(lens.mean()) * 4} B raw avg)")
    if mapping is None:
        mapping = make_mapping(cfg, seed=0, device=dev)
    engine = SketchEngine.build(
        cfg, mapping.to(dev), backend=backend,
        planner=QueryPlanner(min_batch=8, max_batch=max(batch, 8)), capacity=n,
        mutable=mutable, seal_rows=seal_rows, ttl=ttl,
        band_policy=BandPolicy(n_bands=bands, min_rows=256) if prefilter else None)
    if prefilter:
        pol = engine.store.band_policy
        print(f"prefilter: {pol.n_bands} bands, escape hatch at "
              f"{pol.max_candidate_frac:.0%} candidates, segments under "
              f"{pol.min_rows} rows stay unindexed")

    t0 = time.perf_counter()
    tick = 0  # the lifecycle clock: one tick per ingest batch
    born = {}
    for s in range(0, n, ingest_batch):  # streaming ingest
        ids = engine.add(idx[s : s + ingest_batch], batch=ingest_batch, now=float(tick))
        if mutable:
            born.update(dict.fromkeys(ids, tick))
        tick += 1
    _sync(dev)
    t_build = time.perf_counter() - t0
    print(f"build: {t_build:.2f}s ({n / t_build:.0f} docs/s, "
          f"backend={engine.backend.name}, device={dev}, fill cache primed at ingest)")
    out = {"n_docs": n, "n_bins": cfg.n_bins, "n_words": cfg.n_words,
           "build_s": t_build, "docs_per_s": n / t_build}

    serve_now = None
    if mutable:
        # content per live doc id, kept in step with every mutation, so that
        # the exact ground truth covers the surviving catalog
        contents = dict(enumerate(idx))
        rng = np.random.default_rng(7)
        n_mut = int(round(mutate_rate * n))
        victims = rng.choice(n, n_mut, replace=False) if n_mut else np.array([], int)
        dele, upd = victims[: n_mut // 2], victims[n_mut // 2 :]
        fresh_idx, _ = generate_corpus(spec, seed=1)

        t0 = time.perf_counter()
        engine.seal()  # freeze the build; deletions hit tombstone bitmaps
        if len(dele):
            engine.delete(dele.tolist())
        if len(upd):
            engine.update(upd.tolist(), fresh_idx[upd], now=float(tick))
        engine.seal()
        stats = engine.compact()
        _sync(dev)
        t_mut = time.perf_counter() - t0
        for g in dele:
            contents.pop(int(g))
            born.pop(int(g))
        for g in upd:
            contents[int(g)] = fresh_idx[g]
            born[int(g)] = tick
        print(f"mutate: {len(dele)} deleted, {len(upd)} updated, sealed + compacted "
              f"{stats['rows_in']}->{stats['rows_out']} rows in {t_mut:.2f}s "
              f"({n_mut / max(t_mut, 1e-9):.0f} mutations/s); live={engine.store.size}")
        out.update(n_deleted=len(dele), n_updated=len(upd), mutate_s=t_mut,
                   mutations_per_s=n_mut / max(t_mut, 1e-9))

        serve_now = float(tick + 1)
        if ttl is not None:  # lazily expired docs leave the catalog too
            dead = [g for g, b in born.items() if b + ttl <= serve_now]
            for g in dead:
                contents.pop(g)
                born.pop(g)
            print(f"ttl: {len(dead)} docs older than {ttl} ticks at serve time "
                  f"(now={serve_now}) masked lazily — no sweep ran")
        surv_ids = np.asarray(sorted(contents))
        surv_rows = np.stack([contents[int(g)] for g in surv_ids])
    else:  # no mutation phase: the catalog is the corpus, verbatim
        surv_ids, surv_rows = np.arange(n), idx

    rng = np.random.default_rng(1)
    n_queries = min(queries, len(surv_ids))
    if n_queries < queries:
        print(f"(clamping queries {queries} -> {n_queries}: only {len(surv_ids)} docs "
              "survive the mutation phase)")
    q_pick = rng.choice(len(surv_ids), n_queries, replace=False)
    q_rows = surv_rows[q_pick]
    truth_ids = surv_ids[exact_topk(surv_rows, q_rows, topk, device=dev)]

    if distill:
        sc, ids, t_serve = _serve_queries(engine, q_rows, topk, batch, serve_now)
        recall = recall_at(ids, truth_ids, topk)
        print(f"recall@{topk} vs exact Jaccard over survivors, before distillation: "
              f"{recall:.3f}")
        out["pre_distill"] = {"recall": recall, "scores": sc, "ids": ids, "serve_s": t_serve,
                              "queries_per_s": n_queries / t_serve,
                              "segments": list(engine.store.sealed)}
        policy = DistillPolicy(widths=tuple(int(w) for w in distill), min_age=distill_age)
        t0 = time.perf_counter()
        n_tiers = 0  # one pass per tier; None once nothing is eligible
        while engine.distill(policy, now=float(tick)):
            n_tiers += 1
        _sync(dev)
        t_dist = time.perf_counter() - t0
        by_w = {}
        live_bytes = sealed_live = 0
        for seg in engine.store.sealed:
            w = seg.n_bins or cfg.n_bins
            by_w[w] = by_w.get(w, 0) + 1
            live_bytes += seg.n_live * ((w + 31) // 32) * 4
            sealed_live += seg.n_live
        bytes_per_doc = live_bytes / max(sealed_live, 1)
        print(f"distill: {n_tiers} tier pass(es) in {t_dist:.2f}s -> segments by width "
              f"{sorted(by_w.items(), reverse=True)}, {bytes_per_doc:.1f} B/doc over "
              f"{sealed_live} sealed docs (base width: {cfg.n_words * 4} B/doc); serving "
              "is mixed-width from here")
        out.update(distill_s=t_dist, n_tiers=n_tiers, bytes_per_doc=bytes_per_doc)

    sc, ids, t_serve = _serve_queries(engine, q_rows, topk, batch, serve_now)
    print(f"serve: {n_queries} queries in {t_serve:.2f}s "
          f"({n_queries / t_serve:.0f} q/s, batch={batch})")
    recall = recall_at(ids, truth_ids, topk)
    print(f"recall@{topk} vs exact Jaccard" + (" over survivors" if mutable else "")
          + f": {recall:.3f}")
    if prefilter and engine.last_prefilter_stats is not None:
        st = engine.last_prefilter_stats
        frac = st["cand_rows"] / max(st["seg_rows"], 1)
        print(f"prefilter: {st['banded_segments']} banded / {st['exhaustive_segments']} "
              f"escape-hatch / {st['unindexed_segments']} unindexed segment scan(s) on the "
              f"last batch; candidate fraction {frac:.4f}")
        out["prefilter_stats"] = dict(st)
    out.update(recall=recall, serve_s=t_serve, queries_per_s=n_queries / t_serve,
               engine=engine, corpus=idx, surv_ids=surv_ids, surv_rows=surv_rows,
               queries=q_rows, query_ids=surv_ids[q_pick], truth_ids=truth_ids, scores=sc,
               ids=ids, serve_now=serve_now)
    return out


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
    ap.add_argument("--mutate-rate", type=float, default=0.0,
                    help="fraction of the corpus mutated before serving (half deleted, "
                         "half updated); > 0 builds the mutable segmented store")
    ap.add_argument("--seal-rows", type=int, default=None,
                    help="auto-seal the counting head at this many rows (mutable store)")
    ap.add_argument("--ttl", type=float, default=None,
                    help="mutable store: lazy TTL in ingest-batch ticks; docs older than "
                         "this at serve time drop out of results, no sweep")
    ap.add_argument("--distill", default=None, metavar="N1,N2,...",
                    help="mutable store: after the mutation phase, distill sealed "
                         "segments down these width tiers and serve mixed-width")
    ap.add_argument("--distill-age", type=float, default=None,
                    help="only distill segments whose youngest live doc is at least "
                         "this many ticks old (default: every sealed segment)")
    ap.add_argument("--prefilter", action="store_true",
                    help="mutable store: arm the banded LSH prefilter; sealed segments "
                         "grow bucket indexes and queries score only colliding buckets")
    ap.add_argument("--bands", type=int, default=8,
                    help="bands a sketch for --prefilter (more bands: higher recall, "
                         "larger candidate unions)")
    args = ap.parse_args(argv)
    widths = (tuple(int(w) for w in args.distill.split(",") if w)
              if args.distill else None)
    out = serve(DATASETS[args.dataset], queries=args.queries, topk=args.topk,
                rho=args.rho, batch=args.batch, ingest_batch=args.ingest_batch,
                backend=args.backend, device=args.device, mutate_rate=args.mutate_rate,
                seal_rows=args.seal_rows, ttl=args.ttl, distill=widths,
                distill_age=args.distill_age, prefilter=args.prefilter, bands=args.bands)
    return out["recall"]


if __name__ == "__main__":
    main()
