"""Sketch-serving driver — the paper's ranking experiment (§IV-B) as a service.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --queries 64
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --mutate-rate 0.3 --distill 212,106
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --prefilter --bands 8
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --mutate-rate 0.3 --distill 212,106 --background-compact
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --chaos 0.3 --chaos-seed 1234
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --prefilter --probe 8 --stats-every 1 --metrics-json metrics.json
    PYTHONPATH=src python -m repro_torch.launch.serve --dataset tiny --device cpu \\
        --autopilot --seal-rows 24 --churn-docs 16 --queries 96 --batch 8 \\
        --mutate-rate 0.2 --probe 64 --autopilot-max-segments 8

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
``prefilter:`` line reports the last batch's candidate accounting.

``--background-compact`` runs the post-mutation compaction, and each pass of
the ``--distill`` ladder, as supervised background jobs: queries are served
while they run, against the segments as they stand, and each query batch
first swaps in a finished job; whatever is still pending after the loop is
drained before the report. ``--chaos RATE`` (which implies
``--background-compact``, ``--prefilter`` and, if unset, ``--mutate-rate
0.3``) saves one clean checkpoint, arms a seeded fault plan firing at RATE on
the background jobs, the band index's build and lookup and the checkpoint
writes (torn leaves included), launches the compaction under it, saves
asynchronously during the query loop, and reports the faults fired beside
``engine.health()`` and a restore that walks back to the newest checkpoint
that verifies. The telemetry plane is armed for the whole run (every query
sampled): ``--metrics-json`` writes the final ``engine.metrics()`` snapshot,
``--stats-every`` prints a registry summary every N batches, and ``--probe Q``
runs the online recall probe over Q of the served queries, a gate with
``--probe-baseline`` / ``--probe-tol``.

``--autopilot`` (which implies the mutable store, and ``--seal-rows`` of
``max(n // 16, 64)`` if unset) attaches a
:class:`~repro_torch.engine.lifecycle.LifecycleController` and, before each
query batch, churns the catalog (``--churn-docs K``: K/2 live docs deleted, K
fresh ones added) and ticks the controller once: size-tiered merges
(``--autopilot-fanout``), a distill ladder (``--autopilot-distill``) under a
memory budget (``--autopilot-budget``) and the recall guardrail
(``--probe-baseline``) run from what the store reports, with no explicit
compact or distill. After the loop the controller settles (up to four more
ticks, each after the pending job has landed) and ``--autopilot-max-segments``
gates the sealed-segment count; ``--probe`` then reads the controller's own
probe. Ticks are numbered on the query clock (one a batch), as the lifecycle
clock counts ingest batches. All the work is in :func:`serve`; :func:`main`
only reads the flags (and exits non-zero when the probe's or the segment
count's gate fails).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import faults, obs, resolve_device
from ..checkpoint.manager import CheckpointManager
from ..core import BinSketchConfig, make_mapping
from ..data.synthetic import DATASETS, DatasetSpec, generate_corpus
from ..engine import (BandPolicy, ControllerPolicy, DistillPolicy, JobSupervisor,
                      LifecycleController, QueryPlanner, SegmentedStore, SketchEngine,
                      SupervisionPolicy)
from ..obs.probe import RecallProbe, exact_topk

__all__ = ["main", "recall_at", "serve"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_queries(engine: SketchEngine, q_rows: np.ndarray, topk: int, batch: int,
                   now: Optional[float], maintain: Optional[Callable[[int], None]] = None,
                   on_batch: Optional[Callable] = None, stats_every: int = 0):
    """Query ``q_rows`` in batches; returns (scores, ids) as numpy, seconds and
    the number of batches served while a background job was pending.

    ``maintain(batch_index)`` runs before each batch (the maintenance
    heartbeat of a server: it launches background jobs and saves);
    ``on_batch(engine, rows, scores, ids, pending, now)`` sees each batch's
    answer right after it is served, with the op of the job then pending (or
    None) and the query clock, before anything else touches the store. Every
    ``stats_every`` batches a ``stats:`` line summarises the armed registry."""
    t0 = time.perf_counter()
    all_s, all_i = [], []
    pending_batches = 0
    for bi, s in enumerate(range(0, len(q_rows), batch)):
        if maintain is not None:
            maintain(bi)
        sc, ids = engine.query(q_rows[s : s + batch], topk, now=now)
        pending = getattr(engine.store, "job_pending", None)
        pending_batches += pending is not None
        if on_batch is not None:
            on_batch(engine, q_rows[s : s + batch], sc, ids, pending, now)
        all_s.append(sc)
        all_i.append(ids)
        if stats_every and (bi + 1) % stats_every == 0:
            _print_stats(bi)
    ids = torch.cat(all_i).cpu().numpy()  # the copy waits for the device
    seconds = time.perf_counter() - t0
    return torch.cat(all_s).cpu().numpy(), ids, seconds, pending_batches


def _print_stats(bi: int) -> None:
    """One line of the armed registry: calls, rows, query latency p50/p99,
    mean candidate fraction and degraded counts."""
    snap = obs.metrics.active().snapshot()
    qh = snap["histograms"].get("query.query_s", {})
    cf = snap["histograms"].get("query.candidate_frac", {})
    deg = sum(v for k, v in snap["counters"].items() if k.startswith("degraded."))
    print(f"stats: batch {bi + 1}: calls={snap['counters'].get('query.calls', 0)} "
          f"rows={snap['counters'].get('query.rows', 0)} "
          f"p50={qh.get('p50', 0.0) * 1e3:.1f}ms p99={qh.get('p99', 0.0) * 1e3:.1f}ms "
          f"cand_frac={cf.get('mean', float('nan')):.3f} degraded={deg}")


def _chaos_plan(rate: float, seed: int) -> "faults.FaultPlan":
    """The reference serve's chaos plan: every maintenance and query-path
    point fires at ``rate``; checkpoint leaves tear rather than raise. The
    ``placement.*`` points have no code in this package yet and never fire."""
    spec = faults.FaultSpec("raise", p=rate)
    return faults.FaultPlan({
        "compact.work": spec, "distill.work": spec, "band.build": spec,
        "band.lookup": spec, "placement.build": spec, "placement.refresh": spec,
        "checkpoint.write": spec,
        "checkpoint.leaf": faults.FaultSpec("torn-write", p=rate),
    }, seed=seed)


def recall_at(ids: np.ndarray, truth_ids: np.ndarray, topk: int) -> float:
    """Share of the exact top-``topk`` ids found in the served ``ids``."""
    hits = sum(len(set(ids[i].tolist()) & set(truth_ids[i].tolist())) for i in range(len(ids)))
    return hits / (len(ids) * topk)


def _report_distill(engine: SketchEngine, out: dict, background: bool) -> None:
    """Print the ladder's outcome (segments by width, bytes a doc) and keep
    ``bytes_per_doc`` in ``out``."""
    by_w = {}
    live_bytes = sealed_live = 0
    base = engine.cfg.n_bins
    for seg in engine.store.sealed:
        w = seg.n_bins or base
        by_w[w] = by_w.get(w, 0) + 1
        live_bytes += seg.n_live * ((w + 31) // 32) * 4
        sealed_live += seg.n_live
    out["bytes_per_doc"] = live_bytes / max(sealed_live, 1)
    print(f"distill: {out['n_tiers']} tier pass(es) in {out['distill_s']:.2f}s -> "
          f"segments by width {sorted(by_w.items(), reverse=True)}, "
          f"{out['bytes_per_doc']:.1f} B/doc over {sealed_live} sealed docs (base width: "
          f"{engine.cfg.n_words * 4} B/doc); serving is mixed-width"
          + (" (the queries above straddled the swaps)" if background else " from here"))


class _Autopilot:
    """``serve --autopilot``: the controller, the catalog's churn and the
    settle loop. ``contents`` and ``born`` are serve's catalog, kept in step
    with every churned doc."""

    def __init__(self, engine: SketchEngine, spec: DatasetSpec, contents: dict, born: dict, *,
                 topk: int, churn_docs: int, now0: float, probe: int, policy: ControllerPolicy):
        self.engine, self.contents, self.born = engine, contents, born
        self.topk, self.churn_docs, self.now0 = topk, churn_docs, now0
        pr = RecallProbe(engine, k=topk, sample=probe, seed=0) if probe else None
        self.controller = LifecycleController(engine, policy, probe=pr, probe_feed=self._catalog)
        self.rng = np.random.default_rng(5)
        self.pool, _ = generate_corpus(spec, seed=2)
        self.cursor = 0
        self.tick_ms = []
        print(f"autopilot: controller armed (tier_min_rows={policy.tier_min_rows}, "
              f"fanout={policy.tier_fanout}, distill={list(policy.distill_widths) or 'off'}, "
              f"churn={churn_docs} docs/batch, probe={'on' if pr else 'off'})")

    def _catalog(self):
        ids = np.asarray(sorted(self.contents))
        return ids, np.stack([self.contents[int(g)] for g in ids])

    def _tick(self, now: float) -> Optional[dict]:
        t0 = time.perf_counter()
        report = self.controller.tick(now=now)
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)
        return report

    def step(self, bi: int) -> None:
        """Before query batch ``bi``: delete K/2 live docs (never below
        ``topk`` left), add K fresh ones, then one tick, all at the batch's
        time on the query clock."""
        now = float(self.now0 + bi)
        if self.churn_docs:
            live = sorted(self.contents)
            k_del = min(self.churn_docs // 2, max(len(live) - self.topk, 0))
            if k_del > 0:
                dead = [int(g) for g in self.rng.choice(live, k_del, replace=False)]
                self.engine.delete(dead)
                for g in dead:
                    self.contents.pop(g)
                    self.born.pop(g, None)
            take = self.pool[self.cursor : self.cursor + self.churn_docs]
            if len(take):
                for j, g in enumerate(self.engine.add(take, now=now)):
                    self.contents[int(g)] = take[j]
                    self.born[int(g)] = now
                self.cursor += len(take)
        self._tick(now)

    def heartbeat(self, inner: Optional[Callable[[int], None]]) -> Callable[[int], None]:
        """The serve loop's heartbeat: ``inner`` (background maintenance),
        then :meth:`step`."""
        def beat(bi: int) -> None:
            if inner is not None:
                inner(bi)
            self.step(bi)
        return beat

    def settle(self, now: float, max_segments: Optional[int]) -> dict:
        """Drain the action cascade (a merge can put the next tier over its
        fanout): up to four ticks, each after the pending job has landed;
        then report, and gate the sealed-segment count at ``max_segments``."""
        store = self.engine.store
        for i in range(4):
            store.wait_compaction()  # supervised: never raises a job's error
            r = self._tick(now + i)
            if r is None or r["action"] is None:
                break
        store.wait_compaction()
        cs = self.controller.controller_state()
        nseg = len(store.sealed)
        print(f"autopilot: {cs['ticks']} tick(s): {cs['merges']} merge(s), {cs['distills']} "
              f"distill(s), {cs['probes']} probe launch(es), {cs['guardrail_trips']} guardrail "
              f"trip(s), state={cs['state']}; {nseg} sealed segment(s), live={store.size}")
        ok = max_segments is None or nseg <= max_segments
        if max_segments is not None:
            print(f"autopilot: segment count {nseg} {'<=' if ok else '>'} gate {max_segments}"
                  + ("" if ok else " — GATE FAILED"))
        return {"controller": cs, "segments": nseg, "live": int(store.size), "ok": ok,
                "tick_ms": list(self.tick_ms), "churned": self.cursor}


def serve(spec: DatasetSpec, *, queries: int = 64, topk: int = 10, rho: float = 0.05,
          batch: int = 32, ingest_batch: int = 1024, backend: str = "auto",
          device="cuda", mapping: Optional[torch.Tensor] = None,
          mutate_rate: float = 0.0, seal_rows: Optional[int] = None,
          ttl: Optional[float] = None, distill: Optional[Sequence[int]] = None,
          distill_age: Optional[float] = None, prefilter: bool = False,
          bands: int = 8, background_compact: bool = False, chaos: Optional[float] = None,
          chaos_seed: int = 1234, on_batch: Optional[Callable] = None,
          metrics_json: Optional[str] = None, stats_every: int = 0, probe: int = 0,
          probe_baseline: Optional[float] = None, probe_tol: float = 0.02,
          autopilot: bool = False, churn_docs: int = 8, autopilot_fanout: int = 4,
          autopilot_distill: Sequence[int] = (), autopilot_budget: Optional[int] = None,
          autopilot_max_segments: Optional[int] = None) -> dict:
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
    last batch's candidate accounting. ``background_compact`` runs the
    compaction and the distillation ladder as background jobs during
    serving; ``chaos`` adds the seeded fault plan and the checkpoints (see the
    module docstring) and ``out["chaos"]`` the report; ``out["health"]`` is
    ``engine.health()`` at the end. ``on_batch`` is handed to every query
    loop (:func:`_serve_queries`).

    The telemetry plane is armed for the run (``engine.enable_metrics()``)
    and disarmed on return; ``out["metrics"]`` is the final
    ``engine.metrics()`` snapshot, which ``metrics_json`` also writes as
    JSON. ``stats_every`` prints a registry summary every that many batches.
    ``probe`` runs the online recall probe over up to that many served
    queries after serving; ``out["probe"]`` holds its reading and ``ok``,
    False when the reading is missing or outside ``probe_tol`` of
    ``probe_baseline``. ``autopilot`` runs the lifecycle controller over a
    churning catalog (the module docstring; the other ``autopilot_*`` and
    ``churn_docs`` arguments are its flags); ``out["autopilot"]`` holds the
    controller's state, the settled segment count, whether the
    ``autopilot_max_segments`` gate held (``ok``) and each tick's host
    milliseconds; the recall and the probe are then over the catalog as the
    churn left it."""
    dev = resolve_device(device)
    idx, lens = generate_corpus(spec, seed=0)
    n = idx.shape[0]
    if chaos is not None and chaos > 0.0:
        # chaos needs a mutable lifecycle to fault, and band indexes to break
        mutate_rate = mutate_rate or 0.3
        prefilter = background_compact = True
    else:
        chaos = None
    if autopilot and seal_rows is None:
        seal_rows = max(n // 16, 64)  # segments for the controller to manage
    mutable = (mutate_rate > 0.0 or ttl is not None or distill is not None or prefilter
               or autopilot)
    background = background_compact and mutable
    print(f"corpus: {n} docs, d={spec.d}, psi={spec.max_nnz}"
          + (f", mutate-rate={mutate_rate}" if mutable else ""))
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), rho)
    print(f"sketch: N={cfg.n_bins} bins ({cfg.n_words} words, "
          f"{cfg.n_words * 4} B/doc vs {int(lens.mean()) * 4} B raw avg)")
    if mapping is None:
        mapping = make_mapping(cfg, seed=0, device=dev)
    # the reference serve's supervision knobs under chaos: quick retries, a
    # watchdog, quarantine after three exhausted launches
    supervisor = (JobSupervisor(SupervisionPolicy(max_retries=3, backoff_base=0.02,
                                                  backoff_cap=0.2, deadline=60.0,
                                                  quarantine_after=3, probation=5.0))
                  if chaos else None)
    engine = SketchEngine.build(
        cfg, mapping.to(dev), backend=backend,
        planner=QueryPlanner(min_batch=8, max_batch=max(batch, 8)), capacity=n,
        mutable=mutable, seal_rows=seal_rows, ttl=ttl,
        # chaos lowers min_rows, as the reference does, so that a small
        # corpus's segments get band indexes whose build and lookup can fail
        band_policy=(BandPolicy(n_bands=bands, min_rows=64 if chaos else 256)
                     if prefilter else None),
        supervisor=supervisor)
    # arm the telemetry plane for the run (registry + sampled traces): every
    # query below lands in the stage histograms, and the report reads one
    # snapshot; disarmed on return, so nothing leaks past the run
    engine.enable_metrics()
    try:
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
            # in the background the compaction launches just before serving (and
            # under chaos after the plan arms, so that its faults hit the merge)
            stats = None if background else engine.compact()
            _sync(dev)
            t_mut = time.perf_counter() - t0
            for g in dele:
                contents.pop(int(g))
                born.pop(int(g))
            for g in upd:
                contents[int(g)] = fresh_idx[g]
                born[int(g)] = tick
            compacted = (f"compacted {stats['rows_in']}->{stats['rows_out']} rows" if stats
                         else "compaction to run in the background")
            print(f"mutate: {len(dele)} deleted, {len(upd)} updated, sealed + {compacted} in "
                  f"{t_mut:.2f}s ({n_mut / max(t_mut, 1e-9):.0f} mutations/s); "
                  f"live={engine.store.size}")
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
        query_ids = surv_ids[q_pick]
        truth_ids = surv_ids[exact_topk(surv_rows, q_rows, topk, device=dev)]

        mgr = plan = None
        saves = 0
        if chaos:
            ckpt_dir = tempfile.mkdtemp(prefix="repro-torch-chaos-ckpt-")
            mgr = CheckpointManager(ckpt_dir, keep=8, supervisor=engine.supervisor)
            # one clean generation before the plan arms: the walk-back at the end
            # has a verifying floor to land on however many later saves tear
            engine.store.save(mgr, step=1, blocking=True)
            saves = 1
            plan = faults.install(_chaos_plan(min(chaos, 1.0), chaos_seed))
            print(f"chaos: plan armed at rate={min(chaos, 1.0)} seed={chaos_seed}; "
                  f"checkpoints in {ckpt_dir}")
        if background:
            engine.compact(background=True)

        # the background ladder: a pass launches whenever no job is pending;
        # ladder["policy"] goes None once nothing more is eligible
        ladder = {"policy": None, "passes": 0}

        def maintain(bi: int) -> None:
            nonlocal saves
            engine.poll_compaction()
            pol = ladder["policy"]
            if pol is not None and engine.store.job_pending is None:
                if engine.distill(pol, now=float(tick), background=True):
                    ladder["passes"] += 1
                else:
                    ladder["policy"] = None
            if chaos and bi in (1, 3, 5):  # asynchronous saves under fire
                saves += 1
                engine.store.save(mgr, step=saves, blocking=False)

        heartbeat = maintain if background else None
        pilot = None
        if autopilot:
            pilot = _Autopilot(engine, spec, contents, born, topk=topk, churn_docs=churn_docs,
                               now0=serve_now, probe=probe, policy=ControllerPolicy(
                                   tier_min_rows=max(seal_rows, 1),
                                   tier_fanout=autopilot_fanout,
                                   distill_widths=tuple(autopilot_distill or ()),
                                   memory_budget=autopilot_budget,
                                   # ages count ingest and query batches, as TTL does
                                   cold_age=4.0, probe_baseline=probe_baseline,
                                   probe_tol=probe_tol,
                                   probe_interval=4.0 if probe else None))
        if distill:
            sc, ids, t_serve, _ = _serve_queries(engine, q_rows, topk, batch, serve_now,
                                                 heartbeat, on_batch, stats_every)
            recall = recall_at(ids, truth_ids, topk)
            print(f"recall@{topk} vs exact Jaccard over survivors, before distillation: "
                  f"{recall:.3f}")
            out["pre_distill"] = {"recall": recall, "scores": sc, "ids": ids, "serve_s": t_serve,
                                  "queries_per_s": n_queries / t_serve,
                                  "segments": list(engine.store.sealed)}
            policy = DistillPolicy(widths=tuple(int(w) for w in distill), min_age=distill_age)
            t0 = time.perf_counter()
            if background:
                ladder["policy"] = policy
            else:
                n_tiers = 0  # one pass per tier; None once nothing is eligible
                while engine.distill(policy, now=float(tick)):
                    n_tiers += 1
                _sync(dev)
                out.update(distill_s=time.perf_counter() - t0, n_tiers=n_tiers)
                _report_distill(engine, out, background)

        if pilot is not None:
            heartbeat = pilot.heartbeat(heartbeat)
        sc, ids, t_serve, pending_batches = _serve_queries(engine, q_rows, topk, batch, serve_now,
                                                           heartbeat, on_batch, stats_every)
        print(f"serve: {n_queries} queries in {t_serve:.2f}s "
              f"({n_queries / t_serve:.0f} q/s, batch={batch})")
        if pilot is not None:
            out["autopilot"] = pilot.settle(serve_now + n_queries / max(batch, 1) + 1,
                                            autopilot_max_segments)
            _sync(dev)
            # the churn moved the catalog: recall and the probe read it as it is now
            surv_ids = np.asarray(sorted(contents))
            surv_rows = np.stack([contents[int(g)] for g in surv_ids])
            truth_ids = surv_ids[exact_topk(surv_rows, q_rows, topk, device=dev)]
        if background:
            # drain: the pending job, then the rest of the ladder, one pass at a
            # time (a failed pass ends it, as in the synchronous loop)
            engine.wait_compaction()
            if ladder["policy"] is not None:
                while engine.distill(ladder["policy"], now=float(tick)):
                    ladder["passes"] += 1
            _sync(dev)
            print(f"background: {pending_batches} query batch(es) served while a job was "
                  f"pending; {ladder['passes']} distillation pass(es)")
            out["pending_batches"] = pending_batches
            if distill:
                out.update(distill_s=time.perf_counter() - t0, n_tiers=ladder["passes"])
                _report_distill(engine, out, background)
        if chaos:
            out["chaos"] = _chaos_report(engine, mgr, plan, saves, dev)
        if probe:
            out["probe"] = _run_probe(engine, probe, topk, surv_ids, surv_rows, q_rows,
                                      serve_now, probe_baseline, probe_tol,
                                      pilot.controller.probe if pilot is not None else None)
        recall = recall_at(ids, truth_ids, topk)
        print(f"recall@{topk} vs exact Jaccard" + (" over survivors" if mutable else "")
              + f": {recall:.3f}")
        snap = engine.metrics(now=serve_now)  # one snapshot feeds the rest of the report
        if prefilter and snap.get("prefilter") is not None:
            st = snap["prefilter"]
            frac = st["cand_rows"] / max(st["seg_rows"], 1)
            print(f"prefilter: {st['banded_segments']} banded / {st['exhaustive_segments']} "
                  f"escape-hatch / {st['unindexed_segments']} unindexed segment scan(s) on the "
                  f"last batch; candidate fraction {frac:.4f}")
            out["prefilter_stats"] = dict(st)
        if metrics_json:
            with open(metrics_json, "w") as f:
                json.dump(snap, f, indent=2, sort_keys=True)
            print(f"metrics: snapshot written to {metrics_json} ({len(snap['counters'])} "
                  f"counters, {len(snap['histograms'])} histograms, "
                  f"{len(snap['lifecycle']['segments'])} segment(s))")
        out.update(metrics=snap, health=snap["health"], recall=recall, serve_s=t_serve,
                   queries_per_s=n_queries / t_serve, engine=engine, corpus=idx,
                   surv_ids=surv_ids, surv_rows=surv_rows, queries=q_rows,
                   query_ids=query_ids, truth_ids=truth_ids, scores=sc, ids=ids,
                   serve_now=serve_now)
        return out
    finally:
        obs.disable()


def _run_probe(engine: SketchEngine, sample: int, topk: int, surv_ids, surv_rows, q_rows,
               now: Optional[float], baseline: Optional[float], tol: float,
               pr: Optional[RecallProbe] = None) -> dict:
    """The online recall probe over up to ``sample`` of the served queries,
    waited for; with ``baseline``, a gate of ``|recall - baseline| <= tol``.
    ``pr`` is a probe to reuse (the controller's, so the gate reads the gauge
    the guardrail watched): a round it has in flight is the reading. Returns
    the reading and whether the gate held (``ok``)."""
    pr = pr if pr is not None else RecallProbe(engine, k=topk, sample=sample, seed=0)
    if not (pr.running or pr.launch(surv_ids, surv_rows, queries=q_rows)):
        print("probe: launch refused (op quarantined) — no reading")
        return {"recall": None, "ok": baseline is None}
    got = pr.wait(now=now)
    if got is None:
        print("probe: ground-truth job failed — no reading")
        return {"recall": None, "ok": baseline is None}
    where = "a side stream of the card" if engine.device.type == "cuda" else "the CPU"
    print(f"probe: recall@{pr.k} = {got:.3f} over {min(sample, len(q_rows))} queries "
          f"(ground truth supervised, on {where}; gauge probe.recall)")
    ok = True
    if baseline is not None:
        delta = abs(got - baseline)
        ok = delta <= tol
        print(f"probe: |reading - baseline {baseline:.3f}| = {delta:.3f} "
              f"{'<=' if ok else '>'} tol {tol}" + ("" if ok else " — GATE FAILED"))
    return {"recall": got, "ok": ok}


def _chaos_report(engine: SketchEngine, mgr: CheckpointManager, plan, saves: int,
                  dev: torch.device) -> dict:
    """Disarm the plan, print what it fired beside ``engine.health()``, check
    every generation and restore the newest that verifies into a fresh store
    on ``dev``; the checkpoints are removed after."""
    mgr.wait()  # the last asynchronous save (supervised: never raises)
    faults.clear()
    h = engine.health()
    fired = {p: k for p, k in sorted(plan.counters()["fired"].items()) if k}
    jobs = h["jobs"]
    print(f"chaos: {plan.total_fired} fault(s) injected {fired}")
    print(f"chaos: jobs succeeded={sum(v.get('succeeded', 0) for v in jobs.values())} "
          f"failed={sum(v.get('failed', 0) for v in jobs.values())} retries={h['retries']} "
          f"abandoned={h['abandoned']} quarantined={[q['op'] for q in h['quarantined']]} "
          f"degraded={sorted(d['component'] for d in h['degraded'])}")
    good = mgr.resolve_step(None)
    torn = [st for st in range(1, saves + 1) if not mgr.verify_step(st)]
    restored = SegmentedStore.restore(mgr, device=dev, backend=engine.backend)
    print(f"chaos: {saves} checkpoint generation(s) written, torn or failed: "
          f"{torn if torn else 'none'}; restore walked back to step {good} "
          f"({restored.size} live docs)")
    shutil.rmtree(mgr.root, ignore_errors=True)
    return {"counters": plan.counters(), "fired": fired, "saves": saves, "torn": torn,
            "restored_step": good, "restored_live": restored.size}


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
    ap.add_argument("--background-compact", action="store_true",
                    help="mutable store: run the post-mutation compaction and the "
                         "--distill ladder as background jobs while queries are served")
    ap.add_argument("--chaos", type=float, default=None, metavar="RATE",
                    help="arm a seeded fault plan firing at this per-hit probability on "
                         "the background jobs, band index and checkpoint writes; serve "
                         "with background maintenance and asynchronous checkpoints, then "
                         "report the faults beside health() and a restore walk-back. "
                         "Implies --background-compact, --prefilter and, if unset, "
                         "--mutate-rate 0.3")
    ap.add_argument("--chaos-seed", type=int, default=1234,
                    help="the fault plan's seed for --chaos")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the final SketchEngine.metrics() snapshot to this file as JSON")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="print a one-line telemetry summary every N query batches (0: off)")
    ap.add_argument("--probe", type=int, default=0, metavar="Q",
                    help="after serving, run the online recall probe over up to Q of the "
                         "served queries (ground truth supervised, on the card's side stream "
                         "or the CPU) and report the probe.recall gauge (0: off)")
    ap.add_argument("--probe-baseline", type=float, default=None,
                    help="expected probe recall; with --probe-tol a gate: nonzero exit when "
                         "the reading is missing or further than the tolerance from it")
    ap.add_argument("--probe-tol", type=float, default=0.02,
                    help="allowed |probe recall - baseline| for --probe-baseline")
    ap.add_argument("--autopilot", action="store_true",
                    help="hands-off mode: attach a LifecycleController and tick it once a "
                         "query batch (size-tiered merges, the distill ladder and the recall "
                         "guardrail from what the store reports, no explicit compact or "
                         "distill); implies the mutable store; --churn-docs exercises it")
    ap.add_argument("--churn-docs", type=int, default=8, metavar="K",
                    help="--autopilot: each query batch, delete K/2 live docs and add K fresh "
                         "ones (0: no churn)")
    ap.add_argument("--autopilot-fanout", type=int, default=4,
                    help="--autopilot: segments a size tier holds before it merges "
                         "(ControllerPolicy.tier_fanout)")
    ap.add_argument("--autopilot-distill", default=None, metavar="N1,N2,...",
                    help="--autopilot: the width ladder of controller-driven distillation "
                         "(default: no distillation)")
    ap.add_argument("--autopilot-budget", type=int, default=None, metavar="BYTES",
                    help="--autopilot: sealed-slab bytes above which the ladder runs "
                         "(default: whenever a ladder is given)")
    ap.add_argument("--autopilot-max-segments", type=int, default=None,
                    help="gate: nonzero exit when the sealed-segment count ends above this")
    args = ap.parse_args(argv)

    def widths_of(flag):
        return tuple(int(w) for w in flag.split(",") if w) if flag else None

    widths = widths_of(args.distill)
    out = serve(DATASETS[args.dataset], queries=args.queries, topk=args.topk,
                rho=args.rho, batch=args.batch, ingest_batch=args.ingest_batch,
                backend=args.backend, device=args.device, mutate_rate=args.mutate_rate,
                seal_rows=args.seal_rows, ttl=args.ttl, distill=widths,
                distill_age=args.distill_age, prefilter=args.prefilter, bands=args.bands,
                background_compact=args.background_compact, chaos=args.chaos,
                chaos_seed=args.chaos_seed, metrics_json=args.metrics_json,
                stats_every=args.stats_every, probe=args.probe,
                probe_baseline=args.probe_baseline, probe_tol=args.probe_tol,
                autopilot=args.autopilot, churn_docs=args.churn_docs,
                autopilot_fanout=args.autopilot_fanout,
                autopilot_distill=widths_of(args.autopilot_distill),
                autopilot_budget=args.autopilot_budget,
                autopilot_max_segments=args.autopilot_max_segments)
    if args.probe and not out["probe"]["ok"]:
        raise SystemExit("probe recall gate failed (see 'probe:' lines above)")
    if args.autopilot and not out["autopilot"]["ok"]:
        raise SystemExit("autopilot segment-count gate failed (see 'autopilot:' lines above)")
    return out["recall"]


if __name__ == "__main__":
    main()
