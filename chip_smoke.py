#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                    # the full run: 300k-doc corpus
    python3 chip_smoke.py --n-points 20000 --prefilter-docs 65536   # a rehearsal

Phases, each fatal on failure (nothing is caught while the run goes on):

1. The card's name and power limit; every Hopper kernel built with nvcc, one
   process per source, timed; then the rate of the binary tensor-core
   instruction the score and top-k kernels count with (``wgmma
   m64n128k256.s32.b1.b1.and.popc``), timed alone in a loop on operands in
   shared memory, printed beside the card: the operations bound of those
   two kernels.
2. The main path, through the entry points a user calls: ``serve`` over the
   NYTimes-shaped corpus (d=102660, mean length 230, psi=870) at the document
   count of the UCI NYTimes bag-of-words corpus, 300,000, with rho=0.05,
   ingest batches of 16384 and 1024 queries in batches of 256 at k=10; then
   ``score_all`` on 64 of those queries, held against their ``query``
   results. Kernel launch counters are zeroed just before and read just
   after; every kernel must have launched. Recall@10 against exact Jaccard
   must reach 0.3, the floor the JAX driver's test holds it to. ``serve``
   runs with the telemetry plane armed: its ``query.calls`` and
   ``query.rows`` must count the 4 batches and 1024 rows. ``RecallProbe(
   sample=64)`` over the served queries (its ground truth on a side stream
   of the card) must publish exactly the ``recall_at`` of ``serve``'s own
   ids and truth over the same 64 queries. The same queries are then served
   once more, warm, for a steady-state rate, and put through
   :func:`telemetry_checks`: disarmed and armed (every call sampled) the
   answers must be bit-equal, the counters exact, every trace's stages in
   ``STAGES`` order, and under ``torch.profiler`` the ``kernel_score``
   stage total (CUDA events) at least 0.9x the device time of the top-k and
   score kernels the serve launched; warm q/s armed and disarmed and the
   stage totals are printed.
2b. The mutable path, through the same entry point: ``serve`` over the same
   corpus with ``mutate_rate=0.3`` (45,000 docs deleted and 45,000 updated
   at 300,000, into the counting head, sealed and compacted) and the
   distillation ladder (N // 2, N // 4). Launch counters are zeroed before
   and read after; ``count_bins`` and ``rebucket`` must have launched.
   Checks: recall@10 over the survivors >= 0.3 before distillation (printed
   again after, with no floor); the mutated store's answers equal a fresh
   append-only build over the survivors up to score ties; the distilled
   words equal the survivors sketched fresh under the ladder's map and
   ``ops.rebucket`` of the rows before distillation, bit for bit; after
   16,384 new docs enter the head, mixed-width queries equal the same store
   queried through the ``reference`` backend up to ties. It also reads the
   recall of a fresh build at N // 4 under psi mod (N // 4), the map the
   queries are folded to, beside the distilled store's. Then ``count_bins``
   and ``rebucket`` are held against their plain versions (exact) at the
   path's shapes and ragged ones, and timed beside their bounds.
2c. The banded prefilter through ``serve``: the same corpus with
   ``mutate_rate=0.3, prefilter=True, bands=8``. ``band_hash`` must launch
   (seal, compaction, every query chunk) and some segment must be scanned
   banded. For every query batch: each returned (id, score) equals that id's
   score in the exhaustive ``score_all``, within rtol 1e-5 / atol 1e-6; the
   result is the exact top-k over the candidate set, computed apart from the
   index with the plain band hash, up to score ties; and each query's own doc
   is in its result. Recall@10 against exact Jaccard is printed with no
   floor (uniform docs rarely share a whole 736-bit band). The warm serve
   goes through :func:`telemetry_checks` (with ``band_lookup`` in every
   trace, and the traces' per-segment candidates reproducing the phase's
   candidate fraction). ``band_hash`` is then held against its plain version
   (exact) at the path's shapes and timed beside its bound.
2d. The prefilter at serving scale: the JAX repo's ``bench_engine
   run_prefilter`` defaults, 1,000,000 clustered docs (N=512, d=4096, 48
   indices, clusters of 12) sealed as 4 segments through ``seal_sketches``,
   ``BandPolicy()``, 64 near-duplicate queries. Recall@10 of the
   prefiltered ids against the exhaustive ones must reach 0.95, some
   segment must be banded, the candidate fraction must stay under the
   escape hatch, and the returned scores must equal the exhaustive ones;
   then :func:`telemetry_checks` over the 64 queries as one call, the
   traces reproducing the candidate fraction. ``--prefilter-docs`` shrinks
   the corpus for rehearsals.
2e. Hash mode: the NYTimes-shaped corpus sketched by ``ops.hash_build_sketch``
   (multiply-shift coefficients from ``make_mapping``, mode ``hash``, the
   table path's N) in batches of 16384, bulk-loaded with
   ``SketchStore.add_sketches`` and served; every batch bit-equal to
   ``map_indices`` in hash mode followed by ``ops.build_sketch``, recall@10
   against exact Jaccard at least 0.3. ``hash_build`` is then held against
   its plain version at the path's shape and ragged ones (N % 32 != 0,
   N < 32, rows of pads only; :func:`bitmap_ragged`: P % 4 in {0, 1, 2, 3},
   B from 1 to 16384, N up to the widest row, a base 4 bytes past
   alignment, int32 coefficients) and timed beside its bound.
2h. Baselines and near-duplicates: ``find_near_duplicates`` (threshold
   0.8, chunks of 1024) on the card through its defaults over phase 2's
   corpus plus 64 planted pairs (``generate_similar_pairs`` at J=0.95),
   300,128 docs. Every planted pair must be found, each reported estimate
   must equal the plain score of its pair (``hopper/ref.py`` on the card,
   rtol 1e-5 / atol 1e-6), and ``build_sketch`` and ``sketch_score`` must
   launch, the latter once a planner chunk (294). It prints the pair count,
   the seconds, the peak device memory and the score kernel's own time at
   the chunk's shape. Then the first 4,096 docs under the same Ψ on the card
   and on the CPU (``reference``) at threshold 0.3: the same pairs in the
   same order but for pairs within 1e-5 of the threshold, estimates within
   rtol 2e-3 / atol 1e-3. Then the paper's baselines over the first 16,384
   docs at N=5859 (BCS at N bins; MinHash, DOPH, SimHash, CBE at k = N;
   OddSketch at ``suggested_k(N, 0.9)``): the parameters drawn for the card
   equal the CPU's, and the card's sketches of the first 256 rows equal the
   CPU's, bit for bit (CBE's bits wherever the CPU's projection is more than
   1e-3 |x| from 0; the other lanes are counted). Readings, no gate: each
   sketcher's milliseconds a document (CUDA events) beside BinSketch's
   build, and each estimator's mean squared error over 64 pairs at J = 0.9
   and 0.5. Printed as ``{"near_duplicates": ...}`` with the card.
3. Each kernel held against its plain PyTorch version on the card, at the
   main path's shapes and on ragged ones: build bit-exact (also over
   :func:`bitmap_ragged`'s cases), score counts
   exact and measures within rtol 1e-5 / atol 1e-6, top-k equal up to
   provable score ties, band keys bit-exact (W not a multiple of the bands,
   more bands than words, B = W = 1). Score and top-k also at the shapes the
   tensor-core tile makes risky: W = 1, 5, 9, 17, 46 (not multiples of its
   8-word step), Q = 1, 63, 65, 129 (around its 64-row warpgroups), C < 256
   and C = 256 t +- 1 (around its 128-row tiles), a ``b_valid`` mask that
   drops whole tiles, and k = 256. Then each timed twice: ``ms``, the CUDA
   events around the whole call (median; the host's launch path included),
   and ``kernel_ms``, the device time of the kernels the call launched
   under ``torch.profiler`` (median of 20 calls), beside its plain version
   and its bound on this card; the
   counts form of the score kernel also beside ``torch._int_mm`` on the same
   bits expanded to int8 (the library yardstick of both count kernels).

2i. Multi-device serving on one card, run after phase 3 (timings first: in
   a run with 2i before 2h, phase 3's first profiler window lost kernels),
   launch counters zeroed before and read after (``build_sketch``,
   ``sketch_topk``, ``rebucket`` and ``band_hash`` must launch). *(a)*
   ``serve(sharded=True)`` at phase 2b's configuration (a mesh of every
   card): its ids equal phase 2b's served ids up to score
   ties and its recall before and after distillation equals phase 2b's.
   *(b)* The same corpus sealed every 32,768 rows (10 segments; a
   rehearsal's smaller corpus every n // 9 rows, and its slab-size checks
   skipped), 10% deleted and 5% updated (into the head), the older half
   distilled to N // 2, 8 bands; on a mesh of 4 shards of ``cuda:0`` (whole
   segments placed by live rows, one slab per shard and width, every slab
   past the top-k kernel's 8192-row crossover, 9 top-k launches a placed
   batch) the placed exhaustive, placed prefiltered and sliced passes
   over 1,024 queries in batches of 256 are
   held to ``query`` with the same prefilter flag (up to score ties; a
   prefiltered batch only where neither path hit the escape hatch), and the
   prefiltered ones to the exact top-k over the slab candidates (the plain
   band hash, the hatch acting on a whole width slab). A device-local
   compaction (the placement's groups) is held while 256 placed queries
   and a round of 1,024 deletes and 512 updates land, then swapped; the
   answers after it equal ``query``'s and no deleted doc comes back.
   Readings: placement build seconds and resident bytes, warm q/s of the
   single-device, placed and sliced passes, mask refreshes beside the
   tombstone epochs (a warm pass with no epoch moved must refresh nothing).
   *(c)* The sliced path on an append-only store of the 300,000 docs over 7
   shards (300,006 padded rows), equal to ``query``, the tail shard's docs
   retrievable. *(d)* A mesh of ``(cuda:0, cpu)`` at 4,096 docs: each
   shard's slab on its own device (the CPU shard runs the plain versions),
   placed and sliced answers equal to the card's ``query``. Printed as
   ``{"sharded": ...}``; each kernel row gets ``sharded_launches``.

2f. The operations plane, run after phase 3 (late in a long run
   ``torch.profiler`` loses kernels, so the timings come first), at phase 2b's
   configuration with ``BandPolicy(n_bands=8)``. Phases 2–2e, run with no
   fault plan, must each end with ``health()`` clean: no degraded component,
   no failed, abandoned or refused job. Then:
   *background*: ``serve`` with ``background_compact=True``, the compaction
   and both ladder passes as supervised jobs; every batch served while a job
   is pending is held to the exhaustive answers over the store as it stands
   (each (id, score) the id's own score, and the batch served with
   ``prefilter=False`` the exact top-k up to ties, within rtol 1e-5 / atol
   1e-6, the truth from ``Backend.score`` at each view's width); after the
   swaps the store's 1024 answers must be bit-equal to phase 2b's
   synchronous store's. A compaction and then a distillation are held
   (``_hold``) while deletes and relocating updates land; queries during and
   after each are held to the store as it stands; ``band_hash`` must launch
   for each held job's band index (a compaction's at its snapshot, a
   distillation's in its swap). ``count_bins``, ``band_hash``, ``rebucket``,
   ``build_sketch`` and ``sketch_topk`` must launch (counters zeroed before
   the ``serve``, read after the held jobs).
   *checkpoint*: a blocking save, a restore onto the card into a fresh
   store, the two stores' answers bit-equal; save and restore seconds,
   checkpoint bytes and the head's counter bytes are printed.
   *chaos*: ``serve`` under ``chaos=0.3, chaos_seed=1234``: no query raises,
   every (id, score) served is the exhaustive one, every fault fired is
   accounted for in ``health()`` (a retry, failure or abandon of its job, a
   degraded component) or, for torn leaves, by a generation that fails
   verification, and the restore lands on one that verifies.
   *left behind*: no job pending on any of the phase's stores, every thread
   the phase started ended, no fault plan armed and no metrics registry or
   trace collector installed; then, as a reading, how many of 20 one-kernel calls
   ``torch.profiler`` records after the phase.
2g. Hands-off maintenance, run after 2f: ``serve`` with ``autopilot=True``,
   the lifecycle controller ticking once a query batch after a churn of the
   catalog (K/2 docs deleted, K added). Part one, *soak*: the JAX repo's CI
   soak arguments on ``tiny`` (``--seal-rows 24 --churn-docs 16 --queries 96
   --batch 8 --mutate-rate 0.2 --probe 64 --autopilot-max-segments 8``),
   the probe's recall held to that CI's gate, 0.620 +- 0.05.
   Part two, *at scale*: the NYTimes shape at phase 2's document count (the
   build seals a segment per ingest batch of 16384, 19 at 300,000 docs, all
   compacted into one before serving), 2048-row seals, 512 docs of churn a
   batch, 512 queries in batches of 8 as in the soak (16 more segments
   sealed under the controller, one every fourth batch: the ladder folds
   only segments no query scored since the last tick, which it can tell only
   while the layout stays put between two ticks, and with more queries a
   batch nearly every segment shares a band key with one of them), the
   distill ladder (N // 2, N // 4), the prefilter with 8 bands, the probe
   over 64 queries, and a segment gate of the size-tier bound (3 widths x 4
   x ceil(log_4 17) = 36). Launch
   counters are zeroed before each ``serve`` and read after. Each part fails
   when the segment gate fails, a tick failed or raised, a job is pending after settling, a job the controller
   started ran on another backend, never swapped in, or (with a band index
   wanted) built its index without launching ``band_hash`` (a merge at its
   snapshot, a distillation in its swap: ``SegmentedStore`` is patched for
   the phase to count them), the answers after settling are not the
   exhaustive answers over the store as it stands (:func:`check_as_it_stands`),
   ``health()`` records anything but the escape hatch, or a kernel of the
   path never launched (``build_sketch``, ``sketch_score`` and
   ``count_bins``; at scale also ``band_hash``, and ``rebucket`` for the
   mixed-width queries after at least one distillation, beside at least one
   merge with a band index; every slab scored here is under 8192 rows, where
   top-k is a score and a sort, so ``sketch_topk`` is not on this path);
   then :func:`assert_nothing_left`. It prints ticks, merges, distills,
   guardrail trips, the final segment count, the probe's recall, the tick's
   median and maximum host milliseconds and the seconds of each part.

The line before the last lists the seven kernels as JSON (every phase's
kernel rows carry ``ms`` and ``kernel_ms``; ``rebucket``'s also its launch
floor, ``floor_ms`` and ``floor_kernel_ms`` on a (1, 1)-word input), the one
before it the card; before those, ``{"serve": ...}``, ``{"mutable": ...}``,
``{"prefilter": ...}``, ``{"hash_mode": ...}``, ``{"sharded": ...}``,
``{"near_duplicates": ...}``,
``{"ops_plane": ...}`` and
``{"autopilot": ...}`` lines with the end-to-end readings; the last line is the device summary.
Every ``serve`` of the run draws each corpus once: :func:`share_corpora`
memoises the generator ``serve`` calls, for this process (generation is
most of the run's host time). Without a card, or without the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (H100 SXM data sheet, at its 700 W limit):
# device memory rate, and 32-bit operations outside the tensor cores
# (67 TFLOP/s float32), the floor of the SIMT kernels' work; the binary
# tensor-core rate has no published figure and is measured in phase 1
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# iterations of the b1 wgmma loop that measures its rate (a few ms)
B1_LOOP_ITERS = 20_000

RTOL, ATOL = 1e-5, 1e-6
# the kernels of the append-only main path (phase 2); phase 2b adds
# count_bins and rebucket
MAIN_PATH_KERNELS = ("build_sketch", "sketch_score", "sketch_topk")
# the reference backend's estimator (PyTorch's float32 log, unfused) against
# the kernels' epilogue: the oracle tolerance of tests/test_kernels.py
RTOL_REF, ATOL_REF = 2e-3, 1e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_calls(torch, fn, calls: int = 20, warm: int = 10, attempts: int = 3) -> list:
    """The device kernels of ``calls`` calls of ``fn`` as ``torch.profiler``
    records them (CUDA activity): for each call, in order, its kernels'
    (name, milliseconds).

    Late in a long run the profiler was seen to lose the first four kernels
    of a window, whatever the time between its start and theirs, and now
    and then kernels inside it. So the window opens with ``warm`` calls,
    then 100 ms of nothing, then the measured calls, each ended by a sync,
    then 100 ms more; the measured kernels are those after the last gap of
    over 50 ms. In order of start they must fall into ``calls`` equal runs
    of the same names; a window that recorded a count of kernels no equal
    runs make is opened again, up to ``attempts`` windows, and then the run
    fails, as it does if a call launched none."""
    from torch.autograd import DeviceType

    for attempt in range(1, attempts + 1):
        measured, kernels, events = profiler_window(torch, fn, calls, warm)
        if measured and not len(measured) % calls:
            break
        launched = sum(e.device_type == DeviceType.CPU and "LaunchKernel" in e.name
                       for e in events)
        what = (f"profiler window {attempt} of {attempts}: {len(measured)} kernels recorded "
                f"over {calls} calls ({len(kernels)} in the window, {launched} host launch "
                f"events; {sorted({e.name[:60] for e in kernels})})")
        if attempt == attempts:
            fail(what)
        print(what + "; opened again")

    per = len(measured) // calls
    runs = [[(e.name, e.time_range.elapsed_us() / 1e3) for e in measured[i * per : (i + 1) * per]]
            for i in range(calls)]
    if any([n for n, _ in r] != [n for n, _ in runs[0]] for r in runs):
        fail("profiler: the calls launched different kernels")
    return runs


def profiler_window(torch, fn, calls: int, warm: int):
    """One profiler window of :func:`profiled_calls`: (the kernels after its
    last gap, every kernel of the window, every event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        time.sleep(0.1)
    events = prof.events()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.time_range.start)
    gaps = [i for i in range(1, len(kernels))
            if kernels[i].time_range.start - kernels[i - 1].time_range.end > 50_000]
    return (kernels[gaps[-1]:] if gaps else kernels), kernels, events


def device_ms(torch, fn, calls: int = 20) -> float:
    """Median milliseconds, over ``calls`` calls of ``fn``, of the summed
    durations of the device kernels each call launched (:func:`profiled_calls`):
    the kernels' own time, without the host's launch path that the CUDA
    events of :func:`cuda_ms` also hold."""
    return statistics.median(sum(ms for _, ms in run) for run in profiled_calls(torch, fn, calls))


def timed(torch, fn, reps: int) -> dict:
    """``ms``, the CUDA-event median of the whole call (:func:`cuda_ms`), and
    ``kernel_ms``, its kernels' own device time (:func:`device_ms`)."""
    return {"ms": cuda_ms(torch, fn, reps), "kernel_ms": device_ms(torch, fn)}


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = PEAK_OPS_PER_S):
    """(least time in ms, what sets it) for the given bytes and operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_topk(torch, got, want, truth, what: str, rtol: float = RTOL,
               atol: float = ATOL) -> float:
    """Tie-aware top-k check: scores within tolerance slot for slot; ids equal
    except where both ids' scores in ``truth`` (Q, C) tie within tolerance.
    Returns the largest score difference."""
    (gs, gi), (ws, wi) = got, want
    if gs.shape != ws.shape or gi.shape != wi.shape:
        fail(f"{what}: shapes {tuple(gs.shape)} vs {tuple(ws.shape)}")
    finite = torch.isfinite(ws)
    if not torch.equal(finite, torch.isfinite(gs)) or not torch.equal(gi[~finite], wi[~finite]):
        fail(f"{what}: empty slots differ")
    err = float((gs[finite] - ws[finite]).abs().max()) if finite.any() else 0.0
    if not torch.allclose(gs[finite], ws[finite], rtol=rtol, atol=atol):
        fail(f"{what}: scores differ by up to {err}")
    bad = (gi != wi) & finite
    if bad.any():
        r, _ = bad.nonzero(as_tuple=True)
        tg = truth[r, gi[bad].long()]
        tw = truth[r, wi[bad].long()]
        if not torch.all((tg - tw).abs() <= atol + rtol * tw.abs()):
            fail(f"{what}: {int(bad.sum())} ids differ and are not score ties")
    return err


def exact_err(torch, got, want, what: str) -> int:
    """Count of the elements (words, counters, keys) in which two integer
    tensors that must be equal differ, computed from them; the run fails
    unless it is 0."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    err = int((got != want).sum())
    if err:
        fail(f"{what}: {err} elements differ from its plain version")
    return err


def b1_rate(torch, dev) -> float:
    """Bit-AND-popcount multiply-adds per second of the binary wgmma
    (m64n128k256, 64 x 128 x 256 a warpgroup and instruction) alone: four
    warpgroups on every SM loop over it on operands resident in shared
    memory, no device-memory traffic; CUDA-event median of 5."""
    from repro_torch.hopper import popcount_sim

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(sms * 512, dtype=torch.int32, device=dev)
    macs = popcount_sim.mma_b1_loop(out, B1_LOOP_ITERS)
    ms = cuda_ms(torch, lambda: popcount_sim.mma_b1_loop(out, B1_LOOP_ITERS), 5)
    return macs / (ms * 1e-3)


def score_topk_ragged(torch, dev, gen, words) -> None:
    """Score and top-k against their plain versions where the tensor-core
    tile is ragged: W not a multiple of 8 (1, 5, 9, 17, 46), Q around 64-row
    warpgroups, C below two 128-row tiles and one past or short of a multiple
    of one, masks that drop whole tiles, k up to 256."""
    from repro_torch.hopper import ops, ref

    cases = [(1, 100, 1), (63, 255, 5), (65, 257, 9), (129, 511, 17), (1, 513, 46),
             (63, 769, 9), (129, 1025, 46), (65, 1023, 17), (129, 300, 5)]
    for q_, c_, w_ in cases:
        n_ = 32 * w_ - 5 if w_ > 1 else 20
        a, b = words(q_, n_, 0.1), words(c_, n_, 0.1)
        for m in ref.MEASURES:
            got, want = ops.sketch_score(a, b, n_, m), ref.sketch_score_ref(a, b, n_, m)
            if not (torch.equal(got, want) if m == "counts"
                    else torch.allclose(got, want, rtol=RTOL, atol=ATOL)):
                fail(f"sketch_score {m} differs at Q={q_} C={c_} W={w_}")
            if m not in ("counts", "jaccard"):
                continue
            valid = (torch.rand(c_, generator=gen, device=dev) > 0.2).to(torch.int32)
            valid[256:512] = 0  # a whole tile, where there is one
            for k in (1, 10, 200, 256):
                got_t = ops.sketch_topk(a, b, n_, m, k=k, b_valid=valid)
                want_t = ref.sketch_topk_ref(a, b, n_, m, k=k, b_valid=valid)
                check_topk(torch, got_t, want_t, want,
                           f"sketch_topk {m} k={k} at Q={q_} C={c_} W={w_}")


def bitmap_ragged(torch, dev, build: str) -> int:
    """``build_sketch`` (``build == "sketch"``) or ``hash_build_sketch``
    (``"hash"``) against its plain version where the warp-per-row kernel's
    16-byte windows are ragged: P in 869..872 (rows starting at every offset
    mod 4), B in 1, 3, 256, 16384, N in 1, 31, 517, 5859 and the widest row
    (32 * MAX_WORDS), each from an aligned base and from a contiguous view 4
    bytes past one (``flat[1 : 1 + B*P]``); ids >= N and negative, row 0 of
    pads only; the hash build with its coefficients as int64 and as int32
    holding the uint32 bits. The plain version runs 256 rows at a time
    (its dense (B, N) intermediates). Returns the differing words (0)."""
    from repro_torch.core import packed as pk
    from repro_torch.hopper import ops, ref
    from repro_torch.hopper.sketch_build import MAX_WORDS

    gen = torch.Generator(device=dev).manual_seed(5)
    co64 = torch.tensor([0x9E3779B1, 0xDEADBEEF], dtype=torch.int64, device=dev)
    err = 0
    for b_ in (1, 3, 256, 16384):
        for p_ in (869, 870, 871, 872):
            for n_ in (1, 31, 517, 5859, 32 * MAX_WORDS):
                lo, hi = (-3, n_ + 40) if build == "sketch" else (-(1 << 31), (1 << 31) - 1)
                ids = torch.randint(lo, hi, (b_, p_), generator=gen, device=dev,
                                    dtype=torch.int64)
                lens = torch.randint(0, p_ + 1, (b_, 1), generator=gen, device=dev)
                ids = torch.where(torch.arange(p_, device=dev)[None, :] < lens, ids, -1)
                flat = torch.empty(b_ * p_ + 1, dtype=torch.int32, device=dev)
                flat[1:] = ids.reshape(-1)
                if b_ > 1:
                    flat[1 : 1 + p_] = -1  # a row of pads only
                for view in (flat[1:].clone().view(b_, p_), flat[1:].view(b_, p_)):
                    if build == "sketch":
                        calls = [(lambda x: ops.build_sketch(x, n_),
                                  lambda x: ref.build_sketch_ref(x, n_))]
                    else:
                        calls = [(lambda x, c=c: ops.hash_build_sketch(x, c, n_),
                                  lambda x: ref.hash_build_ref(x, co64, n_))
                                 for c in (co64, pk._to_int32_bits(co64))]
                    for kernel, plain in calls:
                        want = torch.cat([plain(view[s : s + 256])
                                          for s in range(0, b_, 256)])
                        err += exact_err(torch, kernel(view), want,
                                         f"{build} build at {(b_, p_, n_)}, base "
                                         f"{view.data_ptr() % 16} bytes past alignment")
    torch.cuda.synchronize()
    return err


def share_corpora() -> None:
    """Memoise, for this process, the corpus generator that ``serve`` calls:
    every ``serve`` of the run asks for the same few (spec, seed) corpora,
    and numpy's Zipf draws over 300,000 x 870 ids take about 20 s each on
    the card's host. The corpora are read only, so sharing them changes no
    answer."""
    import functools

    from repro_torch.launch import serve as serve_mod

    if not hasattr(serve_mod.generate_corpus, "cache_info"):
        serve_mod.generate_corpus = functools.lru_cache(maxsize=None)(serve_mod.generate_corpus)


def serve_batches(torch, engine, queries, now, prefilter=None, batch=256):
    """(scores, ids) of ``queries`` served in batches of ``batch`` at k=10,
    and the warm rate in queries per second (host clock between syncs)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [engine.query(queries[s : s + batch], 10, now=now, prefilter=prefilter)
           for s in range(0, len(queries), batch)]
    torch.cuda.synchronize()
    qps = len(queries) / (time.perf_counter() - t0)
    return torch.cat([g[0] for g in got]), torch.cat([g[1] for g in got]), qps


def view_truth(torch, engine, queries, now, backend=None):
    """(Q, next_id) float32 scores of every live doc, each scored at its own
    view's width from the folded query sketch, by ``backend`` (default: the
    plain versions); -inf for ids that are not live. The tie truth of a
    mixed-width store, and the exhaustive answers over a store as it stands."""
    from repro_torch.engine import ReferenceBackend

    ref_be, cfg = backend or ReferenceBackend(), engine.cfg
    qs = ref_be.sketch(cfg, engine.store.mapping, queries)
    n_ids = getattr(engine.store, "next_id", engine.store.size)  # append-only: row == id
    truth = torch.full((len(queries), n_ids), float("-inf"),
                       device=queries.device)
    for v in engine.store.segment_views(now):
        nb = v.n_bins or cfg.n_bins
        s = ref_be.score(ref_be.rebucket(qs, cfg.n_bins, nb), v.sketches, nb, engine.measure,
                         corpus_fills=v.fills)
        ids = (v.ids.long() if v.ids is not None
               else torch.arange(s.shape[1], device=s.device))
        live = v.valid != 0 if v.valid is not None else torch.ones_like(ids, dtype=torch.bool)
        truth[:, ids[live]] = s[:, live]
    return truth


def mutable_phase(torch, dev, spec, n_bins: int):
    """Phase 2b: the mutable path through ``serve``, its checks, and the
    count_bins / rebucket kernels against their plain versions. Returns the
    kernels' JSON rows and the end-to-end readings."""
    from repro_torch.core import BinSketchConfig, binsketch, counting, packed as pk
    from repro_torch.data.synthetic import generate_corpus
    from repro_torch.engine import CudaBackend, ReferenceBackend, SketchEngine
    from repro_torch.hopper import ops, ref
    from repro_torch.launch.serve import recall_at, serve

    n1, n2 = n_bins // 2, n_bins // 4
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    out = serve(spec, queries=1024, topk=10, rho=0.05, batch=256, ingest_batch=16384,
                backend="cuda", device=dev, mutate_rate=0.3, distill=(n1, n2))
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    print(f"mutable path launches: {launches}")
    for name in ("count_bins", "rebucket"):
        if launches[name] < 1:
            fail(f"kernel {name} never launched on the mutable path")
    engine, pre = out["engine"], out["pre_distill"]
    cfg, mapping, now = engine.cfg, engine.store.mapping, out["serve_now"]
    # the served answers of the synchronous lifecycle, for phase 2f
    sync_ref = {"queries": out["queries"], "now": now, "scores": out["scores"],
                "ids": out["ids"]}
    counters = engine.store.head.counters
    head_bytes = counters.element_size() * counters.numel()
    print(f"head counters: {tuple(counters.shape)} {counters.dtype}, {head_bytes} bytes "
          f"({counters.element_size()} a bin)")
    if pre["recall"] < 0.3:
        fail(f"recall@10 over the survivors before distillation {pre['recall']:.3f} below 0.3")
    print(f"recall@10 over survivors: {pre['recall']:.4f} before distillation, "
          f"{out['recall']:.4f} after (no floor)")

    # the mutated store, before distillation, against a fresh append-only build
    surv_ids, surv_rows = out["surv_ids"], out["surv_rows"]
    fresh = SketchEngine.build(cfg, mapping, backend="cuda", planner=engine.planner,
                               capacity=len(surv_ids))
    fresh.add(surv_rows, batch=16384)
    queries = torch.from_numpy(out["queries"]).to(dev)
    f_s, f_i = [], []
    for s in range(0, len(queries), 256):
        sc, ix = fresh.query(queries[s : s + 256], 10)
        f_s.append(sc)
        f_i.append(ix)
    truth = fresh.score_all(queries)
    surv_dev = torch.from_numpy(surv_ids).to(dev)
    pre_ids = torch.from_numpy(pre["ids"]).to(dev).long()
    pre_pos = torch.where(pre_ids >= 0, torch.searchsorted(surv_dev, pre_ids.clamp_min(0)),
                          pre_ids)
    if not torch.equal(surv_dev[pre_pos.clamp_min(0)][pre_ids >= 0], pre_ids[pre_ids >= 0]):
        fail("the mutated store served an id that is not a survivor")
    check_topk(torch, (torch.from_numpy(pre["scores"]).to(dev), pre_pos),
               (torch.cat(f_s), torch.cat(f_i).long()), truth,
               "mutated store vs a fresh build over the survivors")
    del fresh, truth

    # distilled words against fresh sketches and against the kernel's fold
    (seg,), (seg_pre,) = engine.store.sealed, pre["segments"]
    if seg.n_bins != n2 or seg_pre.n_bins is not None:
        fail(f"distilled widths {seg.n_bins} / {seg_pre.n_bins}, expected {n2} / base")
    keep = torch.from_numpy(seg_pre.valid).to(dev)
    rows_pre = seg_pre.sketches[keep]
    if not (np.array_equal(seg.ids, surv_ids) and seg.valid.all()):
        fail("the distilled segment does not hold exactly the survivors")
    cuda_be = CudaBackend()

    def fresh_words(n_new, psi_new):
        cfg_new = BinSketchConfig(d=cfg.d, n_bins=n_new)
        return torch.cat([cuda_be.sketch(cfg_new, psi_new,
                                         torch.from_numpy(surv_rows[s : s + 16384]).to(dev))
                          for s in range(0, len(surv_rows), 16384)])

    tier1 = ops.rebucket(rows_pre, n_bins, n1)
    if not torch.equal(tier1, fresh_words(n1, mapping % n1)):
        fail(f"ops.rebucket to N'={n1} differs from the survivors sketched under psi mod N'")
    ladder = fresh_words(n2, (mapping % n1) % n2)
    if not torch.equal(seg.sketches, ladder):
        fail(f"distilled words at N'={n2} differ from the survivors sketched under "
             f"(psi mod {n1}) mod {n2}")
    if not torch.equal(seg.sketches, ops.rebucket(tier1, n1, n2)):
        fail("distilled words differ from ops.rebucket of the rows before distillation")
    if not torch.equal(seg.fills, pk.row_popcount(seg.sketches)):
        fail("distilled fills differ from the popcount of their words")
    direct = torch.equal(seg.sketches, fresh_words(n2, mapping % n2))
    print(f"distilled words: bit-equal to fresh sketches at N'={n1} (psi mod {n1}) and at "
          f"N'={n2} (the ladder's (psi mod {n1}) mod {n2}), and to ops.rebucket; equal "
          f"to psi mod {n2} directly: {direct}")
    # what the ladder's map costs: the same survivors sketched at N'=n2 under
    # psi mod n2, the map the queries are folded to, and served fresh
    consistent = SketchEngine.build(BinSketchConfig(d=cfg.d, n_bins=n2), mapping % n2,
                                    backend="cuda", planner=engine.planner,
                                    capacity=len(surv_ids))
    consistent.add(surv_rows, batch=16384)
    pos = torch.cat([consistent.query(queries[s : s + 256], 10)[1]
                     for s in range(0, len(queries), 256)]).cpu().numpy()
    recall_consistent = recall_at(surv_ids[pos], out["truth_ids"], 10)
    print(f"recall@10 of a fresh build at N'={n2} under psi mod {n2}: "
          f"{recall_consistent:.4f} (the distilled store, served: {out['recall']:.4f})")
    del consistent
    warm_qps = serve_batches(torch, engine, queries, now)[2]
    # one query chunk's top-k over the sealed survivors, before and after
    # the ladder: the kernel time behind the two serving rates
    q256 = queries[:256]
    qs = cuda_be.sketch(cfg, mapping, q256)
    topk_ms = {
        "base": cuda_ms(torch, lambda: ops.sketch_topk(qs, rows_pre, n_bins, k=10,
                                                       b_fills=seg_pre.fills), 5),
        "distilled": cuda_ms(torch, lambda: ops.sketch_topk(
            ops.rebucket(qs, n_bins, n2), seg.sketches, n2, k=10, b_fills=seg.fills), 5),
    }

    # mixed width: new docs in the base-width head beside the N // 4 segment
    new_rows, _ = generate_corpus(spec, seed=2)
    engine.add(new_rows[:16384], batch=16384, now=now)
    got = engine.query(q256, 10, now=now)
    want = SketchEngine(engine.store, ReferenceBackend(), engine.measure,
                        engine.planner).query(q256, 10, now=now)
    mixed_err = check_topk(torch, got, want, view_truth(torch, engine, q256, now),
                           "mixed-width query vs the reference backend", RTOL_REF, ATOL_REF)
    print(f"mixed width: {engine.store.head.size} head rows at N={n_bins} beside "
          f"{seg.n_rows} sealed rows at N'={n2} agree with the reference backend "
          f"(rtol {RTOL_REF} / atol {ATOL_REF}, ids up to ties; largest difference {mixed_err})")

    # ------------------------------------- count_bins / rebucket vs plain
    corpus_rows = torch.from_numpy(out["corpus"][:16384]).to(dev)
    bins = binsketch.map_indices(cfg, mapping, counting.dedup_padded(corpus_rows))
    # differing elements of every comparison, by kernel
    errs = {"count_bins": [exact_err(torch, ops.count_bins(bins, n_bins),
                                     ref.count_bins_ref(bins, n_bins),
                                     "count_bins at the ingest shape")],
            "rebucket": []}
    gen = torch.Generator(device=dev).manual_seed(2)
    for b_, p_, n_ in [(1, 4, 32), (7, 33, 517), (300, 1000, 70_000), (64, 870, n_bins)]:
        lens = torch.randint(0, p_ + 1, (b_, 1), generator=gen, device=dev)
        rb = torch.randint(0, n_ + 40, (b_, p_), generator=gen, device=dev, dtype=torch.int32)
        rb = torch.where(torch.arange(p_, device=dev)[None, :] < lens, rb, -1).to(torch.int32)
        rb[0] = -1  # a row of pads only
        errs["count_bins"].append(exact_err(
            torch, ops.count_bins(rb, n_), ref.count_bins_ref(rb, n_),
            f"count_bins at {(b_, p_, n_)}"))
    for n_new in (n1, n2):
        errs["rebucket"].append(exact_err(
            torch, ops.rebucket(qs, n_bins, n_new), ref.rebucket_ref(qs, n_bins, n_new),
            f"rebucket at (256, {cfg.n_words}) -> {n_new}"))
    for b_, n_, n_new in [(13, 512, 100), (9, 101, 33), (5, 517, 1), (5, 517, 32),
                          (3, 33, 32), (64, n_bins, 7)]:
        bits = torch.rand((b_, pk.num_words(n_) * 32), generator=gen, device=dev) < 0.3
        words = pk.pack_bits(bits.to(torch.uint8))  # bits >= N set too: they must not leak
        got = ops.rebucket(words, n_, n_new)
        errs["rebucket"] += [exact_err(torch, got, ref.rebucket_ref(words, n_, n_new),
                                       f"rebucket at {(b_, n_, n_new)}"),
                             exact_err(torch, got, pk.fold_packed(words, n_, n_new),
                                       f"rebucket vs fold_packed at {(b_, n_, n_new)}")]
    torch.cuda.synchronize()
    print("count_bins and rebucket vs plain versions: all agree (exact)")

    bsz, p = bins.shape
    keep_b = (bins >= 0) & (bins < n_bins)
    safe = torch.where(keep_b, bins, 0).long()
    ones = keep_b.to(torch.int32)
    lib_ms = cuda_ms(torch, lambda: torch.zeros((bsz, n_bins), dtype=torch.int32,
                                                device=dev).scatter_add_(1, safe, ones), 10)
    # rebucket's launch floor: the same wrapper on a (1, 1)-word input
    one = torch.full((1, 1), 0x0F0F0F0F, dtype=torch.int32, device=dev)
    floor = timed(torch, lambda: ops.rebucket(one, 32, 16), 50)
    qn, w, w1 = qs.shape[0], cfg.n_words, pk.num_words(n1)
    chunks = -(-n_bins // n1)
    rows = []
    extra = {"rebucket": {"floor_ms": floor["ms"], "floor_kernel_ms": floor["kernel_ms"]}}
    for name, source, replaces, times, plain_ms, n_bytes, n_ops, lib in [
        ("count_bins", "src/repro_torch/hopper/csrc/count_bins.cu",
         "src/repro/kernels/count_update.py:49",
         timed(torch, lambda: ops.count_bins(bins, n_bins), 20),
         cuda_ms(torch, lambda: ref.count_bins_ref(bins, n_bins), 5),
         4.0 * bsz * p + 4.0 * bsz * n_bins, float(bsz * p), lib_ms),
        ("rebucket", "src/repro_torch/hopper/csrc/rebucket.cu",
         "src/repro/kernels/rebucket.py:64",
         timed(torch, lambda: ops.rebucket(qs, n_bins, n1), 50),
         cuda_ms(torch, lambda: ref.rebucket_ref(qs, n_bins, n1), 10),
         4.0 * qn * (w + w1), 2.0 * qn * w1 * chunks, None),
    ]:
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": max(errs[name]), **times,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib, **extra.get(name, {})})
    rb = rows[-1]
    print(f"rebucket launch floor: kernel {rb['kernel_ms']:.6f} ms at (256, {w}) against "
          f"{floor['kernel_ms']:.6f} ms at (1, 1) (call {rb['ms']:.6f} vs {floor['ms']:.6f} ms): "
          f"ratio {rb['kernel_ms'] / floor['kernel_ms']:.3f} (at the floor if <= 1.2)")
    print(f"shapes: count_bins {tuple(bins.shape)} -> (B, N={n_bins}); rebucket "
          f"({qn}, {w}) -> N'={n1} ({w1} words, {chunks} chunks); library_ms of count_bins: "
          "torch.zeros + scatter_add_ on pre-masked ids; rebucket: none (no single PyTorch "
          "call folds packed bits)")
    readings = {
        "n_docs": out["n_docs"], "n_bins": n_bins, "widths": [n1, n2],
        "n_deleted": out["n_deleted"], "n_updated": out["n_updated"],
        "live": int(len(surv_ids)), "ingest_docs_per_s": out["docs_per_s"],
        "mutate_s": out["mutate_s"], "mutations_per_s": out["mutations_per_s"],
        "distill_s": out["distill_s"],
        "first_queries_per_s": out["queries_per_s"], "warm_queries_per_s": warm_qps,
        "pre_distill_first_queries_per_s": pre["queries_per_s"],
        "recall_before_distill": pre["recall"], "recall_after_distill": out["recall"],
        "recall_fresh_at_n2_direct_map": recall_consistent,
        "bytes_per_doc": out["bytes_per_doc"], "base_bytes_per_doc": cfg.n_words * 4,
        "head_counter_bytes": head_bytes, "head_counter_bytes_per_bin":
        counters.element_size(), "peak_device_bytes": peak_bytes,
        "topk_chunk_ms_base": topk_ms["base"], "topk_chunk_ms_distilled": topk_ms["distilled"],
        "mixed_max_abs_err": mixed_err,
        "jobs": assert_healthy(engine, "2b"),
    }
    return rows, readings, sync_ref

def candidate_ids(torch, engine, queries, now) -> np.ndarray:
    """Doc ids a prefiltered query of the batch ``queries`` must score, found
    without the bucket index: the plain band hash of every indexed segment's
    rows against the batch's keys, the live and TTL filter, the escape hatch;
    every live row of unindexed segments and of the head."""
    from repro_torch.core import packed as pk
    from repro_torch.engine import ReferenceBackend

    store, cfg, pol = engine.store, engine.cfg, engine.store.band_policy
    ref_be = ReferenceBackend()
    qs = ref_be.sketch(cfg, store.mapping, queries)
    out = []
    for seg in store.sealed:
        live = seg.valid.copy()
        if store.ttl is not None and now is not None:
            live &= seg.born + store.ttl > now
        if seg.band_index is None:
            out.append(seg.ids[live])
            continue
        nb = seg.n_bins or cfg.n_bins
        qk = pk.band_hash(ref_be.rebucket(qs, cfg.n_bins, nb), pol.n_bands)
        rk = pk.band_hash(seg.sketches, pol.n_bands)
        hit = torch.zeros(seg.n_rows, dtype=torch.bool, device=rk.device)
        for t in range(rk.shape[1]):
            hit |= torch.isin(rk[:, t], qk[:, t])
        rows = hit.cpu().numpy() & live
        if rows.sum() > pol.max_candidate_frac * seg.n_rows:
            rows = live  # the escape hatch: the segment is scanned in full
        out.append(seg.ids[rows])
    h = store.head
    live = h.valid[: h.size].copy()
    if store.ttl is not None and now is not None:
        live &= h.born[: h.size] + store.ttl > now
    out.append(h.ids[: h.size][live])
    return np.sort(np.concatenate(out))


def band_hash_rows(torch, dev, words, launches):
    """``band_hash`` against its plain version (exact) at the path's shapes
    and ragged ones, then timed on ``words``; returns its kernel row."""
    from repro_torch.core import packed as pk
    from repro_torch.hopper import ops, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [words, words[:256]]
    for b_, w_ in [(9, 13), (3, 1), (1, 1), (7, 32), (2, 64), (5, 184)]:
        x = torch.randint(-(1 << 31), 1 << 31, (b_, w_), generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
        x[0] = -1  # every bit set: the product's overflow case
        cases.append(x)
    err = max(exact_err(torch, ops.band_hash(x, n_bands), ref.band_hash_ref(x, n_bands),
                        f"band_hash at {tuple(x.shape)}, {n_bands} bands")
              for x in cases for n_bands in (8, 5, 32, 1))
    torch.cuda.synchronize()
    b, w = words.shape
    nb_eff, _ = pk.band_shape(w, 8)
    b_ms, b_by = bound_ms(4.0 * b * w + 4.0 * b * nb_eff, 4.0 * b * w)
    print(f"band_hash vs plain: all agree (exact) at {(b, w)} and {(256, w)}, 8 bands, and "
          "ragged shapes; library_ms: none (no single PyTorch call hashes word groups)")
    return {"name": "band_hash", "route": "cuda",
            "source": "src/repro_torch/hopper/csrc/band_hash.cu",
            "replaces": "src/repro/kernels/band_hash.py:50",
            "launches": launches["band_hash"], "max_abs_err": err,
            **timed(torch, lambda: ops.band_hash(words, 8), 20),
            "plain_ms": cuda_ms(torch, lambda: ref.band_hash_ref(words, 8), 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def telemetry_checks(torch, engine, queries, now, phase: str, prefilter=None, batch=256,
                     frac=None) -> dict:
    """The engine's own telemetry over a warm serve of ``queries``, held to
    what it observes. The serve runs disarmed, then armed (``enable_metrics``,
    every call sampled): the answers must be bit-equal, scores and ids;
    ``query.calls`` and ``query.rows`` must count the batches and rows; every
    trace's stages are ``STAGES`` names in ``STAGES`` order, with
    ``rebucket`` and ``kernel_score`` (and ``band_lookup`` when banded); with
    ``frac``, the traces' per-segment candidates must reproduce it. Then the
    armed serve once more under ``torch.profiler``: its ``kernel_score``
    stage total (CUDA events) must be at least 0.9x the device time of the
    top-k and score kernels it launched (every launch recorded, else the
    window is retried, three times at most). Returns the readings: both
    rates and the stage totals in ms."""
    from repro_torch import obs
    from repro_torch.hopper import ops

    n_batches = -(-len(queries) // batch)
    if obs.metrics.active() is not None or obs.trace.active() is not None:
        fail(f"phase {phase}: telemetry armed before its check")
    sc0, ix0, qps_off = serve_batches(torch, engine, queries, now, prefilter, batch)
    engine.enable_metrics(sample=1, capacity=n_batches)
    try:
        sc1, ix1, qps_on = serve_batches(torch, engine, queries, now, prefilter, batch)
        m = engine.metrics(now)
        traces = obs.trace.active().traces()
    finally:
        obs.disable()
    if not (torch.equal(sc0, sc1) and torch.equal(ix0, ix1)):
        fail(f"phase {phase}: answers with metrics armed differ from the same serve disarmed")
    calls, rows = m["counters"].get("query.calls"), m["counters"].get("query.rows")
    if (calls, rows, len(traces)) != (n_batches, len(queries), n_batches):
        fail(f"phase {phase}: query.calls {calls}, query.rows {rows}, {len(traces)} traces "
             f"over {n_batches} batches of {len(queries)} rows")
    need = {"rebucket", "kernel_score"} | ({"band_lookup"} if prefilter else set())
    for tr in traces:
        names = list(tr["stages_s"])
        if (not set(names) <= set(obs.STAGES) or not need <= set(names)
                or names != sorted(names, key=obs.STAGES.index)):
            fail(f"phase {phase}: trace stages {names} are not {obs.STAGES} in order "
                 f"with {sorted(need)}")
    readings = {"warm_queries_per_s_disarmed": qps_off, "warm_queries_per_s_armed": qps_on,
                "stage_ms": {name: m["histograms"][f"query.stage.{name}_s"]["sum"] * 1e3
                             for name in obs.STAGES
                             if f"query.stage.{name}_s" in m["histograms"]}}
    if frac is not None:
        seg_rows = sum(s["rows"] for tr in traces for s in tr["segments"])
        cand = sum(s["candidates"] for tr in traces for s in tr["segments"])
        if cand / max(seg_rows, 1) != frac:
            fail(f"phase {phase}: the traces' candidate fraction {cand / max(seg_rows, 1)} "
                 f"is not the phase's {frac}")
        readings["trace_candidate_fraction"] = cand / max(seg_rows, 1)
    names = ("sketch_topk_partial_kernel", "sketch_topk_merge_kernel", "sketch_score_kernel")
    for attempt in range(3):
        deltas = []

        def armed_serve():
            engine.enable_metrics(sample=1, capacity=n_batches)  # the last call's stages
            before = dict(ops.launches)
            serve_batches(torch, engine, queries, now, prefilter, batch)
            deltas.append({k: ops.launches[k] - before[k] for k in before})

        try:
            measured, _, _ = profiler_window(torch, armed_serve, 1, 1)
            stage_ms = obs.metrics.active().snapshot()["histograms"][
                "query.stage.kernel_score_s"]["sum"] * 1e3
        finally:
            obs.disable()
        ks = [e for e in measured if any(n in e.name for n in names)]
        seen = (sum("sketch_topk_partial" in e.name for e in ks),
                sum("sketch_score_kernel" in e.name for e in ks))
        if seen == (deltas[-1]["sketch_topk"], deltas[-1]["sketch_score"]) and sum(seen):
            break
        print(f"phase {phase}: profiler window {attempt} recorded {seen} of "
              f"{deltas[-1]['sketch_topk']} top-k and {deltas[-1]['sketch_score']} score "
              "launches; again")
    else:
        fail(f"phase {phase}: the profiler never recorded every top-k and score kernel")
    kernel_ms = sum(e.time_range.elapsed_us() for e in ks) / 1e3
    if not stage_ms >= 0.9 * kernel_ms:
        fail(f"phase {phase}: kernel_score stage total {stage_ms} ms is under 0.9x the "
             f"{kernel_ms} ms of device time of the kernels it launched")
    readings.update(kernel_score_stage_ms=stage_ms, score_topk_kernel_ms=kernel_ms,
                    stage_over_kernel=stage_ms / kernel_ms,
                    profiled_launches={"sketch_topk": seen[0], "sketch_score": seen[1]})
    print(f"phase {phase} telemetry: warm {qps_off:.1f} q/s disarmed, {qps_on:.1f} q/s armed "
          f"(sample 1); answers bit-equal; {calls} calls / {rows} rows counted; stage totals "
          f"over the warm serve, ms: {readings['stage_ms']}; kernel_score {stage_ms:.4f} ms "
          f"against {kernel_ms:.4f} ms of top-k and score kernels under the profiler "
          f"({stage_ms / kernel_ms:.3f}x)")
    return readings


def probe_check(torch, engine, out) -> dict:
    """``RecallProbe(sample=64)`` over phase 2's served queries: its ground
    truth on a side stream of the card, the engine queried again for the 64
    it samples; the published ``probe.recall`` must equal ``recall_at`` over
    the same 64 rows of the serve's own ids and exact truth, exactly."""
    from repro_torch import obs
    from repro_torch.launch.serve import recall_at

    reg = engine.enable_metrics()
    try:
        pr = obs.RecallProbe(engine, k=10, sample=64, seed=0)
        t0 = time.perf_counter()
        if not pr.launch(out["surv_ids"], out["surv_rows"], queries=out["queries"]):
            fail("the recall probe's launch was refused")
        t_launch = time.perf_counter() - t0
        got = pr.wait(timeout=600.0)
        t_probe = time.perf_counter() - t0
        gauge = reg.gauge("probe.recall")
    finally:
        obs.disable()
    pick = np.random.default_rng(0).choice(len(out["queries"]), 64, replace=False)
    want = recall_at(out["ids"][pick], out["truth_ids"][pick], 10)
    if got is None or got != want or gauge != got:
        fail(f"probe recall {got} (gauge {gauge}) differs from serve's recall_at {want} over "
             "the same 64 queries")
    print(f"probe: recall@10 {got} over 64 of the served queries, equal to serve's recall_at "
          f"over them; launch {t_launch:.3f}s, reading after {t_probe:.3f}s")
    return {"recall": got, "serve_recall_same_queries": want, "launch_s": t_launch,
            "reading_s": t_probe, "health": engine.health()["jobs"].get("probe")}


def prefilter_phase(torch, dev, spec):
    """Phase 2c: the banded prefilter through ``serve``, its checks, and the
    band_hash kernel against its plain version. Returns the kernel's JSON
    row and the end-to-end readings."""
    from repro_torch.hopper import ops, ref
    from repro_torch.launch.serve import recall_at, serve

    ops.reset_launches()
    out = serve(spec, queries=1024, topk=10, rho=0.05, batch=256, ingest_batch=16384,
                backend="cuda", device=dev, mutate_rate=0.3, prefilter=True, bands=8)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    print(f"prefilter path launches: {launches}")
    if launches["band_hash"] < 1:
        fail("kernel band_hash never launched on the prefilter path")
    engine, now = out["engine"], out["serve_now"]
    store = engine.store
    queries = torch.from_numpy(out["queries"]).to(dev)
    live_ids = store.live_ids
    live_dev = torch.from_numpy(live_ids).to(dev)
    totals = engine._fresh_prefilter_stats()
    worst = 0.0
    for s in range(0, len(queries), 256):
        qb = queries[s : s + 256]
        sc, ix = engine.query(qb, 10, now=now)
        stats = engine.last_prefilter_stats
        for key in totals:
            totals[key] += stats[key]
        if stats["banded_segments"] < 1:
            fail(f"no segment was scanned banded for query batch {s // 256}: {stats}")
        truth = engine.score_all(qb)  # (256, live) exhaustive scores, live ids ascending
        ix = ix.long()
        cols = torch.where(ix >= 0, torch.searchsorted(live_dev, ix.clamp_min(0)), ix)
        if not torch.equal(torch.where(ix >= 0, live_dev[cols.clamp_min(0)], ix), ix):
            fail("the prefilter served an id that is not live")
        finite = torch.isfinite(sc)
        ex = torch.gather(truth, 1, cols.clamp_min(0))
        if not torch.allclose(sc[finite], ex[finite], rtol=RTOL, atol=ATOL):
            fail("prefiltered scores differ from the exhaustive scan's scores of the same ids")
        cand = torch.from_numpy(np.searchsorted(live_ids, candidate_ids(torch, engine, qb,
                                                                        now))).to(dev)
        masked = torch.full_like(truth, float("-inf"))
        masked[:, cand] = truth[:, cand]
        cols_all = torch.arange(truth.shape[1], dtype=torch.int32, device=dev).expand_as(truth)
        want = ref.select_topk(masked, cols_all, 10)
        worst = max(worst, check_topk(torch, (sc, cols), (want[0], want[1].long()), truth,
                                      "prefiltered top-k vs the exact top-k over the candidates"))
        own = torch.from_numpy(out["query_ids"][s : s + 256]).to(dev)
        if not (ix == own[:, None]).any(dim=1).all():
            fail("a query's own doc is missing from its prefiltered result")
        del truth, masked
    frac = totals["cand_rows"] / max(totals["seg_rows"], 1)
    qps_pf = serve_batches(torch, engine, queries, now, prefilter=True)[2]
    qps_ex = serve_batches(torch, engine, queries, now, prefilter=False)[2]
    ids_ex = torch.cat([engine.query(queries[s : s + 256], 10, now=now, prefilter=False)[1]
                        for s in range(0, len(queries), 256)]).cpu().numpy()
    recall_ex = recall_at(ids_ex, out["truth_ids"], 10)
    print(f"prefilter: candidate fraction {frac:.6f}; {totals['banded_segments']} banded / "
          f"{totals['exhaustive_segments']} escape-hatch / {totals['unindexed_segments']} "
          f"unindexed segment scans over {len(queries) // 256} batches; "
          f"{qps_pf:.1f} q/s prefiltered, {qps_ex:.1f} q/s exhaustive (warm); recall@10 vs "
          f"exact Jaccard {out['recall']:.4f} prefiltered, {recall_ex:.4f} exhaustive "
          "(no floor)")
    tele = telemetry_checks(torch, engine, queries, now, "2c", prefilter=True, frac=frac)
    jobs = assert_healthy(engine, "2c")
    seg = max(store.sealed, key=lambda x: x.n_rows)
    row = band_hash_rows(torch, dev, seg.sketches, launches)
    readings = {
        "n_docs": out["n_docs"], "n_bins": out["n_bins"], "bands": 8,
        "live": int(len(live_ids)), "segments": [x.n_rows for x in store.sealed],
        "band_index": [x.band_index.stats() if x.band_index is not None else None
                       for x in store.sealed],
        "candidate_fraction": frac, **{k: int(v) for k, v in totals.items()},
        "first_queries_per_s": out["queries_per_s"], "warm_queries_per_s": qps_pf,
        "warm_queries_per_s_exhaustive": qps_ex, "speedup": qps_pf / qps_ex,
        "recall": out["recall"], "recall_exhaustive": recall_ex,
        "ingest_docs_per_s": out["docs_per_s"], "mutate_s": out["mutate_s"],
        "max_abs_err": worst, "telemetry": tele, "jobs": jobs,
    }
    return row, readings


def _clustered_corpus(rng, n_docs, n_clusters, d, nnz):
    """(n_docs, nnz) docs in near-duplicate clusters: one base doc per cluster,
    one index re-rolled per member (a copy of the JAX repo's
    ``benchmarks/bench_engine.py::_clustered_corpus``, whose package imports
    JAX)."""
    base = rng.integers(0, d, size=(n_clusters, nnz), dtype=np.int32)
    docs = base[np.arange(n_docs) % n_clusters].copy()
    swap = rng.integers(0, nnz, size=n_docs)
    docs[np.arange(n_docs), swap] = rng.integers(0, d, size=n_docs)
    return np.sort(docs, axis=1)


def prefilter_scale_phase(torch, dev, n_docs: int):
    """Phase 2d: the prefilter at the JAX repo's ``run_prefilter`` defaults
    (``bench_engine.py:202-204``): 64 near-duplicate queries, timed 5 times
    each way. Returns the readings."""
    from repro_torch.core import BinSketchConfig, make_mapping
    from repro_torch.engine import BandPolicy, QueryPlanner, SketchEngine
    from repro_torch.hopper import ops

    d, nnz, n_bins, cluster, segments, queries = 4096, 48, 512, 12, 4, 64
    rng = np.random.default_rng(0)
    cfg = BinSketchConfig(d=d, n_bins=n_bins)
    mapping = make_mapping(cfg, seed=0, device=dev)
    policy = BandPolicy()
    engine = SketchEngine.build(cfg, mapping, backend="cuda", mutable=True, band_policy=policy,
                                planner=QueryPlanner(min_batch=8, max_batch=queries))
    docs = _clustered_corpus(rng, n_docs, max(n_docs // cluster, 1), d, nnz)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seg_rows = -(-n_docs // segments)
    for s in range(0, n_docs, seg_rows):
        part = docs[s : s + seg_rows]
        sk = torch.cat([engine.backend.sketch(cfg, mapping,
                                              torch.from_numpy(part[b : b + 131072]).to(dev))
                        for b in range(0, len(part), 131072)])
        engine.store.seal_sketches(sk, backend=engine.backend)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    pick = rng.choice(n_docs, queries, replace=False)
    q_np = docs[pick].copy()
    q_np[np.arange(queries), rng.integers(0, nnz, queries)] = rng.integers(0, d, queries)
    q = torch.from_numpy(np.sort(q_np, axis=1)).to(dev)
    s_ex, i_ex = engine.query(q, 10, prefilter=False)
    s_pf, i_pf = engine.query(q, 10, prefilter=True)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    stats = dict(engine.last_prefilter_stats)
    print(f"prefilter at scale launches: {launches}")
    if launches["band_hash"] < 1:
        fail("kernel band_hash never launched at serving scale")
    ids_ex, ids_pf = i_ex.cpu().numpy(), i_pf.cpu().numpy()
    hits = sum(len(set(ids_pf[i].tolist()) & {t for t in ids_ex[i].tolist() if t >= 0})
               for i in range(queries))
    recall = hits / max(int((ids_ex >= 0).sum()), 1)
    frac = stats["cand_rows"] / max(stats["seg_rows"], 1)
    truth = engine.score_all(q)  # ids are 0..n-1, live and gap-free: column == id
    finite = torch.isfinite(s_pf)
    ex = torch.gather(truth, 1, i_pf.long().clamp_min(0))
    err = float((s_pf[finite] - ex[finite]).abs().max()) if finite.any() else 0.0
    if not torch.allclose(s_pf[finite], ex[finite], rtol=RTOL, atol=ATOL):
        fail(f"prefiltered scores at scale differ from the exhaustive ones by up to {err}")
    if recall < 0.95:
        fail(f"prefilter recall@10 against the exhaustive scan {recall:.4f} below 0.95")
    if stats["banded_segments"] < 1:
        fail(f"no segment was scanned banded at scale: {stats}")
    if not frac < policy.max_candidate_frac:
        fail(f"candidate fraction {frac} not under max_candidate_frac "
             f"{policy.max_candidate_frac}")
    del truth
    # parent-style interleaving: prefiltered, exhaustive, exhaustive, prefiltered, ...
    times = {True: [], False: []}
    for r in range(5):
        for pf in ((True, False) if r % 2 == 0 else (False, True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.query(q, 10, prefilter=pf)[1].cpu()
            times[pf].append(time.perf_counter() - t0)
    qps_pf = queries / statistics.median(times[True])
    qps_ex = queries / statistics.median(times[False])
    tele = telemetry_checks(torch, engine, q, None, "2d", prefilter=True, batch=queries,
                            frac=frac)
    assert_healthy(engine, "2d")
    print(f"prefilter at scale: {n_docs} clustered docs in {segments} segments (ingest "
          f"{n_docs / t_ingest:.1f} docs/s), {queries} near-duplicate queries: recall@10 vs "
          f"exhaustive {recall:.4f} (floor 0.95), candidate fraction {frac:.6f}, "
          f"{stats['banded_segments']} banded segments; {qps_pf:.1f} q/s prefiltered vs "
          f"{qps_ex:.1f} q/s exhaustive (ratio {qps_pf / qps_ex:.3f})")
    return {"n_docs": n_docs, "n_bins": n_bins, "d": d, "nnz": nnz, "cluster": cluster,
            "segments": segments, "queries": queries, "n_bands": policy.n_bands,
            "max_candidate_frac": policy.max_candidate_frac, "recall_vs_exhaustive": recall,
            "candidate_fraction": frac, **{k: int(v) for k, v in stats.items()},
            "queries_per_s_prefilter": qps_pf, "queries_per_s_exhaustive": qps_ex,
            "ratio": qps_pf / qps_ex, "ingest_docs_per_s": n_docs / t_ingest,
            "band_hash_launches": launches["band_hash"], "max_abs_err": err,
            "telemetry": tele}


def hash_mode_phase(torch, dev, spec, corpus, queries_np, truth_ids, n_bins: int):
    """Phase 2e: hash-mode ingest through ``ops.hash_build_sketch``, served;
    the hash_build kernel against its plain version. Returns its JSON row and
    the readings."""
    from repro_torch.core import BinSketchConfig, make_mapping, map_indices
    from repro_torch.engine import QueryPlanner, SketchEngine
    from repro_torch.hopper import ops, ref
    from repro_torch.launch.serve import recall_at

    n = len(corpus)
    cfg = BinSketchConfig(d=spec.d, n_bins=n_bins, mode="hash")
    coeffs = make_mapping(cfg, seed=0, device=dev)
    engine = SketchEngine.build(cfg, coeffs, backend="cuda", capacity=n,
                                planner=QueryPlanner(min_batch=8, max_batch=256))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, n, 16384):
        rows = torch.from_numpy(corpus[s : s + 16384]).to(dev)
        engine.store.add_sketches(ops.hash_build_sketch(rows, coeffs, n_bins))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    launches = dict(ops.launches)
    print(f"hash-mode ingest launches: {launches}")
    if launches["hash_build"] < 1:
        fail("kernel hash_build never launched on the hash-mode path")
    errs = []  # differing words of every comparison
    for s in range(0, n, 16384):  # every batch against map-then-build
        rows = torch.from_numpy(corpus[s : s + 16384]).to(dev)
        want = ops.build_sketch(map_indices(cfg, coeffs, rows), n_bins)
        errs.append(exact_err(torch, engine.store.sketches[s : s + len(rows)], want,
                              f"hash_build_sketch vs map_indices + build_sketch at batch "
                              f"{s // 16384}"))
    queries = torch.from_numpy(queries_np).to(dev)
    t0 = time.perf_counter()
    ids = torch.cat([engine.query(queries[s : s + 256], 10)[1]
                     for s in range(0, len(queries), 256)]).cpu().numpy()
    t_serve = time.perf_counter() - t0
    recall = recall_at(ids, truth_ids, 10)
    if recall < 0.3:
        fail(f"hash-mode recall@10 {recall:.3f} below 0.3")
    warm = serve_batches(torch, engine, queries, None)[2]
    assert_healthy(engine, "2e")
    print(f"hash mode: {n} docs hash-built at N={n_bins} in {t_build:.3f}s "
          f"({n / t_build:.1f} docs/s), every batch bit-equal to map-then-build; "
          f"{len(queries)} queries, recall@10 vs exact Jaccard {recall:.4f} (floor 0.3), "
          f"{len(queries) / t_serve:.1f} q/s first pass, {warm:.1f} q/s warm")

    rows = torch.from_numpy(corpus[:16384]).to(dev)
    cpu_coeffs = coeffs.cpu()
    errs.append(exact_err(torch, ops.hash_build_sketch(rows, coeffs, n_bins),
                          ref.hash_build_ref(rows, coeffs, n_bins),
                          "hash_build at the ingest shape"))
    gen = torch.Generator(device=dev).manual_seed(4)
    for b_, p_, n_ in [(1, 4, 32), (7, 33, 517), (5, 10, 20), (3, 9, 1), (64, 256, 4096),
                       (300, 1000, 35000)]:
        rb = torch.randint(0, (1 << 31) - 1, (b_, p_), generator=gen, device=dev,
                           dtype=torch.int32)
        lens = torch.randint(0, p_ + 1, (b_, 1), generator=gen, device=dev)
        rb = torch.where(torch.arange(p_, device=dev)[None, :] < lens, rb, -1).to(torch.int32)
        rb[0] = -1  # a row of pads only
        got = ops.hash_build_sketch(rb, coeffs, n_)
        errs.append(exact_err(torch, got, ref.hash_build_ref(rb, cpu_coeffs, n_),
                              f"hash_build at {(b_, p_, n_)}"))
        if got[0].any():
            fail(f"hash_build set a bit from a row of pads at {(b_, p_, n_)}")
    errs.append(bitmap_ragged(torch, dev, "hash"))
    torch.cuda.synchronize()
    print("hash_build vs plain: all agree (exact) at the ingest shape and ragged ones (P "
          "869..872, B 1..16384, N 1..393216, bases aligned and 4 bytes past, coefficients "
          "int64 and int32); library_ms: none (no single PyTorch call does a packed "
          "bit-scatter)")
    bsz, p = rows.shape
    w = cfg.n_words
    b_ms, b_by = bound_ms(4.0 * bsz * p + 4.0 * bsz * w, 3.0 * bsz * p)
    row = {"name": "hash_build", "route": "cuda",
           "source": "src/repro_torch/hopper/csrc/hash_build.cu",
           "replaces": "src/repro/kernels/hash_build.py:48",
           "launches": launches["hash_build"], "max_abs_err": max(errs),
           **timed(torch, lambda: ops.hash_build_sketch(rows, coeffs, n_bins), 20),
           "plain_ms": cuda_ms(torch, lambda: ref.hash_build_ref(rows, coeffs, n_bins), 3),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    readings = {"n_docs": n, "n_bins": n_bins, "build_s": t_build, "docs_per_s": n / t_build,
                "queries_per_s": len(queries) / t_serve, "warm_queries_per_s": warm,
                "recall": recall}
    return row, readings


def assert_healthy(engine, phase: str, allow=()) -> dict:
    """A phase run with no fault plan records nothing: no degraded component
    (but those in ``allow``), no failed, abandoned or refused job, no
    quarantine (the fallbacks of the operations plane must never hide a
    kernel or a card fault). Returns the job counters."""
    h = engine.health()
    bad = {op: c for op, c in h["jobs"].items()
           if c.get("failed") or c.get("abandoned") or c.get("refused")}
    degraded = [d for d in h["degraded"] if d["component"] not in allow]
    if degraded or bad or h["quarantined"]:
        fail(f"phase {phase} ran with no fault plan but recorded degraded {degraded}, "
             f"jobs {bad}, quarantined {h['quarantined']}")
    return h["jobs"]


def assert_nothing_left(threads_before) -> dict:
    """What the operations plane could leave to the rest of the process (and
    to ``torch.profiler``): a worker thread still alive (a job in flight, an
    asynchronous save), an armed fault plan, an installed metrics registry or
    trace collector. Threads started since ``threads_before`` are joined (a
    finished job's thread ends at once; ten seconds each at most) and must
    all have ended; the plan, the registry and the collector must be gone.
    Returns the readings."""
    from repro_torch import faults, obs

    started = [t for t in threading.enumerate() if t not in threads_before]
    for t in started:
        t.join(timeout=10.0)
    alive = [t.name for t in started if t.is_alive()]
    armed = (faults.active(), obs.metrics.active(), obs.trace.active())
    if alive or any(a is not None for a in armed):
        fail(f"the operations plane left threads {alive} alive; fault plan, metrics registry "
             f"and trace collector: {armed}")
    return {"threads_started": len(started), "threads_alive": len(alive),
            "active_count": threading.active_count(), "fault_plan": None, "metrics": None,
            "trace": None}


def check_as_it_stands(torch, engine, q, now, sc, ix, what: str, exhaustive: bool = True):
    """Answers served by ``engine`` just now against the exhaustive scores over
    its store as it stands (``Backend.score`` at each view's width: what
    ``score_all`` gives on a store of one width): each returned (id, score) is
    a live id with its own score, within rtol 1e-5 / atol 1e-6. With
    ``exhaustive``, the batch is served again with ``prefilter=False`` and must
    be the exact top-k up to score ties (the truth is taken anew if that
    query's poll swapped a finished job in). Returns the largest difference."""
    from repro_torch.hopper import ref

    truth = view_truth(torch, engine, q, now, engine.backend)
    ix = ix.long()
    finite = torch.isfinite(sc)
    own = torch.gather(truth, 1, ix.clamp_min(0))
    if not torch.isfinite(own[finite]).all():
        fail(f"{what}: an id served is not live in the store as it stands")
    err = float((sc[finite] - own[finite]).abs().max()) if finite.any() else 0.0
    if not torch.allclose(sc[finite], own[finite], rtol=RTOL, atol=ATOL):
        fail(f"{what}: served scores differ from the exhaustive ones by up to {err}")
    if exhaustive:
        layout = [id(x) for x in engine.store.sealed]
        ex_s, ex_i = engine.query(q, 10, now=now, prefilter=False)
        if [id(x) for x in engine.store.sealed] != layout:
            truth = view_truth(torch, engine, q, now, engine.backend)
        cols = torch.arange(truth.shape[1], dtype=torch.int32, device=truth.device)
        want = ref.select_topk(truth, cols.expand_as(truth), 10)
        err = max(err, check_topk(torch, (ex_s, ex_i.long()), (want[0], want[1].long()), truth,
                                  f"{what}, exhaustive"))
    return err


def ops_plane_phase(torch, dev, spec, n_bins: int, sync_ref: dict) -> dict:
    """Phase 2f: the operations plane on the card, at phase 2b's
    configuration with ``BandPolicy(n_bands=8)``. Returns its readings."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.engine import DistillPolicy, SegmentedStore, SketchEngine
    from repro_torch.hopper import ops
    from repro_torch.launch.serve import serve

    n1, n2 = n_bins // 2, n_bins // 4
    kw = dict(queries=1024, topk=10, rho=0.05, batch=256, ingest_batch=16384, backend="cuda",
              device=dev, mutate_rate=0.3, distill=(n1, n2), prefilter=True, bands=8)
    seen = {"checked": 0, "err": 0.0}

    def pending_check(engine, rows, sc, ix, pending, now):
        if pending is None:
            return
        q = torch.from_numpy(rows).to(dev)
        seen["err"] = max(seen["err"], check_as_it_stands(
            torch, engine, q, now, sc, ix, f"batch served with {pending} pending"))
        seen["checked"] += 1

    # ---- background: serve with the compaction and the ladder as jobs
    ops.reset_launches()
    t0 = time.perf_counter()
    out = serve(spec, background_compact=True, on_batch=pending_check, **kw)
    t_serve = time.perf_counter() - t0
    engine, now = out["engine"], out["serve_now"]
    if not np.array_equal(out["queries"], sync_ref["queries"]) or now != sync_ref["now"]:
        fail("phase 2f's queries differ from phase 2b's")
    if {s.n_bins for s in engine.store.sealed} != {n2} or out["n_tiers"] != 2:
        fail(f"the background ladder ended at {[s.n_bins for s in engine.store.sealed]}")
    queries = torch.from_numpy(out["queries"]).to(dev)
    settled = [engine.query(queries[s : s + 256], 10, now=now, prefilter=False)
               for s in range(0, len(queries), 256)]
    got_s = torch.cat([x[0] for x in settled]).cpu()
    got_i = torch.cat([x[1] for x in settled]).cpu()
    if not (torch.equal(got_s, torch.from_numpy(sync_ref["scores"]))
            and torch.equal(got_i, torch.from_numpy(sync_ref["ids"]))):
        fail("after its background swaps the store answers otherwise than phase 2b's "
             "synchronous store")
    print(f"background: {out['pending_batches']} serve batch(es) with a job pending, each "
          f"equal to the exhaustive answers over the store as it stood; after the swaps, "
          f"1024 answers bit-equal to phase 2b's synchronous store ({t_serve:.2f}s)")

    # ---- held jobs on the card: mutations land while a job is pinned
    store = engine.store
    rng = np.random.default_rng(11)
    live = np.concatenate([x.ids[x.valid] for x in store.sealed])
    victims = rng.choice(live, 2000, replace=False)
    fresh_rows = out["corpus"][::-1]  # other docs' contents, as updates and new docs
    engine.delete(victims[:1000])
    held = {}
    for op in ("compact", "distill"):
        hold = threading.Event()
        # the band keys of the rewritten rows are hashed on the card: a
        # compaction's at its snapshot, a distillation's in its swap
        before = ops.launches["band_hash"]
        if op == "compact":
            engine.compact(background=True, _hold=hold)
            hashed = ops.launches["band_hash"] - before
        else:
            engine.seal()  # the relocated docs: a base-width segment to fold
            engine.distill(DistillPolicy(widths=(n2,)), now=now, background=True, _hold=hold)
        if store.job_pending != op:
            fail(f"no {op} job pending under its hold")
        if op == "compact":  # deletes and relocating updates land mid-job
            engine.delete(victims[1000:1500])
            engine.update(victims[1500:2000], fresh_rows[:500], now=now)
        else:
            engine.delete(victims[1500:1600])  # tombstones in the folding segment
        errs = [check_as_it_stands(torch, engine, queries[s : s + 256], now,
                                   *engine.query(queries[s : s + 256], 10, now=now),
                                   f"query with a held {op} job")
                for s in (0, 256)]
        if store.job_pending != op:
            fail(f"the held {op} job was swapped in before its release")
        hold.set()
        before = ops.launches["band_hash"]
        stats = engine.wait_compaction()
        if op == "distill":
            hashed = ops.launches["band_hash"] - before
        if stats is None:
            fail(f"the held {op} job failed: {engine.health()['last_error']}")
        if hashed < 1:
            fail(f"the background {op} built its band index without the band_hash kernel")
        errs.append(check_as_it_stands(torch, engine, queries[:256], now,
                                       *engine.query(queries[:256], 10, now=now),
                                       f"query after the {op} swap"))
        held[op] = {**stats, "tombstones_after": int(sum(x.n_rows - x.n_live
                                                        for x in store.sealed)),
                    "band_hash_launches": hashed, "max_abs_err": max(errs)}
    engine.add(fresh_rows[500:4596], batch=4096, now=now)  # head rows for the checkpoint
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    print(f"operations plane launches: {launches}")
    for name in ("count_bins", "band_hash", "rebucket", "build_sketch", "sketch_topk"):
        if launches[name] < 1:
            fail(f"kernel {name} never launched on the operations plane's path")
    # the escape hatch is selectivity, not a fault: the held jobs' queries
    # hit small fresh segments
    jobs = assert_healthy(engine, "2f (background)", allow=("prefilter_hatch",))
    print(f"held jobs: {held}")

    # ---- checkpoint: save blocking, restore onto the card, bit-equal answers
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        mgr = CheckpointManager(ckpt, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.save(mgr, step=1, blocking=True)
        save_s = time.perf_counter() - t0
        step_dir = pathlib.Path(ckpt) / ("step_%012d" % 1)
        ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
        keys = json.loads((step_dir / "tree.json").read_text())["keys"]
        head_leaf = np.load(step_dir / ("leaf_%05d.npy" % keys.index("['head']['counters']")),
                            mmap_mode="r")
        t0 = time.perf_counter()
        back = SegmentedStore.restore(mgr, device=dev, backend=engine.backend)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        other = SketchEngine(back, engine.backend, engine.measure, engine.planner)
        for s in range(0, len(queries), 256):
            a = engine.query(queries[s : s + 256], 10, now=now)
            b = other.query(queries[s : s + 256], 10, now=now)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                fail("the restored store answers otherwise than the saved one")
        counters = store.head.counters
        checkpoint = {"save_s": save_s, "restore_s": restore_s, "bytes": ckpt_bytes,
                      "head_rows": int(store.head.size), "sealed_rows":
                      [x.n_rows for x in store.sealed],
                      "head_counter_leaf": [str(head_leaf.dtype), list(head_leaf.shape)],
                      "head_counter_bytes_saved": int(head_leaf.nbytes),
                      "head_counter_bytes_allocated":
                      counters.element_size() * counters.numel()}
        del head_leaf
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if store.job_pending is not None or back.job_pending is not None:
        fail("a background job is still pending after the checkpoint")
    print(f"checkpoint: {checkpoint}; the restored store's 1024 answers bit-equal")
    background = {"serve_s": t_serve, "pending_batches": out["pending_batches"],
                  "checked_batches": seen["checked"], "max_abs_err": seen["err"],
                  "recall": out["recall"], "distill_s": out["distill_s"],
                  "n_tiers": out["n_tiers"], "launches": launches, "jobs": jobs,
                  "held": held}
    del engine, store, out, back, other
    torch.cuda.empty_cache()

    # ---- chaos: the seeded plan over the same lifecycle
    seen.update(checked=0, err=0.0)

    def chaos_check(engine, rows, sc, ix, pending, now):
        q = torch.from_numpy(rows).to(dev)
        seen["err"] = max(seen["err"], check_as_it_stands(
            torch, engine, q, now, sc, ix, "batch served under chaos", exhaustive=False))
        seen["checked"] += 1

    out = serve(spec, chaos=0.3, chaos_seed=1234, on_batch=chaos_check, **kw)
    c, h = out["chaos"], out["health"]
    if out["engine"].store.job_pending is not None:
        fail(f"a {out['engine'].store.job_pending} job is still pending after the chaos serve")
    deg = {d["component"]: d["count"] for d in h["degraded"]}
    accounted = {}
    for point, op in (("compact.work", "compact"), ("distill.work", "distill"),
                      ("checkpoint.write", "checkpoint")):
        j = h["jobs"].get(op, {})
        accounted[point] = j.get("retries", 0) + j.get("failed", 0) + j.get("abandoned", 0)
    for point, comp in (("band.build", "band_index"), ("band.lookup", "band_lookup")):
        accounted[point] = deg.get(comp, 0)
    for point, n in c["fired"].items():
        if point == "checkpoint.leaf":
            if not c["torn"]:
                fail("torn checkpoint leaves went unnoticed by verification")
        elif n > accounted.get(point, 0):
            fail(f"{n} fault(s) at {point} but health() accounts for {accounted.get(point, 0)}")
    if c["restored_step"] in c["torn"] or c["restored_live"] < 1:
        fail(f"the restore walk-back landed on {c['restored_step']} (torn: {c['torn']})")
    print(f"chaos: {seen['checked']} batches served, none raised, every (id, score) the "
          f"exhaustive one (largest difference {seen['err']}); faults fired {c['fired']}, "
          f"accounted in health() {accounted}")
    chaos = {"fired": c["fired"], "hits": c["counters"]["hits"], "accounted": accounted,
             "jobs": h["jobs"], "retries": h["retries"], "abandoned": h["abandoned"],
             "quarantined": [q["op"] for q in h["quarantined"]], "degraded": deg,
             "saves": c["saves"], "torn": c["torn"], "restored_step": c["restored_step"],
             "restored_live": c["restored_live"], "checked_batches": seen["checked"],
             "max_abs_err": seen["err"], "recall": out["recall"]}
    del out
    return {"background": background, "checkpoint": checkpoint, "chaos": chaos}


def controller_jobs(torch):
    """Patch ``SegmentedStore`` for phase 2g so that every background job
    records the ``band_hash`` launches made for its band index: a merge's at
    its snapshot (inside ``compact_async``), a distillation's in its swap
    (inside ``_apply_swap``). In phase 2g only the lifecycle controller starts
    jobs. Returns the list of records and a function that undoes the patch."""
    from repro_torch.engine.segments import SegmentedStore
    from repro_torch.hopper import ops

    real = {n: getattr(SegmentedStore, n) for n in ("compact_async", "distill_async",
                                                    "_apply_swap")}
    jobs, by_job = [], {}

    def record(store, op, rows, backend, hashed):
        rec = {"op": op, "rows": rows, "backend": getattr(backend, "name", None),
               "indexed": store.band_policy is not None and store.band_policy.wants_index(rows),
               "band_hash": hashed, "swapped": False}
        jobs.append(rec)
        by_job[id(store._compaction.job)] = rec

    def compact_async(self, groups=None, *, backend=None, _hold=None):
        rows = sum(self.sealed[i].n_live for g in (groups or [range(len(self.sealed))])
                   for i in g)
        before = ops.launches["band_hash"]
        started = real["compact_async"](self, groups, backend=backend, _hold=_hold)
        if started:
            record(self, "compact", rows, backend, ops.launches["band_hash"] - before)
        return started

    def distill_async(self, policy, *, now=0.0, only=None, backend=None, _hold=None):
        started = real["distill_async"](self, policy, now=now, only=only, backend=backend,
                                        _hold=_hold)
        if started:
            rows = sum(s.n_live for s in self._compaction.segments)
            record(self, "distill", rows, backend, 0)
        return started

    def apply_swap(self, job):
        before = ops.launches["band_hash"]
        got = real["_apply_swap"](self, job)
        rec = by_job.get(id(job.job))
        if rec is not None:
            rec["swapped"] = got is not None
            if rec["op"] == "distill":
                rec["band_hash"] = ops.launches["band_hash"] - before
        return got

    SegmentedStore.compact_async = compact_async
    SegmentedStore.distill_async = distill_async
    SegmentedStore._apply_swap = apply_swap

    def undo():
        for n, f in real.items():
            setattr(SegmentedStore, n, f)

    return jobs, undo


def autopilot_phase(torch, dev, spec, n_bins: int) -> dict:
    """Phase 2g: ``serve --autopilot`` on the card, the lifecycle controller
    ticking once a query batch over a churning catalog. Part one: the JAX
    repo's CI soak arguments on ``tiny``; part two: ``spec`` (the NYTimes
    shape, d=102660, psi=870, N=5859) with 2048-row seals, 512 docs of churn a
    batch of 8 queries, the distill ladder (N // 2, N // 4) and the prefilter.
    Returns its readings."""
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.hopper import ops
    from repro_torch.launch.serve import serve

    readings = {}
    parts = {
        "soak": dict(spec=DATASETS["tiny"], queries=96, topk=10, batch=8, mutate_rate=0.2,
                     seal_rows=24, probe=64, churn_docs=16, autopilot_max_segments=8),
        "at_scale": dict(spec=spec, queries=512, topk=10, batch=8, ingest_batch=16384,
                         seal_rows=2048, probe=64, churn_docs=512, prefilter=True, bands=8,
                         autopilot_distill=None),
    }
    for name, kw in parts.items():
        kw = dict(kw)
        spec_ = kw.pop("spec")
        widths = ()
        if name == "at_scale":
            widths = (n_bins // 2, n_bins // 4)
            kw["autopilot_distill"] = widths
            # the size-tier bound, F * ceil(log_F S) a width, over the S
            # segments the controller can see sealed: the build's compacted
            # one and those the churn seals
            s_total = 1 + kw["queries"] // kw["batch"] * kw["churn_docs"] // kw["seal_rows"]
            kw["autopilot_max_segments"] = (1 + len(widths)) * 4 * math.ceil(
                math.log(s_total, 4))
        print(f"phase 2g {name}: {spec_.n_points} docs (d={spec_.d}, psi={spec_.max_nnz}); "
              + (f"cut from 300,000 to {spec_.n_points} by --n-points"
                 if name == "at_scale" and spec_.n_points < 300_000 else "no cut"))
        jobs, undo = controller_jobs(torch)
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            out = serve(spec_, backend="cuda", device=dev, autopilot=True, **kw)
        finally:
            undo()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ops.launches)
        engine, ap = out["engine"], out["autopilot"]
        cs = ap["controller"]
        print(f"phase 2g {name} launches: {launches}")
        if not ap["ok"]:
            fail(f"phase 2g {name}: {ap['segments']} sealed segments, above the gate "
                 f"{kw['autopilot_max_segments']}")
        if name == "soak" and not abs(out["probe"]["recall"] - 0.620) <= 0.05:
            fail(f"phase 2g soak: probe recall {out['probe']['recall']} outside the JAX "
                 "CI's gate, 0.620 +- 0.05")
        if cs["failed_ticks"] or engine.health()["jobs"].get("lifecycle", {}).get("failed"):
            fail(f"phase 2g {name}: a tick failed: {engine.health()['last_error']}")
        if engine.store.job_pending is not None:
            fail(f"phase 2g {name}: a {engine.store.job_pending} job is pending after settling")
        if len(jobs) != cs["merges"] + cs["distills"]:
            fail(f"phase 2g {name}: {len(jobs)} jobs started, the controller counts "
                 f"{cs['merges']} merges and {cs['distills']} distillations")
        for j in jobs:
            if j["backend"] != "cuda" or not j["swapped"]:
                fail(f"phase 2g {name}: a controller job ran on {j['backend']} or never "
                     f"swapped in: {j}")
            if j["indexed"] and j["band_hash"] < 1:
                fail(f"phase 2g {name}: a controller {j['op']} built its band index without "
                     f"the band_hash kernel: {j}")
        # every slab scored here is under 8192 rows (tiny's segments; at scale
        # the prefilter's candidate slabs and the head), where Backend.topk is
        # a score and a sort: sketch_topk is not on this path
        need = ["build_sketch", "sketch_score", "count_bins"]
        if name == "at_scale":
            need += ["band_hash", "rebucket"]
            if cs["merges"] < 1 or cs["distills"] < 1:
                fail(f"phase 2g {name}: the controller merged {cs['merges']} and distilled "
                     f"{cs['distills']} times; each must happen at this size")
            if not any(j["indexed"] and j["op"] == "compact" for j in jobs):
                fail(f"phase 2g {name}: no controller merge was big enough for a band index")
        for k in need:
            if launches[k] < 1:
                fail(f"phase 2g {name}: kernel {k} never launched")
        allow = ("prefilter_hatch",) if kw.get("prefilter") else ()
        assert_healthy(engine, f"2g ({name})", allow=allow)
        queries = torch.from_numpy(out["queries"]).to(dev)
        now = out["serve_now"]
        err = max(check_as_it_stands(torch, engine, queries[s : s + 256], now,
                                     *engine.query(queries[s : s + 256], 10, now=now),
                                     f"phase 2g {name}: answers after settling")
                  for s in range(0, min(len(queries), 512), 256))
        by_width = {}
        for seg in engine.store.sealed:
            by_width[seg.n_bins or out["n_bins"]] = by_width.get(seg.n_bins or out["n_bins"],
                                                                 0) + 1
        tick_ms = ap["tick_ms"]
        readings[name] = {
            "docs": out["n_docs"], "ticks": cs["ticks"], "merges": cs["merges"],
            "distills": cs["distills"], "probes": cs["probes"],
            "guardrail_trips": cs["guardrail_trips"], "segments": ap["segments"],
            "gate": kw["autopilot_max_segments"], "segments_by_width": by_width,
            "live": ap["live"], "churned": ap["churned"],
            "probe_recall": out["probe"]["recall"], "recall": out["recall"],
            "tick_ms_median": statistics.median(tick_ms), "tick_ms_max": max(tick_ms),
            "serve_s": out["serve_s"], "seconds": seconds, "launches": launches,
            "jobs": {op: {"count": sum(j["op"] == op for j in jobs),
                          "band_hash": sum(j["band_hash"] for j in jobs if j["op"] == op),
                          "indexed": sum(j["indexed"] for j in jobs if j["op"] == op)}
                     for op in ("compact", "distill")},
            "max_abs_err": err}
        print(f"phase 2g {name}: {cs['ticks']} ticks, {cs['merges']} merges, {cs['distills']} "
              f"distills, {cs['guardrail_trips']} guardrail trips, {ap['segments']} sealed "
              f"segments (gate {kw['autopilot_max_segments']}; by width {by_width}), probe "
              f"recall {out['probe']['recall']}, tick median "
              f"{statistics.median(tick_ms):.3f} ms, max {max(tick_ms):.3f} ms, "
              f"{seconds:.1f} s")
        del engine, out, queries
        torch.cuda.empty_cache()
    return readings


SHARDED_SEAL_ROWS = 32_768  # rows of a sealed segment in phase 2i's many-segment store


def slab_candidate_ids(torch, engine, queries, now) -> np.ndarray:
    """Doc ids the placed prefilter must score for the batch ``queries``,
    found without the bucket index (the plain band hash, as
    :func:`candidate_ids`), with the escape hatch acting on a whole width
    slab as the placed path applies it: one indexed segment past the hatch
    puts every live row of its width among the candidates."""
    from repro_torch.core import packed as pk
    from repro_torch.engine import ReferenceBackend

    store, cfg, pol = engine.store, engine.cfg, engine.store.band_policy
    ref_be = ReferenceBackend()
    qs = ref_be.sketch(cfg, store.mapping, queries)
    by_width = {}
    for seg in store.sealed:
        if seg.n_rows == 0:
            continue
        live = seg.valid.copy()
        if store.ttl is not None and now is not None:
            live &= seg.born + store.ttl > now
        rows, hatch = live, False
        if seg.band_index is not None:
            nb = seg.n_bins or cfg.n_bins
            qk = pk.band_hash(ref_be.rebucket(qs, cfg.n_bins, nb), pol.n_bands)
            rk = pk.band_hash(seg.sketches, pol.n_bands)
            hit = torch.zeros(seg.n_rows, dtype=torch.bool, device=rk.device)
            for t in range(rk.shape[1]):
                hit |= torch.isin(rk[:, t], qk[:, t])
            rows = hit.cpu().numpy() & live
            hatch = bool(rows.sum() > pol.max_candidate_frac * seg.n_rows)
        w = by_width.setdefault(seg.n_bins or cfg.n_bins, {"cand": [], "live": [], "hatch": False})
        w["cand"].append(seg.ids[rows])
        w["live"].append(seg.ids[live])
        w["hatch"] |= hatch
    out = [np.concatenate(w["live"] if w["hatch"] else w["cand"]) for w in by_width.values()]
    h = store.head
    live = h.valid[: h.size].copy()
    if store.ttl is not None and now is not None:
        live &= h.born[: h.size] + store.ttl > now
    out.append(h.ids[: h.size][live])
    return np.sort(np.concatenate(out))


def sharded_batches(torch, engine, mesh, queries, now, batch=256, **kw):
    """(scores, ids) of ``queries`` through ``query_sharded`` over ``mesh`` in
    batches of ``batch`` at k=10, and the warm rate in queries per second
    (host clock between syncs)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [engine.query_sharded(mesh, "data", queries[s : s + batch], 10, now=now, **kw)
           for s in range(0, len(queries), batch)]
    torch.cuda.synchronize()
    qps = len(queries) / (time.perf_counter() - t0)
    return torch.cat([g[0] for g in got]), torch.cat([g[1] for g in got]), qps


def held_to(torch, engine, queries, now, got, want, what: str) -> float:
    """``got`` against ``want`` over the batches of 256 of ``queries``, up to
    score ties in the exhaustive scores over the store as it stands
    (:func:`view_truth` through the engine's backend, a batch at a time).
    Returns the largest score difference."""
    err = 0.0
    for s in range(0, len(queries), 256):
        truth = view_truth(torch, engine, queries[s : s + 256], now, engine.backend)
        err = max(err, check_topk(torch, (got[0][s : s + 256], got[1][s : s + 256].long()),
                                  (want[0][s : s + 256], want[1][s : s + 256].long()), truth,
                                  f"{what}, batch {s // 256}"))
        del truth
    return err


def sharded_serve_part(torch, dev, spec, n_bins: int, sync_ref: dict, mut: dict) -> dict:
    """Phase 2i (a): ``serve(sharded=True)`` at phase 2b's configuration, held
    to phase 2b's served answers and recall."""
    from repro_torch.launch.serve import serve

    out = serve(spec, queries=1024, topk=10, rho=0.05, batch=256, ingest_batch=16384,
                backend="cuda", device=dev, mutate_rate=0.3, distill=(n_bins // 2, n_bins // 4),
                sharded=True)
    torch.cuda.synchronize()
    engine, now = out["engine"], out["serve_now"]
    cards = (tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
             if dev.type == "cuda" else (dev,))
    if out["mesh"].devices != cards:
        fail(f"serve's mesh {out['mesh']} is not every card")
    if not np.array_equal(out["queries"], sync_ref["queries"]) or now != sync_ref["now"]:
        fail("phase 2i's queries differ from phase 2b's")
    queries = torch.from_numpy(out["queries"]).to(dev)
    err = held_to(torch, engine, queries, now,
                  (torch.from_numpy(out["scores"]).to(dev), torch.from_numpy(out["ids"]).to(dev)),
                  (torch.from_numpy(sync_ref["scores"]).to(dev),
                   torch.from_numpy(sync_ref["ids"]).to(dev)),
                  "serve(sharded=True) vs phase 2b's serve")
    recalls = (out["pre_distill"]["recall"], out["recall"])
    want = (mut["recall_before_distill"], mut["recall_after_distill"])
    if recalls != want:
        fail(f"the sharded serve's recall {recalls} differs from phase 2b's {want}")
    hist = out["metrics"]["histograms"].get("query.query_sharded_s", {})
    if hist.get("count") != 8:
        fail(f"serve(sharded=True) recorded {hist.get('count')} calls in query.query_sharded_s, "
             "not 8")
    counters = out["metrics"]["counters"]
    bit_equal = bool(np.array_equal(out["ids"], sync_ref["ids"])
                     and np.array_equal(out["scores"], sync_ref["scores"]))
    print(f"phase 2i serve: recall {recalls[0]} before and {recalls[1]} after distillation "
          f"(phase 2b's); answers {'bit-equal' if bit_equal else 'equal up to score ties'} "
          f"to phase 2b's; {counters.get('placement.builds')} placement builds")
    assert_healthy(engine, "2i serve")
    return {"recall_before_distill": recalls[0], "recall_after_distill": recalls[1],
            "bit_equal_to_2b": bit_equal, "max_abs_err": err,
            "first_queries_per_s": out["queries_per_s"],
            "pre_distill_first_queries_per_s": out["pre_distill"]["queries_per_s"],
            "placement_builds": counters.get("placement.builds"),
            "mask_refreshes": counters.get("placement.mask_refreshes"),
            "queries": queries}


def many_segment_part(torch, dev, cfg, mapping, corpus, fresh_rows, queries) -> dict:
    """Phase 2i (b): a store sealed every 32,768 rows, 10% deleted and 5%
    updated, its older half distilled to N // 2, with 8 bands, served on four
    shards of ``cuda:0``: placed exhaustive, placed prefiltered and sliced
    passes held to ``query`` with the same prefilter flag, then a held
    device-local compaction while queries and mutations land."""
    from repro_torch.engine import (BandPolicy, CudaBackend, DistillPolicy, QueryPlanner,
                                    SketchEngine)
    from repro_torch.hopper import ops, ref
    from repro_torch.parallel import make_mesh

    n = len(corpus)
    n1 = cfg.n_bins // 2
    # a rehearsal's smaller corpus (--n-points) still makes about 10
    # segments; its slabs then fall under the top-k crossover, whose checks
    # hold only at scale
    seal_rows = min(SHARDED_SEAL_ROWS, max(n // 9, 1024))
    at_scale = n >= 9 * SHARDED_SEAL_ROWS
    engine = SketchEngine.build(cfg, mapping, backend="cuda", mutable=True,
                                seal_rows=seal_rows, band_policy=BandPolicy(n_bands=8),
                                planner=QueryPlanner(min_batch=8, max_batch=256),
                                capacity=seal_rows)
    store = engine.store
    reg = engine.enable_metrics()
    t0 = time.perf_counter()
    for s in range(0, n, seal_rows):  # the older half born at 0, the rest at 10
        engine.add(corpus[s : s + seal_rows], batch=16384, now=0.0 if s < n // 2 else 10.0)
    engine.seal()  # the tail
    rng = np.random.default_rng(11)
    victims = rng.choice(n, n * 15 // 100, replace=False)
    dele, upd = victims[: n // 10], victims[n // 10 :]
    engine.delete(dele.tolist())
    engine.update(upd.tolist(), fresh_rows[upd], now=10.0)
    if engine.distill(DistillPolicy(widths=(n1,), min_age=5.0), now=10.0) is None:
        fail("phase 2i: the distillation of the older segments did not run")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    widths = sorted({seg.n_bins or cfg.n_bins for seg in store.sealed}, reverse=True)
    if widths != [cfg.n_bins, n1]:
        fail(f"phase 2i: sealed widths {widths}, not [{cfg.n_bins}, {n1}]")
    mesh = make_mesh((4,), ("data",))
    if mesh.devices != (dev,) * 4:
        fail(f"make_mesh((4,)) on one card gave {mesh.devices}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placement = engine._ensure_placement(mesh, "data")
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    if placement.widths != widths or any(t.device != dev for s in placement.slabs
                                         for t in s.sketches + s.fills + s.ids):
        fail(f"phase 2i: placement widths {placement.widths} or a slab off the card")
    small = [s.n_local for s in placement.slabs if s.n_local < CudaBackend.topk_crossover]
    if small and at_scale:
        fail(f"phase 2i: shard slabs of {small} rows sit under the top-k kernel's crossover")
    print(f"phase 2i store: {len(store.sealed)} sealed segments at widths "
          f"{[seg.n_bins or cfg.n_bins for seg in store.sealed]}, head {store.head.size} rows, "
          f"live {store.size}; placement on 4 shards of {dev}: {placement.assign}, slabs of "
          f"{[s.n_local for s in placement.slabs]} rows a shard, {placement.nbytes} bytes, "
          f"built in {place_s:.3f}s")

    # ---- exhaustive: placed and sliced against query
    single_ex = serve_batches(torch, engine, queries, None, prefilter=False)
    mid = dict(ops.launches)
    placed_ex = sharded_batches(torch, engine, mesh, queries, None, prefilter=False)
    placed_topk = ops.launches["sketch_topk"] - mid["sketch_topk"]
    # four batches, each a pass per shard and width plus the head
    if at_scale and placed_topk != 4 * (4 * len(widths) + 1):
        fail(f"the placed pass launched sketch_topk {placed_topk} times, not "
             f"{4 * (4 * len(widths) + 1)}")
    sliced = sharded_batches(torch, engine, mesh, queries, None, use_placement=False)
    errs = {"placed": held_to(torch, engine, queries, None, placed_ex, single_ex,
                              "placed exhaustive vs query"),
            "sliced": held_to(torch, engine, queries, None, sliced, single_ex,
                              "sliced vs query")}

    # ---- prefiltered: placed against query(prefilter=True) and the exact
    # top-k over the slab candidates
    totals = engine._fresh_prefilter_stats()
    band_before = ops.launches["band_hash"]
    compared = 0
    errs["prefiltered"] = 0.0
    for s in range(0, len(queries), 256):
        qb = queries[s : s + 256]
        sc, ix = engine.query_sharded(mesh, "data", qb, 10, prefilter=True)
        st = dict(engine.last_prefilter_stats)
        for key in totals:
            totals[key] += st[key]
        if st["banded_segments"] < 1:
            fail(f"no segment was scanned banded on the placed path, batch {s // 256}: {st}")
        truth = view_truth(torch, engine, qb, None, engine.backend)
        cand = torch.from_numpy(slab_candidate_ids(torch, engine, qb, None)).to(dev)
        masked = torch.full_like(truth, float("-inf"))
        masked[:, cand] = truth[:, cand]
        cols = torch.arange(truth.shape[1], dtype=torch.int32, device=dev).expand_as(truth)
        want = ref.select_topk(masked, cols, 10)
        errs["prefiltered"] = max(errs["prefiltered"], check_topk(
            torch, (sc, ix.long()), (want[0], want[1].long()), truth,
            "placed prefilter vs the exact top-k over the slab candidates"))
        ws, wi = engine.query(qb, 10, prefilter=True)
        if st["exhaustive_segments"] == 0 and engine.last_prefilter_stats[
                "exhaustive_segments"] == 0:
            compared += 1  # no escape hatch on either path: the same candidates
            check_topk(torch, (sc, ix.long()), (ws, wi.long()), truth,
                       "placed prefilter vs query(prefilter=True)")
        del truth, masked
    if ops.launches["band_hash"] == band_before:
        fail("band_hash never launched on the placed prefiltered pass")
    frac = totals["cand_rows"] / max(totals["seg_rows"], 1)

    # ---- warm rates on the same engine (readings); no mask refresh without
    # a tombstone epoch
    refreshes = reg.counter("placement.mask_refreshes")
    rates = {"single_exhaustive": serve_batches(torch, engine, queries, None,
                                                prefilter=False)[2],
             "placed_exhaustive": sharded_batches(torch, engine, mesh, queries, None,
                                                  prefilter=False)[2],
             "sliced": sharded_batches(torch, engine, mesh, queries, None,
                                       use_placement=False)[2],
             "single_prefiltered": serve_batches(torch, engine, queries, None,
                                                 prefilter=True)[2],
             "placed_prefiltered": sharded_batches(torch, engine, mesh, queries, None,
                                                   prefilter=True)[2]}
    if reg.counter("placement.mask_refreshes") != refreshes:
        fail("a placed pass refreshed a validity mask with no tombstone epoch moved")
    epochs = [store._valid_epoch]

    # ---- a device-local compaction held while queries and mutations land
    # the placement's groups, split by width; a lone tombstone-free segment
    # (a distilled one: the fold drops dead rows) has nothing to merge
    groups = [[i for i in g if store.sealed[i].n_bins == w] for g in placement.assign
              for w in {store.sealed[i].n_bins for i in g}]
    groups = [g for g in groups if len(g) > 1 or not store.sealed[g[0]].valid.all()]
    hold = threading.Event()
    engine.compact(background=True, _hold=hold)
    job = store._compaction
    if job is None or sorted(id(x) for x in job.segments) != sorted(
            id(store.sealed[i]) for g in groups for i in g):
        fail(f"the background compaction did not take the placement's device-local groups "
             f"{groups}: it took segments {[[y is x for y in store.sealed].index(True) for x in job.segments]}")
    qb = queries[:256]
    during = engine.query_sharded(mesh, "data", qb, 10, prefilter=False)
    errs["held"] = held_to(torch, engine, qb, None, during,
                           engine.query(qb, 10, prefilter=False), "placed, compaction held")
    sealed_live = np.concatenate([seg.ids[seg.valid] for seg in store.sealed])
    pick = rng.choice(sealed_live, 1536, replace=False)
    engine.delete(pick[:1024].tolist())
    engine.update(pick[1024:].tolist(), fresh_rows[:512], now=10.0)
    epochs.append(store._valid_epoch)
    during = engine.query_sharded(mesh, "data", qb, 10, prefilter=False)
    errs["held_mutated"] = held_to(torch, engine, qb, None, during,
                                   engine.query(qb, 10, prefilter=False),
                                   "placed, compaction held, after mutations")
    hold.set()
    stats = engine.wait_compaction()
    if stats is None or stats["groups"] != len(groups):
        fail(f"the device-local compaction merged {stats and stats['groups']} groups, not "
             f"{len(groups)}")
    after = sharded_batches(torch, engine, mesh, queries, None, prefilter=False)
    errs["after_swap"] = held_to(torch, engine, queries, None, after,
                                 serve_batches(torch, engine, queries, None, prefilter=False),
                                 "placed after the device-local compaction vs query")
    dead = torch.from_numpy(pick[:1024]).to(dev)
    if torch.isin(after[1], dead).any():
        fail("a doc deleted while the compaction was held came back after its swap")
    epochs.append(store._valid_epoch)
    print(f"phase 2i passes: placed, sliced and prefiltered answers equal query's (largest "
          f"differences {errs}); candidate fraction {frac:.6f}, {compared} of 4 prefiltered "
          f"batches free of the escape hatch and compared with query(prefilter=True); "
          f"warm q/s {rates}; compaction {stats}")
    assert_healthy(engine, "2i", allow=("prefilter_hatch",))
    snap = reg.snapshot()["counters"]
    return {"segments": sum(len(g) for g in placement.assign),
            "segments_after_compaction": len(store.sealed), "widths": widths,
            "live": int(store.size), "head_rows": int(store.head.size), "build_s": build_s,
            "placement": {"assign": placement.assign, "n_local": [s.n_local
                                                                  for s in placement.slabs],
                          "build_s": place_s, "resident_bytes": placement.nbytes},
            "placed_topk_launches": placed_topk, "candidate_fraction": frac,
            **{f"prefilter_{k}": int(v) for k, v in totals.items()},
            "prefiltered_batches_compared": compared, "queries_per_s": rates,
            "max_abs_err": errs, "compaction": stats,
            "mask_refreshes": snap.get("placement.mask_refreshes"),
            "placement_builds": snap.get("placement.builds"), "tombstone_epochs": epochs}


def sliced_part(torch, dev, cfg, mapping, corpus, queries) -> dict:
    """Phase 2i (c): the sliced path on an append-only store of the whole
    corpus over seven shards of ``cuda:0`` (a C seven does not divide)."""
    from repro_torch.engine import QueryPlanner, SketchEngine
    from repro_torch.parallel import make_mesh

    engine = SketchEngine.build(cfg, mapping, corpus, backend="cuda", batch=16384,
                                planner=QueryPlanner(min_batch=8, max_batch=256))
    n = engine.store.size
    mesh = make_mesh((7,), ("data",))
    padded = 7 * -(-n // 7)
    single = serve_batches(torch, engine, queries, None)
    sliced = sharded_batches(torch, engine, mesh, queries, None)
    err = held_to(torch, engine, queries, None, sliced, single, "sliced on 7 shards vs query")
    tail = torch.from_numpy(corpus[n - 16 :]).to(dev)
    _, tail_ids = engine.query_sharded(mesh, "data", tail, 10)
    if not (tail_ids == torch.arange(n - 16, n, device=dev)[:, None]).any(dim=1).all():
        fail("a doc of the padded tail shard is missing from its own query's answers")
    rates = {"single": serve_batches(torch, engine, queries, None)[2],
             "sliced": sharded_batches(torch, engine, mesh, queries, None)[2]}
    print(f"phase 2i sliced: {n} docs over 7 shards ({padded} padded rows), answers equal "
          f"query's (largest difference {err}); warm q/s {rates}")
    return {"n_docs": n, "shards": 7, "padded_rows": padded, "max_abs_err": err,
            "queries_per_s": rates}


def mixed_device_part(torch, dev, cfg, mapping, corpus, fresh_rows, queries) -> dict:
    """Phase 2i (d): a mesh of ``cuda:0`` and the CPU at 4,096 docs, the one-card
    stand-in for copies between devices: each shard's slab on its own device,
    the answers equal to the card's ``query``."""
    from repro_torch.engine import SketchEngine
    from repro_torch.parallel import make_mesh

    engine = SketchEngine.build(cfg, mapping, backend="cuda", mutable=True, seal_rows=1024)
    engine.add(corpus[:4096], batch=1024)
    engine.delete(list(range(0, 4096, 37)))
    engine.update([5, 1500, 3000], fresh_rows[:3])
    mesh = make_mesh((2,), ("data",), devices=[dev, "cpu"])
    q = queries[:64]
    want = engine.query(q, 10)
    err = 0.0
    for use_placement in (True, False):
        got = engine.query_sharded(mesh, "data", q, 10, use_placement=use_placement)
        if got[0].device != dev:
            fail(f"the mixed mesh answered on {got[0].device}, not {dev}")
        err = max(err, held_to(torch, engine, q, None, got, want,
                               f"mesh (cuda:0, cpu), placement={use_placement}"))
    p = engine._placement
    where = [[str(t.device) for t in s.sketches] for s in p.slabs]
    if any(w != [str(dev), "cpu"] for w in where):
        fail(f"the mixed mesh's slabs sit on {where}")
    print(f"phase 2i mixed devices: slabs on {where}, placement {p.assign}; answers equal "
          f"the card's query (largest difference {err})")
    return {"n_docs": 4096, "devices": [str(dev), "cpu"], "assign": p.assign,
            "max_abs_err": err}


def sharded_phase(torch, dev, spec, n_bins: int, sync_ref: dict, mut: dict) -> dict:
    """Phase 2i: multi-device serving on one card. Launch counters are zeroed
    before and read after; returns the ``{"sharded": ...}`` readings."""
    from repro_torch import obs
    from repro_torch.core import BinSketchConfig, make_mapping
    from repro_torch.hopper import ops
    from repro_torch.launch import serve as serve_mod

    ops.reset_launches()
    readings = {"serve": sharded_serve_part(torch, dev, spec, n_bins, sync_ref, mut)}
    queries = readings["serve"].pop("queries")
    torch.cuda.empty_cache()
    corpus, lens = serve_mod.generate_corpus(spec, seed=0)  # memoised: serve's draws
    fresh_rows, _ = serve_mod.generate_corpus(spec, seed=1)
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), 0.05)
    if cfg.n_bins != n_bins:
        fail(f"phase 2i: N={cfg.n_bins}, not phase 2's {n_bins}")
    mapping = make_mapping(cfg, seed=0, device=dev)  # serve's draw
    try:
        readings["many_segments"] = many_segment_part(torch, dev, cfg, mapping, corpus,
                                                      fresh_rows, queries)
    finally:
        obs.disable()
    torch.cuda.empty_cache()
    readings["sliced_append_only"] = sliced_part(torch, dev, cfg, mapping, corpus, queries)
    torch.cuda.empty_cache()
    readings["mixed_devices"] = mixed_device_part(torch, dev, cfg, mapping, corpus, fresh_rows,
                                                  queries)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    print(f"phase 2i launches: {launches}")
    for name in ("build_sketch", "sketch_topk", "rebucket", "band_hash"):
        if launches[name] < 1:
            fail(f"kernel {name} never launched in phase 2i")
    readings["launches"] = launches
    return readings


DEDUP_PLANTED = 64  # planted 0.95-Jaccard pairs appended to the corpus (phase 2h)
DEDUP_CPU_ROWS = 4096  # rows of the card-against-CPU dedup check
BASELINE_ROWS = 16_384  # rows each baseline sketches on the card
BASELINE_CPU_ROWS = 256  # of those, the rows the CPU sketches again


def pair_truth(a, b):
    """Exact Jaccard and cosine of aligned padded rows (numpy, pad = -1)."""
    js, cos = [], []
    for x, y in zip(a, b):
        x, y = set(x[x >= 0].tolist()), set(y[y >= 0].tolist())
        inter = len(x & y)
        js.append(inter / max(len(x | y), 1))
        cos.append(inter / max(math.sqrt(len(x) * len(y)), 1e-12))
    return np.array(js), np.array(cos)


def baseline_sketchers(torch, n_bins: int, d: int) -> dict:
    """Phase 2h's competitors: name -> (make(device) -> parameters, sketch(
    parameters, rows) as the gate reads it, estimates(sketch_a, sketch_b) ->
    {measure: (B,)}, the timed user call or None for the same). BCS at N
    bins, MinHash, DOPH, SimHash and CBE at k = N, OddSketch at
    suggested_k(N, 0.9); CBE's gate reads its float32 projections, its user
    call returns the sign bits."""
    from repro_torch.core.baselines import bcs, cbe, doph, minhash, oddsketch, simhash

    k_odd = oddsketch.suggested_k(n_bins, 0.9)

    def mh_est(a, b):
        return minhash.estimates(a[0], b[0], a[1], b[1])

    def cbe_est(a, b):
        return cbe.estimates((a >= 0).to(torch.uint8), (b >= 0).to(torch.uint8))

    return {
        "bcs": (lambda dv: bcs.make_mapping(d, n_bins, device=dv),
                lambda p, x: bcs.sketch_indices(p, n_bins, x),
                lambda a, b: bcs.estimates(a, b, n_bins), None),
        "minhash": (lambda dv: minhash.make_hashes(n_bins, device=dv), minhash.sketch_indices,
                    mh_est, None),
        "doph": (lambda dv: doph.make_hashes(device=dv),
                 lambda p, x: doph.sketch_indices(p, n_bins, x), mh_est, None),
        "oddsketch": (lambda dv: oddsketch.make_hashes(k_odd, device=dv),
                      lambda p, x: oddsketch.sketch_indices(p, n_bins, x),
                      lambda a, b: oddsketch.estimates(a, b, n_bins, k_odd), None),
        "simhash": (lambda dv: simhash.make_hashes(n_bins, device=dv), simhash.sketch_indices,
                    simhash.estimates, None),
        "cbe": (lambda dv: cbe.make_params(d, device=dv),
                lambda p, x: cbe.project_indices(p, n_bins, d, x), cbe_est,
                lambda p, x: cbe.sketch_indices(p, n_bins, d, x)),
    }


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def dedup_check(torch, dev, docs, planted, n_bins: int, card: str) -> dict:
    """Phase 2h, first part: ``find_near_duplicates`` over ``docs`` on the
    card through its defaults (its own Ψ), then the same search over the
    first rows on the card and on the CPU under one Ψ."""
    from repro_torch.core import BinSketchConfig, binsketch, make_mapping
    from repro_torch.core import packed as pk
    from repro_torch.data import find_near_duplicates
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.engine import CudaBackend, QueryPlanner
    from repro_torch.hopper import ops, ref

    d, n = DATASETS["nytimes"].d, docs.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    pairs = find_near_duplicates(docs, d, threshold=0.8, chunk=1024)
    seconds = time.perf_counter() - t0
    launches = {k: ops.launches[k] for k in ("build_sketch", "sketch_score")}
    peak = torch.cuda.max_memory_allocated()
    missed = planted - {(i, j) for i, j, _ in pairs}
    if missed:
        fail(f"phase 2h: {len(missed)} of {len(planted)} planted pairs not found: "
             f"{sorted(missed)[:4]}")
    chunks = len(QueryPlanner(min_batch=8, max_batch=1024).plan(n))
    if launches["sketch_score"] != chunks or launches["build_sketch"] < 1:
        fail(f"phase 2h: dedup launched {launches}, not {chunks} score kernels and a build")

    # each reported estimate against the plain score of its pair, on the
    # card, under the Ψ dedup drew for itself (seed 0)
    psi = int((docs >= 0).sum(1).max())
    cfg = BinSketchConfig.from_sparsity(d, psi, 0.05)
    if cfg.n_bins != n_bins:
        fail(f"phase 2h: N={cfg.n_bins}, not phase 2's {n_bins}")
    mapping = make_mapping(cfg, seed=0, device=dev)
    est = torch.tensor([s for *_, s in pairs], dtype=torch.float32, device=dev)
    plain = []
    for s in range(0, len(pairs), 1024):
        si, sj = (binsketch.sketch_indices(
            cfg, mapping, torch.from_numpy(docs[[p[side] for p in pairs[s : s + 1024]]]).to(dev))
            for side in (0, 1))
        plain.append(torch.diagonal(ref.sketch_score_ref(si, sj, cfg.n_bins, "jaccard")))
    plain = torch.cat(plain)
    pair_err = float((est - plain).abs().max())
    if not torch.allclose(est, plain, rtol=RTOL, atol=ATOL):
        fail(f"phase 2h: reported estimates differ from the plain scores by up to {pair_err}")

    # the score kernel at the path's chunk shape: its own device time
    backend = CudaBackend()
    corpus = torch.cat([backend.sketch(cfg, mapping, torch.from_numpy(docs[s : s + 16384]).to(dev))
                        for s in range(0, n, 16384)])
    fills = pk.row_popcount(corpus)
    score_kernel_ms = device_ms(torch, lambda: ops.sketch_score(
        corpus[:1024], corpus, cfg.n_bins, "jaccard", a_fills=fills[:1024], b_fills=fills))
    del corpus, fills
    torch.cuda.empty_cache()
    print(f"phase 2h dedup: {len(pairs)} pairs over {n} docs (all {len(planted)} planted "
          f"found) in {seconds:.3f} s, peak device memory {peak} bytes, launches {launches}, "
          f"largest difference from the plain score {pair_err}; sketch_score kernel "
          f"{score_kernel_ms:.4f} ms at (1024, {n}, {cfg.n_words} words), x {chunks} chunks "
          f"{score_kernel_ms * chunks / 1e3:.3f} s; on {card}")

    # card against CPU (the reference backend), the first rows, the same Ψ
    thr = 0.3  # low enough that uniform docs give hundreds of pairs
    kw = dict(threshold=thr, psi=psi, rho=0.05, chunk=1024)
    rows = docs[:DEDUP_CPU_ROWS]
    on_card = find_near_duplicates(rows, d, device=dev, mapping=mapping, **kw)
    on_cpu = find_near_duplicates(rows, d, backend="reference", device="cpu",
                                  mapping=mapping.cpu(), **kw)
    got, want = {(i, j): s for i, j, s in on_card}, {(i, j): s for i, j, s in on_cpu}
    edge = set(got) ^ set(want)
    if any(abs(got.get(p, want.get(p)) - thr) > 1e-5 for p in edge):
        fail(f"phase 2h: card and CPU dedup differ in pairs away from the threshold: "
             f"{sorted(edge)[:4]}")
    if ([p for p in got if p in want] != [p for p in want if p in got] or not want):
        fail("phase 2h: card and CPU dedup list their pairs in another order, or none")
    common = np.array([[got[p], want[p]] for p in got if p in want])
    cpu_err = float(np.abs(common[:, 0] - common[:, 1]).max())
    if not np.allclose(common[:, 0], common[:, 1], rtol=RTOL_REF, atol=ATOL_REF):
        fail(f"phase 2h: card and CPU dedup estimates differ by up to {cpu_err}")
    print(f"phase 2h dedup card vs CPU: {len(on_card)} and {len(on_cpu)} pairs at threshold "
          f"{thr} over the first {len(rows)} docs, {len(edge)} within 1e-5 of it, largest "
          f"estimate difference {cpu_err}")
    return {"n_docs": n, "pairs": len(pairs), "planted_found": len(planted), "seconds": seconds,
            "peak_device_bytes": peak, "launches": launches,
            "max_abs_err_vs_plain": pair_err, "score_kernel_ms": score_kernel_ms,
            "score_shape": [1024, n, cfg.n_words],
            "vs_cpu": {"rows": len(rows), "threshold": thr, "pairs_card": len(on_card),
                       "pairs_cpu": len(on_cpu), "at_threshold": len(edge),
                       "max_abs_err": cpu_err}}


def baselines_check(torch, dev, docs, n_bins: int, card: str) -> dict:
    """Phase 2h, second part: each baseline on the card against the same
    function on the CPU, its time a document beside BinSketch's, and its
    estimators' mean squared error over planted pairs."""
    from repro_torch.core import BinSketchConfig, estimators, make_mapping
    from repro_torch.core import packed as pk
    from repro_torch.data import generate_similar_pairs
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.engine import CudaBackend

    nyt = DATASETS["nytimes"]
    rows = torch.from_numpy(docs[:BASELINE_ROWS]).to(dev)
    rows_cpu = rows[:BASELINE_CPU_ROWS].cpu()
    norm = (rows_cpu >= 0).sum(1, keepdim=True).double().sqrt()
    cfg = BinSketchConfig(d=nyt.d, n_bins=n_bins)
    mapping = make_mapping(cfg, seed=0, device=dev)
    backend = CudaBackend()
    per_doc = {"binsketch": cuda_ms(torch, lambda: backend.sketch(cfg, mapping, rows), 5)
               / BASELINE_ROWS}
    pairs = {j: generate_similar_pairs(nyt, j, 64) for j in (0.9, 0.5)}
    truth = {j: pair_truth(a, b) for j, (a, b, _) in pairs.items()}
    dev_pairs = {j: (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
                 for j, (a, b, _) in pairs.items()}

    def mse(est, j):
        out = {}
        for m, col in (("jaccard", 0), ("cosine", 1)):
            if m in est:
                e = est[m].double().cpu().numpy()
                out[m] = float(np.mean((e - truth[j][col]) ** 2))
        return out

    errors = {"binsketch": {}}
    for j, (qa, qb) in dev_pairs.items():
        sa, sb = backend.sketch(cfg, mapping, qa), backend.sketch(cfg, mapping, qb)
        errors["binsketch"][str(j)] = mse(estimators.estimates_from_counts(
            pk.row_popcount(sa), pk.row_popcount(sb), pk.row_popcount(sa & sb), n_bins), j)
    unclear = {}
    for name, (make, sketch, estimate, user) in baseline_sketchers(torch, n_bins, nyt.d).items():
        params, params_cpu = as_tuple(make(dev)), as_tuple(make("cpu"))
        if any(not torch.equal(p.cpu(), q) for p, q in zip(params, params_cpu)):
            fail(f"phase 2h: {name}'s parameters differ between the card and the CPU")
        unpack = (lambda p: p) if len(params) > 1 else (lambda p: p[0])
        on_card = as_tuple(sketch(unpack(params), rows))
        on_cpu = as_tuple(sketch(unpack(params_cpu), rows_cpu))
        if name == "cbe":  # float32 FFTs: the sign holds wherever |projection| is clear of 0
            clear = on_cpu[0].double().abs() > 1e-3 * norm
            unclear[name] = int((~clear).sum())
            g, w = on_card[0][:BASELINE_CPU_ROWS].cpu() >= 0, on_cpu[0] >= 0
            if not torch.equal(g[clear], w[clear]):
                fail("phase 2h: cbe's bits differ between the card and the CPU off 0")
        else:
            for g, w in zip(on_card, on_cpu):
                exact_err(torch, g[:BASELINE_CPU_ROWS].cpu(), w, f"phase 2h {name} on the card")
        call = user or sketch
        per_doc[name] = cuda_ms(torch, lambda: call(unpack(params), rows), 3) / BASELINE_ROWS
        errors[name] = {str(j): mse(estimate(sketch(unpack(params), qa),
                                             sketch(unpack(params), qb)), j)
                        for j, (qa, qb) in dev_pairs.items()}
        del on_card
        torch.cuda.empty_cache()
    order = sorted(per_doc, key=per_doc.get)
    print(f"phase 2h baselines: card equal to the CPU over the first {BASELINE_CPU_ROWS} rows "
          f"(integer sketches bit for bit; cbe's bits off the rounding band, "
          f"{unclear.get('cbe', 0)} lanes within 1e-3 |x| of 0); ms a document at "
          f"{BASELINE_ROWS} rows: " + ", ".join(f"{k} {per_doc[k]:.6f}" for k in order)
          + f"; on {card}")
    for name, by_j in errors.items():
        print(f"  {name} MSE: " + "; ".join(
            f"J={j}: " + ", ".join(f"{m} {v:.6g}" for m, v in e.items()) for j, e in by_j.items())
            + f" ({card})")
    return {"rows": BASELINE_ROWS, "cpu_rows": BASELINE_CPU_ROWS, "n_bins": n_bins,
            "ms_per_doc": per_doc, "order": order, "mse": errors,
            "cbe_lanes_near_zero": unclear.get("cbe", 0)}


def near_duplicates_phase(torch, dev, corpus, n_bins: int, card: str) -> dict:
    """Phase 2h: phase 2's corpus with planted duplicates through
    :func:`dedup_check`, then :func:`baselines_check` on its first rows."""
    from repro_torch.data import generate_similar_pairs
    from repro_torch.data.synthetic import DATASETS

    a, b, _ = generate_similar_pairs(DATASETS["nytimes"], jaccard=0.95, n_pairs=DEDUP_PLANTED)
    n0 = corpus.shape[0]
    docs = np.concatenate([corpus, a, b])
    planted = {(n0 + k, n0 + DEDUP_PLANTED + k) for k in range(DEDUP_PLANTED)}
    out = {"card": card, "dedup": dedup_check(torch, dev, docs, planted, n_bins, card)}
    torch.cuda.empty_cache()
    out["baselines"] = baselines_check(torch, dev, docs, n_bins, card)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-points", type=int, default=300_000,
                    help="corpus documents (default: the UCI NYTimes count)")
    ap.add_argument("--prefilter-docs", type=int, default=1_000_000,
                    help="clustered documents of the prefilter at serving scale (phase 2d; "
                         "default: the JAX repo's run_prefilter default)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "hopper" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not beside this file ({SRC})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import binsketch, packed as pk
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.engine import CudaBackend
    from repro_torch.hopper import build, ops, ref
    from repro_torch.launch.serve import serve

    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {' '.join(build.NVCC_FLAGS[:2])}) -> {build.BUILD_DIR}")
    rate = b1_rate(torch, dev)
    print(f"b1 tensor-core rate: {rate:.6e} bit-AND-popcount multiply-adds/s (wgmma "
          f"m64n128k256.s32.b1.b1.and.popc in a loop, operands in shared memory) on {card}")

    # ------------------------------------------------------------ main path
    spec = dataclasses.replace(DATASETS["nytimes"], n_points=args.n_points)
    share_corpora()
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        phase_s[name] = time.perf_counter() - t_phase
        print(f"phase {name}: {phase_s[name]:.1f}s")
        t_phase = time.perf_counter()

    ops.reset_launches()
    out = serve(spec, queries=1024, topk=10, rho=0.05, batch=256,
                ingest_batch=16384, backend="cuda", device=dev)
    engine = out["engine"]
    q64 = out["queries"][:64]
    s_all = engine.score_all(q64)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    print(f"main path launches: {launches}")
    if out["recall"] < 0.3:
        fail(f"recall@10 {out['recall']:.3f} below 0.3")
    if s_all.shape != (64, out["n_docs"]) or not torch.isfinite(s_all).all():
        fail(f"score_all gave {tuple(s_all.shape)} or non-finite scores")
    ids64 = torch.from_numpy(out["ids"][:64]).to(dev).long()
    top_vals = torch.sort(s_all, dim=1, descending=True).values[:, :10]
    if not torch.allclose(torch.gather(s_all, 1, ids64), top_vals, rtol=RTOL, atol=ATOL):
        fail("score_all disagrees with the served top-10")
    for name in MAIN_PATH_KERNELS:
        if launches[name] < 1:
            fail(f"kernel {name} never launched on the main path")
    # serve's own telemetry (armed for its run): its counters are exact
    served = out["metrics"]["counters"]
    if (served.get("query.calls"), served.get("query.rows")) != (4, 1024):
        fail(f"serve counted {served.get('query.calls')} calls / {served.get('query.rows')} "
             "rows for 4 batches of 256")
    out["probe"] = probe_check(torch, engine, out)
    # the same queries again, with every library loaded and every kernel
    # launched once (serve's own reading includes those first-use costs),
    # disarmed and armed, and under the profiler
    queries = torch.from_numpy(out["queries"]).to(dev)
    _, warm_ids, _ = serve_batches(torch, engine, queries, None)
    if not torch.equal(warm_ids.cpu(), torch.from_numpy(out["ids"])):
        fail("a repeated serve returned other ids")
    out["telemetry"] = telemetry_checks(torch, engine, queries, None, "2")
    out["warm_queries_per_s"] = out["telemetry"]["warm_queries_per_s_disarmed"]
    assert_healthy(engine, "2")

    # the engine goes; phase 3 keeps its slab, cfg and map
    cfg, mapping = engine.cfg, engine.store.mapping
    corpus, fills = engine.store.sketches, engine.store.fills
    del engine, out["engine"]
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- mutable path
    phase_done("2")
    mut_rows, mut, sync_ref = mutable_phase(torch, dev, spec, out["n_bins"])
    torch.cuda.empty_cache()
    phase_done("2b")

    # ------------------------------------------------------ banded prefilter
    band_row, pf = prefilter_phase(torch, dev, spec)
    torch.cuda.empty_cache()
    phase_done("2c")
    pf["at_scale"] = prefilter_scale_phase(torch, dev, args.prefilter_docs)
    torch.cuda.empty_cache()
    phase_done("2d")

    # ------------------------------------------------------------- hash mode
    hash_row, hm = hash_mode_phase(torch, dev, spec, out["corpus"], out["queries"],
                                   out["truth_ids"], out["n_bins"])
    torch.cuda.empty_cache()
    phase_done("2e")


    # ----------------------------------- baselines and near-duplicates (2h)
    near_dup = near_duplicates_phase(torch, dev, out["corpus"], out["n_bins"], card)
    torch.cuda.empty_cache()
    phase_done("2h")

    # ------------------------------------------ kernels vs plain, main shapes
    n, w = cfg.n_bins, cfg.n_words
    corpus_rows = torch.from_numpy(out["corpus"][:16384]).to(dev)
    bins = binsketch.map_indices(cfg, mapping, corpus_rows)
    build_err = exact_err(torch, ops.build_sketch(bins, n), ref.build_sketch_ref(bins, n),
                          "build_sketch at the ingest shape")
    qs = CudaBackend().sketch(cfg, mapping, torch.from_numpy(out["queries"][:256]).to(dev))
    qf = pk.row_popcount(qs)
    got_s = ops.sketch_score(qs, corpus, n, "jaccard", a_fills=qf, b_fills=fills)
    want_s = ref.sketch_score_ref(qs, corpus, n, "jaccard", a_fills=qf, b_fills=fills)
    torch.cuda.synchronize()
    score_err = float((got_s - want_s).abs().max())
    if not torch.allclose(got_s, want_s, rtol=RTOL, atol=ATOL):
        fail(f"sketch_score differs from its plain version by up to {score_err}")
    got_t = ops.sketch_topk(qs, corpus, n, "jaccard", k=10, a_fills=qf, b_fills=fills)
    want_t = ref.sketch_topk_ref(qs, corpus, n, "jaccard", k=10, a_fills=qf, b_fills=fills)
    topk_err = check_topk(torch, got_t, want_t, want_s, "sketch_topk at the serving shape")
    del got_s

    # ------------------------------------------- kernels vs plain, ragged
    gen = torch.Generator(device=dev).manual_seed(1)

    def words(rows, n_bins, density):
        bits = torch.rand((rows, pk.num_words(n_bins) * 32), generator=gen, device=dev) < density
        bits[:, n_bins:] = False
        return pk.pack_bits(bits.to(torch.uint8))

    for b_, p_, n_ in [(1, 4, 32), (7, 33, 517), (64, 256, 4096), (300, 1000, 35000)]:
        lens = torch.randint(0, p_ + 1, (b_, 1), generator=gen, device=dev)
        rb = torch.randint(0, n_ + 40, (b_, p_), generator=gen, device=dev, dtype=torch.int32)
        rb = torch.where(torch.arange(p_, device=dev)[None, :] < lens, rb, -1).to(torch.int32)
        build_err = max(build_err, exact_err(torch, ops.build_sketch(rb, n_),
                                             ref.build_sketch_ref(rb, n_),
                                             f"build_sketch at {(b_, p_, n_)}"))
    build_err = max(build_err, bitmap_ragged(torch, dev, "sketch"))
    score_topk_ragged(torch, dev, gen, words)
    for q_, c_, n_ in [(9, 130, 517), (130, 300, 1000), (1, 1, 32), (65, 4099, 2048)]:
        a, b = words(q_, n_, 0.1), words(c_, n_, 0.1)
        for m in ref.MEASURES:
            got, want = ops.sketch_score(a, b, n_, m), ref.sketch_score_ref(a, b, n_, m)
            exact = m == "counts"
            if not (torch.equal(got, want) if exact
                    else torch.allclose(got, want, rtol=RTOL, atol=ATOL)):
                fail(f"sketch_score {m} differs at {(q_, c_, n_)}")
            for k in (1, 10, 200):
                valid = (torch.rand(c_, generator=gen, device=dev) > 0.2).to(torch.int32)
                got = ops.sketch_topk(a, b, n_, m, k=k, b_valid=valid)
                want_ = ref.sketch_topk_ref(a, b, n_, m, k=k, b_valid=valid)
                check_topk(torch, got, want_, want, f"sketch_topk {m} k={k} at {(q_, c_, n_)}")
    torch.cuda.synchronize()
    print("kernels vs plain versions: all agree (build bit-exact, score counts exact and "
          f"measures within rtol {RTOL} / atol {ATOL}, top-k ids up to score ties; W = 1, 5, "
          "9, 17, 46, Q = 1, 63, 65, 129, C < 256 and 256 t +- 1, whole tiles masked, k to 256)")

    # the library yardstick of the counts: torch._int_mm on the same bits as
    # int8 0/1, (Q, 32W) x (32W, C); the expansion is not timed
    a8 = pk.unpack_bits(qs, 32 * w).to(torch.int8)
    b8 = torch.cat([pk.unpack_bits(corpus[s : s + 16384], 32 * w).to(torch.int8)
                    for s in range(0, corpus.shape[0], 16384)])
    counts = ops.sketch_score(qs, corpus, n, "counts", a_fills=qf, b_fills=fills)
    lib_counts = torch._int_mm(a8, b8.t())
    if not torch.equal(lib_counts.float(), counts):
        fail("torch._int_mm on the expanded bits disagrees with the kernel's counts")
    lib_ms = cuda_ms(torch, lambda: torch._int_mm(a8, b8.t()), 5)
    counts_ms = cuda_ms(torch, lambda: ops.sketch_score(qs, corpus, n, "counts", a_fills=qf,
                                                        b_fills=fills), 5)
    del a8, b8, counts, lib_counts
    torch.cuda.empty_cache()
    print(f"counts (Q={qs.shape[0]}, C={corpus.shape[0]}, W={w}): sketch_score counts form "
          f"{counts_ms:.4f} ms, torch._int_mm on int8 0/1 bits {lib_ms:.4f} ms (equal counts; "
          "the library_ms of sketch_score and sketch_topk, which covers the counts only)")

    # ---------------------------------------------------------------- times
    bsz, p = bins.shape
    qn, cn = qs.shape[0], corpus.shape[0]
    pair_macs = 32.0 * qn * cn * w  # bit-AND-popcount multiply-adds on the tensor cores
    rows = []

    def row(name, source, replaces, times, plain_ms, n_bytes, n_ops, err,
            ops_per_s=PEAK_OPS_PER_S, library_ms=None, **extra):
        b_ms, b_by = bound_ms(n_bytes, n_ops, ops_per_s)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": err, **times,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms, **extra})

    row("build_sketch", "src/repro_torch/hopper/csrc/sketch_build.cu",
        "src/repro/kernels/sketch_build.py:51",
        timed(torch, lambda: ops.build_sketch(bins, n), 20),
        cuda_ms(torch, lambda: ref.build_sketch_ref(bins, n), 3),
        4.0 * bsz * p + 4.0 * bsz * w, float(bsz * p), build_err,
        dedup_launches=near_dup["dedup"]["launches"]["build_sketch"])
    row("sketch_score", "src/repro_torch/hopper/csrc/popcount_sim.cu",
        "src/repro/kernels/popcount_sim.py:120",
        timed(torch, lambda: ops.sketch_score(qs, corpus, n, "jaccard", a_fills=qf,
                                              b_fills=fills), 5),
        cuda_ms(torch, lambda: ref.sketch_score_ref(qs, corpus, n, "jaccard", a_fills=qf,
                                                    b_fills=fills), 2),
        4.0 * (qn + cn) * (w + 1) + 4.0 * qn * cn, pair_macs, score_err, rate, lib_ms,
        counts_ms=counts_ms, dedup_launches=near_dup["dedup"]["launches"]["sketch_score"])
    row("sketch_topk", "src/repro_torch/hopper/csrc/topk_stream.cu",
        "src/repro/kernels/topk_stream.py:146",
        timed(torch, lambda: ops.sketch_topk(qs, corpus, n, "jaccard", k=10, a_fills=qf,
                                             b_fills=fills), 5),
        cuda_ms(torch, lambda: ref.sketch_topk_ref(qs, corpus, n, "jaccard", k=10,
                                                   a_fills=qf, b_fills=fills), 2),
        4.0 * (qn + cn) * (w + 1) + 8.0 * qn * 10, pair_macs, topk_err, rate, lib_ms)
    rows += mut_rows + [band_row, hash_row]
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms, kernels {r['kernel_ms']:.4f} ms (plain "
              f"{r['plain_ms']:.2f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {r['launches']} launches)")
    print(f"shapes: build {tuple(bins.shape)} -> W={w} (N={n}); score/topk "
          f"Q={qn} x C={cn} x W={w}, k=10; score and top-k bounds from the measured b1 rate "
          f"{rate:.6e}/s, their library_ms torch._int_mm (counts only)")
    phase_done("3")

    # ------------------------------------ multi-device serving (phase 2i,
    # after phase 3: the timings come first, as for 2f)
    del corpus, fills, qs, qf, bins
    torch.cuda.empty_cache()
    sharded = sharded_phase(torch, dev, spec, out["n_bins"], sync_ref, mut)
    for r in rows:  # each kernel's launches on phase 2i's path too
        r["sharded_launches"] = sharded["launches"][r["name"]]
    torch.cuda.empty_cache()
    phase_done("2i")

    # ---------------------------------- operations plane (phase 2f, run last:
    # torch.profiler loses kernels late in a long run, so phase 3 times first)
    threads_before = set(threading.enumerate())
    ops_plane = ops_plane_phase(torch, dev, spec, out["n_bins"], sync_ref)
    ops_plane["fault_free"] = "phases 2, 2b, 2c, 2d, 2e: no degraded component, no failed job"
    ops_plane["left_behind"] = assert_nothing_left(threads_before)
    # a reading, not a check: how many of 20 one-kernel calls the profiler
    # records after phase 2f (run before phase 3, phase 2f was followed by
    # a window that lost kernels; PERF.md section 7)
    one = torch.ones((256, 184), dtype=torch.int32, device=dev)
    probe, _, _ = profiler_window(torch, lambda: ops.rebucket(one, 5859, 2929), 20, 10)
    ops_plane["left_behind"]["profiler_after"] = {"calls": 20, "kernels_recorded": len(probe)}
    print(f"after phase 2f: {ops_plane['left_behind']}")
    phase_done("2f")

    # --------------------------------------- hands-off maintenance (phase 2g)
    threads_before = set(threading.enumerate())
    autopilot = autopilot_phase(torch, dev, spec, out["n_bins"])
    autopilot["left_behind"] = assert_nothing_left(threads_before)
    phase_done("2g")
    ops_plane["phase_s"] = phase_s
    print(json.dumps({"serve": {k: out[k] for k in ("n_docs", "n_bins", "n_words", "build_s",
                                                  "docs_per_s", "serve_s", "queries_per_s",
                                                  "warm_queries_per_s", "recall", "probe",
                                                  "telemetry")}}))
    print(json.dumps({"mutable": mut}))
    print(json.dumps({"prefilter": pf}))
    print(json.dumps({"hash_mode": hm}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"near_duplicates": near_dup}))
    print(json.dumps({"ops_plane": ops_plane}))
    print(json.dumps({"autopilot": autopilot}))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
