#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                    # the full run: 300k-doc corpus
    python3 chip_smoke.py --n-points 20000   # a shorter rehearsal

Phases, each fatal on failure (nothing is caught while the run goes on):

1. The card's name and power limit; every Hopper kernel built with nvcc, one
   process per source, timed.
2. The main path, through the entry points a user calls: ``serve`` over the
   NYTimes-shaped corpus (d=102660, mean length 230, psi=870) at the document
   count of the UCI NYTimes bag-of-words corpus, 300,000, with rho=0.05,
   ingest batches of 16384 and 1024 queries in batches of 256 at k=10; then
   ``score_all`` on 64 of those queries, held against their ``query``
   results. Kernel launch counters are zeroed just before and read just
   after; every kernel must have launched. Recall@10 against exact Jaccard
   must reach 0.3, the floor the JAX driver's test holds it to. The same
   queries are then served once more, warm, for a steady-state rate.
3. Each kernel held against its plain PyTorch version on the card, at the
   main path's shapes and on ragged ones: build bit-exact, score counts
   exact and measures within rtol 1e-5 / atol 1e-6, top-k equal up to
   provable score ties. Then each timed with CUDA events (median), beside
   its plain version and its bound on this card.

The line before the last lists the kernels as JSON, the one before it the
card; the last line is the device summary. Without a card, or without the
repository beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (H100 SXM data sheet, at its 700 W limit):
# device memory rate, and 32-bit operations outside the tensor cores
# (67 TFLOP/s float32; the integer AND/POPC/ADD work runs on the same SM
# pipes, so this is a floor on its time, not a reachable rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

RTOL, ATOL = 1e-5, 1e-6


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


def bound_ms(n_bytes: float, n_ops: float):
    """(least time in ms, what sets it) for the given bytes and operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_topk(torch, got, want, truth, what: str) -> float:
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
    if not torch.allclose(gs[finite], ws[finite], rtol=RTOL, atol=ATOL):
        fail(f"{what}: scores differ by up to {err}")
    bad = (gi != wi) & finite
    if bad.any():
        r, _ = bad.nonzero(as_tuple=True)
        tg = truth[r, gi[bad].long()]
        tw = truth[r, wi[bad].long()]
        if not torch.all((tg - tw).abs() <= ATOL + RTOL * tw.abs()):
            fail(f"{what}: {int(bad.sum())} ids differ and are not score ties")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-points", type=int, default=300_000,
                    help="corpus documents (default: the UCI NYTimes count)")
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

    # ------------------------------------------------------------ main path
    spec = dataclasses.replace(DATASETS["nytimes"], n_points=args.n_points)
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
    for name, n in launches.items():
        if n < 1:
            fail(f"kernel {name} never launched on the main path")
    # the same queries again, with every library loaded and every kernel
    # launched once: serve's own reading includes those first-use costs
    t0 = time.perf_counter()
    for s in range(0, len(out["queries"]), 256):
        warm_ids = engine.query(out["queries"][s : s + 256], 10)[1]
    torch.cuda.synchronize()
    out["warm_queries_per_s"] = len(out["queries"]) / (time.perf_counter() - t0)
    if not torch.equal(warm_ids.cpu(), torch.from_numpy(out["ids"][-len(warm_ids):])):
        fail("a repeated query batch returned other ids")

    # ------------------------------------------ kernels vs plain, main shapes
    cfg, store = engine.cfg, engine.store
    n, w = cfg.n_bins, cfg.n_words
    corpus_rows = torch.from_numpy(out["corpus"][:16384]).to(dev)
    bins = binsketch.map_indices(cfg, store.mapping, corpus_rows)
    got_b, want_b = ops.build_sketch(bins, n), ref.build_sketch_ref(bins, n)
    torch.cuda.synchronize()
    if not torch.equal(got_b, want_b):
        fail("build_sketch differs from its plain version at the ingest shape")
    qs = engine.backend.sketch(cfg, store.mapping, torch.from_numpy(out["queries"][:256]).to(dev))
    corpus, fills = store.sketches, store.fills
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
        if not torch.equal(ops.build_sketch(rb, n_), ref.build_sketch_ref(rb, n_)):
            fail(f"build_sketch differs at {(b_, p_, n_)}")
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
    print("kernels vs plain versions: all agree (build bit-exact, score and top-k "
          f"within rtol {RTOL} / atol {ATOL}, top-k ids up to score ties)")

    # ---------------------------------------------------------------- times
    bsz, p = bins.shape
    qn, cn = qs.shape[0], corpus.shape[0]
    pair_ops = 3.0 * qn * cn * w  # AND + POPC + ADD per word pair
    rows = []

    def row(name, source, replaces, ms, plain_ms, n_bytes, n_ops, err):
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})

    row("build_sketch", "src/repro_torch/hopper/csrc/sketch_build.cu",
        "src/repro/kernels/sketch_build.py:51",
        cuda_ms(torch, lambda: ops.build_sketch(bins, n), 20),
        cuda_ms(torch, lambda: ref.build_sketch_ref(bins, n), 3),
        4.0 * bsz * p + 4.0 * bsz * w, float(bsz * p), 0.0)
    row("sketch_score", "src/repro_torch/hopper/csrc/popcount_sim.cu",
        "src/repro/kernels/popcount_sim.py:120",
        cuda_ms(torch, lambda: ops.sketch_score(qs, corpus, n, "jaccard", a_fills=qf,
                                                b_fills=fills), 5),
        cuda_ms(torch, lambda: ref.sketch_score_ref(qs, corpus, n, "jaccard", a_fills=qf,
                                                    b_fills=fills), 2),
        4.0 * (qn + cn) * (w + 1) + 4.0 * qn * cn, pair_ops, score_err)
    row("sketch_topk", "src/repro_torch/hopper/csrc/topk_stream.cu",
        "src/repro/kernels/topk_stream.py:146",
        cuda_ms(torch, lambda: ops.sketch_topk(qs, corpus, n, "jaccard", k=10, a_fills=qf,
                                               b_fills=fills), 5),
        cuda_ms(torch, lambda: ref.sketch_topk_ref(qs, corpus, n, "jaccard", k=10,
                                                   a_fills=qf, b_fills=fills), 2),
        4.0 * (qn + cn) * (w + 1) + 8.0 * qn * 10, pair_ops, topk_err)
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.2f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {r['launches']} launches)")
    print(f"shapes: build {tuple(bins.shape)} -> W={w} (N={n}); score/topk "
          f"Q={qn} x C={cn} x W={w}, k=10")
    print(json.dumps({"serve": {k: out[k] for k in ("n_docs", "n_bins", "n_words", "build_s",
                                                  "docs_per_s", "serve_s", "queries_per_s",
                                                  "warm_queries_per_s", "recall")}}))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
