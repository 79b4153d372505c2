"""Quickstart of the PyTorch port: the paper in a few lines, then the
serving engine, on the card.

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu    # plain PyTorch

Part 1 (the paper): sketches pairs of KOS-shaped documents with BinSketch
(Definition 4), then estimates Inner-Product / Hamming / Jaccard / Cosine
for each pair from the SAME sketch (Algorithms 1-4) and compares them with
the exact values.

Part 2 (the system): build a mutable corpus -> query it -> mutate it (delete /
update, no rebuild) -> distill sealed segments to half sketch width -> query
the mixed-width corpus -> read one telemetry snapshot. The counterpart of
``examples/quickstart.py``; ``--device`` picks where it runs (default
``cuda``, which raises without a card).
"""

import argparse

import numpy as np

from repro_torch import obs, resolve_device
from repro_torch.core import BinSketchConfig, estimators, make_mapping, packed as pk, theorem1_N
from repro_torch.data.synthetic import DATASETS, generate_corpus, generate_similar_pairs
from repro_torch.engine import SketchEngine, get_backend
from repro_torch.engine.store import as_index_tensor


def paper(dev):
    spec = DATASETS["kos"]  # n=3430 docs, d=6906 vocab — the paper's KOS stats
    psi = spec.max_nnz
    n_bins = theorem1_N(psi, rho=0.1)
    print(f"KOS-like corpus: d={spec.d}, sparsity psi={psi}")
    print(f"Theorem-1 sketch length: N={n_bins} bits "
          f"({(n_bins + 31) // 32 * 4} bytes/doc vs ~{spec.mean_nnz * 4} bytes raw)\n")

    cfg = BinSketchConfig(d=spec.d, n_bins=n_bins)
    mapping = make_mapping(cfg, seed=0, device=dev)
    backend = get_backend("auto")  # the build kernel on the card, its plain twin on the CPU

    print(f"{'true J':>8} {'IP est':>14} {'Ham est':>14} {'JS est':>14} {'Cos est':>14}")
    for jacc in (0.9, 0.7, 0.5, 0.3):
        a, b, js_true = generate_similar_pairs(spec, jacc, n_pairs=16, seed=1)
        ska = backend.sketch(cfg, mapping, as_index_tensor(a, dev))
        skb = backend.sketch(cfg, mapping, as_index_tensor(b, dev))
        na, nb = pk.row_popcount(ska), pk.row_popcount(skb)
        nab = pk.row_popcount(ska & skb)
        est = {k: v.cpu().numpy() for k, v in
               estimators.estimates_from_counts(na, nb, nab, n_bins).items()}

        sa = (a >= 0).sum(1)
        sb = (b >= 0).sum(1)
        ip_t = js_true[0] * (sa + sb) / (1 + js_true[0])
        ham_t = sa + sb - 2 * ip_t
        cos_t = ip_t / np.sqrt(sa * sb)
        fmt = lambda e, t: f"{np.mean(e):7.2f}/{np.mean(t):<6.2f}"  # noqa: E731
        print(f"{js_true[0]:8.3f} {fmt(est['ip'], ip_t):>14} {fmt(est['hamming'], ham_t):>14} "
              f"{fmt(est['jaccard'], js_true):>14} {fmt(est['cosine'], cos_t):>14}")
    print("\n(each cell: estimated/true, averaged over 16 pairs — one sketch, four measures)")


def lifecycle(dev):
    """Build -> query -> mutate -> distill -> observe."""
    spec = DATASETS["tiny"]
    idx, lens = generate_corpus(spec, seed=0)  # (C, P) padded sparse rows
    cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), rho=0.1)
    mapping = make_mapping(cfg, seed=0, device=dev)
    w_bytes = cfg.n_words * 4

    # build -> query: mutable store (counting head + sealed segments) on the
    # Hopper kernels ("auto"; on the CPU their plain versions run)
    eng = SketchEngine.build(cfg, mapping, idx, backend="auto", mutable=True, seal_rows=64)
    q = idx[:8]
    scores, ids = eng.query(q, k=5)
    print(f"\nbuilt mutable corpus: {eng.store.size} docs at N={cfg.n_bins} "
          f"({w_bytes} B/doc) on {dev}; query top-1 ids {ids.cpu().numpy()[:4, 0]}")

    # mutate: tombstones + in-place updates — no rebuild, ids stable
    eng.delete([3, 17])
    eng.update([5], idx[100:101])
    eng.seal()
    eng.compact()
    print(f"mutated: deleted 2, updated 1 -> {eng.store.size} live docs")

    # distill: re-sketch the sealed segments to half width — memory traded
    # for recall per segment, raw documents never touched
    n_half = cfg.n_bins // 2
    stats = eng.distill(widths=(n_half,), background=False)
    scores2, ids2 = eng.query(q, k=5)  # mixed-width serving, same API
    before, after = ids.cpu().numpy().tolist(), ids2.cpu().numpy().tolist()
    kept = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(before, after)])
    print(f"distilled {stats['rows_out']} rows to N'={n_half} "
          f"({(n_half + 31) // 32 * 4} B/doc, was {w_bytes}); "
          f"top-5 overlap with full width: {kept:.2f}")
    assert (ids2.cpu().numpy()[:, 0] >= 0).all()

    # observe: arm the telemetry plane and read one JSON-safe snapshot —
    # stage latency histograms, per-segment lifecycle gauges, the last
    # sampled trace
    eng.enable_metrics()
    eng.query(q, k=5)
    m = eng.metrics()
    seg0 = m["lifecycle"]["segments"][0]
    stages = {k: f"{v * 1e3:.2f}ms" for k, v in m["last_trace"]["stages_s"].items()}
    print(f"telemetry: query.calls={m['counters']['query.calls']}, "
          f"seg0 width={seg0['width']} live={seg0['live']} "
          f"hits={seg0['hits']}; trace stages {stages}")
    obs.disable()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of the kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    paper(dev)
    lifecycle(dev)


if __name__ == "__main__":
    main()
