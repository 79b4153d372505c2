"""Port parity, distillation and mixed-width serving: ``DistillPolicy``, the
N -> N' fold of sealed segments (``SegmentedStore.distill``), queries folded
to each segment's width (``Backend.rebucket``), the carry-over of a JAX store
(``convert.segmented_store_from_reference``) and the driver's mutable arm,
against ``repro`` on the ``tiny`` corpus with the JAX package's Ψ table.

Tolerances as in ``tests/test_torch_segments.py``: store state and packed
words bit-equal; queries against a fresh build exactly; against the JAX
engine tie-aware, rtol 1e-5 / atol 1e-6 (port ``cuda`` on the CPU vs JAX
``pallas-interpret``) or rtol 2e-3 / atol 1e-3 (port ``reference`` vs JAX
``oracle``). A distilled store has no common row width, so the tie check
reads per-view scores (:func:`mixed_truth`) instead of ``score_all``."""

import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import sketch_indices as j_sketch_indices
from repro.engine import DistillPolicy as JPolicy
from repro.engine import SketchEngine as JEngine
from repro.engine import get_backend as j_get_backend
from repro.engine.testing import assert_topk_equivalent
from repro_torch.convert import packed_to_reference, segmented_store_from_reference
from repro_torch.data.synthetic import DATASETS
from repro_torch.engine import BandPolicy, DistillPolicy, SketchEngine, get_backend

from test_torch_segments import Twin, _ingest, assert_same_state, tiny  # noqa: F401

CPU = "cpu"


def mixed_truth(engine, queries, now=None):
    """Per-query ``{global id: score}`` over every live row of every view,
    each scored at its own width from the folded query sketch."""
    cfg = engine.cfg
    qs = engine.backend.sketch(cfg, engine.store.mapping, torch.from_numpy(queries))
    truth = [{} for _ in range(len(queries))]
    for v in engine.store.segment_views(now):
        nb = v.n_bins or cfg.n_bins
        s = engine.backend.score(engine.backend.rebucket(qs, cfg.n_bins, nb), v.sketches, nb,
                                 engine.measure, corpus_fills=v.fills).numpy()
        ids = v.ids.numpy() if v.ids is not None else np.arange(s.shape[1])
        live = v.valid.numpy() != 0 if v.valid is not None else np.ones(s.shape[1], bool)
        for r in range(len(queries)):
            truth[r].update(zip(ids[live].tolist(), s[r, live].tolist()))
    return truth


def assert_mixed_equal(jeng, teng, queries, k=5, measures=("jaccard",)):
    """Port queries == the JAX engine's on a mixed-width store, tie-aware."""
    tol = ({"rtol": 1e-5, "atol": 1e-6} if teng.backend.name == "cuda"
           else {"rtol": 2e-3, "atol": 1e-3})
    for m in measures:
        jeng.measure = teng.measure = m
        got = teng.query(queries, k)
        assert_topk_equivalent((got[0].numpy(), got[1].numpy()), jeng.query(queries, k),
                               mixed_truth(teng, queries), err_msg=m, **tol)
    jeng.measure = teng.measure = "jaccard"


def _sealed_twin(tiny, n=48, seal_rows=16, **kw):
    """Both engines with corpus rows [0, n) sealed into n // seal_rows segments."""
    *_, idx = tiny
    tw, contents = Twin(tiny, seal_rows=seal_rows, **kw), {}
    _ingest(tw, contents, idx, 0, n)
    return tw, contents


# ----------------------------------------------------------------- policy
def test_distill_policy_tiering_matches_reference():
    kw = {"widths": (128, 256), "min_age": 10.0, "live_floor": 4}
    p, jp = DistillPolicy(**kw), JPolicy(**kw)
    assert p.widths == jp.widths == (256, 128)
    for cur in (512, 256, 128):
        for age in (0.0, 9.9, 10.0, 99.0):
            for live in (2, 4, 5, 10**6):
                assert p.target_width(cur, age, live) == jp.target_width(cur, age, live)
    assert DistillPolicy(widths=(64,)).target_width(512, 0.0, 10**6) == 64
    with pytest.raises(ValueError):
        DistillPolicy(widths=())
    with pytest.raises(ValueError):
        DistillPolicy(widths=(0,))


def test_distill_policy_drives_store(tiny):
    """Age and size tiering end to end: the old segment and the nearly dead
    one drop a tier, the young populated one stays — as in the reference."""
    *_, idx = tiny
    tw, contents = Twin(tiny), {}
    for lo, now in ((0, 0.0), (16, 50.0), (32, 50.0)):
        _ingest(tw, contents, idx, lo, lo + 16, now=now)
        tw("seal")
    tw("delete", list(range(32, 46)))  # two live rows left in segment 2
    n_new = tw.t.cfg.n_bins // 2
    policy = dict(widths=(n_new,), min_age=30.0, live_floor=4)
    sj = tw.j.distill(JPolicy(**policy), now=60.0, background=False)
    st_ = tw.t.distill(DistillPolicy(**policy), now=60.0)
    assert st_ == sj and st_["groups"] == 2
    assert sorted(s.n_bins or 0 for s in tw.t.store.sealed) == [0, n_new, n_new]
    assert_same_state(tw.j.store, tw.t.store)
    assert tw.t.distill(DistillPolicy(**policy), now=60.0) is None  # nothing left


# ------------------------------------------------------- fold and queries
def test_fold_matches_derived_mapping_sketch(tiny):
    """fold(sketch_N(x)) == sketch_N'(x) under pi' = pi mod N', for widths
    that do not divide N; the same words as the reference's sketch there."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    be = get_backend("reference")
    sk = be.sketch(tcfg, tmap, torch.from_numpy(idx[:17]))
    for n_new in (tcfg.n_bins // 2, tcfg.n_bins // 3 + 1, 65, 32, 7):
        cfg2 = tcfg.__class__(d=tcfg.d, n_bins=n_new)
        want = be.sketch(cfg2, tmap % n_new, torch.from_numpy(idx[:17]))
        assert torch.equal(be.rebucket(sk, tcfg.n_bins, n_new), want), n_new
        assert torch.equal(get_backend("cuda").rebucket(sk, tcfg.n_bins, n_new), want), n_new
    j_want = j_sketch_indices(JCfg(d=jcfg.d, n_bins=65), jmap % 65, idx[:17])
    np.testing.assert_array_equal(
        packed_to_reference(be.rebucket(sk, tcfg.n_bins, 65)), np.asarray(j_want))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_distilled_queries_equal_fresh_narrow_build(tiny, backend):
    """The acceptance property: distilling a mutated store to N' answers like
    a fresh build at N' (derived map) over the survivors, all four measures;
    the distilled store is the reference's, bit for bit."""
    *_, idx = tiny
    tw, contents = _sealed_twin(tiny, tbackend=backend)
    tw("delete", [3, 30, 40])
    for g in (3, 30, 40):
        contents.pop(g)
    upd = [10, 20, 21, 22, 23, 24, 25, 26]
    tw("update", upd, idx[200:208])  # sealed -> head
    contents.update({g: idx[200 + j] for j, g in enumerate(upd)})
    tw("seal")  # the head back into sealed, so everything distills
    n_new = tw.t.cfg.n_bins // 2
    sj = tw.j.distill(widths=(n_new,), background=False)
    st_ = tw.t.distill(widths=(n_new,))
    assert st_ == sj and st_["rows_out"] == len(contents)
    assert all(s.n_bins == n_new for s in tw.t.store.sealed)
    assert_same_state(tw.j.store, tw.t.store)

    surv = np.asarray(sorted(contents))
    cfg2 = tw.t.cfg.__class__(d=tw.t.cfg.d, n_bins=n_new)
    fresh = SketchEngine.build(cfg2, tw.t.store.mapping % n_new,
                               np.stack([contents[int(g)] for g in surv]), backend=backend)
    q = idx[100:108]
    for m in ("jaccard", "ip", "cosine", "hamming"):
        tw.t.measure = fresh.measure = m
        sc_m, id_m = tw.t.query(q, 5)
        sc_f, id_f = fresh.query(q, 5)
        np.testing.assert_array_equal(id_m.numpy(), surv[id_f.numpy()], err_msg=m)
        np.testing.assert_allclose(sc_m.numpy(), sc_f.numpy(), rtol=1e-5, atol=1e-6, err_msg=m)


@pytest.fixture(scope="module")
def mixed(tiny):
    """Three sealed segments, the two oldest distilled to N // 2, deletes in
    both widths, and a live head at the base width; JAX and port alike."""
    *_, idx = tiny
    tw, contents = _sealed_twin(tiny)
    tw("delete", [5, 40])
    for g in (5, 40):
        contents.pop(g)
    n_new = tw.t.cfg.n_bins // 2
    for store in (tw.j.store, tw.t.store):
        store.sealed[2].born[:] = 1.0  # young
    policy = dict(widths=(n_new,), min_age=0.5)
    tw.j.distill(JPolicy(**policy), now=1.0, background=False)
    tw.t.distill(DistillPolicy(**policy), now=1.0)
    assert sorted(s.n_bins or 0 for s in tw.t.store.sealed) == [0, n_new, n_new]
    _ingest(tw, contents, idx, 96, 104)
    tw("delete", [20, 50])
    for g in (20, 50):
        contents.pop(g)
    assert_same_state(tw.j.store, tw.t.store)
    return tw, contents


def test_mixed_width_serving_matches_reference(tiny, mixed):
    """Mixed-width queries: port ``reference`` vs JAX ``oracle`` and port
    ``cuda`` (plain ``rebucket`` and top-k here) vs JAX ``pallas-interpret``
    (the Pallas rebucket kernel in interpret mode)."""
    *_, idx = tiny
    tw, contents = mixed
    q = np.stack([contents[g] for g in (1, 17, 33, 48, 51, 55, 45, 8)])
    assert_mixed_equal(tw.j, tw.t, q)
    assert_mixed_equal(JEngine(tw.j.store, j_get_backend("pallas-interpret")),
                       SketchEngine(tw.t.store, get_backend("cuda")), q)


def test_mixed_width_queries_fold_once_per_width(tiny, mixed):
    """One rebucket per distinct narrow width per planner chunk, and none
    for the base width."""
    *_, idx = tiny
    tw, _ = mixed
    calls = []
    be = get_backend("reference")
    fold = be.rebucket
    be.rebucket = lambda *a: calls.append(a[1:]) or fold(*a)
    eng = SketchEngine(tw.t.store, be)
    eng.planner.max_batch = 8
    eng.query(idx[:20], 5)  # three chunks
    n = tw.t.cfg.n_bins
    assert calls == [(n, n // 2)] * 3


def test_two_tier_ladder_matches_reference_with_composed_map(tiny):
    """Walking the ladder (N // 2, N // 4) folds twice: a segment at N // 4
    holds the sketch under (pi mod N // 2) mod N // 4, while queries fold
    from N straight to N // 4 (pi mod N // 4); the two maps differ where
    N // 4 does not divide N // 2 (ROADMAP queue 3). The port reproduces the
    reference, state and queries."""
    *_, idx = tiny
    tw, contents = _sealed_twin(tiny, n=32)
    n1 = tw.t.cfg.n_bins // 2 + 1  # 213: 106 does not divide it
    n2 = tw.t.cfg.n_bins // 4
    policy = dict(widths=(n1, n2))
    passes = 0
    while tw.t.distill(DistillPolicy(**policy)):
        assert tw.j.distill(JPolicy(**policy), background=False)
        passes += 1
    assert passes == 2 and all(s.n_bins == n2 for s in tw.t.store.sealed)
    assert_same_state(tw.j.store, tw.t.store)
    be, cfg, mp = get_backend("reference"), tw.t.cfg, tw.t.store.mapping
    rows = torch.from_numpy(idx[:16])
    composed = be.sketch(cfg.__class__(d=cfg.d, n_bins=n2), (mp % n1) % n2, rows)
    direct = be.sketch(cfg.__class__(d=cfg.d, n_bins=n2), mp % n2, rows)
    seg = tw.t.store.sealed[0]
    assert torch.equal(seg.sketches, composed) and not torch.equal(seg.sketches, direct)
    assert_mixed_equal(tw.j, tw.t, idx[100:108])


def test_distill_then_lifecycle_keeps_working(tiny):
    """After distillation the store still deletes, updates (relocating out of
    a distilled segment), seals and compacts per width; merge_rows on a
    distilled doc and the base-width ``live()`` are refused."""
    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, seal_rows=16)
    eng.add(idx[:32], batch=16)
    n_new = tcfg.n_bins // 2
    assert eng.distill(widths=(n_new,))["groups"] == 2
    eng.delete([1])
    eng.update([2], idx[60:61])  # distilled -> head
    with pytest.raises(ValueError, match="distilled"):
        eng.merge_rows([3], idx[61:62])
    with pytest.raises(ValueError, match="base width"):
        eng.store.live()
    eng.seal()
    stats = eng.compact()  # one group per width tier
    assert stats["groups"] == 2 and stats["rows_out"] == 31
    assert sorted(s.n_bins or tcfg.n_bins for s in eng.store.sealed) == [n_new, tcfg.n_bins]
    _, ids = eng.query(idx[5:9], 4)
    assert (ids[:, 0] >= 0).all()
    assert eng.distill(widths=(n_new,))["groups"] == 1  # the base-width segment
    assert eng.distill(widths=(n_new,)) is None  # the ladder's bottom
    assert eng.distill(DistillPolicy(widths=(n_new // 2,), min_age=100.0)) is None
    with pytest.raises(ValueError):
        eng.distill()


# ----------------------------------------------------- state across packages
def test_segmented_store_from_reference(tiny, mixed):
    """A JAX store after mutation and distillation, carried across through
    its checkpoint tree, is the port's twin store and answers alike."""
    *_, idx = tiny
    tw, contents = mixed
    tree, aux = tw.j.store.checkpoint_tree()
    tree = {"mapping": np.asarray(tree["mapping"]),
            "head": {k: np.asarray(v) for k, v in tree["head"].items()},
            "sealed": [{k: np.asarray(v) for k, v in s.items()} for s in tree["sealed"]]}
    back = segmented_store_from_reference(tree, aux, CPU)
    assert_same_state(tw.j.store, back)
    assert [s.n_bins for s in back.sealed] == [s.n_bins for s in tw.t.store.sealed]
    q = idx[20:28]
    got = SketchEngine(back, get_backend("reference")).query(q, 5)
    want = tw.t.query(q, 5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    # a band policy crosses too, each segment's index rebuilt from its slab
    # (tests/test_torch_banding.py holds the indexes to the reference's)
    aux = dict(aux, band_policy={"n_bands": 8, "min_rows": 8})
    banded = segmented_store_from_reference(tree, aux, CPU)
    assert banded.band_policy == BandPolicy(n_bands=8, min_rows=8)
    assert all((s.band_index is not None) == (s.n_rows >= 8) for s in banded.sealed)
    got = SketchEngine(banded, get_backend("reference")).query(q, 5, prefilter=False)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ------------------------------------------------------------------ driver
def test_serve_mutable_arm_matches_reference_driver(tiny, monkeypatch):
    """``launch.serve`` with mutation and a distillation ladder, on the JAX
    Ψ table, against ``repro.launch.serve.main`` with the same flags on the
    ``oracle`` backend: the served ids agree up to score ties and the recall
    agrees up to the tied slots."""
    from repro.launch import serve as jserve
    from repro_torch.launch.serve import serve

    served = []
    query = JEngine.query
    monkeypatch.setattr(JEngine, "query",
                        lambda self, *a, **kw: served.append(query(self, *a, **kw)) or served[-1])
    want_recall = jserve.main(["--dataset", "tiny", "--queries", "16", "--batch", "16",
                               "--topk", "5", "--mutate-rate", "0.3", "--distill", "212,106",
                               "--backend", "oracle", "--ingest-batch", "8"])
    want_ids = np.concatenate([np.asarray(ids) for _, ids in served])
    want_sc = np.concatenate([np.asarray(sc) for sc, _ in served])
    *_, tmap, _ = tiny
    out = serve(DATASETS["tiny"], queries=16, batch=16, topk=5, device=CPU, mapping=tmap,
                ingest_batch=8, mutate_rate=0.3, distill=(212, 106), backend="reference")
    assert out["n_deleted"] == 38 and out["n_updated"] == 39 and out["n_tiers"] == 2
    eng = out["engine"]
    truth = mixed_truth(eng, out["queries"], out["serve_now"])
    assert_topk_equivalent((out["scores"], out["ids"]), (want_sc, want_ids), truth,
                           rtol=2e-3, atol=1e-3)
    tied = int((out["ids"] != want_ids).sum())
    assert abs(out["recall"] - want_recall) * out["ids"].size <= tied
