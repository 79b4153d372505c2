"""Port parity, the mutable store: ``repro_torch.engine.segments.SegmentedStore``
and the lifecycle verbs of ``SketchEngine`` against ``repro.engine`` under the
same histories on the ``tiny`` corpus, with the JAX package's Ψ table.

After each history the two stores must hold the same state, bit for bit:
location map, segments (ids, tombstones, birth stamps, widths, packed words,
fills) and head (ids, counters, packed rows, fills, exactness, saturation).
Queries are held to a fresh append-only build over the survivors exactly
(ids equal, scores allclose at rtol 1e-5 / atol 1e-6: the same plain scoring
on the same words), and, where the JAX engine answers too, to it tie-aware
at rtol 2e-3 / atol 1e-3 (port ``reference`` against JAX ``oracle``: float32
``log`` differs in the last ulp; see ``tests/test_torch_engine.py``). The
engine-to-engine comparisons of a mutated, mixed-width store, including
port ``cuda`` against JAX ``pallas-interpret``, are in
``tests/test_torch_distill.py``. Every-doc-deleted cases are held to
``oracle``: ``pallas-interpret`` raises on an empty store (ROADMAP queue 3).
The JAX side is fed batches of 8 rows: it compiles every eager operation
anew for each shape, seconds apiece on a CPU.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import BinSketchConfig as JCfg
from repro.core import make_mapping as j_make_mapping
from repro.data.synthetic import DATASETS as JDATASETS
from repro.data.synthetic import generate_corpus as j_generate_corpus
from repro.engine import SketchEngine as JEngine
from repro.engine.testing import assert_topk_equivalent, topk_truth
from repro_torch.convert import config_from_reference, mapping_from_reference, packed_to_reference
from repro_torch.core import counting as tcount
from repro_torch.core import packed as tpk
from repro_torch.engine import SegmentedStore, SketchEngine, SketchStore, get_backend

CPU = "cpu"
P = JDATASETS["tiny"].max_nnz
MEASURES = ["jaccard", "ip", "cosine", "hamming"]


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax mapping, port cfg, port mapping, corpus idx)."""
    idx, lens = j_generate_corpus(JDATASETS["tiny"], seed=0)
    jcfg = JCfg.from_sparsity(JDATASETS["tiny"].d, int(lens.max()), 0.05)
    jmap = j_make_mapping(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_reference(jcfg.d, jcfg.n_bins, jcfg.mode)
    return jcfg, jmap, tcfg, mapping_from_reference(np.asarray(jmap), tcfg, CPU), idx


def _crafted():
    """N=4 over d=8: ids 0 and 1 share bin 2, id 2 sits alone in bin 0."""
    m = np.asarray([2, 2, 0, 1, 1, 3, 3, 0], np.int32)
    jcfg = JCfg(d=8, n_bins=4)
    tcfg = config_from_reference(8, 4)
    return jcfg, m, tcfg, torch.from_numpy(m)


def _rows(*sets, pad=4):
    out = np.full((len(sets), pad), -1, np.int32)
    for i, s in enumerate(sets):
        out[i, : len(s)] = s
    return out


def _bits(store, n):
    return tpk.unpack_bits(store.sketches, n).numpy()


def assert_same_state(jstore, tstore):
    """The port's store holds exactly the reference's state."""
    assert tstore.next_id == jstore.next_id and tstore.size == jstore.size
    assert tstore._loc == jstore._loc
    assert len(tstore.sealed) == len(jstore.sealed)
    for js, ts in zip(jstore.sealed, tstore.sealed):
        assert ts.n_bins == js.n_bins
        np.testing.assert_array_equal(ts.ids, js.ids)
        np.testing.assert_array_equal(ts.valid, js.valid)
        np.testing.assert_array_equal(ts.born, js.born)
        np.testing.assert_array_equal(packed_to_reference(ts.sketches), np.asarray(js.sketches))
        np.testing.assert_array_equal(ts.fills.numpy(), np.asarray(js.fills))
    jh, th = jstore.head, tstore.head
    n = th.size
    assert n == jh.size and th.is_sorted == jh.is_sorted
    for name in ("ids", "valid", "born", "exact"):
        np.testing.assert_array_equal(getattr(th, name)[:n], getattr(jh, name)[:n], err_msg=name)
    # the head's counters are the reference's u16 bits, two bytes a bin
    assert th.counters.element_size() == np.asarray(jh.counters).itemsize == 2
    np.testing.assert_array_equal(th.counters[:n].numpy().view(np.uint16),
                                  np.asarray(jh.counters[:n]))
    np.testing.assert_array_equal(packed_to_reference(th.packed[:n]), np.asarray(jh.packed[:n]))
    np.testing.assert_array_equal(th.fills[:n].numpy(), np.asarray(jh.fills[:n]))
    np.testing.assert_array_equal(th.saturated[:n], jh.saturated[:n])


def assert_fresh_equal(engine, contents, queries, k=5, measures=("jaccard",), now=None):
    """Query results == a fresh append-only build over the survivors, ids
    exactly and scores allclose (the invariant of tests/test_segments.py)."""
    surv = np.asarray(sorted(contents), np.int64)
    st_ = engine.store
    fresh = SketchEngine.build(st_.cfg, st_.mapping, backend=engine.backend,
                               capacity=max(len(surv), 1))
    if len(surv):
        fresh.add(np.stack([contents[int(g)] for g in surv]))
    for m in measures:
        engine.measure = fresh.measure = m
        sc_m, id_m = engine.query(queries, k, now=now)
        sc_f, id_f = fresh.query(queries, k)
        id_f = id_f.numpy()
        id_f = np.where(id_f >= 0, surv[np.maximum(id_f, 0)] if len(surv) else -1, -1)
        np.testing.assert_array_equal(id_m.numpy(), id_f, err_msg=m)
        np.testing.assert_allclose(sc_m.numpy(), sc_f.numpy(), rtol=1e-5, atol=1e-6, err_msg=m)
    engine.measure = "jaccard"


def assert_reference_equal(jeng, teng, queries, k=5, measures=("jaccard",)):
    """Port queries == the JAX engine's, tie-aware, at the backend pair's
    tolerance (see the module docstring). Scores are held slot for slot to
    the JAX engine's; the tie check reads the port's materialized scores."""
    tol = ({"rtol": 1e-5, "atol": 1e-6} if teng.backend.name == "cuda"
           else {"rtol": 2e-3, "atol": 1e-3})
    for m in measures:
        jeng.measure = teng.measure = m
        want = jeng.query(queries, k)
        got = teng.query(queries, k)
        truth = topk_truth(teng, queries) if teng.store.size else None
        assert_topk_equivalent((got[0].numpy(), got[1].numpy()), want, truth,
                               err_msg=m, **tol)
    jeng.measure = teng.measure = "jaccard"


class Twin:
    """A JAX engine and a port engine on one corpus, fed the same verbs."""

    def __init__(self, tiny, jbackend="oracle", tbackend="reference", **kw):
        jcfg, jmap, tcfg, tmap, _ = tiny
        self.j = JEngine.build(jcfg, jmap, backend=jbackend, mutable=True, **kw)
        self.t = SketchEngine.build(tcfg, tmap, backend=tbackend, mutable=True, **kw)

    def __call__(self, verb, *args, **kw):
        rj = getattr(self.j, verb)(*args, **kw)
        rt = getattr(self.t, verb)(*args, **kw)
        return rj, rt


def _union(*rows, pad=P):
    """One padded row holding the union of the given padded rows' sets."""
    u = np.unique(np.concatenate([r[r >= 0] for r in rows]))
    return _rows(u, pad=pad)[0]


def _minus(row, drop, pad=P):
    keep = np.setdiff1d(row[row >= 0], drop)
    return _rows(keep, pad=pad)[0]


def _ingest(tw, contents, idx, lo, hi, now=0.0):
    """Add corpus rows [lo, hi) to both engines, 8 at a time: one batch shape
    keeps the JAX side from compiling anew for every call."""
    for s in range(lo, hi, 8):
        rj, rt = tw("add", idx[s : min(s + 8, hi)], now=now)
        assert list(rj) == list(rt)
        contents.update({g: idx[s + j] for j, g in enumerate(rt)})


@pytest.fixture(scope="module")
def history(tiny):
    """One history run on a JAX ``oracle`` engine and a port engine alike:
    ingest, seal, deletes in both tiers, updates of sealed and head docs, a
    merge that relocates sealed docs (one id given twice), a retraction,
    seal, compact, more ingest, relocating updates that leave the head
    unsorted, and the head re-sort. ``contents`` tracks each live doc's set."""
    *_, idx = tiny
    tw = Twin(tiny)
    contents = {}
    _ingest(tw, contents, idx, 0, 40, now=0.0)
    tw("seal")
    _ingest(tw, contents, idx, 40, 64, now=10.0)
    dead = [0, 13, 39, 41]
    tw("delete", dead)
    upd = [1, 2, 3, 4, 5, 6, 8, 9]  # sealed: relocate into the head
    tw("update", upd, idx[200:208], now=20.0)
    head = [45, 46, 47, 48, 49, 50, 51, 52]  # in place: counters overwritten
    tw("update", head, idx[208:216], now=20.0)
    merged = [7, 45, 7, 10, 11, 46, 12, 14]  # sealed relocations, head increments
    tw("merge_rows", merged, idx[216:224])
    drop = [r[r >= 0][:10] for r in idx[200:208]]
    tw("retract_rows", upd, np.stack([_rows(d, pad=P)[0] for d in drop]))
    for g in dead:
        contents.pop(g)
    for j, g in enumerate(upd):
        contents[g] = _minus(idx[200 + j], drop[j])
    contents.update({g: idx[208 + j] for j, g in enumerate(head)})
    for j, g in enumerate(merged):
        contents[g] = _union(contents[g], idx[216 + j])
    assert_same_state(tw.j.store, tw.t.store)
    tw("seal")
    tw("delete", [20])
    contents.pop(20)
    sj, st_ = tw("compact")
    assert st_ == sj and st_["rows_out"] == len(contents)
    _ingest(tw, contents, idx, 64, 72, now=30.0)
    upd = [15, 16, 17, 18, 19, 21, 22, 23]  # relocate behind ids 64..71
    tw("update", upd, idx[224:232], now=30.0)
    contents.update({g: idx[224 + j] for j, g in enumerate(upd)})
    assert not tw.t.store.head.is_sorted
    tw.j.store._sort_head()
    tw.t.store._sort_head()
    assert_same_state(tw.j.store, tw.t.store)
    return tw, contents


# ------------------------------------------------------------ counting head
def test_counting_multiplicity_duplicates_and_retraction():
    """Two elements in one bin count 2; retracting one keeps the bin set,
    retracting both clears it. Rows are sets: repeats are collapsed at every
    counting entry point, so no phantom count remains (the outcomes
    tests/test_segments.py asserts of the reference)."""
    _, _, tcfg, tm = _crafted()
    ts = SegmentedStore.create(tcfg, tm, capacity=2)
    ts.add(_rows([0, 1, 2, 2]))
    ts.add(_rows([0, 0, 0, 1]))
    np.testing.assert_array_equal(ts.head.counters[:2].numpy(), [[1, 0, 2, 0], [0, 0, 2, 0]])
    ts.retract_rows([0, 1], _rows([1], [0]))
    np.testing.assert_array_equal(_bits(ts, 4), [[1, 0, 1, 0], [0, 0, 1, 0]])
    ts.retract_rows([0, 1, 1], _rows([0], [1, 1], []))  # a repeated id: deltas add
    np.testing.assert_array_equal(_bits(ts, 4), [[1, 0, 0, 0], [0, 0, 0, 0]])
    assert int(ts.head.counters[1].sum()) == 0


def test_retraction_refusals_and_update_recovery(tiny):
    """merge_rows makes a row inexact, sealing makes it packed-only: both
    refuse retraction; update restores exactness. A retraction matches the
    shrunken document's fresh sketch."""
    _, _, tcfg, tm = _crafted()
    ts = SegmentedStore.create(tcfg, tm, capacity=2)
    ts.add(_rows([0]))
    ts.merge_rows([0], _rows([0]))  # overlap: a shared element counts twice
    with pytest.raises(ValueError, match="exact head row"):
        ts.retract_rows([0], _rows([0]))
    ts.update([0], _rows([0, 3]))
    ts.retract_rows([0], _rows([3]))
    np.testing.assert_array_equal(_bits(ts, 4), [[0, 0, 1, 0]])

    _, _, tcfg, tmap, idx = tiny
    ts = SegmentedStore.from_indices(tcfg, tmap, idx[:4])
    row = idx[2][idx[2] >= 0]
    drop, keep = row[: len(row) // 2], row[len(row) // 2:]
    ts.retract_rows([2], _rows(drop, pad=P))
    want = get_backend("reference").sketch(tcfg, tmap, torch.from_numpy(_rows(keep, pad=P)))
    assert torch.equal(ts.sketches[2], want[0])
    ts.seal()
    with pytest.raises(ValueError, match="exact head row"):
        ts.retract_rows([2], idx[2:3])


def test_saturated_counters_refuse_retraction(monkeypatch):
    """A counter clamped at COUNTER_MAX flags its row: retraction is refused
    there, a merge past the clamp marks a row too (sticky), and update
    re-counts below the clamp (the outcomes tests/test_segments.py asserts
    of the reference, on a clamp lowered to 3)."""
    monkeypatch.setattr(tcount, "COUNTER_MAX", 3)
    ts = SegmentedStore.create(config_from_reference(8, 4), torch.zeros(8, dtype=torch.int32),
                               capacity=2)
    ts.add(_rows([0, 1, 2, 3, 4], [5, 6], pad=6))  # occupancy 5 > 3, and 2
    assert ts.head.saturated[:2].tolist() == [True, False]
    assert ts.head.counters[0, 0] == 3
    with pytest.raises(ValueError, match="saturated"):
        ts.retract_rows([0], _rows([0], pad=6))
    ts.retract_rows([1], _rows([5], pad=6))
    ts.merge_rows([1], _rows([0, 1, 2, 7], pad=6))  # 1 + 4 > 3: sticky flag
    assert ts.head.saturated[1]
    ts.update([0], _rows([0, 1], pad=6))
    assert not ts.head.saturated[0] and ts.head.exact[0]
    ts.retract_rows([0], _rows([0], pad=6))
    assert ts.head.counters[0, 0] == 1


def test_sixteen_bit_counters_saturate_as_the_reference():
    """At the real clamp (65535), against the JAX store's u16 counters: a doc
    with 66,000 elements in one bin saturates (clamped, flagged, retraction
    refused) and one with 40,000 (past int16's range, inside u16's) keeps its
    exact count and retracts; the stored bits, packed rows and flags equal
    the reference's after each step."""
    from repro.engine import SegmentedStore as JStore

    d = 70_000
    m = np.zeros(d, np.int32)
    m[-3:] = [1, 2, 3]  # all but three elements share bin 0
    jcfg, tcfg = JCfg(d=d, n_bins=4), config_from_reference(d, 4)
    rows = np.full((2, 66_000), -1, np.int32)
    rows[0] = np.arange(66_000)
    rows[1, :40_000] = np.arange(40_000)
    rows[1, 40_000:40_002] = [d - 2, d - 1]
    js = JStore.create(jcfg, jax.numpy.asarray(m), capacity=2)
    ts = SegmentedStore.create(tcfg, torch.from_numpy(m), capacity=2)
    js.add(jax.numpy.asarray(rows))
    ts.add(rows)
    assert_same_state(js, ts)
    assert ts.head.counters.dtype == torch.int16 and ts.head.counters.element_size() == 2
    assert tcount.widen(ts.head.counters[:2, 0]).tolist() == [65535, 40000]
    assert ts.head.saturated[:2].tolist() == [True, False]
    drop = _rows(list(range(30_000)) + [d - 1], pad=30_001)
    for store in (js, ts):
        with pytest.raises(ValueError, match="saturated"):
            store.retract_rows([0], drop)
        store.retract_rows([1], drop)
    assert_same_state(js, ts)
    assert tcount.widen(ts.head.counters[1]).tolist() == [10000, 0, 1, 0]


# ---------------------------------------------------------- store surface
def test_add_across_capacity_doublings_matches_append_only_store(tiny):
    """The counting head's packed view and fills are the append-only store's,
    across capacity doublings, on both port backends."""
    _, _, tcfg, tmap, idx = tiny
    plain = SketchStore.from_indices(tcfg, tmap, idx[:100])
    for backend in ("reference", "cuda"):
        ts = SegmentedStore.create(tcfg, tmap, capacity=4)
        for lo, hi in [(0, 3), (3, 40), (40, 41), (41, 100)]:
            ts.add(idx[lo:hi], backend=get_backend(backend), batch=16, now=float(lo))
        assert ts.size == 100 and ts.head.capacity == 128
        assert torch.equal(ts.sketches, plain.sketches) and torch.equal(ts.fills, plain.fills)
        np.testing.assert_array_equal(ts.head.born[:100], np.repeat([0, 3, 40, 41],
                                                                    [3, 37, 1, 59]))


def test_add_sketches_and_merge_by_id(tiny):
    """Pre-packed rows enter as occupancy-1 counters; merging another store by
    id ORs shared ids (relocating them out of a sealed segment, inexact from
    then on) and appends the rest under their own ids."""
    _, _, tcfg, tmap, idx = tiny
    base = SketchStore.from_indices(tcfg, tmap, idx[:8])
    ts = SegmentedStore.create(tcfg, tmap)
    ts.add_sketches(base.sketches)
    assert torch.equal(ts.sketches, base.sketches) and not ts.head.exact[:8].any()
    ts.seal()
    other = SegmentedStore.create(tcfg, tmap)
    other.add(idx[8:18])
    other.delete([6, 7])
    ts.merge(other)  # ids 0..5 OR in; 8 and 9 are new
    assert ts.size == 10 and ts.next_id == 10 and ts.sealed[0].n_live == 2
    rows = [_union(idx[g], idx[8 + g]) for g in range(6)] + [idx[6], idx[7], idx[16], idx[17]]
    assert torch.equal(ts.sketches, SketchStore.from_indices(tcfg, tmap, np.stack(rows)).sketches)
    assert ts.live_ids.tolist() == list(range(10))


def test_seal_sketches_bypasses_the_head(tiny):
    """Pre-packed rows go straight into a sealed segment under fresh ids, as
    in the reference; wrong widths and word types are refused."""
    *_, idx = tiny
    tw, contents = Twin(tiny), {}
    _ingest(tw, contents, idx, 0, 8)
    words = SketchStore.from_indices(tw.t.cfg, tw.t.store.mapping, idx[8:16]).sketches
    rj = tw.j.store.seal_sketches(packed_to_reference(words), now=3.0)
    rt = tw.t.store.seal_sketches(words, now=3.0)
    assert list(rt) == list(rj) == list(range(8, 16))
    assert tw.t.store.head.size == 8 and tw.t.store.sealed[0].born.tolist() == [3.0] * 8
    assert_same_state(tw.j.store, tw.t.store)
    with pytest.raises(ValueError, match="base"):
        tw.t.store.seal_sketches(words[:, :3])
    with pytest.raises(TypeError):
        tw.t.store.seal_sketches(words.to(torch.int64))


def test_append_only_merge_rows_and_merge(tiny):
    """``SketchStore.merge_rows`` (a repeated id OR-combined first) and the
    row-aligned ``merge`` give the sketches of the unions."""
    _, _, tcfg, tmap, idx = tiny
    store = SketchStore.from_indices(tcfg, tmap, idx[:10])
    store.merge_rows([3, 7, 3, 0], idx[20:24])
    rows = [idx[i] for i in range(10)]
    rows[3], rows[7], rows[0] = (_union(idx[3], idx[20], idx[22]), _union(idx[7], idx[21]),
                                 _union(idx[0], idx[23]))
    store.merge(SketchStore.from_indices(tcfg, tmap, idx[30:42]))
    rows = [_union(r, idx[30 + i]) for i, r in enumerate(rows)] + list(idx[40:42])
    want = SketchStore.from_indices(tcfg, tmap, np.stack(rows))
    assert store.size == 12
    assert torch.equal(store.sketches, want.sketches) and torch.equal(store.fills, want.fills)


# --------------------------------------------------------------- lifecycle
def test_history_matches_reference_state(history):
    tw, contents = history
    assert_same_state(tw.j.store, tw.t.store)
    assert sorted(tw.t.store._loc) == sorted(contents)
    assert len(tw.t.store.sealed) == 1 and tw.t.store.head.size == 16


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_history_matches_fresh_build(tiny, history, backend):
    """The acceptance invariant: the mutated store answers like a fresh build
    over the survivors, all four measures, on both port backends."""
    *_, idx = tiny
    tw, contents = history
    eng = SketchEngine(tw.t.store, get_backend(backend))
    q = np.concatenate([idx[100:104], np.stack([contents[g] for g in (1, 7, 45, 16)])])
    assert_fresh_equal(eng, contents, q, measures=MEASURES)


@settings(max_examples=8, database=None, derandomize=True, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["insert", "delete", "update", "seal",
                                               "compact"]),
                              st.integers(1, 5), st.integers(0, 10**6)),
                    min_size=4, max_size=12))
def test_random_interleavings_query_identical(tiny, ops):
    """Any interleaving of insert / delete / update / seal / compact answers
    like a fresh build over the survivors (tests/test_segments.py:273)."""
    _, _, tcfg, tmap, idx = tiny
    engine = SketchEngine(SegmentedStore.create(tcfg, tmap, capacity=8), get_backend("reference"))
    contents, cursor = {}, 0
    for op, b, pick in ops:
        live = sorted(contents)
        if op == "insert" or not live:
            ids = engine.add(idx[cursor : cursor + b])
            contents.update({int(g): idx[cursor + j] for j, g in enumerate(ids)})
            cursor += b
        elif op == "delete":
            g = live[pick % len(live)]
            engine.delete([g])
            contents.pop(g)
        elif op == "update":
            g = live[pick % len(live)]
            engine.update([g], idx[cursor : cursor + 1])
            contents[g] = idx[cursor]
            cursor += 1
        else:
            getattr(engine, op)()
    assert engine.store.size == len(contents)
    assert sorted(engine.store._loc) == sorted(contents)
    assert_fresh_equal(engine, contents, idx[200:206])


def test_empty_after_total_deletion(tiny):
    """Every doc deleted: sentinels only, compaction drops everything, ids
    are never reused; held to the JAX oracle."""
    *_, idx = tiny
    tw, contents = Twin(tiny), {}
    _ingest(tw, contents, idx, 0, 16)
    tw("seal")
    tw("delete", list(range(16)))
    assert tw.t.store.size == 0
    sc, ids = tw.t.query(idx[:8], 4)
    assert (ids == -1).all() and torch.isneginf(sc).all()
    assert_reference_equal(tw.j, tw.t, idx[:8], k=4)
    sj, st_ = tw("compact")
    assert st_ == sj and st_["rows_out"] == 0 and tw.t.store.sealed == []
    rj, rt = tw("add", idx[16:24])
    assert list(rt) == list(rj) == list(range(16, 24))
    assert_same_state(tw.j.store, tw.t.store)


def test_delete_unknown_id_raises(tiny):
    _, _, tcfg, tmap, idx = tiny
    store = SegmentedStore.from_indices(tcfg, tmap, idx[:4])
    with pytest.raises(KeyError):
        store.delete([99])
    with pytest.raises(KeyError):  # a bad id anywhere leaves the batch undone
        store.delete([1, 99])
    assert store.size == 4 and store.live_ids.tolist() == [0, 1, 2, 3]
    store.delete([2])
    with pytest.raises(KeyError):
        store.delete([2])
    with pytest.raises(ValueError, match="duplicate"):
        store.update([1, 1], idx[:2])
    with pytest.raises(ValueError, match="content rows"):
        store.update([1], idx[:2])
    assert store.size == 3


def test_ttl_lazy_then_swept(tiny):
    """With a store ttl, docs aged out at query time never appear in a top-k
    before any sweep; the sweep reclaims them without changing what queries
    see, in step with the reference's state. A merge keeps birth stamps."""
    *_, idx = tiny
    tw, contents = Twin(tiny, ttl=5.0), {}
    _ingest(tw, contents, idx, 0, 8, now=0.0)  # sealed, old
    tw("seal")
    _ingest(tw, contents, idx, 8, 16, now=0.0)  # head, old
    _ingest(tw, contents, idx, 16, 24, now=10.0)  # head, fresh
    tw("merge_rows", list(range(8)), idx[24:32])  # relocated, still born at 0
    tw.j.store._sort_head()  # queries re-sort the port's head; keep both in step
    tw.t.store._sort_head()
    engine, q = tw.t, idx[:24]
    _, ids_all = engine.query(q, 24)
    assert set(ids_all.numpy().ravel().tolist()) == set(range(24))
    sc, ids = engine.query(q, 24, now=11.0)
    assert set(ids.numpy().ravel().tolist()) - {-1} == set(range(16, 24))
    assert engine.store.size == 24
    nj, nt = tw("expire", 5.0, 11.0)
    assert nt == nj == 16 and engine.store.size == 8
    assert_same_state(tw.j.store, tw.t.store)
    sc2, ids2 = engine.query(q, 24, now=11.0)
    assert torch.equal(ids, ids2) and torch.equal(sc, sc2)
    tw("seal")
    tw("compact")
    assert len(engine.store.sealed) == 1 and engine.store.sealed[0].n_rows == 8
    assert_same_state(tw.j.store, tw.t.store)


def test_seal_rows_auto_seals_and_score_all_columns(tiny):
    """``seal_rows`` seals the head as it fills; ``score_all`` on a segmented
    store has one column per live doc in ascending id."""
    *_, idx = tiny
    tw, contents = Twin(tiny, seal_rows=16), {}
    _ingest(tw, contents, idx, 0, 48)
    tw("delete", [3, 40])
    assert len(tw.t.store.sealed) == 3 and tw.t.store.head.size == 0
    sj, st_ = tw("compact")
    assert st_ == sj and len(tw.t.store.sealed) == 1
    assert_same_state(tw.j.store, tw.t.store)
    live = [g for g in range(48) if g not in (3, 40)]
    fresh = SketchEngine.build(tw.t.cfg, tw.t.store.mapping, idx[live], backend="reference")
    assert torch.equal(tw.t.score_all(idx[:5]), fresh.score_all(idx[:5]))
    with pytest.raises(TypeError, match="append-only"):
        SketchEngine.build(tw.t.cfg, tw.t.store.mapping).delete([0])
    with pytest.raises(ValueError, match="mutable"):
        SketchEngine.build(tw.t.cfg, tw.t.store.mapping, ttl=1.0)
