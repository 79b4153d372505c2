"""Port parity, multi-device serving: ``repro_torch.parallel`` (the one-process
device mesh), ``repro_torch.engine.placement`` (whole sealed segments placed
on shards) and ``SketchEngine.query_sharded`` (placed and sliced), against
``repro.engine`` on the ``tiny`` corpus with the JAX package's Ψ table.

The port runs on meshes of 1, 3 and 8 CPU shards (``make_mesh(...,
devices=["cpu"])``: several shards on one device, as the reference's tests
force eight host devices). Its answers are held to the JAX engine's: port
``reference`` against JAX ``oracle`` at rtol 2e-3 / atol 1e-3, port ``cuda``
(its plain versions here) against JAX ``pallas-interpret`` at rtol 1e-5 /
atol 1e-6 on a one-device mesh, ids tie-aware through
``repro.engine.testing.assert_topk_equivalent``. The JAX side runs in this
process on a one-device mesh (its answers do not depend on the mesh: its own
tests prove the placed and sliced paths equal to ``query``), plus one
eight-device subprocess that prints its placements as JSON; each JAX
``query_sharded`` retraces its ``shard_map`` and takes seconds here, so the
file makes few of them. Port-only cases (the ported ``tests/test_placement.py``
and its neighbours) hold the placed and sliced paths to the port's own
``query`` or to a fresh build over the survivors."""

import json
import threading

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.engine import DistillPolicy as JPolicy
from repro.engine import SegmentPlacer as JPlacer
from repro.engine import get_backend as j_get_backend
from repro.engine.testing import assert_topk_equivalent, topk_truth
from repro_torch import faults, obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import BinSketchConfig, make_mapping
from repro_torch.data.synthetic import DATASETS
from repro_torch.engine import (BandPolicy, DistillPolicy, QueryPlanner, SegmentedStore,
                                SegmentPlacement, SegmentPlacer, SketchEngine, SketchStore,
                                WidthSlab, get_backend, shard_topk)
from repro_torch.hopper.build import KernelError
from repro_torch.parallel import DeviceMesh, all_gather, make_mesh, shard_put

from test_torch_distill import mixed_truth
from test_torch_ops_plane import join_attempt
from test_torch_segments import Twin, _ingest, tiny  # noqa: F401

CPU = "cpu"
SHARDS = [1, 3, 8]
REF_TOL = {"rtol": 2e-3, "atol": 1e-3}  # port reference vs JAX oracle
KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-6}  # port cuda (plain) vs JAX pallas-interpret


def mesh_of(n):
    return make_mesh((n,), ("data",), devices=[CPU])


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()
    obs.disable()


def _np(pair):
    return pair[0].numpy(), pair[1].numpy()


def _engine(tiny, n=96, seal_rows=24, **kw):
    """A mutable port engine whose first ``n`` rows are sealed into
    ``n // seal_rows`` segments (``tests/conftest.py::multi_segment_engine``)."""
    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True,
                             seal_rows=seal_rows, **kw)
    for s in range(0, n, seal_rows):
        eng.add(idx[s : s + seal_rows])
    return eng


def assert_fresh(eng, contents, q, k=5, **kw):
    """``query_sharded(**kw)`` equals a fresh append-only build over the
    survivors, tie-aware (the invariant of the reference's placement tests)."""
    surv = np.asarray(sorted(contents))
    fresh = SketchEngine.build(eng.cfg, eng.store.mapping, backend=eng.backend,
                               capacity=len(surv))
    fresh.add(np.stack([contents[int(g)] for g in surv]))
    got = _np(eng.query_sharded(kw.pop("mesh"), "data", q, k, **kw))
    sc_f, id_f = _np(fresh.query(q, k))
    id_f = np.where(id_f >= 0, surv[np.maximum(id_f, 0)], -1)
    assert_topk_equivalent(got, (sc_f, id_f), truth=topk_truth(fresh, q, id_map=surv))


# ------------------------------------------------------------------- mesh
def test_mesh_shard_put_and_all_gather():
    m = make_mesh((4,), ("data",), devices=[CPU])
    assert isinstance(m, DeviceMesh) and m.shape["data"] == m.size == 4
    assert m.devices == (torch.device(CPU),) * 4
    assert m == make_mesh((4,), ("data",), devices=["cpu", "cpu"]) and m != mesh_of(3)
    with pytest.raises(dataclasses_frozen_error()):
        m.devices = ()
    t = torch.arange(12).reshape(6, 2)
    parts = shard_put(t, mesh_of(3))
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]], [[8, 9], [10, 11]]]
    assert torch.equal(all_gather(parts, CPU, dim=0), t)
    with pytest.raises(ValueError, match="equal shards"):
        shard_put(t, mesh_of(4))
    with pytest.raises(ValueError, match="one-axis"):
        make_mesh((2, 2), ("data", "model"), devices=[CPU])


def dataclasses_frozen_error():
    import dataclasses

    return dataclasses.FrozenInstanceError


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((4,), ("data",))


def test_shard_topk_merges_like_lax_top_k():
    """The per-shard top-k and its merge over four shard slices equal one
    top-k over the whole candidate set, ties to the lower position."""
    rng = np.random.default_rng(0)
    words = torch.from_numpy(rng.integers(0, 2**31, (40, 4), dtype=np.int64).astype(np.int32))
    words[10] = words[3]  # a tie across shards
    q = words[[3, 7, 20]]
    mesh = mesh_of(4)
    be = get_backend("reference")
    sc, ids = shard_topk(q, list(words.split(10)), 128, "jaccard", 5, mesh, backend=be)
    want = be.topk(q, words, 128, "jaccard", 5)
    assert torch.equal(ids, want[1]) and torch.equal(sc, want[0])
    assert ids[0, :2].tolist() == [3, 10]


# --------------------------------------------------------------- placer
@pytest.mark.parametrize("n_shards", SHARDS)
def test_placement_slab_invariants(tiny, n_shards):
    """Each shard's slab is id-ascending, provenance maps every slot back to
    its (segment, row), pad slots carry id -1, and tombstones and a
    relocation land in the mask without rebuilding the slabs."""
    *_, idx = tiny
    eng = _engine(tiny)
    eng.delete([3, 30, 70])
    eng.update([50], idx[200:201])  # sealed -> head relocation
    store = eng.store
    p = SegmentPlacer().place(store, mesh_of(n_shards), "data")
    assert isinstance(p, SegmentPlacement) and isinstance(p.slabs[0], WidthSlab)
    assert sorted(i for g in p.assign for i in g) == list(range(len(store.sealed)))
    assert p.widths == [eng.cfg.n_bins] and p.n_devices == n_shards
    slab = p.slabs[0]
    ids = slab.ids_host()
    assert len(ids) == slab.n_slots == n_shards * slab.n_local
    for d in range(n_shards):
        local = ids[d * slab.n_local : (d + 1) * slab.n_local]
        real = local[local >= 0]
        assert (np.diff(real) > 0).all() and (local[len(real):] == -1).all()
    real = ids >= 0
    for j in np.nonzero(real)[0]:
        seg = store.sealed[int(slab.src_seg[j])]
        assert int(seg.ids[int(slab.src_row[j])]) == int(ids[j])
    assert (slab.src_seg[~real] == -1).all() and (slab.src_row[~real] == -1).all()
    valid = torch.cat(slab.valid_mask(store)).numpy()
    for j in np.nonzero(real)[0]:
        assert bool(valid[j]) == (int(ids[j]) not in {3, 30, 50, 70})
    assert not valid[~real].any()


def test_placement_balances_by_live_rows(tiny):
    """LPT: the heavy segment first, onto the lightest shard; ties to the
    lower shard; an empty shard gets a zero slab of pads."""
    _, _, tcfg, tmap, idx = tiny
    store = SegmentedStore.create(tcfg, tmap)
    lo = 0
    for sz in [40, 8, 8, 8, 8, 8]:
        store.add(idx[lo : lo + sz])
        store.seal()
        lo += sz
    p = SegmentPlacer().place(store, mesh_of(1), "data")
    assert p.assign == [[0, 1, 2, 3, 4, 5]] and p.segments_per_device == 6
    p = SegmentPlacer().place(store, mesh_of(3), "data")
    assert p.assign == [[0], [1, 3, 5], [2, 4]]
    p = SegmentPlacer().place(store, mesh_of(8), "data")
    assert p.assign == [[0], [1], [2], [3], [4], [5], [], []]
    slab = p.slabs[0]
    assert slab.n_local == 40
    assert (slab.ids_host()[6 * 40 :] == -1).all() and not slab.sketches[7].any()


def test_placement_cache_reuse_and_invalidation(tiny):
    """Slabs rebuild only on a layout change (seal, compaction); a tombstone
    flip rebuilds the validity mask once per width, and only when the
    store's tombstone epoch moved."""
    *_, idx = tiny
    eng = _engine(tiny)
    mesh = mesh_of(3)
    q = idx[5:9]
    reg = obs.enable()
    eng.query_sharded(mesh, "data", q, 3)
    p1 = eng._placement
    eng.query_sharded(mesh, "data", q, 3)
    assert reg.snapshot()["counters"]["placement.mask_refreshes"] == 1
    epoch = eng.store._valid_epoch
    eng.delete([7])  # liveness only
    assert eng.store._valid_epoch == epoch + 1
    eng.query_sharded(mesh, "data", q, 3)
    assert eng._placement is p1
    assert reg.snapshot()["counters"]["placement.mask_refreshes"] == 2
    eng.query_sharded(mesh_of(8), "data", q, 3)  # another mesh: rebuilt
    p8 = eng._placement
    assert p8 is not p1 and p8.mesh == mesh_of(8)
    eng.add(idx[200:210])
    eng.seal()  # layout change
    eng.query_sharded(mesh_of(8), "data", q, 3)
    assert eng._placement is not p8
    snap = reg.snapshot()
    assert snap["counters"]["placement.builds"] == 3
    assert snap["counters"]["placement.rows_placed"] == 96 + 96 + 106
    assert snap["histograms"]["query.query_sharded_s"]["count"] == 5


# ------------------------------------------------- against the JAX package
def _stage_a(tw, idx):
    """Four sealed segments of 24 (the first two born at 0, the rest at 10),
    tombstones in each, two sealed docs relocated into the head."""
    contents = {}
    _ingest(tw, contents, idx, 0, 48, now=0.0)
    _ingest(tw, contents, idx, 48, 96, now=10.0)
    tw("delete", [3, 30, 70, 81])
    tw("update", [50, 20], idx[200:202], now=10.0)
    return contents


def _stage_b(tw, idx, contents):
    """The two old segments distilled to N // 2, eight more head rows."""
    w = tw.t.cfg.n_bins // 2
    if tw.j is not None:
        tw.j.distill(JPolicy(widths=(w,), min_age=5.0), now=10.0, background=False)
    tw.t.distill(DistillPolicy(widths=(w,), min_age=5.0), now=10.0)
    _ingest(tw, contents, idx, 96, 104, now=10.0)


class _PortOnly:
    """A port engine fed the verbs of :class:`Twin` (no JAX engine)."""

    def __init__(self, tiny, **kw):
        _, _, tcfg, tmap, _ = tiny
        self.j = None
        self.t = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, **kw)

    def __call__(self, verb, *args, **kw):
        r = getattr(self.t, verb)(*args, **kw)
        return r, r


@pytest.fixture(scope="module")
def staged(tiny):
    """One history on a JAX engine and port engines, with the JAX placed
    answers (``query_sharded`` on a one-device mesh) after stage A (mutated;
    ``oracle``, for the port's ``reference``) and stage B (mixed width plus
    head; ``pallas-interpret``, for the port's ``cuda``), a port engine left at
    each stage, and the segment hits of one placed call on each side."""
    *_, idx = tiny
    q = idx[10:18]
    jmesh = jax.make_mesh((1,), ("data",))
    tw = Twin(tiny, seal_rows=24)
    contents = _stage_a(tw, idx)
    want_a = tuple(map(np.asarray, tw.j.query_sharded(jmesh, "data", q, 6)))
    jplace = JPlacer().place(tw.j.store, jmesh, "data")
    hits = {"jax": ([s.hits for s in tw.j.store.sealed], tw.j.store.head_hits)}
    port_a = _PortOnly(tiny, seal_rows=24)
    _stage_a(port_a, idx)
    port_a.t.query_sharded(mesh_of(8), "data", q, 6)
    hits["port"] = ([s.hits for s in port_a.t.store.sealed], port_a.t.store.head_hits)
    _stage_b(tw, idx, contents)
    tw.j.backend, tw.t.backend = j_get_backend("pallas-interpret"), get_backend("cuda")
    want_b = tuple(map(np.asarray, tw.j.query_sharded(jmesh, "data", q, 6)))
    return {"q": q, "jplace": jplace, "hits": hits, "a": (port_a.t, want_a, REF_TOL),
            "b": (tw.t, want_b, KERNEL_TOL)}


def test_placement_equals_the_reference_on_one_device(staged):
    """The port's placement of the mutated store on one shard is the JAX
    engine's on one device: assignment, widths, slab sizes, ids, provenance."""
    eng = staged["a"][0]
    p, jp = SegmentPlacer().place(eng.store, mesh_of(1), "data"), staged["jplace"]
    assert p.assign == jp.assign and p.widths == jp.widths
    for s, js in zip(p.slabs, jp.slabs):
        assert s.n_local == js.n_local
        np.testing.assert_array_equal(s.ids_host(), np.asarray(js.ids))
        np.testing.assert_array_equal(s.src_seg, js.src_seg)
        np.testing.assert_array_equal(s.src_row, js.src_row)
        np.testing.assert_array_equal(s.born, js.born)


@pytest.mark.parametrize("stage", ["a", "b"])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_placed_and_sliced_match_the_reference(staged, stage, n_shards):
    """Placed and sliced answers on 1, 3 and 8 shards equal the JAX engine's
    placed answers: the port's ``reference`` against ``oracle`` on the
    mutated store (a), the port's ``cuda`` (its plain versions on the CPU)
    against ``pallas-interpret`` on the mixed-width store with a head (b)."""
    eng, want, tol = staged[stage]
    q, mesh = staged["q"], mesh_of(n_shards)
    truth = mixed_truth(eng, q)
    for use_placement in (True, False):
        got = _np(eng.query_sharded(mesh, "data", q, 6, use_placement=use_placement))
        assert_topk_equivalent(got, want, truth, err_msg=f"placement={use_placement}", **tol)
    if stage == "b":
        assert eng.backend.name == "cuda"
        assert eng._placement.widths == [eng.cfg.n_bins, eng.cfg.n_bins // 2]


def test_slab_and_head_hits_match_the_reference(staged):
    """A placed call counts one hit per scored width slab's segments and one
    for the replicated head, never one per shard."""
    (j_seg, j_head), (t_seg, t_head) = staged["hits"]["jax"], staged["hits"]["port"]
    assert t_seg == j_seg and t_head == j_head == 1 and all(h == 1 for h in t_seg)


# -------------------------------------------------- port: placed == query
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_placed_query_sharded_matches_query(tiny, seed, n_shards):
    """A seeded mutation soup: the placed and sliced paths equal ``query``."""
    _, _, tcfg, tmap, idx = tiny
    rng = np.random.default_rng(seed)
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, seal_rows=16)
    mesh = mesh_of(n_shards)
    cursor, live = 0, []
    for _ in range(10):
        op = rng.choice(["insert", "delete", "update", "seal", "compact"])
        if op == "insert" or not live:
            b = int(rng.integers(1, 8))
            live.extend(eng.add(idx[cursor : cursor + b]))
            cursor += b
        elif op == "delete":
            g = int(rng.choice(live))
            eng.delete([g])
            live.remove(g)
        elif op == "update":
            eng.update([int(rng.choice(live))], idx[cursor][None])
            cursor += 1
        elif op == "seal":
            eng.seal()
        else:
            eng.compact()
    q = idx[100:108]
    truth = topk_truth(eng, q)
    want = _np(eng.query(q, 5))
    for use_placement in (True, False):
        got = _np(eng.query_sharded(mesh, "data", q, 5, use_placement=use_placement))
        assert_topk_equivalent(got, want, truth, err_msg=f"seed {seed} {use_placement}")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_plain_store_rows_sliced_with_pads(n_shards):
    """An append-only store has nothing to place: the sliced path serves it,
    C=29 padded to a multiple of the shard count, and the tail docs a
    truncating slice would drop stay retrievable (``tests/test_engine.py``)."""
    from repro_torch.data.synthetic import generate_similar_pairs

    spec = DATASETS["tiny"]
    a, b, _ = generate_similar_pairs(spec, 0.9, 32, seed=0)
    cfg = BinSketchConfig.from_sparsity(spec.d, spec.max_nnz, rho=0.05)
    eng = SketchEngine.build(cfg, make_mapping(cfg, seed=0, device=CPU), a[:29],
                             backend="reference")
    assert isinstance(eng.store, SketchStore)
    mesh = mesh_of(n_shards)
    sc1, id1 = eng.query(b[:8], k=4)
    sc8, id8 = eng.query_sharded(mesh, "data", b[:8], k=4)
    assert torch.equal(id1, id8) and torch.allclose(sc1, sc8, rtol=1e-5, atol=1e-6)
    _, idt = eng.query_sharded(mesh, "data", b[24:29], k=1)
    assert idt[:, 0].tolist() == list(range(24, 29))
    assert eng._placement is None


# --------------------------------------------- background, faults, TTL
@pytest.mark.parametrize("n_shards", SHARDS)
def test_device_local_groups_from_placement(tiny, n_shards):
    """After a placed query a background compaction merges each shard's
    resident segments as one group, and the answers stay the store's."""
    *_, idx = tiny
    eng = _engine(tiny)  # 4 segments of 24
    eng.delete([1, 30, 55, 80])  # one tombstone a segment
    mesh = mesh_of(n_shards)
    eng.query_sharded(mesh, "data", idx[:4], 3)
    loaded = sum(1 for g in eng._placement.assign if g)
    eng.compact(background=True)
    stats = eng.wait_compaction()
    assert stats["groups"] == loaded == min(n_shards, 4)
    assert stats["segments_in"] == 4 and stats["rows_out"] == 92
    assert_fresh(eng, {g: idx[g] for g in range(96) if g not in (1, 30, 55, 80)},
                 idx[10:18], mesh=mesh)
    assert sorted(len(g) for g in eng._placement.assign if g) == [1] * loaded


def test_back_to_back_background_compactions(tiny):
    """A second background compaction before anyone polled the first adopts
    the pending swap *before* reading the placement's groups."""
    *_, idx = tiny
    eng = _engine(tiny)
    eng.delete([1, 30, 55, 80])
    eng.query_sharded(mesh_of(3), "data", idx[:4], 3)  # placement live
    eng.compact(background=True)
    eng.add(idx[96:120])
    eng.seal()
    eng.delete([100])
    eng.compact(background=True)  # must not mis-group
    assert eng.wait_compaction() is not None
    assert (eng.query(idx[:4], 3)[1] >= 0).all()
    assert eng.store.size == 96 - 4 + 24 - 1
    eng.delete([2])
    with pytest.raises(ValueError, match="out of range or duplicated"):
        eng.store.compact_async(groups=[[97]])


@pytest.mark.parametrize("n_shards", [3, 8])
def test_held_background_compaction_serves_sharded(tiny, n_shards):
    """While a device-local merge is held, placed queries answer from the old
    segments; deletes and a relocating update land mid-merge and come out of
    the swap as tombstones; the query path swaps the finished job in."""
    *_, idx = tiny
    eng = _engine(tiny)
    mesh = mesh_of(n_shards)
    contents = {g: idx[g] for g in range(96)}
    for g in (2, 40):
        contents.pop(g)
    eng.delete([2, 40])
    q = idx[10:16]
    before = _np(eng.query_sharded(mesh, "data", q, 5))
    hold = threading.Event()
    eng.compact(background=True, _hold=hold)
    job = eng.store._compaction.job
    n_seg, epoch = len(eng.store.sealed), eng.store._layout_epoch
    loaded = sum(1 for g in eng._placement.assign if g)  # one merge group a shard
    during = _np(eng.query_sharded(mesh, "data", q, 5))
    np.testing.assert_array_equal(during[1], before[1])
    eng.delete([10, 77])
    contents.pop(10), contents.pop(77)
    eng.update([33], idx[210:211])  # sealed -> head, mid-merge
    contents[33] = idx[210]
    assert_fresh(eng, contents, q, mesh=mesh)  # still the old segments
    assert len(eng.store.sealed) == n_seg and eng.store.job_pending == "compact"
    hold.set()
    join_attempt(job)
    assert_fresh(eng, contents, q, mesh=mesh)  # this call swaps the job in
    assert eng.store.job_pending is None and eng.store._layout_epoch > epoch
    assert len(eng.store.sealed) == loaded == min(n_shards, n_seg)
    assert eng.compact()["rows_out"] == len([g for g in contents if g < 96]) - 1


def test_placement_fault_degrades_to_sliced_path(tiny):
    """``placement.build`` raising: the call is served sliced with the same
    answers, recorded as the ``placement`` degraded mode; a ``placement.
    refresh`` fault likewise; with the plan gone the placed path re-arms."""
    *_, idx = tiny
    eng = _engine(tiny)
    eng.delete([5, 60])
    mesh = mesh_of(3)
    q = idx[100:106]
    want = _np(eng.query_sharded(mesh, "data", q, 5))
    eng._placement = None
    for point in ("placement.build", "placement.refresh"):
        with faults.scoped(faults.FaultPlan({point: faults.FaultSpec("raise")})):
            got = _np(eng.query_sharded(mesh, "data", q, 5))
        assert_topk_equivalent(got, want)
        assert eng._placement is None
    assert "placement" in {d["component"] for d in eng.health()["degraded"]}
    assert_topk_equivalent(_np(eng.query_sharded(mesh, "data", q, 5)), want)
    assert eng._placement is not None


def test_device_fault_in_placed_path_propagates(tiny, monkeypatch):
    """A kernel failing inside the placed path is not a placement fault: it
    propagates, and nothing is recorded as degraded."""
    *_, idx = tiny
    eng = _engine(tiny)

    def kernel_down(*_a, **_k):
        raise KernelError("sketch_topk: launch failed")

    monkeypatch.setattr(eng.backend, "topk", kernel_down)
    with pytest.raises(KernelError):
        eng.query_sharded(mesh_of(3), "data", idx[:4], 3)
    assert eng.health()["degraded"] == []
    assert eng._placement is not None  # the placement itself was sound


@pytest.mark.parametrize("n_shards", [3, 8])
def test_lazy_ttl_through_now_on_sharded_paths(tiny, n_shards):
    """Docs older than the store's ttl at the query's ``now`` never appear on
    either sharded path, no sweep needed (``tests/test_segments.py``); the
    mask refreshes when ``now`` moves."""
    _, _, tcfg, tmap, idx = tiny
    store = SegmentedStore.create(tcfg, tmap, ttl=5.0)
    eng = SketchEngine(store, get_backend("reference"))
    eng.add(idx[:4], now=0.0)  # sealed, old
    eng.seal()
    eng.add(idx[4:6], now=0.0)  # head, old
    eng.add(idx[6:10], now=10.0)  # head, fresh
    q = idx[:10]
    mesh = mesh_of(n_shards)
    sc, ids = eng.query(q, 10, now=11.0)
    for use_placement in (True, False):
        sc_s, ids_s = eng.query_sharded(mesh, "data", q, 10, now=11.0,
                                        use_placement=use_placement)
        np.testing.assert_allclose(np.sort(sc.numpy(), axis=1), np.sort(sc_s.numpy(), axis=1),
                                   rtol=1e-5, atol=1e-6)
        for r in range(len(q)):
            assert set(ids[r].tolist()) == set(ids_s[r].tolist())
        assert set(ids_s.numpy().ravel().tolist()) - {-1} == {6, 7, 8, 9}
    _, ids_early = eng.query_sharded(mesh, "data", q, 10, now=1.0)
    assert set(ids_early.numpy().ravel().tolist()) - {-1} == set(range(10))


# ------------------------------------------------- widths, bands, restore
@pytest.mark.parametrize("n_shards", SHARDS)
def test_mixed_width_one_slab_per_width(tiny, n_shards):
    """Only the two oldest segments distilled: the placement holds one slab
    per width, base first, and the placed and sliced paths equal ``query``
    on the mixed-width store with a head (``tests/test_distill.py``)."""
    *_, idx = tiny
    eng = _engine(tiny)
    eng.delete([5, 40])
    n_new = eng.cfg.n_bins // 2
    for seg in eng.store.sealed[2:]:
        seg.born[:] = 1.0  # young
    assert eng.distill(DistillPolicy(widths=(n_new,), min_age=0.5), now=1.0) is not None
    assert [s.n_bins for s in eng.store.sealed].count(n_new) == 2
    eng.add(idx[96:104])
    q = idx[10:18]
    mesh = mesh_of(n_shards)
    want, truth = _np(eng.query(q, 6)), mixed_truth(eng, q)
    assert_topk_equivalent(_np(eng.query_sharded(mesh, "data", q, 6)), want, truth)
    assert eng._placement.widths == [eng.cfg.n_bins, n_new]
    assert all(s.n_local >= 1 for s in eng._placement.slabs)
    assert_topk_equivalent(_np(eng.query_sharded(mesh, "data", q, 6, use_placement=False)),
                           want, truth)


@pytest.mark.parametrize("n_shards", [3, 8])
def test_prefilter_placed_matches_single_device(n_shards):
    """Mixed-width store with band indexes: the placed prefilter equals the
    single-device prefilter, ids and scores, every prefiltered score is the
    id's exhaustive one, and both exhaustive sharded paths equal the
    exhaustive ``query`` (``tests/test_banding.py``)."""
    rng = np.random.default_rng(0)
    d, nnz = 2048, 32
    base = rng.integers(0, d, size=(30, nnz), dtype=np.int32)
    docs = base[np.arange(240) % 30].copy()
    docs[np.arange(240), rng.integers(0, nnz, 240)] = rng.integers(0, d, 240)
    docs = np.sort(docs, axis=1)
    cfg = BinSketchConfig(d=d, n_bins=256)
    eng = SketchEngine.build(cfg, make_mapping(cfg, seed=3, device=CPU), backend="reference",
                             mutable=True,
                             band_policy=BandPolicy(n_bands=8, max_candidate_frac=0.5, min_rows=8),
                             planner=QueryPlanner(min_batch=8, max_batch=16))
    for s in range(0, 240, 80):
        eng.add(docs[s : s + 80])
        eng.seal()
    eng.delete(list(range(0, 240, 13)))
    eng.distill(DistillPolicy(widths=(128,)))  # mixed width
    eng.add(docs[:5])  # head rows on top
    pick = rng.choice(240, 12, replace=False)
    q = docs[pick].copy()
    q[np.arange(12), rng.integers(0, nnz, 12)] = rng.integers(0, d, 12)
    q = np.sort(q, axis=1)
    mesh = mesh_of(n_shards)
    s_sp, i_sp = _np(eng.query(q, 10, prefilter=True))
    s_se, i_se = _np(eng.query(q, 10, prefilter=False))
    s_pp, i_pp = _np(eng.query_sharded(mesh, "data", q, 10, prefilter=True))
    stats = eng.last_prefilter_stats
    assert stats["banded_segments"] >= 1 and stats["cand_rows"] < stats["seg_rows"]
    s_pe, i_pe = _np(eng.query_sharded(mesh, "data", q, 10, prefilter=False))
    s_le, i_le = _np(eng.query_sharded(mesh, "data", q, 10, use_placement=False))
    np.testing.assert_array_equal(i_pp, i_sp)
    np.testing.assert_allclose(s_pp, s_sp, rtol=1e-6)
    np.testing.assert_array_equal(i_pe, i_se)
    np.testing.assert_allclose(s_pe, s_se, rtol=1e-6)
    np.testing.assert_array_equal(i_le, i_se)
    truth = mixed_truth(eng, q)
    for r, c in zip(*np.nonzero(i_pp >= 0)):
        assert abs(truth[r][int(i_pp[r, c])] - s_pp[r, c]) <= 1e-6


def test_checkpoint_restore_placed_parity(tiny, tmp_path):
    """Checkpoint a mutated store, restore it cold, and the placed answers on
    eight shards equal the snapshot engine's: the placement is rebuilt from
    the restored segments, never carried in the checkpoint."""
    *_, idx = tiny
    eng = _engine(tiny, n=80, seal_rows=20)
    eng.delete([3, 41])
    eng.update([7, 66], idx[100:102])
    eng.add(idx[80:90])
    mesh = mesh_of(8)
    q = idx[12:20]
    sc_pre, id_pre = eng.query_sharded(mesh, "data", q, 5)
    mgr = CheckpointManager(str(tmp_path))
    eng.store.save(mgr, step=1)
    back = SegmentedStore.restore(mgr, device=CPU)
    eng2 = SketchEngine(back, get_backend("reference"))
    sc_post, id_post = eng2.query_sharded(mesh, "data", q, 5)
    assert torch.equal(id_pre, id_post)
    torch.testing.assert_close(sc_pre, sc_post, rtol=1e-5, atol=1e-6)
    assert len(back.sealed) == len(eng.store.sealed)
    assert eng2._placement.assign == eng._placement.assign


# --------------------------------------- eight JAX devices, in a subprocess
HISTORY = """
for s in range(0, 96, 8):
    eng.add(rows(s, s + 8), now=0.0)
for s in range(96, 160, 8):
    eng.add(rows(s, s + 8), now=10.0)
eng.delete([2, 17, 44, 99, 130, 131])
eng.update([5, 70, 140], rows(200, 203), now=10.0)
"""
# after the distillation (segments born at 0 fold to N // 2), before the
# device-local compaction
LATER_DELETES = [9, 60, 150]

JAX_8 = """
import json
import numpy as np, jax, jax.numpy as jnp
from repro.core import BinSketchConfig, make_mapping
from repro.data.synthetic import DATASETS, generate_corpus
from repro.engine import DistillPolicy, SketchEngine

spec = DATASETS["tiny"]
idx, lens = generate_corpus(spec, seed=0)
cfg = BinSketchConfig.from_sparsity(spec.d, int(lens.max()), rho=0.05)
mapping = make_mapping(cfg, jax.random.PRNGKey(0))
mesh = jax.make_mesh((8,), ("data",))
eng = SketchEngine.build(cfg, mapping, backend="oracle", mutable=True, seal_rows=16)
rows = lambda a, b: jnp.asarray(idx[a:b])
%s

def dump():
    p = eng._ensure_placement(mesh, "data")
    return {"assign": p.assign, "widths": p.widths, "slabs": [
        {"n_local": s.n_local, "ids": np.asarray(s.ids).tolist(),
         "src_seg": s.src_seg.tolist(), "src_row": s.src_row.tolist()} for s in p.slabs]}

out = {"mutated": dump()}
eng.distill(DistillPolicy(widths=(cfg.n_bins // 2,), min_age=5.0), now=10.0,
            background=False)
out["distilled"] = dump()
eng.delete(%s)
eng.compact(background=True)
eng.wait_compaction()
out["compacted"] = dump()
print("PLACEMENTS=" + json.dumps(out))
"""


def test_placements_equal_the_reference_on_eight_devices(tiny, multidevice):
    """The JAX engine on eight host devices and the port on eight CPU shards,
    fed one history: equal ``assign``, widths, ``n_local`` and, for every
    slab, equal ids and provenance, for the mutated, the distilled and the
    device-locally compacted store; the port's placed answers equal its
    ``query`` at each step."""
    _, _, tcfg, tmap, idx = tiny
    out = multidevice(JAX_8 % (HISTORY, LATER_DELETES), 8)
    want = json.loads(next(line for line in out.splitlines()
                           if line.startswith("PLACEMENTS="))[len("PLACEMENTS="):])
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, seal_rows=16)
    exec(HISTORY, {"eng": eng, "rows": lambda a, b: idx[a:b]})
    mesh = mesh_of(8)
    q = idx[30:42]

    def check(name):
        p = eng._ensure_placement(mesh, "data")
        w = want[name]
        assert p.assign == w["assign"] and p.widths == w["widths"], name
        assert len(p.slabs) == len(w["slabs"])
        for s, ws in zip(p.slabs, w["slabs"]):
            assert s.n_local == ws["n_local"], name
            assert s.ids_host().tolist() == ws["ids"], name
            assert s.src_seg.tolist() == ws["src_seg"] and s.src_row.tolist() == ws["src_row"]
        assert_topk_equivalent(_np(eng.query_sharded(mesh, "data", q, 6)), _np(eng.query(q, 6)),
                               mixed_truth(eng, q), err_msg=name)

    check("mutated")
    assert sum(1 for g in eng._placement.assign if g) == 8  # spread, not piled up
    eng.distill(DistillPolicy(widths=(tcfg.n_bins // 2,), min_age=5.0), now=10.0)
    check("distilled")
    assert len(eng._placement.widths) == 2
    eng.delete(LATER_DELETES)
    eng.compact(background=True)
    assert eng.wait_compaction()["groups"] >= 2  # one merge per loaded shard
    check("compacted")


# ------------------------------------------------------------- property
D, PAD = 2000, 96
_CFG = BinSketchConfig(d=D, n_bins=256)
_MAP = make_mapping(_CFG, seed=0, device=CPU)
sets_st = st.sets(st.integers(0, D - 1), min_size=0, max_size=PAD)


def _pad_rows(rows):
    out = np.full((len(rows), PAD), -1, np.int32)
    for i, r in enumerate(rows):
        u = np.unique(np.asarray(sorted(r), np.int32))[:PAD]
        out[i, : len(u)] = u
    return out


@settings(max_examples=25, deadline=None, database=None, derandomize=True)
@given(st.data())
def test_placed_sharded_with_background_compaction_query_identical(data):
    """``tests/test_properties.py``'s property on the port: the placed
    ``query_sharded`` on 1, 3 or 8 shards, with a background compaction held
    in flight and mutations landing mid-merge, equals a fresh build over the
    survivors (ids up to provable ties), all four measures."""
    store = SegmentedStore.create(_CFG, _MAP, capacity=4, seal_rows=6)
    engine = SketchEngine(store, get_backend("reference"))
    mesh = mesh_of(data.draw(st.sampled_from(SHARDS)))
    contents = {}
    hold = None
    try:
        for _ in range(data.draw(st.integers(3, 9))):
            live = sorted(contents)
            op = data.draw(st.sampled_from(["insert", "insert", "delete", "update", "seal",
                                            "compact_bg", "finish_bg", "query"]))
            if op == "insert" or not live:
                rows = _pad_rows([data.draw(sets_st) for _ in range(data.draw(st.integers(1, 3)))])
                ids = engine.add(rows)
                contents.update({int(g): rows[j] for j, g in enumerate(ids)})
            elif op == "delete":
                g = data.draw(st.sampled_from(live))
                engine.delete([g])
                contents.pop(g)
            elif op == "update":
                g = data.draw(st.sampled_from(live))
                rows = _pad_rows([data.draw(sets_st)])
                engine.update([g], rows)
                contents[g] = rows[0]
            elif op == "seal":
                engine.seal()
            elif op == "compact_bg":
                if hold is None:  # one job at a time; later ops land mid-merge
                    hold = threading.Event()
                    engine.compact(background=True, _hold=hold)
            elif op == "query":  # builds the placement: later merges go device-local
                engine.query_sharded(mesh, "data", _pad_rows([data.draw(sets_st)]), 2)
            elif hold is not None:
                hold.set()
                engine.wait_compaction()
                hold = None
        surv = np.asarray(sorted(contents))
        queries = _pad_rows([data.draw(sets_st) for _ in range(2)])
        fresh = SketchStore.create(_CFG, _MAP)
        if len(surv):  # a live doc's own content guarantees ties and hits
            queries = np.concatenate([queries, contents[int(surv[0])][None]], axis=0)
            fresh.add(np.stack([contents[int(g)] for g in surv]))
        for measure in ("jaccard", "ip", "cosine", "hamming"):
            sc_m, id_m = SketchEngine(store, engine.backend, measure).query_sharded(
                mesh, "data", queries, 4)
            fresh_eng = SketchEngine(fresh, engine.backend, measure)
            sc_f, id_f = _np(fresh_eng.query(queries, 4))
            id_f = np.where(id_f >= 0, surv[np.maximum(id_f, 0)] if len(surv) else -1, -1)
            assert_topk_equivalent((sc_m.numpy(), id_m.numpy()), (sc_f, id_f),
                                   truth=topk_truth(fresh_eng, queries, id_map=surv),
                                   err_msg=measure)
    finally:
        if hold is not None:  # release the worker before the example ends
            hold.set()
            store.wait_compaction()
    assert store.size == len(contents)


# ------------------------------------------------------------------ serve
def test_serve_sharded_on_the_cpu(tiny, capsys):
    """``serve(sharded=True)`` answers as the unsharded serve, reads its
    latency from ``query.query_sharded_s``, and under chaos the
    ``placement.*`` points are hit on the sharded path."""
    from repro_torch.launch.serve import serve

    _, _, _, tmap, _ = tiny
    kw = dict(queries=32, topk=5, batch=8, device=CPU, mapping=tmap, mutate_rate=0.3,
              distill=(212, 106), stats_every=4)
    plain = serve(DATASETS["tiny"], **kw)
    sharded = serve(DATASETS["tiny"], sharded=True, **kw)
    out = capsys.readouterr().out
    assert "sharded serve: 1 device(s), segment-placed" in out
    np.testing.assert_array_equal(sharded["ids"], plain["ids"])
    np.testing.assert_allclose(sharded["scores"], plain["scores"], rtol=1e-5, atol=1e-6)
    assert sharded["recall"] == plain["recall"]
    assert sharded["mesh"] == mesh_of(1) and plain["mesh"] is None
    hist = sharded["metrics"]["histograms"]
    assert hist["query.query_sharded_s"]["count"] == 8 and "query.query_s" not in hist
    assert sharded["metrics"]["counters"]["placement.builds"] >= 2  # before and after the fold
    chaos = serve(DATASETS["tiny"], queries=32, topk=5, batch=8, device=CPU, mapping=tmap,
                  chaos=0.3, chaos_seed=1234, sharded=True)
    hits = chaos["chaos"]["counters"]["hits"]
    assert hits["placement.build"] >= 1 and hits["placement.refresh"] >= 1
    fired = chaos["chaos"]["fired"]
    degraded = {d["component"] for d in chaos["health"]["degraded"]}
    assert ("placement" in degraded) == bool(fired.get("placement.build")
                                             or fired.get("placement.refresh"))
