"""Port parity, the banded LSH prefilter: the band hash (``core.packed``,
``hopper.ops``, ``hopper.ref``), ``BandPolicy`` / ``BandIndex``
(``engine.banding``), ``QueryPlanner.candidate_bucket`` and the engine's
prefiltered queries, against ``repro`` on the clustered fixture of
``tests/test_banding.py`` with the JAX package's Ψ table.

Band keys and bucket indexes are integers and must be bit-equal, against the
JAX package's jnp, numpy and Pallas (interpret mode) versions alike.
Prefiltered queries are held to the JAX ``oracle`` engine on the same
history: the same candidate rows per segment, the same
``last_prefilter_stats``, ids equal up to score ties and scores at rtol 2e-3
/ atol 1e-3 (the port's plain scoring against the JAX oracle's eager float32
``log``, as in ``tests/test_torch_segments.py``). Inside the port, a
prefiltered id scores exactly as in the exhaustive scan (rtol 1e-6), and the
escape hatch, unindexed segments and the head give the exhaustive result.
The JAX side sees few distinct shapes: it compiles every eager operation
anew per shape, seconds apiece on a CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import make_mapping as j_make_mapping
from repro.core import packed as jpk
from repro.engine import BandIndex as JBandIndex
from repro.engine import BandPolicy as JBandPolicy
from repro.engine import DistillPolicy as JDistillPolicy
from repro.engine import QueryPlanner as JPlanner
from repro.engine import SketchEngine as JEngine
from repro.engine.testing import assert_topk_equivalent, topk_truth
from repro.kernels import ops as jops
from repro_torch.convert import (
    config_from_reference,
    mapping_from_reference,
    packed_from_reference,
    segmented_store_from_reference,
)
from repro_torch.core import packed as tpk
from repro_torch.data.synthetic import DATASETS
from repro_torch.engine import (
    BandIndex,
    BandPolicy,
    DistillPolicy,
    QueryPlanner,
    SegmentedStore,
    SketchEngine,
    get_backend,
)
from repro_torch.hopper import ops, ref

from test_torch_distill import mixed_truth

CPU = "cpu"
TOL = {"rtol": 2e-3, "atol": 1e-3}
D, NNZ, N_BINS = 2048, 32, 256


def _words(rng, n, w):
    x = rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32)
    x[0] = 0xFFFFFFFF  # the top bit set in every word: h * PRIME passes 2^63
    return x


# ------------------------------------------------------------- band hash
@pytest.mark.parametrize("n,w,n_bands", [(5, 14, 4), (3, 1, 8), (7, 32, 32), (9, 13, 5),
                                         (1, 7, 3), (2, 64, 3), (1, 1, 1), (4, 184, 8)])
def test_band_hash_bit_equal(n, w, n_bands):
    """Port torch and numpy, the wrapper's plain version and the backends ==
    the JAX jnp oracle, its numpy twin and its Pallas kernel (interpret):
    W not a multiple of the bands, the clamp (n_bands > W), B = 1, W = 1."""
    x = _words(np.random.default_rng(w), n, w)
    want = jpk.band_hash_host(x, n_bands)
    np.testing.assert_array_equal(np.asarray(jpk.band_hash(jnp.asarray(x), n_bands)), want)
    np.testing.assert_array_equal(
        np.asarray(jops.band_hash(jnp.asarray(x), n_bands, interpret=True)), want)
    words = torch.from_numpy(x.view(np.int32).copy())
    nb_eff, wpb = tpk.band_shape(w, n_bands)
    assert want.shape == (n, nb_eff) and nb_eff * wpb >= w > (nb_eff - 1) * wpb
    for got in (tpk.band_hash(words, n_bands), ops.band_hash(words, n_bands),
                ref.band_hash_ref(words, n_bands),
                get_backend("reference").band_hash(words, n_bands),
                get_backend("cuda").band_hash(words, n_bands)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for host in (tpk.band_hash_host(x, n_bands), tpk.band_hash_host(x.view(np.int32), n_bands)):
        assert host.dtype == np.uint32
        np.testing.assert_array_equal(host, want)


def test_band_hash_contract():
    """Non-int32 words raise; an empty batch gives (0, nb_eff); one flipped
    bit changes exactly its band's key."""
    with pytest.raises(TypeError):
        ops.band_hash(torch.zeros((2, 4), dtype=torch.int64), 2)
    assert ops.band_hash(torch.zeros((0, 13), dtype=torch.int32), 5).shape == (0, 5)
    x = _words(np.random.default_rng(1), 2, 16)
    x[1] = x[0]
    x[1, 5] ^= np.uint32(1)  # band 2 of 8 (words 4-5)
    k = tpk.band_hash(torch.from_numpy(x.view(np.int32)), 8).numpy()
    assert (k[0] == k[1]).tolist() == [True, True, False, True, True, True, True, True]


# ------------------------------------------------------------- BandIndex
@pytest.mark.parametrize("n_rows,n_bands,n_keys", [(50, 3, 4), (300, 8, 1 << 32), (1, 1, 2)])
def test_band_index_matches_reference(n_rows, n_bands, n_keys):
    """Buckets, CSR offsets, stats and candidate unions equal the JAX index on
    the same keys; keys given as int32 bits read as uint32."""
    rng = np.random.default_rng(n_rows)
    keys = rng.integers(0, n_keys, (n_rows, n_bands), dtype=np.uint64).astype(np.uint32)
    want, got = JBandIndex.build(keys), BandIndex.build(keys.view(np.int32))
    assert (got.n_rows, got.n_bands) == (want.n_rows, want.n_bands)
    np.testing.assert_array_equal(got.orders, want.orders)
    for t in range(n_bands):
        np.testing.assert_array_equal(got.uniq[t], want.uniq[t])
        np.testing.assert_array_equal(got.starts[t], want.starts[t])
    assert got.stats() == want.stats()
    qk = np.concatenate([keys[rng.integers(0, n_rows, 3)],
                         rng.integers(0, n_keys + 1, (3, n_bands), dtype=np.uint64)
                         .astype(np.uint32)])
    cand = got.candidates(qk)
    assert cand.dtype == np.int64 and (np.diff(cand) > 0).all()
    np.testing.assert_array_equal(cand, want.candidates(qk))
    np.testing.assert_array_equal(got.candidates(qk.view(np.int32)), cand)
    words = _words(rng, n_rows, 2 * n_bands + 1)
    np.testing.assert_array_equal(BandIndex.build_from_packed(words, n_bands).orders,
                                  JBandIndex.build_from_packed(words, n_bands).orders)
    with pytest.raises(ValueError, match="qkeys"):
        got.candidates(np.zeros((2, n_bands + 1), np.uint32))


def test_band_policy_and_candidate_bucket_match_reference():
    for kw in ({"n_bands": 0}, {"max_candidate_frac": 0.0}, {"max_candidate_frac": 1.5},
               {"min_rows": -1}):
        with pytest.raises(ValueError):
            BandPolicy(**kw)
        with pytest.raises(ValueError):
            JBandPolicy(**kw)
    pol, jpol = (BandPolicy(n_bands=6, max_candidate_frac=0.3, min_rows=100),
                 JBandPolicy(n_bands=6, max_candidate_frac=0.3, min_rows=100))
    assert pol.to_aux() == jpol.to_aux()
    assert BandPolicy.from_aux(jpol.to_aux()) == pol and BandPolicy.from_aux(None) is None
    assert BandPolicy() == BandPolicy.from_aux(JBandPolicy().to_aux())
    assert pol.wants_index(100) and not pol.wants_index(99)
    p, jp = QueryPlanner(), JPlanner()
    for n in (0, 1, 3, 63, 64, 65, 500, 5000, 9000, 10000, 20000):
        for cap in (0, 1, 10, 64, 100, 10000):
            assert p.candidate_bucket(n, cap) == jp.candidate_bucket(n, cap), (n, cap)


# ------------------------------------------------------------ the engines
def _clustered(rng, n_docs, cluster):
    """Near-duplicate clusters (``tests/test_banding.py``'s generator)."""
    base = rng.integers(0, D, size=(max(n_docs // cluster, 1), NNZ), dtype=np.int32)
    docs = base[np.arange(n_docs) % len(base)].copy()
    docs[np.arange(n_docs), rng.integers(0, NNZ, n_docs)] = rng.integers(0, D, n_docs)
    return np.sort(docs, axis=1)


class Banded:
    """A JAX ``oracle`` engine and port engines (``reference`` and ``cuda``,
    the latter running its plain versions here) over one clustered history:
    ``n_docs`` docs sealed into ``segments`` segments, 12 near-duplicate
    queries of known docs (``pick``)."""

    def __init__(self, policy=(8, 0.5, 8), n_docs=240, segments=3, ttl=None):
        rng = np.random.default_rng(0)
        jcfg = JCfg(d=D, n_bins=N_BINS)
        jmap = j_make_mapping(jcfg, jax.random.PRNGKey(3))
        tcfg = config_from_reference(D, N_BINS)
        tmap = mapping_from_reference(np.asarray(jmap), tcfg, CPU)
        kw = {"mutable": True, "ttl": ttl}
        self.j = JEngine.build(jcfg, jmap, backend="oracle", band_policy=JBandPolicy(*policy),
                               planner=JPlanner(min_batch=8, max_batch=16), **kw)
        self.t = {name: SketchEngine.build(tcfg, tmap, backend=name,
                                           band_policy=BandPolicy(*policy),
                                           planner=QueryPlanner(min_batch=8, max_batch=16),
                                           **kw)
                  for name in ("reference", "cuda")}
        self.docs = _clustered(rng, n_docs, 8)
        per = -(-n_docs // segments)
        for i, s in enumerate(range(0, n_docs, per)):
            self("add", self.docs[s : s + per], now=float(10 * i))
            self("seal")
        self.pick = rng.choice(n_docs, 12, replace=False)
        q = self.docs[self.pick].copy()
        q[np.arange(12), rng.integers(0, NNZ, 12)] = rng.integers(0, D, 12)
        self.q = np.sort(q, axis=1)

    def engines(self):
        return [self.j, *self.t.values()]

    def __call__(self, verb, *args, **kw):
        for eng in self.engines():
            getattr(eng, verb)(*(jnp.asarray(a) if eng is self.j and isinstance(a, np.ndarray)
                                 else a for a in args), **kw)

    def query(self, k=10, **kw):
        """(JAX result, {port backend: result}) of one query batch."""
        want = tuple(map(np.asarray, self.j.query(jnp.asarray(self.q), k, **kw)))
        return want, {n: tuple(x.numpy() for x in e.query(self.q, k, **kw))
                      for n, e in self.t.items()}


def assert_same_indexes(jstore, tstore):
    """Every sealed segment carries the same bucket index, or none on both."""
    assert len(jstore.sealed) == len(tstore.sealed)
    for js, ts in zip(jstore.sealed, tstore.sealed):
        assert (js.band_index is None) == (ts.band_index is None)
        if ts.band_index is not None:
            np.testing.assert_array_equal(ts.band_index.orders, js.band_index.orders)
            assert ts.band_index.stats() == js.band_index.stats()


def assert_same_candidates(b: Banded, now=None):
    """Query band keys and live candidate rows per indexed segment equal the
    JAX engine's, hatch decisions included."""
    jq = b.j._padded_query_sketches(jnp.asarray(b.q), 16)
    for eng in b.t.values():
        tq = eng._padded_query_sketches(torch.from_numpy(b.q), 16)
        for js, ts in zip(b.j.store.sealed, eng.store.sealed):
            if ts.band_index is None:
                continue
            nb = ts.n_bins or N_BINS
            jk = b.j._query_band_keys(jq, nb, len(b.q), {}, {})
            tk = eng._query_band_keys(tq, nb, len(b.q), {}, {})
            np.testing.assert_array_equal(tk, jk)
            jc = b.j._segment_candidates(js, jk, now)
            tc = eng._segment_candidates(ts, tk, now)
            assert (jc is None) == (tc is None)
            if tc is not None:
                np.testing.assert_array_equal(tc, jc)


def assert_prefilter_matches(b: Banded, k=10, truth_fn=topk_truth, now=None):
    """Prefiltered results equal the JAX engine's (ties aside), with the same
    stats; each surviving id scores as in the port's exhaustive scan."""
    want, got = b.query(k, prefilter=True, now=now)
    for name, eng in b.t.items():
        truth = truth_fn(eng, b.q) if now is None else mixed_truth(eng, b.q, now)
        assert_topk_equivalent(got[name], want, truth, err_msg=name, **TOL)
        assert eng.last_prefilter_stats == b.j.last_prefilter_stats, name
        sc, ix = got[name]
        for r in range(len(b.q)):
            for s, i in zip(sc[r], ix[r]):
                if i >= 0:
                    assert abs(truth[r][int(i)] - float(s)) <= 1e-6 * max(abs(s), 1.0)
    return got


@pytest.fixture(scope="module")
def banded():
    return Banded()


def test_prefilter_matches_reference(banded):
    """Three indexed segments: the same indexes, query keys and candidate
    rows as the JAX engine, the same results and stats, candidates a strict
    subset, and every planted near-duplicate found."""
    b = banded
    for eng in b.t.values():
        assert_same_indexes(b.j.store, eng.store)
    assert_same_candidates(b)
    got = assert_prefilter_matches(b)
    stats = b.j.last_prefilter_stats
    assert stats["banded_segments"] > 0 and stats["cand_rows"] < stats["seg_rows"]
    for _, ix in got.values():
        for r, p in enumerate(b.pick):
            assert int(p) in set(ix[r].tolist())


def test_prefilter_auto_enable_opt_out_and_build_checks(banded):
    """``prefilter=None`` turns on with a policy; ``False`` is the exhaustive
    scan and leaves the stats alone; ``True`` without a policy and a policy on
    an append-only build raise as the JAX engine does."""
    b = banded
    eng = b.t["reference"]
    eng.last_prefilter_stats = None
    auto = eng.query(b.q, 5)
    assert eng.last_prefilter_stats is not None
    on = eng.query(b.q, 5, prefilter=True)
    assert all(torch.equal(x, y) for x, y in zip(auto, on))
    eng.last_prefilter_stats = None
    eng.query(b.q, 5, prefilter=False)
    assert eng.last_prefilter_stats is None
    plain = SketchEngine.build(eng.cfg, eng.store.mapping, backend="reference", mutable=True)
    plain.add(b.docs[:8])
    with pytest.raises(ValueError, match="band_policy"):
        plain.query(b.q, 3, prefilter=True)
    assert plain.query(b.q, 3, prefilter=False)[1].shape == (12, 3)
    with pytest.raises(ValueError, match="band_policy"):
        SketchEngine.build(eng.cfg, eng.store.mapping, backend="reference",
                           band_policy=BandPolicy())
    # the auto-seal builds an index too, through ops.band_hash
    store = SegmentedStore.create(eng.cfg, eng.store.mapping, seal_rows=16,
                                  band_policy=BandPolicy(min_rows=8))
    store.add(b.docs[:16])
    (seg,) = store.sealed
    np.testing.assert_array_equal(
        seg.band_index.orders,
        JBandIndex.build(jpk.band_hash_host(seg.sketches.numpy().view(np.uint32), 8)).orders)


def test_prefilter_escape_hatch_is_exhaustive_exact():
    """A candidate union above ``max_candidate_frac`` scans the segment in
    full: results bit-equal to ``prefilter=False`` and equal to the JAX
    engine's hatch, counted in ``exhaustive_segments``."""
    b = Banded(policy=(8, 1e-9, 8))
    assert_same_candidates(b)
    got = assert_prefilter_matches(b)
    for name, eng in b.t.items():
        sc, ix = eng.query(b.q, 10, prefilter=False)
        np.testing.assert_array_equal(got[name][1], ix.numpy())
        np.testing.assert_array_equal(got[name][0], sc.numpy())
        st = eng.last_prefilter_stats
        assert st["exhaustive_segments"] == 3 and st["cand_rows"] == st["seg_rows"]


def test_prefilter_unindexed_segments_and_head():
    """Segments under ``min_rows`` carry no index and the head is never
    banded: both scan in full, so results equal ``prefilter=False``; a
    head doc identical to query 0 wins its slot 0. (Batches of 80 rows: the
    shape the JAX side has compiled already.)"""
    b = Banded(policy=(8, 0.5, 10_000))
    head_id = b.t["reference"].store.next_id
    b("add", np.concatenate([b.q[:1], b.docs[1:80]]))
    got = assert_prefilter_matches(b)
    for name, eng in b.t.items():
        assert all(s.band_index is None for s in eng.store.sealed)
        st = eng.last_prefilter_stats
        assert st["unindexed_segments"] == 3 and st["banded_segments"] == 0
        np.testing.assert_array_equal(got[name][1], eng.query(b.q, 10, prefilter=False)[1])
        assert got[name][1][0, 0] == head_id


def test_lifecycle_never_resurrects_tombstones():
    """seal -> delete -> compact -> distill, held to the JAX engine at every
    step: stale buckets never return a dead id,
    compaction and distillation build fresh indexes (the distilled one from
    the folded words), and the live near-duplicates keep being found."""
    b = Banded(n_docs=160, segments=2)
    dead = [int(p) for p in b.pick[:4]]
    b("delete", dead)
    for step in ("deleted", "compacted", "distilled"):
        if step == "compacted":
            b("compact")
        elif step == "distilled":
            b.j.distill(JDistillPolicy(widths=(128,)), background=False)
            for eng in b.t.values():
                eng.distill(DistillPolicy(widths=(128,)))
            assert all(s.n_bins == 128 for s in b.t["reference"].store.sealed)
        for eng in b.t.values():
            assert_same_indexes(b.j.store, eng.store)
        assert_same_candidates(b)
        got = assert_prefilter_matches(b, truth_fn=mixed_truth)
        for name, (_, ix) in got.items():
            assert not np.isin(ix, dead).any(), (step, name)
            if step != "distilled":
                for r in range(4, len(b.pick)):
                    assert int(b.pick[r]) in set(ix[r].tolist()), (step, name)
    seg = b.t["reference"].store.sealed[0]
    np.testing.assert_array_equal(
        seg.band_index.orders,
        BandIndex.build(tpk.band_hash_host(seg.sketches.numpy(), 8)).orders)


def test_prefilter_ttl_expiry():
    """Rows past the TTL at the query's ``now`` sit in their buckets and are
    dropped from the candidates, as the JAX engine drops them."""
    b = Banded(n_docs=160, segments=2, ttl=15.0)  # segment 0 born at 0, segment 1 at 10
    now = 18.0
    assert_same_candidates(b, now=now)
    got = assert_prefilter_matches(b, now=now)
    first = b.t["reference"].store.sealed[0].ids
    for _, ix in got.values():
        assert not np.isin(ix, first).any()


def test_seal_sketches_builds_the_index():
    """Bulk ingest into a sealed segment (no counting head) indexes the slab
    through the backend's band hash, as the JAX store's ``seal_sketches``."""
    b = Banded(n_docs=80, segments=1)
    docs = _clustered(np.random.default_rng(5), 80, 8)
    jsk = b.j.backend.sketch(b.j.cfg, b.j.store.mapping, jnp.asarray(docs))
    jids = b.j.store.seal_sketches(jsk, backend=b.j.backend)
    for eng in b.t.values():
        sk = packed_from_reference(np.asarray(jsk), CPU)
        assert list(eng.store.seal_sketches(sk, backend=eng.backend)) == list(jids)
        seg = eng.store.sealed[-1]
        np.testing.assert_array_equal(seg.fills.numpy(), np.asarray(b.j.store.sealed[-1].fills))
        assert_same_indexes(b.j.store, eng.store)
    assert_prefilter_matches(b)
    with pytest.raises(ValueError, match="width"):
        b.t["reference"].store.seal_sketches(torch.zeros((4, N_BINS // 32 + 1),
                                                         dtype=torch.int32))


def test_convert_carries_band_policy():
    """A JAX store with a band policy, carried over through its checkpoint
    tree: the policy crosses and every index is rebuilt from its slab, equal
    to the JAX store's; prefiltered answers equal the JAX engine's."""
    b = Banded(n_docs=160, segments=2)
    b("delete", [int(b.pick[0])])
    tree, aux = b.j.store.checkpoint_tree()
    tree = {"mapping": np.asarray(tree["mapping"]),
            "head": {k: np.asarray(v) for k, v in tree["head"].items()},
            "sealed": [{k: np.asarray(v) for k, v in s.items()} for s in tree["sealed"]]}
    back = segmented_store_from_reference(tree, aux, CPU)
    assert back.band_policy == BandPolicy(8, 0.5, 8)
    assert_same_indexes(b.j.store, back)
    b.t = {"reference": SketchEngine(back, get_backend("reference"),
                                     planner=QueryPlanner(min_batch=8, max_batch=16))}
    assert_same_candidates(b)
    assert_prefilter_matches(b)


def test_serve_prefilter_arm():
    """``serve(prefilter=True)`` on ``tiny``: the mutable store with a band
    policy; its 256-row segment is indexed, random docs give too large a
    candidate union, so the hatch fires and recall equals the exhaustive
    run's."""
    from repro_torch.launch.serve import serve

    out = serve(DATASETS["tiny"], queries=16, batch=16, topk=5, device=CPU, prefilter=True,
                bands=8)
    eng = out["engine"]
    assert eng.store.band_policy == BandPolicy(n_bands=8, min_rows=256)
    assert [s.band_index is not None for s in eng.store.sealed] == [True]
    st = out["prefilter_stats"]
    assert st["exhaustive_segments"] == 1 and st["cand_rows"] == st["seg_rows"] == 256
    ids = eng.query(out["queries"], 5, prefilter=False)[1].numpy()
    np.testing.assert_array_equal(out["ids"], ids)
    assert (out["query_ids"] == out["surv_ids"][np.searchsorted(out["surv_ids"],
                                                                 out["query_ids"])]).all()
