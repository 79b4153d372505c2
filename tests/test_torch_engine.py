"""Port parity, the whole slice: store, backends, ``SketchEngine.query`` /
``score_all``, exact ground truth and the serve driver, on the ``tiny``
corpus with the JAX package's own Ψ table carried across.

The port's ``cuda`` backend runs its plain versions here (CPU tensors) and is
held to the JAX ``pallas`` backend in interpret mode at rtol 1e-5 / atol 1e-6
(the same fused epilogue); the port's ``reference`` backend to the JAX
``oracle`` at the oracle tolerance of ``tests/test_kernels.py`` (rtol 2e-3,
atol 1e-3): the two evaluate one formula, but PyTorch's float32 ``log`` and
XLA's differ in the last ulp on ~1% of arguments, and the IP cancellation
magnifies that. Top-k ids go through the tie-aware
``assert_topk_equivalent``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BinSketchConfig as JCfg
from repro.core import make_mapping as j_make_mapping
from repro.data.synthetic import DATASETS as JDATASETS
from repro.data.synthetic import generate_corpus as j_generate_corpus
from repro.engine import QueryPlanner as JPlanner
from repro.engine import SketchEngine as JEngine
from repro.engine import SketchStore as JStore
from repro.engine import get_backend as j_get_backend
from repro.engine import merge_segment_topk as j_merge
from repro.engine.testing import assert_topk_equivalent, topk_truth
from repro.obs.probe import exact_topk as j_exact_topk
from repro_torch.convert import (
    config_from_reference,
    mapping_from_reference,
    packed_to_reference,
    store_from_reference,
)
from repro_torch.data.synthetic import DATASETS
from repro_torch.engine import (
    QueryPlanner,
    SketchEngine,
    SketchStore,
    available_backends,
    get_backend,
    merge_segment_topk,
)
from repro_torch.obs.probe import exact_topk

MEASURES = ["jaccard", "ip", "cosine", "hamming"]
CPU = "cpu"


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax mapping, port cfg, port mapping, corpus idx)."""
    idx, lens = j_generate_corpus(JDATASETS["tiny"], seed=0)
    jcfg = JCfg.from_sparsity(JDATASETS["tiny"].d, int(lens.max()), 0.05)
    jmap = j_make_mapping(jcfg, jax.random.PRNGKey(0))
    tcfg = config_from_reference(jcfg.d, jcfg.n_bins, jcfg.mode)
    return jcfg, jmap, tcfg, mapping_from_reference(np.asarray(jmap), tcfg, CPU), idx


def _queries(idx, n, seed=1):
    return idx[np.random.default_rng(seed).choice(len(idx), n, replace=False)]


def _np(pair):
    return np.asarray(pair[0]), np.asarray(pair[1])


# ------------------------------------------------------------------- store
def test_store_matches_reference_store(tiny):
    """Streaming ingest across capacity doublings == the JAX store, words and
    fill cache bit-equal; the converted JAX store equals the port's."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    jstore = JStore.from_indices(jcfg, jmap, jnp.asarray(idx))
    inc = SketchStore.create(tcfg, tmap, capacity=4)
    for lo, hi in [(0, 3), (3, 40), (40, 41), (41, 200), (200, len(idx))]:
        inc.add(idx[lo:hi], backend=get_backend("cuda"))
    assert inc.size == len(idx) and inc.capacity >= inc.size
    np.testing.assert_array_equal(packed_to_reference(inc.sketches), np.asarray(jstore.sketches))
    np.testing.assert_array_equal(inc.fills.numpy(), np.asarray(jstore.fills))
    conv = store_from_reference(tcfg, tmap, np.asarray(jstore.sketches),
                                np.asarray(jstore.fills), CPU)
    assert torch.equal(conv.sketches, inc.sketches) and torch.equal(conv.fills, inc.fills)
    again = SketchStore.from_sketches(tcfg, tmap, inc.sketches.clone())
    assert torch.equal(again.fills, inc.fills)
    assert [v.ids for v in inc.segment_views(now=None)] == [None]
    assert SketchStore.create(tcfg, tmap).segment_views(now=None) == []


def test_backend_registry():
    assert available_backends() == ["auto", "cuda", "reference"]
    assert get_backend().name == "cuda" and get_backend("reference").name == "reference"
    with pytest.raises(ValueError):
        get_backend("pallas")


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("measure", MEASURES)
def test_engine_cuda_backend_matches_pallas_engine(tiny, measure):
    """query (ragged batches, k > C tail included) and score_all of the port's
    kernel backend against the JAX engine on its Pallas kernels."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    corpus, q = idx[:200], _queries(idx, 13)
    jeng = JEngine.build(jcfg, jmap, jnp.asarray(corpus), backend="pallas-interpret",
                         measure=measure, planner=JPlanner(8, 8))
    teng = SketchEngine.build(tcfg, tmap, corpus, backend="cuda", measure=measure,
                              planner=QueryPlanner(8, 8))
    truth = topk_truth(jeng, jnp.asarray(q))
    s_t = teng.score_all(q).numpy()
    np.testing.assert_allclose(s_t, np.asarray(jeng.score_all(jnp.asarray(q))),
                               rtol=1e-5, atol=1e-6)
    for k in (5, 203):
        got = teng.query(q, k)
        assert got[0].shape == (13, k) and got[1].dtype == torch.int32
        assert_topk_equivalent(_np(got), jeng.query(jnp.asarray(q), k), truth,
                               err_msg=f"{measure} k={k}")
    assert (got[1].numpy()[:, 200:] == -1).all()


@pytest.mark.parametrize("measure", MEASURES)
def test_engine_reference_backend_matches_oracle_engine(tiny, measure):
    """The plain-PyTorch backend against the JAX oracle, the chunked top-k
    merge forced (chunk far below C), 13 queries padded to a 16-row chunk."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    q = _queries(idx, 13, seed=2)
    jeng = JEngine.build(jcfg, jmap, jnp.asarray(idx), backend="oracle", measure=measure,
                         planner=JPlanner(8, 16))
    teng = SketchEngine.build(tcfg, tmap, idx, backend="reference", measure=measure,
                              planner=QueryPlanner(8, 16))
    teng.backend.topk_crossover = 0
    teng.backend.topk_chunk = 37
    truth = topk_truth(jeng, jnp.asarray(q))
    assert_topk_equivalent(_np(teng.query(q, 7)), jeng.query(jnp.asarray(q), 7), truth,
                           rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(teng.score_all(q).numpy(),
                               np.asarray(jeng.score_all(jnp.asarray(q))),
                               rtol=2e-3, atol=1e-3)


def test_engine_streaming_arm_matches_materialized(tiny):
    """The cuda backend's streaming arm (topk_crossover = 0) and its
    materialize arm agree exactly, and both agree with the JAX fused top-k."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    q = _queries(idx, 9, seed=3)
    teng = SketchEngine.build(tcfg, tmap, idx, backend="cuda")
    want = _np(teng.query(q, 10))
    teng.backend.topk_crossover = 0
    got = _np(teng.query(q, 10))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    jbe = j_get_backend("pallas-interpret")
    jbe.topk_crossover = 0
    jeng = JEngine.build(jcfg, jmap, jnp.asarray(idx), backend=jbe)
    assert_topk_equivalent(got, jeng.query(jnp.asarray(q), 10), topk_truth(jeng, jnp.asarray(q)))


def test_engine_empty_and_incremental(tiny):
    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="cuda", capacity=2)
    sc, ix = eng.query(idx[:3], 4)
    assert (sc == -np.inf).all() and (ix == -1).all()
    assert eng.score_all(idx[:3]).shape == (3, 0)
    assert list(eng.add(idx[:50])) == list(range(50))
    assert list(eng.add(idx[50:60])) == list(range(50, 60))
    sc, ix = eng.query(idx[:0], 4)
    assert sc.shape == ix.shape == (0, 4)
    _, ix = eng.query(idx[:60], 1)
    np.testing.assert_array_equal(ix.numpy()[:, 0], np.arange(60))  # each doc finds itself


def test_merge_segment_topk_matches_reference():
    rng = np.random.default_rng(4)
    parts_s, parts_i = [], []
    for lo in (0, 100, 50):  # interleaved id ranges, heavy score ties
        s = np.round(rng.random((6, 5)), 1).astype(np.float32)
        s[:, -1] = -np.inf
        i = (lo + rng.permutation(40)[:5]).astype(np.int32)[None, :].repeat(6, 0)
        i[:, -1] = -1
        parts_s.append(s)
        parts_i.append(i)
    got = merge_segment_topk([torch.from_numpy(s) for s in parts_s],
                             [torch.from_numpy(i) for i in parts_i], 12)
    want = j_merge([jnp.asarray(s) for s in parts_s], [jnp.asarray(i) for i in parts_i], 12)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ------------------------------------------------------- ground truth, serve
def test_exact_topk_same_positions(tiny):
    *_, idx = tiny
    q = np.concatenate([_queries(idx, 12, seed=5), np.full((1, idx.shape[1]), -1, np.int32)])
    np.testing.assert_array_equal(exact_topk(idx, q, 9, device=CPU), j_exact_topk(idx, q, 9))


def test_serve_recall_equals_reference_driver(tiny):
    """The port's driver on the JAX Ψ table gives the JAX driver's recall."""
    from repro.launch import serve as jserve
    from repro_torch.launch.serve import serve

    *_, tmap, _ = tiny
    want = jserve.main(["--dataset", "tiny", "--queries", "16", "--topk", "5"])
    out = serve(DATASETS["tiny"], queries=16, topk=5, batch=32, device=CPU, mapping=tmap)
    assert out["recall"] == want and out["recall"] > 0.3
    assert out["ids"].shape == (16, 5) and out["n_bins"] == tiny[2].n_bins
