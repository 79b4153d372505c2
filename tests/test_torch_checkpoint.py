"""Port parity, checkpoints: ``repro_torch.checkpoint.manager`` and
``SegmentedStore.save`` / ``restore`` against ``repro.checkpoint`` and the
JAX store, on the reference's on-disk layout.

Ported cases: the five of ``tests/test_checkpoint.py`` that need no mesh
(round trip with a bfloat16 leaf, async save and LATEST, retention, stray
tmp directories, tree mismatch; the elastic-mesh case waits for the port's
multi-device item), and the six checkpoint cases of ``tests/test_faults.py``
(aux serializability, torn leaf walk-back, vanished LATEST directory, a
store restore pinned to the verified step, a supervised async save retrying
a write fault, an unsupervised one re-raising). Then the layout itself: the
port's flattening keys leaves as ``jax.tree_util.keystr`` does, a store
saved by either package restores in the other to the same state (counters
as u16 bits, words as uint32), and the two packages write the same store
byte for byte. The JAX side is fed batches of 8 rows, as in
``tests/test_torch_segments.py``.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.engine import BandPolicy as JBandPolicy
from repro.engine import DistillPolicy as JDistillPolicy
from repro.engine import SegmentedStore as JStore
from repro.engine import SketchEngine as JEngine
from repro_torch import faults
from repro_torch.checkpoint.manager import (BackgroundJob, CheckpointCorruptError,
                                            CheckpointManager, flatten)
from repro_torch.convert import segmented_store_from_reference
from repro_torch.engine import (BandPolicy, JobSupervisor, SegmentedStore, SketchEngine,
                                SupervisionPolicy)
from repro_torch.obs.clock import ManualClock

from test_torch_distill import assert_mixed_equal
from test_torch_segments import assert_same_state, tiny  # noqa: F401

CPU = "cpu"
FAST = SupervisionPolicy(max_retries=1, backoff_base=0.0, backoff_cap=0.0)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.clear()


@pytest.fixture
def tree():
    g0, g1 = np.random.default_rng(0), np.random.default_rng(1)
    return {"w": torch.from_numpy(g0.normal(size=(16, 8)).astype(np.float32)),
            "b16": torch.from_numpy(g1.normal(size=(4,)).astype(np.float32)).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}


def _small(val=1.0):
    return {"a": torch.full((1024,), val), "b": torch.arange(256, dtype=torch.int32)}


# ------------------------------------------------- tests/test_checkpoint.py
def test_roundtrip_and_aux(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(3, tree, aux={"note": "x"}, blocking=True)
    restored, aux = mgr.restore(None, tree)
    assert aux["note"] == "x"
    for k in tree:
        assert torch.equal(restored[k].float(), tree[k].float())
    assert restored["b16"].dtype == torch.bfloat16


def test_async_save_and_latest(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree, blocking=False)
    mgr.save(5, tree, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_retention_gc(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_atomicity_tmp_dirs_ignored(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, tree, blocking=True)
    os.makedirs(tmp_path / ".tmp-000000000009")  # a crash mid-save
    assert mgr.latest_step() == 2
    with open(tmp_path / "LATEST", "w") as f:
        f.write("99")  # the manifest ahead of a vanished directory
    assert mgr.latest_step() == 2
    restored, _ = mgr.restore(None, tree)
    assert torch.equal(restored["w"], tree["w"])


def test_tree_mismatch_rejected(tmp_path, tree):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree, blocking=True)
    bad = dict(tree)
    bad["extra"] = torch.zeros((2,))
    with pytest.raises(ValueError, match="mismatch"):
        mgr.restore(None, bad)


# -------------------------------------------- checkpoint cases of test_faults
def test_aux_serializability_fails_fast_on_caller_thread(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError, match="JSON-serializable"):
        m.save(1, _small(), aux={"bad": object()}, blocking=False)
    assert m._pending is None


def test_torn_leaf_walks_back_one_generation(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _small(1.0), aux={"gen": 1})
    with faults.scoped(faults.FaultPlan(
            {"checkpoint.leaf": faults.FaultSpec("torn-write", times=1)}, seed=3)) as plan:
        m.save(2, _small(2.0), aux={"gen": 2})
    assert plan.counters()["fired"]["checkpoint.leaf"] == 1
    assert not m.verify_step(2) and m.verify_step(1)
    assert m.resolve_step(None) == 1
    got, aux = m.restore(None, _small(0.0))
    assert aux["gen"] == 1 and torch.equal(got["a"], torch.full((1024,), 1.0))
    with pytest.raises(CheckpointCorruptError, match="leaf"):
        m.restore(2, _small(0.0))


def test_vanished_latest_dir_walks_back_to_verifying(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=5)
    m.save(1, _small(1.0), aux={"gen": 1})
    with faults.scoped(faults.FaultPlan(
            {"checkpoint.leaf": faults.FaultSpec("torn-write", times=1)})):
        m.save(2, _small(2.0), aux={"gen": 2})
    m.save(3, _small(3.0), aux={"gen": 3})
    shutil.rmtree(os.path.join(str(tmp_path), "step_%012d" % 3))
    assert m.latest_step() == 1  # LATEST -> 3 (gone), 2 torn: back to 1
    assert m.load_aux(m.resolve_step(None))["gen"] == 1


def test_store_restore_pins_verified_step(tiny, tmp_path):
    """A store round trip through a torn newest checkpoint: aux and arrays
    both come from the older generation that verifies."""
    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, seal_rows=24)
    eng.add(idx[:48])
    m = CheckpointManager(str(tmp_path))
    eng.store.save(m, step=1)
    eng.add(idx[48:72])  # diverge, then tear the newer save
    with faults.scoped(faults.FaultPlan(
            {"checkpoint.leaf": faults.FaultSpec("torn-write", times=1)})):
        eng.store.save(m, step=2)
    back = SegmentedStore.restore(m, device=CPU)
    assert back.size == 48
    q = idx[100:106]
    ref = SketchEngine.build(tcfg, tmap, idx[:48], backend="reference")
    got, want = SketchEngine(back, ref.backend).query(q, 5), ref.query(q, 5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_supervised_async_save_retries_transient_write_fault(tmp_path):
    sup = JobSupervisor(FAST, clock=ManualClock())
    m = CheckpointManager(str(tmp_path), supervisor=sup)
    with faults.scoped(faults.FaultPlan(
            {"checkpoint.write": faults.FaultSpec("raise", times=1)})):
        m.save(5, _small(5.0), aux={"gen": 5}, blocking=False)
        m.wait()  # never raises under supervision
    assert m.latest_step() == 5
    h = sup.health()
    assert h["jobs"]["checkpoint"]["retries"] == 1
    assert h["jobs"]["checkpoint"]["succeeded"] == 1


def test_unsupervised_async_save_still_raises(tmp_path):
    m = CheckpointManager(str(tmp_path))
    with faults.scoped(faults.FaultPlan({"checkpoint.write": faults.FaultSpec("raise")})):
        m.save(1, _small(), blocking=False)
        with pytest.raises(faults.FaultError):
            m.wait()


def test_background_job_handoff():
    job = BackgroundJob(lambda: 41 + 1)
    assert job.result() == 42 and job.done() and job.error is None

    def fail():
        raise ValueError("worker failed")

    bad = BackgroundJob(fail)
    with pytest.raises(ValueError, match="worker failed"):
        bad.result()


# ------------------------------------------------------ the reference layout
@pytest.fixture(scope="module")
def twin_stores(tiny):
    """One history on both packages: two sealed segments (one distilled to
    N // 2, with tombstones), a base-width head with a relocated doc; band
    indexes on. Returns (jax store, port store converted from it)."""
    jcfg, jmap, _, _, idx = tiny
    jeng = JEngine.build(jcfg, jmap, backend="oracle", mutable=True,
                         band_policy=JBandPolicy(n_bands=4, min_rows=8))
    for s in range(0, 48, 8):
        jeng.add(idx[s : s + 8], now=float(s))
        if s in (16, 40):
            jeng.seal()
    jeng.delete([3, 30])
    assert jeng.store.distill_async(JDistillPolicy(widths=(jcfg.n_bins // 2,)), only=[0])
    jeng.store.wait_compaction()
    for s in range(48, 64, 8):
        jeng.add(idx[s : s + 8], now=float(s))
    jeng.update([40], idx[200:201], now=70.0)  # a sealed doc relocates into the head
    jstore = jeng.store
    tree, aux = jstore.checkpoint_tree()
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return jstore, segmented_store_from_reference(tree, aux, device=CPU)


def test_flatten_keys_match_jax_keystr(twin_stores):
    jstore, tstore = twin_stores
    jtree, _ = jstore.checkpoint_tree()
    jflat, _ = jax.tree_util.tree_flatten_with_path(jtree)
    ttree, _ = tstore.checkpoint_tree()
    assert [k for k, _ in flatten(ttree)] == [jax.tree_util.keystr(k) for k, _ in jflat]
    assert "['head']['counters']" in dict(flatten(ttree))
    assert "['sealed'][0]['fills']" in dict(flatten(ttree))


def test_both_packages_write_the_same_bytes(twin_stores, tmp_path):
    """The same store saved by each package: every file of the generation,
    manifest, aux and each leaf, byte for byte."""
    jstore, tstore = twin_stores
    jstore.save(JManager(str(tmp_path / "jax")), step=7)
    tstore.save(CheckpointManager(str(tmp_path / "port")), step=7)
    jdir, tdir = tmp_path / "jax" / ("step_%012d" % 7), tmp_path / "port" / ("step_%012d" % 7)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and "tree.json" in names and "aux.json" in names
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    assert (tmp_path / "jax" / "LATEST").read_text() == (tmp_path / "port" / "LATEST").read_text()


def test_reference_save_restores_in_the_port(twin_stores, tmp_path):
    """A store saved by the JAX ``SegmentedStore.save`` restores through the
    port's manager to the state ``convert.segmented_store_from_reference``
    gives, and to the JAX store's own state."""
    jstore, converted = twin_stores
    jstore.save(JManager(str(tmp_path)), step=3)
    back = SegmentedStore.restore(CheckpointManager(str(tmp_path)), device=CPU)
    assert_same_state(jstore, back)
    assert_same_state(jstore, converted)
    for a, b in zip(back.sealed, converted.sealed):
        assert a.band_index.stats() == b.band_index.stats()
    assert back.band_policy == converted.band_policy == BandPolicy(n_bands=4, min_rows=8)


def test_port_save_restores_in_the_reference(twin_stores, tiny, tmp_path):
    """A port save restores through the JAX manager to the port store's state,
    and the two stores answer alike (tie-aware, at the backend pair's
    tolerance)."""
    _, tstore = twin_stores
    tstore.save(CheckpointManager(str(tmp_path)), step=4)
    jback = JStore.restore(JManager(str(tmp_path)))
    assert_same_state(jback, tstore)
    q = tiny[4][100:108]
    jeng = JEngine(jback, JEngine.build(tiny[0], tiny[1], backend="oracle").backend)
    teng = SketchEngine(tstore, SketchEngine.build(tstore.cfg, tstore.mapping,
                                                   backend="reference").backend)
    assert_mixed_equal(jeng, teng, q)
