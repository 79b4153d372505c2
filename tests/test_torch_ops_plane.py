"""Port parity, the operations plane: ``repro_torch.faults``,
``repro_torch.engine.supervision``, the store's background verbs and the
engine's degradation paths, held to what ``tests/test_faults.py`` asserts of
the reference, on the ``tiny`` corpus with the JAX package's Ψ table.

Ported cases of ``tests/test_faults.py`` (same names): plan validation, seed
determinism (also decision for decision against ``repro.faults``), ``times``
/ ``after`` counters, compaction failure never reaching queries, distillation
retry, quarantine and probe, the watchdog, band lookup and band build
degradation, the full chaos cycle, and faults as metric deltas (the registry
half; the trace half waits for the port's telemetry). Its checkpoint cases
are in ``tests/test_torch_checkpoint.py``, its first lifecycle-controller case
in ``tests/test_torch_lifecycle.py``. Not ported: the placement case (the
port has no placement yet); the hung-merge controller case is in
``tests/test_torch_lifecycle.py``.

Every supervisor runs on a ``ManualClock``: retries use a zero backoff and the
watchdog fires when the test advances the clock, so no case waits on real
time. Answers are held to a fresh append-only build over the survivors (ids
exact, scores allclose at rtol 1e-5 / atol 1e-6) or, for degraded paths, to
a clean ``prefilter=False`` run, exactly: the exhaustive scan against the
exhaustive scan (a clean banded run may return other, approximate ids).
"""

import ast
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro.analysis import ownership
from repro.analysis.rules import FileContext
from repro.analysis.rules.conventions import check_swallowed_exception
from repro_torch import faults
from repro_torch.core import BinSketchConfig
from repro_torch.engine import (BandPolicy, DistillPolicy, JobSupervisor, SketchEngine,
                                SupervisionPolicy)
from repro_torch.hopper.build import KernelError, is_device_fault
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.clock import ManualClock, SystemClock, ensure_clock

from test_torch_segments import assert_fresh_equal, tiny  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
CPU = "cpu"
# retries without waiting: a ManualClock never moves on its own
FAST = SupervisionPolicy(max_retries=1, backoff_base=0.0, backoff_cap=0.0)


@pytest.fixture(autouse=True)
def _disarm():
    """No test leaks an armed plan or registry into the next."""
    yield
    faults.clear()
    obs_metrics.clear()


def _engine(tiny, n=96, seal_rows=24, supervisor=None, band_policy=None):
    """A mutable port engine whose first ``n`` corpus rows are sealed into
    ``n // seal_rows`` segments (``tests/conftest.py::multi_segment_engine``)."""
    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True,
                             seal_rows=seal_rows, supervisor=supervisor,
                             band_policy=band_policy)
    for s in range(0, n, seal_rows):
        eng.add(idx[s : s + seal_rows])
    return eng


def _contents(idx, n, deleted=()):
    return {g: idx[g] for g in range(n) if g not in set(deleted)}


def _supervisor(policy=FAST):
    clock = ManualClock()
    return JobSupervisor(policy, clock=clock), clock


def join_attempt(job, timeout=30.0):
    """Join a supervised job's attempt in flight, if it runs on a thread, for
    at most ``timeout`` seconds: a loop that polls between joins then ends on
    the job's state, however loaded the host, never on a count of sleeps.
    ``job`` may also be the attempt itself (``job._job``, taken before an
    abandon drops the job's reference to it), to join a zombie."""
    attempt = getattr(job, "_job", job)  # either package's job, or an attempt
    thread = getattr(attempt, "_thread", None)
    if thread is not None:
        thread.join(timeout)
        what = getattr(job, "op", "an abandoned")
        assert not thread.is_alive(), f"{what} attempt still runs after {timeout} s"


# ------------------------------------------------------------- fault plans
def test_plan_rejects_unknown_point_and_bad_spec():
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.FaultPlan({"compact.wrok": faults.FaultSpec()})
    with pytest.raises(ValueError, match="mode"):
        faults.FaultSpec(mode="explode")
    assert faults.POINTS == jfaults.POINTS  # a reference plan validates here


def test_plan_decisions_are_seed_deterministic():
    """Same seed and hit sequence -> the same firing pattern, and the very
    pattern ``repro.faults`` draws: a plan means one schedule in both
    packages."""
    def mk(mod, seed):
        return mod.FaultPlan({"compact.work": mod.FaultSpec("raise", p=0.4),
                              "band.lookup": mod.FaultSpec("raise", p=0.7)}, seed=seed)

    def seq(plan):
        return [(p, plan.decide(p) is not None) for p in ["compact.work", "band.lookup"] * 40]

    a = seq(mk(faults, 7))
    assert a == seq(mk(faults, 7)) == seq(mk(jfaults, 7))
    assert any(f for _, f in a) and not all(f for _, f in a)
    assert seq(mk(faults, 8)) != a
    assert seq(mk(faults, 8)) == seq(mk(jfaults, 8))


def test_times_after_and_counters():
    plan = faults.FaultPlan({"compact.work": faults.FaultSpec("raise", times=2, after=1)})
    with faults.scoped(plan):
        faults.inject("compact.work")  # after=1: the first hit passes
        for _ in range(2):
            with pytest.raises(faults.FaultError):
                faults.inject("compact.work")
        faults.inject("compact.work")  # the times=2 budget is spent
    c = plan.counters()
    assert c["hits"]["compact.work"] == 4 and c["fired"]["compact.work"] == 2
    faults.inject("compact.work")  # disarmed: no-op, not even a hit
    assert plan.counters()["hits"]["compact.work"] == 4


def test_clock_and_metrics_basics():
    """The clock doubles and the registry the supervisor leans on: a
    ManualClock moves only when told, a bare callable is coerced, the system
    clock is monotonic; histogram quantiles stay within their relative
    error, and the disarmed helpers are no-ops."""
    c = ManualClock(5.0)
    assert c() == 5.0 and c.advance(2.5) == 7.5 and c.set(1.0) == 1.0 and c() == 1.0
    assert ensure_clock(lambda: 3.0)() == 3.0 and ensure_clock(c) is c
    s = ensure_clock(None)
    assert isinstance(s, SystemClock) and s() <= s()
    h = obs_metrics.Histogram(alpha=0.05)
    for v in range(1, 1001):
        h.observe(v / 1000.0)
    assert abs(h.quantile(0.5) - 0.5) <= 0.05 * 0.5 + 1e-3 and h.count == 1000
    obs_metrics.inc("x")  # disarmed
    reg = obs_metrics.install(obs_metrics.MetricsRegistry(clock=c))
    obs_metrics.inc("x", 2)
    obs_metrics.observe("y", 0.5)
    obs_metrics.set_gauge("z", 4.0)
    snap = reg.snapshot()
    assert snap["counters"] == {"x": 2} and snap["gauges"] == {"z": 4.0}
    assert snap["at"] == 1.0 and "repro_x 2" in reg.to_prometheus()


# --------------------------------------------------- supervised maintenance
def test_compaction_failure_never_reaches_queries(tiny):
    """A compaction that fails on every attempt leaves queries exception-free
    and equal to a fresh build over the survivors; the next compaction, with
    the faults gone, heals the store."""
    idx = tiny[4]
    sup, _ = _supervisor()
    eng = _engine(tiny, supervisor=sup)
    eng.delete([3, 30, 70])
    q = idx[100:108]
    with faults.scoped(faults.FaultPlan({"compact.work": faults.FaultSpec("raise")})):
        assert eng.store.compact_async() is True
        # queries drive the poll and retry state machine; between two, the
        # attempt in flight is joined, so the loop ends on the job's state
        for _ in range(4 * (FAST.max_retries + 1)):
            eng.query(q, 5)
            if sup.health()["jobs"]["compact"]["failed"]:
                break
            join_attempt(getattr(eng.store._compaction, "job", None))
    h = sup.health()
    assert h["jobs"]["compact"]["failed"] == 1
    assert h["jobs"]["compact"]["retries"] == FAST.max_retries
    assert "FaultError" in h["last_error"]["error"]
    assert len(eng.store.sealed) == 4  # still the pre-swap segments
    assert_fresh_equal(eng, _contents(idx, 96, {3, 30, 70}), q)
    assert eng.store.compact_async() is True
    assert eng.store.wait_compaction()["rows_out"] == 93


def test_distill_transient_failure_retries_to_success(tiny):
    sup, _ = _supervisor()
    eng = _engine(tiny, n=48, seal_rows=24, supervisor=sup)
    n_new = eng.cfg.n_bins // 2
    with faults.scoped(faults.FaultPlan({"distill.work": faults.FaultSpec("raise", times=1)})):
        assert eng.store.distill_async(DistillPolicy(widths=(n_new,))) is True
        stats = eng.store.wait_compaction()  # the retry absorbs the transient
    assert stats is not None and stats["groups"] == 2
    assert {s.n_bins for s in eng.store.sealed} == {n_new}
    h = sup.health()
    assert h["jobs"]["distill"]["retries"] == 1 and h["jobs"]["distill"]["succeeded"] == 1


def test_quarantine_engages_and_healthy_probe_clears(tiny):
    """Two exhausted launches quarantine (op, key); launches are refused in
    probation; a failed probe restarts it; a healthy probe clears it."""
    sup, clock = _supervisor(SupervisionPolicy(max_retries=0, quarantine_after=2,
                                               probation=30.0))
    eng = _engine(tiny, supervisor=sup)
    eng.delete([3])
    store = eng.store
    with faults.scoped(faults.FaultPlan({"compact.work": faults.FaultSpec("raise")})):
        for _ in range(2):
            assert store.compact_async() is True
            assert store.wait_compaction() is None  # failed, not raised
        assert sup.health()["quarantined"], "2 failures must quarantine"
        assert store.compact_async() is False  # refused inside probation
        assert sup.health()["jobs"]["compact"]["refused"] == 1
        clock.set(31.0)  # probation over: exactly one probe is admitted...
        assert store.compact_async() is True
        assert store.wait_compaction() is None  # ...and it fails too
        assert store.compact_async() is False  # probation restarted
    clock.set(62.0)
    assert store.compact_async() is True
    assert store.wait_compaction() is not None
    h = sup.health()
    assert h["quarantined"] == [] and h["jobs"]["compact"]["succeeded"] == 1


def test_watchdog_abandons_stalled_job_without_swapping(tiny):
    """A hung worker is abandoned once the clock passes its deadline: a
    terminal failure, no retry, and its late result is never swapped in."""
    idx = tiny[4]
    sup, clock = _supervisor(SupervisionPolicy(max_retries=3, deadline=0.05))
    eng = _engine(tiny, supervisor=sup)
    eng.delete([3])
    store = eng.store
    sealed_before = list(store.sealed)
    hold = threading.Event()
    assert store.compact_async(_hold=hold) is True
    zombie = store._compaction.job._job  # the attempt: the abandon drops the job's reference
    q = idx[100:104]
    eng.query(q, 3)  # inside the deadline: still running
    assert store.job_pending == "compact" and not sup.health()["abandoned"]
    clock.advance(1.0)
    eng.query(q, 3)  # serving never blocks on the hung job; the poll abandons it
    h = sup.health()
    assert h["abandoned"] == 1 and h["jobs"]["compact"]["retries"] == 0
    assert store.job_pending is None
    hold.set()  # let the zombie finish: its result must be dropped
    join_attempt(zombie)
    eng.query(q, 3)
    assert store.sealed == sealed_before
    assert "deadline" in h["last_error"]["error"]


def test_abandon_compaction_by_op(tiny):
    """``abandon_compaction`` drops a pending job of the named op only."""
    sup, _ = _supervisor()
    eng = _engine(tiny, n=48, supervisor=sup)
    hold = threading.Event()
    assert eng.store.distill_async(DistillPolicy(widths=(100,)), _hold=hold) is True
    assert eng.store.abandon_compaction("compact") is False
    assert eng.store.abandon_compaction("distill") is True
    hold.set()
    assert eng.store.job_pending is None and sup.health()["abandoned"] == 1
    assert all(s.n_bins is None for s in eng.store.sealed)


# ----------------------------------------------------- degraded-mode serving
def test_band_lookup_failure_degrades_to_exhaustive(tiny):
    eng = _engine(tiny, band_policy=BandPolicy(n_bands=8, max_candidate_frac=1.0, min_rows=8))
    q = tiny[4][100:108]
    exact = eng.query(q, 5, prefilter=False)
    with faults.scoped(faults.FaultPlan({"band.lookup": faults.FaultSpec("raise")})):
        got = eng.query(q, 5)  # banded by default; must not raise
    assert torch.equal(got[1], exact[1]) and torch.equal(got[0], exact[0])
    deg = {d["component"]: d for d in eng.health()["degraded"]}
    assert "band_lookup" in deg and deg["band_lookup"]["count"] >= 1


def test_band_build_failure_at_seal_degrades_not_raises(tiny):
    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True,
                             band_policy=BandPolicy(n_bands=8, min_rows=8))
    with faults.scoped(faults.FaultPlan({"band.build": faults.FaultSpec("raise")})):
        eng.add(idx[:48])
        eng.seal()
    assert eng.store.sealed[0].band_index is None
    assert "band_index" in {d["component"] for d in eng.health()["degraded"]}
    assert_fresh_equal(eng, _contents(idx, 48), idx[100:106])


def _chunk_fault(eng):
    """Make the query side's band hash raise: the whole prefiltered chunk fails."""
    def boom(*_a, **_k):
        raise RuntimeError("query band hash failed")

    eng.backend.band_hash = boom


@pytest.mark.parametrize("fault,component", [("band.lookup", "band_lookup"),
                                             ("band.build", "band_index"),
                                             ("chunk", "prefilter")])
def test_band_faults_match_a_clean_exhaustive_run(tiny, fault, component):
    """Each prefilter failure the reference degrades (a bucket lookup, an
    index build, a whole prefiltered chunk) degrades here to the exhaustive
    scan: answers equal to a clean ``prefilter=False`` run over the same
    store, and the reference's component name in ``health()``."""
    policy = BandPolicy(n_bands=8, max_candidate_frac=1.0, min_rows=8)
    idx = tiny[4]
    q = idx[100:116]
    clean = _engine(tiny, band_policy=policy)
    want = clean.query(q, 5, prefilter=False)
    assert clean.health()["degraded"] == []
    plan = faults.FaultPlan({fault: faults.FaultSpec("raise")} if "." in fault else {})
    with faults.scoped(plan):
        eng = _engine(tiny, band_policy=policy)
        if fault == "chunk":
            _chunk_fault(eng)
        got = eng.query(q, 5)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert component in {d["component"] for d in eng.health()["degraded"]}
    if fault == "band.build":
        assert all(s.band_index is None for s in eng.store.sealed)


def test_escape_hatch_is_recorded(tiny):
    """A candidate union past ``max_candidate_frac`` scans the segment in full
    and records ``prefilter_hatch``, as the reference does."""
    eng = _engine(tiny, band_policy=BandPolicy(n_bands=1, max_candidate_frac=0.01, min_rows=8))
    q = tiny[4][:8]  # the store's own docs: each hits its own bucket
    got = eng.query(q, 5)
    assert eng.last_prefilter_stats["exhaustive_segments"] >= 1
    assert "prefilter_hatch" in {d["component"] for d in eng.health()["degraded"]}
    assert torch.equal(got[1][:, 0], torch.arange(8, dtype=torch.int32))  # each finds itself


def test_kernel_faults_are_never_degraded(tiny):
    """A kernel that fails to build or launch is not a degraded mode: it
    propagates from a prefiltered chunk and from an index build, and nothing
    is recorded."""
    assert is_device_fault(KernelError("nvcc failed"))
    assert is_device_fault(RuntimeError("CUDA error: an illegal memory access"))
    assert is_device_fault(torch.cuda.OutOfMemoryError("out of memory"))
    assert not is_device_fault(RuntimeError("query band hash failed"))
    assert not is_device_fault(faults.FaultError("injected"))

    def kernel_down(*_a, **_k):
        raise KernelError("band_hash: CUDA error 700 at launch")

    eng = _engine(tiny, band_policy=BandPolicy(n_bands=8, max_candidate_frac=1.0, min_rows=8))
    eng.backend.band_hash = kernel_down
    with pytest.raises(KernelError):
        eng.query(tiny[4][100:104], 5)
    with pytest.raises(KernelError):
        eng.add(tiny[4][96:120])  # 24 rows: the head auto-seals and indexes
    assert eng.health()["degraded"] == []


def test_wrapper_refusals_propagate_not_degrade(tiny, monkeypatch):
    """A kernel wrapper that refuses its input (a ``ValueError`` raised
    inside ``repro_torch.hopper``) is not a degraded mode either: on the
    ``cuda`` backend it propagates from a prefiltered chunk and from an index
    build, and nothing is recorded."""
    from repro_torch.hopper import ref

    _, _, tcfg, tmap, idx = tiny
    eng = SketchEngine.build(tcfg, tmap, backend="cuda", mutable=True, seal_rows=24,
                             band_policy=BandPolicy(n_bands=8, max_candidate_frac=1.0,
                                                    min_rows=8))
    for s in range(0, 96, 24):
        eng.add(idx[s : s + 24])
    assert all(seg.band_index is not None for seg in eng.store.sealed)

    def refuse(*_a, **_k):
        raise ValueError("band_hash: kernel needs a CUDA tensor")

    monkeypatch.setattr(ref, "band_hash_ref", refuse)
    with pytest.raises(ValueError) as got:
        eng.query(idx[100:104], 5)
    assert is_device_fault(got.value)
    with pytest.raises(ValueError):
        eng.add(idx[96:120])  # 24 rows: the head auto-seals and indexes
    assert eng.health()["degraded"] == []


@pytest.mark.parametrize("op", ["compact", "distill"])
def test_background_indexes_hash_through_the_engine_backend(tiny, op):
    """A background job's band keys come from the engine's backend (on the
    ``cuda`` backend, the kernel), hashed on the caller's thread: a
    compaction's at its snapshot, one call a source segment, a
    distillation's in its swap, one call a folded segment (its words exist
    only then); the worker only buckets them. Each new index equals one
    built from the plain hash of its segment's words."""
    from repro_torch.core import packed as pk
    from repro_torch.engine.banding import BandIndex

    sup, _ = _supervisor()
    eng = _engine(tiny, supervisor=sup, band_policy=BandPolicy(n_bands=8, min_rows=8))
    eng.delete([1, 50])
    calls = []
    real = eng.backend.band_hash

    def spy(packed, n_bands):
        calls.append(threading.current_thread() is threading.main_thread())
        return real(packed, n_bands)

    eng.backend.band_hash = spy
    hold = threading.Event()
    if op == "compact":
        eng.compact(background=True, _hold=hold)
        assert len(calls) == 4
    else:
        assert eng.distill(widths=(tiny[2].n_bins // 2,), background=True, _hold=hold)
        assert calls == []
    hold.set()
    at_snapshot = len(calls)
    assert eng.wait_compaction() is not None
    assert len(calls) - at_snapshot == (0 if op == "compact" else 4)
    assert all(calls)
    for seg in eng.store.sealed:
        want = BandIndex.build(pk.band_hash(seg.sketches, 8).numpy())
        np.testing.assert_array_equal(seg.band_index.orders, want.orders)
    assert eng.health()["degraded"] == []


def test_full_chaos_cycle_zero_query_exceptions(tiny, tmp_path):
    """A seeded plan across compaction, band lookups and checkpoint writes
    (one torn leaf) while a delete / compact / query / save loop runs: no
    query raises, the final answers equal a fresh build over the survivors,
    and restore lands on the newest generation that verifies."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.engine import SegmentedStore

    idx = tiny[4]
    sup, _ = _supervisor()
    eng = _engine(tiny, supervisor=sup,
                  band_policy=BandPolicy(n_bands=8, max_candidate_frac=1.0, min_rows=8))
    mgr = CheckpointManager(str(tmp_path), keep=4, supervisor=sup)
    q = idx[100:108]
    deleted = {3, 30, 70}
    plan = faults.FaultPlan({
        "compact.work": faults.FaultSpec("raise", times=3),
        "band.lookup": faults.FaultSpec("raise", times=4),
        "checkpoint.write": faults.FaultSpec("raise", times=1),
        "checkpoint.leaf": faults.FaultSpec("torn-write", times=1, after=20),
    }, seed=1234)
    with faults.scoped(plan):
        eng.delete(sorted(deleted))
        for round_i in range(3):
            eng.store.compact_async()
            for _ in range(3):
                eng.query(q, 5)  # drives the poll and any retries; must not raise
                time.sleep(0.005)
            eng.store.wait_compaction()
            eng.store.save(mgr, step=round_i + 1, blocking=False)
        mgr.wait()
    assert plan.total_fired >= 5, "the chaos plan must actually have fired"
    h = sup.health()
    assert h["jobs"]["compact"]["failed"] >= 1 and h["retries"] >= 2
    eng.store.band_policy = None  # the exhaustive scan, for the comparison
    assert_fresh_equal(eng, _contents(idx, 96, deleted), q)
    step = mgr.resolve_step(None)
    assert step is not None and mgr.verify_step(step)
    back = SegmentedStore.restore(mgr, device=CPU)
    assert back.size == 96 - len(deleted)


def test_injected_faults_show_as_metric_deltas(tiny):
    """Injected faults are counter deltas in an armed registry: a band.build
    failure at seal lands as ``degraded.band_index``, a band.lookup failure
    as ``degraded.band_lookup``."""
    idx = tiny[4]
    eng = _engine(tiny, n=48, seal_rows=48, band_policy=BandPolicy(n_bands=4, min_rows=8))
    reg = obs_metrics.install(obs_metrics.MetricsRegistry(clock=ManualClock()))
    before = reg.counter("degraded.band_index")
    with faults.scoped(faults.FaultPlan({"band.build": faults.FaultSpec("raise")})):
        eng.add(idx[48:96])
        eng.seal()  # the index build fails: an unindexed segment, recorded
    assert reg.counter("degraded.band_index") == before + 1
    before_q = reg.counter("degraded.band_lookup")
    with faults.scoped(faults.FaultPlan({"band.lookup": faults.FaultSpec("raise")})):
        eng.query(idx[:4], 5)
    assert reg.counter("degraded.band_lookup") > before_q
    assert reg.counter("lifecycle.seal.runs") == 1


# ------------------------------------------------------- held background jobs
@pytest.mark.parametrize("op", ["compact", "distill"])
def test_mutations_during_a_held_job_match_a_fresh_build(tiny, op):
    """Deletes, relocating updates and new docs that land while a ``_hold``
    pins a background job: queries before the swap answer over the store as
    it stands, and after the swap the store answers as a fresh build over
    the survivors (for distillation: at N', under psi mod N'), the mid-job
    casualties coming out as tombstones of the new segments."""
    _, _, tcfg, tmap, idx = tiny
    sup, _ = _supervisor()
    eng = _engine(tiny, supervisor=sup)
    contents = _contents(idx, 96)
    eng.delete([1, 50])
    for g in (1, 50):
        contents.pop(g)
    hold = threading.Event()
    n_new = tcfg.n_bins // 2
    if op == "compact":
        assert eng.store.compact_async(_hold=hold) is True
    else:
        assert eng.store.distill_async(DistillPolicy(widths=(n_new,)), _hold=hold) is True
    q = idx[100:110]
    eng.delete([2, 60, 95])  # mid-job tombstones in snapshot rows
    for g in (2, 60, 95):
        contents.pop(g)
    if op == "compact":
        eng.update([10, 40], idx[200:202])  # sealed docs relocate into the head
        contents.update({10: idx[200], 40: idx[201]})
        for g in eng.add(idx[150:154]):
            contents[g] = idx[150 + g - 96]
    assert eng.store.job_pending == op
    assert_fresh_equal(eng, contents, q)  # served while held, pre-swap
    hold.set()
    stats = eng.store.wait_compaction()
    assert stats is not None and eng.store.job_pending is None
    # the mid-job casualties: three deletes, and for the compaction the two
    # relocated rows too, come out as tombstones of the new segments
    dead_mid_job = 3 + (2 if op == "compact" else 0)
    assert sum(s.n_rows - s.n_live for s in eng.store.sealed) == dead_mid_job
    assert sup.health()["jobs"][op]["succeeded"] == 1
    if op == "compact":
        assert_fresh_equal(eng, contents, q)
        return
    assert {s.n_bins for s in eng.store.sealed} == {n_new}
    surv = np.asarray(sorted(contents))
    fresh = SketchEngine.build(BinSketchConfig(d=tcfg.d, n_bins=n_new), tmap % n_new,
                               backend="reference")
    fresh.add(np.stack([contents[int(g)] for g in surv]))
    sc, ix = eng.query(q, 5)
    fs, fi = fresh.query(q, 5)
    np.testing.assert_array_equal(ix.numpy(), surv[fi.numpy()])
    np.testing.assert_allclose(sc.numpy(), fs.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- the serve loop
def test_serve_background_and_chaos_on_the_cpu():
    """``serve`` with background maintenance answers as the synchronous run
    once every job has landed, and under a chaos plan no query raises and
    every fault the plan fired is accounted for in ``health()``."""
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.launch.serve import serve

    kw = dict(queries=32, topk=5, batch=16, device=CPU, mutate_rate=0.3, distill=(212, 106))
    sync = serve(DATASETS["tiny"], **kw)
    bg = serve(DATASETS["tiny"], background_compact=True, **kw)
    q, now = sync["queries"], sync["serve_now"]
    for a, b in zip(sync["engine"].query(q, 5, now=now), bg["engine"].query(q, 5, now=now)):
        assert torch.equal(a, b)
    assert bg["n_tiers"] == 2 and bg["health"]["degraded"] == []
    assert sync["health"]["jobs"]["distill"]["succeeded"] == 2

    out = serve(DATASETS["tiny"], chaos=0.5, chaos_seed=1234, **kw)
    c, h = out["chaos"], out["health"]
    assert sum(c["fired"].values()) > 0
    deg = {d["component"]: d["count"] for d in h["degraded"]}
    for point, op in (("compact.work", "compact"), ("distill.work", "distill"),
                      ("checkpoint.write", "checkpoint")):
        j = h["jobs"].get(op, {})
        assert c["fired"].get(point, 0) <= j.get("retries", 0) + j.get("failed", 0) \
            + j.get("abandoned", 0)
    for point, comp in (("band.build", "band_index"), ("band.lookup", "band_lookup")):
        assert c["fired"].get(point, 0) <= deg.get(comp, 0)
    if c["fired"].get("checkpoint.leaf"):
        assert c["torn"], "a torn leaf must fail its generation's verification"
    assert c["restored_step"] not in c["torn"] and c["restored_live"] > 0


# ---------------------------------------------------------- analyzer guards
_CLOCK_CALLS = {"time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
                "time.clock_gettime", "time.clock_gettime_ns", "datetime.datetime.now",
                "datetime.datetime.utcnow", "datetime.date.today"}


def _ctx(path: pathlib.Path, rel: str) -> FileContext:
    src = path.read_text()
    return FileContext(path=str(path), rel=rel, tree=ast.parse(src), source=src)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_real_time_enters_the_port_only_through_its_clock(path):
    """The ``wall-clock`` rule exempts only the reference's clock module, so
    the port's guarantee is kept here: no port module but ``obs/clock.py``
    reads a timeline clock, ``time.clock_gettime`` (the port clock's call)
    included. ``time.perf_counter`` measures durations and stays allowed."""
    from repro.analysis.rules import import_aliases, resolve_call_path

    rel = path.relative_to(REPO).as_posix()
    ctx = _ctx(path, rel)
    aliases = import_aliases(ctx)
    calls = {resolve_call_path(n.func, aliases) for n in ast.walk(ctx.tree)
             if isinstance(n, ast.Call)}
    found = calls & _CLOCK_CALLS
    if rel == "src/repro_torch/obs/clock.py":
        assert found == {"time.clock_gettime"}
    else:
        assert not found, f"{rel} reads real time directly: {sorted(found)}"


def test_port_workers_own_only_their_snapshots():
    """The reference's ownership check over the port's threaded modules: no
    off-thread code writes captured live state; the port's ``BackgroundJob``
    handoff cell is the one allowed entry (and without it, the check finds
    exactly that cell, so it does see the workers)."""
    allow = {("src/repro_torch/checkpoint/manager.py", "BackgroundJob.__init__.run")}
    for rel in ("src/repro_torch/engine/segments.py", "src/repro_torch/engine/supervision.py",
                "src/repro_torch/engine/lifecycle.py", "src/repro_torch/engine/placement.py",
                "src/repro_torch/checkpoint/manager.py", "src/repro_torch/obs/probe.py",
                "src/repro_torch/obs/trace.py"):
        assert ownership.check_file(str(REPO / rel), rel, allowlist=allow) == [], rel
    rel = "src/repro_torch/checkpoint/manager.py"
    got = ownership.check_file(str(REPO / rel), rel, allowlist=set())
    assert got and all("off-thread function BackgroundJob.__init__.run()" in f.message
                       for f in got)


def test_port_engine_and_checkpoint_swallow_no_exception():
    """``swallowed-exception`` scans only the reference's engine and
    checkpoint directories; each port file of those layers, and the probe and
    trace of the telemetry plane (which catch on the query and supervision
    paths too), is run through it under a path in its scope, and a seeded
    swallow is caught the same way."""
    files = sorted((PORT / "engine").glob("*.py")) + sorted((PORT / "checkpoint").glob("*.py"))
    assert len(files) >= 9
    for path in files:
        rel = "src/repro/" + path.relative_to(PORT).as_posix()
        assert list(check_swallowed_exception(_ctx(path, rel))) == [], path.name
    for name in ("probe.py", "trace.py"):
        ctx = _ctx(PORT / "obs" / name, f"src/repro/engine/obs_{name}")
        assert list(check_swallowed_exception(ctx)) == [], name
    bad = "try:\n    f()\nexcept ValueError:\n    pass\n"
    ctx = FileContext(path="/x.py", rel="src/repro/engine/x.py", tree=ast.parse(bad), source=bad)
    assert len(list(check_swallowed_exception(ctx))) == 1
