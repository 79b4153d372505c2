"""Port parity, the lifecycle controller: ``repro_torch.engine.lifecycle`` and
``serve --autopilot`` held to the JAX package's controller on the CPU.

Each of ``tests/test_lifecycle.py``'s 12 tests is replayed here under its own
name. A scenario is written once against a :class:`Side` (the JAX package on
``oracle``, or the port on ``reference``, fed the JAX Ψ table through
``convert``) and run on both, on the same seeded corpus
(``tests/conftest.py::corpus``) and the same ``ManualClock`` schedule; each
side makes the reference's own assertions, and the two runs' logs must agree:
every tick report and ``controller_state()`` exactly, each sealed segment's
``(live, n_bins)`` after every tick, and the top-k answers taken along the
way (``repro.engine.testing.assert_topk_equivalent``, ids up to provable
score ties read from the port's own scores, at the tolerance of the port's
other JAX comparisons, rtol 2e-3 / atol 1e-3: PyTorch's float32 ``log`` and
XLA's differ in the last ulp, which the estimator's inversion magnifies to
about 3e-5; see ``tests/test_torch_engine.py``). The controller-under-fault case of
``tests/test_faults.py`` is replayed the same way; its hung-merge case runs
on the port alone, on a ``ManualClock`` (the reference's hang is a real-time
delay, the port's watchdog reads the supervisor's clock). Then what only the port
has: a device fault raised inside a tick propagates (and is counted in
``health()``) where every other failure is recorded and swallowed; a tick
with a held job returns without reaching ``wait_compaction``; and ``serve
--autopilot`` on the CI soak's arguments against the JAX serve.

No case waits on real time for a result: every wait joins a job's attempt
through the supervisor or the store with a bound of tens of seconds. In the
serve soak every job a tick starts, and the JAX probe's truth (a worker
thread there, done at launch on the CPU here), is joined as it starts, so
both packages swap each result in, and read each probe, at the same poll.
"""

import json
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from conftest import Workload, corpus, multi_segment_engine
from repro import faults as jfaults
from repro import obs as jobs
from repro.engine import ControllerPolicy as JPolicy
from repro.engine import DistillPolicy as JDistillPolicy
from repro.engine import JobSupervisor as JSupervisor
from repro.engine import LifecycleController as JController
from repro.engine import SketchEngine as JEngine
from repro.engine import SketchStore as JStore
from repro.engine import SupervisionPolicy as JSupervisionPolicy
from repro.engine.testing import assert_topk_equivalent, topk_truth
from repro.obs import clock as jclock
from repro.obs import probe as jprobe
from repro_torch import faults, obs
from repro_torch.convert import config_from_reference, mapping_from_reference
from repro_torch.engine import (BandPolicy, ControllerPolicy, DistillPolicy, JobSupervisor,
                                LifecycleController, SketchEngine, SupervisionPolicy)
from repro_torch.hopper.build import KernelError
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.clock import ManualClock
from repro_torch.obs.probe import RecallProbe

from test_torch_ops_plane import join_attempt
from test_torch_segments import assert_fresh_equal

CPU = "cpu"


@pytest.fixture(scope="module")
def tri():
    """The JAX package's (cfg, mapping, idx) and the port's (cfg, mapping)."""
    cfg, mapping, idx = corpus()
    tcfg = config_from_reference(cfg.d, cfg.n_bins, cfg.mode)
    return cfg, mapping, idx, tcfg, mapping_from_reference(np.asarray(mapping), tcfg, CPU)


@pytest.fixture(autouse=True)
def _nothing_left():
    """Both packages disarmed after every case, and no thread a case started
    (a job's worker, a JAX probe's truth) left alive."""
    before = set(threading.enumerate())
    yield
    left = {"faults": faults.active(), "metrics": obs_metrics.active()}
    faults.clear()
    obs.disable()
    jfaults.clear()
    jobs.disable()
    alive = [t.name for t in threading.enumerate() if t not in before and t.is_alive()]
    assert all(v is None for v in left.values()), f"left armed: {left}"
    assert not alive, f"threads left alive: {alive}"


# ------------------------------------------------------------------ sides
class Side:
    """One package's half of a replay: engine, controller, clock, probe and
    fault plan under one interface, and the log the two halves compare."""

    def __init__(self):
        self.log = []

    def tick(self, ctl, now):
        """``ctl.tick(now)``, logged with the controller's state and each
        sealed segment's ``(live, n_bins)``."""
        r = ctl.tick(now=now)
        self.log.append(("tick", r, ctl.controller_state(),
                         [(int(s.n_live), s.n_bins) for s in ctl.engine.store.sealed]))
        return r

    def answer(self, eng, rows, k):
        """Top-k of ``rows``, logged (the port's with its own scores, for the
        tie check); returns (scores, ids) as numpy."""
        sc, ix = self.query(eng, rows, k)
        self.log.append(("answer", sc, ix, self.truth(eng, rows) if self.port else None))
        return sc, ix

    def join_probe(self, probe):
        """Drive a launched probe's truth to its end (a bounded join of the
        JAX worker; the port's CPU truth is done at launch)."""
        join_attempt(probe._job)


class Jax(Side):
    port = False
    faults = jfaults
    Policy, Controller, DistillPolicy = JPolicy, JController, JDistillPolicy
    Supervisor, SupervisionPolicy = JSupervisor, JSupervisionPolicy
    ManualClock = jclock.ManualClock

    def __init__(self, tri):
        super().__init__()
        self.cfg, self.mapping, self.idx = tri[0], tri[1], tri[2]

    def build(self, n=0, seal_rows=16, **kw):
        if n:
            return multi_segment_engine(self.cfg, self.mapping, self.idx, n=n,
                                        seal_rows=seal_rows, **kw)
        return JEngine.build(self.cfg, self.mapping, backend="oracle", mutable=True,
                             seal_rows=seal_rows, **kw)

    def append_only(self, rows):
        return JEngine.build(self.cfg, self.mapping, jnp.asarray(rows), backend="oracle")

    @staticmethod
    def rows(rows):
        return jnp.asarray(rows)

    def add(self, eng, rows, now=0.0):
        return [int(g) for g in eng.add(jnp.asarray(rows), now=float(now))]

    def query(self, eng, rows, k):
        sc, ix = eng.query(jnp.asarray(rows), k)
        return np.asarray(sc), np.asarray(ix)

    def probe(self, eng, **kw):
        return jprobe.RecallProbe(eng, **kw)

    def rebuild_equal(self, eng, contents, k=5, n_queries=8, seed=11):
        """``tests/test_lifecycle.py::_rebuild_equal``: the engine against a
        fresh batch build over the survivors, tie-aware."""
        surv = np.asarray(sorted(contents))
        rows = np.stack([contents[int(g)] for g in surv])
        pick = np.random.default_rng(seed).choice(len(surv), min(n_queries, len(surv)),
                                                  replace=False)
        q = jnp.asarray(rows[pick])
        fresh = JEngine(JStore.from_indices(eng.cfg, eng.store.mapping, jnp.asarray(rows),
                                            backend=eng.backend), eng.backend, "jaccard")
        sc_f, id_f = fresh.query(q, k)
        id_f = np.where(np.asarray(id_f) >= 0, surv[np.maximum(np.asarray(id_f), 0)], -1)
        assert_topk_equivalent(self.answer(eng, rows[pick], k), (np.asarray(sc_f), id_f),
                               truth=topk_truth(fresh, q, id_map=surv),
                               err_msg="controller-managed store vs fresh rebuild")


class Port(Side):
    port = True
    Policy, Controller, DistillPolicy = ControllerPolicy, LifecycleController, DistillPolicy
    Supervisor, SupervisionPolicy = JobSupervisor, SupervisionPolicy
    ManualClock = ManualClock

    def __init__(self, tri):
        super().__init__()
        self.idx, self.cfg, self.mapping = tri[2], tri[3], tri[4]
        self.faults = faults

    def build(self, n=0, seal_rows=16, clock=None, supervisor=None, band_policy=None,
              backend="reference"):
        eng = SketchEngine.build(self.cfg, self.mapping, backend=backend, mutable=True,
                                 seal_rows=seal_rows, clock=clock, supervisor=supervisor,
                                 band_policy=band_policy)
        for s in range(0, n, seal_rows):
            eng.add(self.idx[s : s + seal_rows], now=0.0)
        return eng

    def append_only(self, rows):
        return SketchEngine.build(self.cfg, self.mapping, rows, backend="reference")

    @staticmethod
    def rows(rows):
        return np.asarray(rows)

    @staticmethod
    def truth(eng, rows):
        """Per query, ``{id: score}`` of every live doc, from the engine's
        own full ranking (each segment at its width); the hits that ranking
        counts are put back, so the cold test sees only the scenario's reads."""
        st_ = eng.store
        hits = [s.hits for s in st_.sealed], st_.head_hits
        sc, ix = eng.query(np.asarray(rows), max(st_.size, 1))
        for s, h in zip(st_.sealed, hits[0]):
            s.hits = h
        st_.head_hits = hits[1]
        return [{int(g): float(v) for g, v in zip(ix[r].tolist(), sc[r].tolist()) if g >= 0}
                for r in range(len(rows))]

    def add(self, eng, rows, now=0.0):
        return [int(g) for g in eng.add(np.asarray(rows), now=float(now))]

    def query(self, eng, rows, k):
        sc, ix = eng.query(np.asarray(rows), k)
        return sc.numpy(), ix.numpy()

    def probe(self, eng, **kw):
        return RecallProbe(eng, **kw)

    def rebuild_equal(self, eng, contents, k=5, n_queries=8, seed=11):
        """The engine against a fresh append-only build over the survivors:
        ids exactly, scores allclose (``assert_fresh_equal``)."""
        surv = np.asarray(sorted(contents))
        rows = np.stack([contents[int(g)] for g in surv])
        pick = np.random.default_rng(seed).choice(len(surv), min(n_queries, len(surv)),
                                                  replace=False)
        self.answer(eng, rows[pick], k)
        assert_fresh_equal(eng, contents, rows[pick], k=k)


def replay(tri, scenario, *args):
    """Run ``scenario`` on both sides and hold the port's log to the JAX
    package's: tick entries equal, answers equivalent."""
    logs = []
    for side in (Jax(tri), Port(tri)):
        scenario(side, *args)
        logs.append(side.log)
    jlog, tlog = logs
    assert [e[0] for e in tlog] == [e[0] for e in jlog]
    for i, (j, t) in enumerate(zip(jlog, tlog)):
        if j[0] == "tick":
            assert t[1:] == j[1:], f"entry {i}: port {t[1:]} != reference {j[1:]}"
        else:
            assert_topk_equivalent((t[1], t[2]), (j[1], j[2]), truth=t[3], rtol=2e-3,
                                   atol=1e-3, err_msg=f"entry {i}: port answers vs reference")
    return logs


def settle(S, ctl, clk, max_ticks=6):
    """``tests/test_lifecycle.py::_settle``, logged: tick until no action,
    driving each launched job to its end."""
    for _ in range(max_ticks):
        r = S.tick(ctl, clk())
        assert r is not None, "tick must not fail in a healthy sim"
        ctl.engine.store.wait_compaction()
        if r["action"] is None:
            return r
        clk.advance(0.25)
    raise AssertionError(f"controller did not settle in {max_ticks} ticks")


# ------------------------------------------------------------ policy basics
def test_policy_validation_and_tier_math():
    for P in (JPolicy, ControllerPolicy):
        with pytest.raises(ValueError, match="tier_min_rows"):
            P(tier_min_rows=0)
        with pytest.raises(ValueError, match="tier_factor"):
            P(tier_factor=1.0)
        with pytest.raises(ValueError, match="tier_fanout"):
            P(tier_fanout=1)
        with pytest.raises(ValueError, match="tombstone_density"):
            P(tombstone_density=0.0)
    jp, p = (P(tier_min_rows=16, tier_factor=4.0, distill_widths=(64, 256, 128))
             for P in (JPolicy, ControllerPolicy))
    assert p.distill_widths == jp.distill_widths == (256, 128, 64)  # applied descending
    assert [p.tier(n) for n in (1, 16, 17, 63, 64, 256, 1024)] == [0, 0, 1, 1, 2, 3, 4]
    tiers = [p.tier(n) for n in range(1, 2000)]
    assert tiers == sorted(tiers) == [jp.tier(n) for n in range(1, 2000)]
    assert p.snapshot() == jp.snapshot()
    full = dict(memory_budget=1 << 20, probe_baseline=0.9, probe_interval=4.0, cold_age=5.0)
    assert ControllerPolicy(**full).snapshot() == JPolicy(**full).snapshot()


def test_controller_requires_mutable_engine(tri):
    for S in (Jax(tri), Port(tri)):
        eng = S.append_only(S.idx[:8])
        with pytest.raises(TypeError, match="mutable"):
            S.Controller(eng)


def _tick_reports_and_metrics_surface(S):
    clk = S.ManualClock()
    eng = S.build(n=32, seal_rows=16, clock=clk)
    ctl = S.Controller(eng, S.Policy(), clock=clk)
    r = S.tick(ctl, 1.0)
    assert r == {"at": 1.0, "state": "steady", "swapped": False, "action": None,
                 "segments": 2, "tombstone_density": 0.0}
    state = eng.metrics()["controller"]
    assert state == ctl.controller_state()
    assert state["ticks"] == 1 and state["failed_ticks"] == 0
    assert state["state"] == "steady" and state["last_tick_at"] == 1.0
    assert state["policy"]["tier_fanout"] == 4
    assert eng.supervisor.health()["jobs"]["lifecycle"]["succeeded"] == 1


def test_tick_reports_and_metrics_surface(tri):
    """A quiet store ticks to no action; ``controller_state`` rides along in
    ``metrics()`` with the policy's snapshot."""
    replay(tri, _tick_reports_and_metrics_surface)


# ----------------------------------------------------------- merge triggers
def _occupancy_merge(S):
    clk = S.ManualClock()
    eng = S.build(n=48, seal_rows=16, clock=clk)
    ctl = S.Controller(eng, S.Policy(tier_min_rows=16, tier_fanout=4), clock=clk)
    assert S.tick(ctl, 0.5)["action"] is None  # 3 segments < fanout
    S.add(eng, S.idx[48:64])  # seals the 4th
    r = S.tick(ctl, 1.0)
    assert r["action"]["kind"] == "merge" and r["action"]["trigger"] == "occupancy"
    assert sorted(r["action"]["segments"]) == [0, 1, 2, 3]
    eng.store.wait_compaction()
    assert len(eng.store.sealed) == 1 and eng.store.sealed[0].n_live == 64
    assert ctl.merges == 1
    S.answer(eng, S.idx[100:108], 5)


def test_occupancy_merge_triggers_at_fanout(tri):
    replay(tri, _occupancy_merge)


def _tombstone_merge(S):
    clk = S.ManualClock()
    eng = S.build(n=16, seal_rows=16, clock=clk)
    ctl = S.Controller(eng, S.Policy(tombstone_density=0.25), clock=clk)
    eng.delete(list(range(2)))
    assert S.tick(ctl, 1.0)["action"] is None  # 2/16 < 0.25
    eng.delete(list(range(2, 6)))
    r = S.tick(ctl, 2.0)  # 6/16 >= 0.25
    assert r["action"]["kind"] == "merge" and r["action"]["trigger"] == "tombstones"
    eng.store.wait_compaction()
    assert eng.store.sealed[0].n_live == 10
    assert eng.store.lifecycle_snapshot()["tombstone_density"] == 0.0
    S.answer(eng, S.idx[100:108], 5)


def test_tombstone_density_merge_triggers_below_fanout(tri):
    replay(tri, _tombstone_merge)


# -------------------------------------------------- the churn simulation
def _sustained_churn(S):
    clk = S.ManualClock()
    pol = S.Policy(tier_min_rows=16, tier_factor=4.0, tier_fanout=4, tombstone_density=0.5)
    eng = S.build(n=64, seal_rows=16, clock=clk)
    contents = {i: S.idx[i] for i in range(64)}
    wl = Workload(S.idx, seed=7, start=64)
    ctl = S.Controller(eng, pol, clock=clk)
    sealed_total = 4
    for rnd in range(12):
        rows = wl.fresh_rows(16)
        ids = S.add(eng, rows, now=clk())
        contents.update({g: rows[j] for j, g in enumerate(ids)})
        sealed_total += 1
        victims = wl.victims(contents, 6)
        eng.delete(victims)
        for g in victims:
            contents.pop(g)
        q, _ = wl.query_picks(contents, 4)
        S.answer(eng, q, 5)
        clk.advance(1.0)
        settle(S, ctl, clk)
        bound = pol.tier_fanout * math.ceil(math.log(sealed_total, pol.tier_fanout))
        assert len(eng.store.sealed) <= bound, (
            f"round {rnd}: {len(eng.store.sealed)} sealed segments exceed the size-tier "
            f"bound {bound} (S={sealed_total})")
        if rnd % 3 == 2:
            S.rebuild_equal(eng, contents, seed=100 + rnd)
    assert ctl.merges >= 2, "churn at this rate must have forced merges"
    assert ctl.ticks >= 12 and ctl.failed_ticks == 0
    assert eng.store.size == len(contents)
    state = eng.metrics()["controller"]
    assert state["state"] == "steady" and state["last_action"]["kind"] == "merge"


def test_bounded_segments_under_sustained_churn(tri):
    """Rounds of ingest, random deletes and Zipfian reads, the controller
    settled each round: the sealed-segment count stays under the
    ``F * ceil(log_F S)`` bound and the store answers as a fresh rebuild."""
    replay(tri, _sustained_churn)


# ----------------------------------------------------------- distill ladder
def _cold_hot_young(S):
    def build():
        clk = S.ManualClock()
        eng = S.build(n=32, seal_rows=16, clock=clk)
        ctl = S.Controller(eng, S.Policy(distill_widths=(128,), cold_age=5.0), clock=clk)
        return clk, eng, ctl

    # cold: no reads between ticks, so both segments fold to 128
    clk, eng, ctl = build()
    clk.advance(20.0)
    assert S.tick(ctl, clk())["action"] is None, "the first tick has no hits baseline"
    clk.advance(1.0)
    r = S.tick(ctl, clk())
    assert r["action"]["kind"] == "distill" and sorted(r["action"]["segments"]) == [0, 1]
    eng.store.wait_compaction()
    assert {s.n_bins for s in eng.store.sealed} == {128}
    assert ctl.distills == 1
    S.answer(eng, S.idx[200:204], 3)

    # hot: reads land between ticks, so the same age folds nothing
    clk, eng, ctl = build()
    clk.advance(20.0)
    S.tick(ctl, clk())
    S.answer(eng, S.idx[200:204], 3)  # the exhaustive scan hits both
    clk.advance(1.0)
    assert S.tick(ctl, clk())["action"] is None
    assert ctl.distills == 0
    assert {s.n_bins for s in eng.store.sealed} == {None}

    # young: cold by hits but under cold_age
    clk, eng, ctl = build()
    S.tick(ctl, 1.0)
    assert S.tick(ctl, 2.0)["action"] is None
    assert ctl.distills == 0


def test_cold_segments_distill_hot_segments_keep_width(tri):
    replay(tri, _cold_hot_young)


def _memory_budget(S):
    def build(budget):
        clk = S.ManualClock()
        eng = S.build(n=32, seal_rows=16, clock=clk)
        ctl = S.Controller(eng, S.Policy(distill_widths=(128,), cold_age=1.0,
                                         memory_budget=budget), clock=clk)
        clk.advance(10.0)
        S.tick(ctl, clk())
        clk.advance(1.0)
        return clk, eng, ctl

    clk, eng, ctl = build(budget=1 << 30)
    assert S.tick(ctl, clk())["action"] is None  # under budget
    assert ctl.distills == 0
    clk, eng, ctl = build(budget=1)
    r = S.tick(ctl, clk())  # over budget: the cold set folds
    assert r["action"]["kind"] == "distill"
    eng.store.wait_compaction()
    assert {s.n_bins for s in eng.store.sealed} == {128}
    S.answer(eng, S.idx[200:204], 3)


def test_memory_budget_gates_distill_pressure(tri):
    replay(tri, _memory_budget)


# -------------------------------------------------------- recall guardrail
def _guardrail_state_machine(S):
    clk = S.ManualClock()
    eng = S.build(n=32, seal_rows=16, clock=clk)
    probe = S.probe(eng, clock=clk)
    ctl = S.Controller(eng, S.Policy(distill_widths=(128,), cold_age=1.0, probe_baseline=0.9,
                                     probe_tol=0.05), probe=probe, clock=clk)
    probe.last_recall = 0.92
    assert S.tick(ctl, 1.0)["state"] == "steady"

    # a distillation pinned in flight, then the dip lands
    hold = threading.Event()
    assert eng.store.distill_async(S.DistillPolicy(widths=(128,)), now=1.0, _hold=hold)
    zombie = eng.store._compaction.job._job  # the attempt, which abandoning drops
    sealed_before = list(eng.store.sealed)
    probe.last_recall = 0.80  # < 0.9 - 0.05
    r = S.tick(ctl, 2.0)
    assert r["state"] == "halted"
    assert ctl.guardrail_trips == 1 and ctl.abandoned_distills == 1
    assert eng.store._compaction is None, "the in-flight distillation must be dropped"
    h = eng.supervisor.health()
    assert h["abandoned"] == 1
    assert [d["component"] for d in h["degraded"]] == ["lifecycle_distill"]
    hold.set()  # the zombie worker finishes; its fold must never swap in
    zombie._thread.join(30.0)
    assert not zombie._thread.is_alive()
    clk.advance(5.0)
    assert S.tick(ctl, 7.0)["action"] is None, "halted: the cold set stays put"
    assert eng.store.sealed == sealed_before
    assert ctl.distills == 0

    # merges are lossless: still allowed while halted
    for s in range(32, 64, 16):
        S.add(eng, S.idx[s : s + 16], now=clk())
    r = S.tick(ctl, 8.0)
    assert r["state"] == "halted" and r["action"]["kind"] == "merge"
    eng.store.wait_compaction()

    # a recovered reading clears the halt and the degraded record
    probe.last_recall = 0.91
    r = S.tick(ctl, 9.0)
    assert r["state"] == "steady"
    assert eng.supervisor.health()["degraded"] == []
    state = eng.metrics()["controller"]
    assert state["guardrail_trips"] == 1 and state["halted_since"] is None
    S.answer(eng, S.idx[100:108], 5)


def test_guardrail_halts_distill_abandons_inflight_and_recovers(tri):
    replay(tri, _guardrail_state_machine)


def _guardrail_end_to_end(S):
    clk = S.ManualClock()
    eng = S.build(n=64, seal_rows=16, clock=clk)
    contents = {i: S.idx[i] for i in range(64)}
    surv = np.asarray(sorted(contents))
    rows = np.stack([contents[int(g)] for g in surv])
    probe = S.probe(eng, k=5, sample=32, seed=3, clock=clk)
    assert probe.launch(surv, rows)
    S.join_probe(probe)
    baseline = probe.wait(now=clk())
    assert baseline is not None and baseline > 0.5
    S.log.append(("tick", "baseline", baseline, None))

    # tier_fanout=8 keeps the 4 fresh segments out of occupancy range
    ctl = S.Controller(eng, S.Policy(distill_widths=(64,), cold_age=1.0, tier_fanout=8,
                                     probe_baseline=baseline, probe_tol=0.05),
                       probe=probe, probe_feed=lambda: (surv, rows), clock=clk)
    clk.advance(10.0)
    S.tick(ctl, clk())
    clk.advance(1.0)
    with S.faults.scoped(S.faults.FaultPlan(
            {"distill.corrupt": S.faults.FaultSpec("raise")})) as plan:
        r = S.tick(ctl, clk())  # the cold set distills; the fold is zeroed
        assert r["action"]["kind"] == "distill"
        eng.store.wait_compaction()
        assert plan.counters()["fired"]["distill.corrupt"] >= 1
    assert probe.launch(surv, rows)
    S.join_probe(probe)
    dipped = probe.wait(now=clk())
    assert dipped < baseline - 0.05, f"zeroed sketches must crater recall ({baseline} -> {dipped})"
    S.log.append(("tick", "dipped", dipped, None))
    clk.advance(1.0)
    r = S.tick(ctl, clk())
    assert r["state"] == "halted"
    assert ctl.guardrail_trips == 1 and ctl.distills == 1
    sc, ids = S.answer(eng, rows[:4], 5)  # serving never stops
    assert ids.shape == (4, 5)
    clk.advance(1.0)
    assert S.tick(ctl, clk())["action"] is None, "no further distillation while halted"


def test_guardrail_trips_on_fault_corrupted_distill_end_to_end(tri):
    """A fault zeroes a distillation's fold, a real probe round measures the
    recall collapse, and the next tick halts distillation; both packages
    read the same baseline and the same dip."""
    replay(tri, _guardrail_end_to_end)


def _probe_interval(S):
    clk = S.ManualClock()
    eng = S.build(n=32, seal_rows=16, clock=clk)
    surv, rows = np.arange(32), S.idx[:32]
    probe = S.probe(eng, k=5, sample=16, seed=1, clock=clk)
    ctl = S.Controller(eng, S.Policy(probe_interval=4.0), probe=probe,
                       probe_feed=lambda: (surv, rows), clock=clk)
    S.tick(ctl, 0.0)
    assert ctl.probes == 1 and probe.running
    S.join_probe(probe)  # the truth has landed; the next tick's poll reads it
    S.tick(ctl, 1.0)
    assert ctl.probes == 1, "within the interval: no relaunch"
    assert not probe.running
    assert probe.last_recall is not None and probe.runs == 1
    S.log.append(("tick", "recall", probe.last_recall, None))
    clk.advance(8.0)
    S.tick(ctl, clk())
    assert ctl.probes == 2, "past the interval: the next round launches"
    S.join_probe(probe)
    S.tick(ctl, clk() + 1.0)
    assert probe.runs == 2


def test_controller_launches_probe_rounds_on_interval(tri):
    replay(tri, _probe_interval)


# ------------------------------------------------------ property: identity
def _interleaving(S, ops):
    clk = S.ManualClock()
    eng = S.build(seal_rows=8, clock=clk)
    ctl = S.Controller(eng, S.Policy(tier_min_rows=8, tier_fanout=3, tombstone_density=0.3),
                       clock=clk)
    contents = {}
    cursor = 0
    for op, arg in ops:
        live = sorted(contents)
        if op == "insert" or not live:
            rows = S.idx[cursor : cursor + arg]
            ids = S.add(eng, rows, now=clk())
            contents.update({g: rows[j] for j, g in enumerate(ids)})
            cursor += arg
        elif op == "delete":
            g = live[arg % len(live)]
            eng.delete([g])
            contents.pop(g)
        elif op == "seal":
            eng.seal()
        elif op == "advance":
            clk.advance(float(arg))
        else:
            assert S.tick(ctl, clk()) is not None
            eng.store.wait_compaction()
    settle(S, ctl, clk, max_ticks=8)
    assert ctl.failed_ticks == 0
    assert eng.store.size == len(contents)
    if contents:
        S.rebuild_equal(eng, contents, k=4, n_queries=4, seed=ops[0][1])


_OP = st.one_of(st.tuples(st.sampled_from(["insert", "insert"]), st.integers(1, 6)),
                st.tuples(st.just("delete"), st.integers(0, 10_000)),
                st.tuples(st.just("seal"), st.just(0)),
                st.tuples(st.just("advance"), st.integers(1, 10)),
                st.tuples(st.just("tick"), st.just(0)))


@settings(max_examples=10, deadline=None, database=None, derandomize=True)
@given(ops=st.lists(_OP, min_size=4, max_size=12))
def test_interleaved_ticks_and_mutations_query_identical(tri, ops):
    """Any interleaving of inserts, deletes, seals, clock advances and ticks
    leaves both stores answering as a fresh build over the survivors, and
    the two controllers taking the same decisions."""
    replay(tri, _interleaving, ops)


# ------------------------------------------------ the controller under fault
def _tick_failures_quarantine(S, q):
    t = [0.0]  # an injectable clock: probation advances on demand
    sup = S.Supervisor(S.SupervisionPolicy(max_retries=0, quarantine_after=2, probation=30.0),
                       clock=lambda: t[0])
    eng = S.build(n=96, seal_rows=24, supervisor=sup)
    probe = S.probe(eng, clock=lambda: t[0])

    def bad_feed():
        raise RuntimeError("catalog service down")

    ctl = S.Controller(eng, S.Policy(probe_interval=1.0), probe=probe, probe_feed=bad_feed,
                       clock=lambda: t[0])
    for _ in range(2):
        t[0] += 2.0  # past the probe interval: the feed is consulted
        assert S.tick(ctl, None) is None  # recorded, not raised
        S.answer(eng, q, 3)  # serving is unaffected between failing ticks
    assert ctl.failed_ticks == 2
    h = sup.health()
    assert h["jobs"]["lifecycle"]["failed"] == 2
    assert h["last_error"]["error"] == "RuntimeError: catalog service down"
    assert h["quarantined"] and h["quarantined"][0]["op"] == "lifecycle"
    t[0] += 2.0
    assert S.tick(ctl, None) is None  # refused inside probation: the body never runs
    assert sup.health()["jobs"]["lifecycle"]["refused"] == 1
    assert ctl.failed_ticks == 3
    # the feed recovers and probation lapses: the probe tick heals the pair
    ctl.probe_feed = lambda: (np.arange(32), S.idx[:32])
    t[0] = 60.0
    r = S.tick(ctl, None)
    assert r is not None and r["state"] == "steady"
    assert sup.health()["quarantined"] == []
    assert ctl.ticks >= 1 and eng.metrics()["controller"]["failed_ticks"] == 3
    assert r["action"]["kind"] == "merge"  # the four 24-row segments reach the fanout
    eng.store.wait_compaction()  # its worker ends inside the case
    S.join_probe(probe)
    S.log.append(("tick", "jobs", {k: v for k, v in sup.health()["jobs"].items()
                                   if k == "lifecycle"}, None))


def test_controller_tick_failures_quarantine_without_stalling_serving(tri):
    """``tests/test_faults.py``'s controller case: a tick whose probe feed
    raises a ``RuntimeError`` is recorded and returns None, never raised;
    two failures quarantine ``("lifecycle", ("tick",))``; a healthy tick
    after probation clears it."""
    replay(tri, _tick_failures_quarantine, tri[2][100:104])


# --------------------------------------------------------- the port's own
def _merge_ready(tri, **kw):
    """A port engine of four 24-row segments (one tier at fanout) and its
    controller on a ManualClock."""
    sup = JobSupervisor(SupervisionPolicy(max_retries=0, backoff_base=0.0, backoff_cap=0.0),
                        clock=ManualClock())
    eng = Port(tri).build(n=96, seal_rows=24, supervisor=sup, **kw)
    return eng, LifecycleController(eng, ControllerPolicy(tier_min_rows=24))


def test_device_fault_in_a_tick_propagates_and_is_counted(tri, monkeypatch):
    """The boundary of a tick: a ``KernelError`` raised inside a job launch
    (the band-key hash at a merge's snapshot) is recorded, counted in
    ``health()`` and ``failed_ticks``, and propagates; so does a kernel
    wrapper's refusal (a ``ValueError`` raised inside ``repro_torch.hopper``).
    Any other error (here a ``RuntimeError`` of the store's snapshot) is
    recorded and the tick returns None, as in the reference."""
    from repro_torch.hopper import ref

    eng, ctl = _merge_ready(tri, band_policy=BandPolicy(n_bands=4, min_rows=8))

    def kernel_down(*_a, **_k):
        raise KernelError("band_hash: CUDA error 700 at launch")

    real = eng.backend.band_hash
    eng.backend.band_hash = kernel_down
    with pytest.raises(KernelError, match="CUDA error 700"):
        ctl.tick(now=1.0)
    h = eng.health()
    assert h["jobs"]["lifecycle"]["failed"] == 1 and ctl.failed_ticks == 1
    assert h["last_error"]["op"] == "lifecycle" and "KernelError" in h["last_error"]["error"]
    assert eng.store.job_pending is None and ctl.merges == 0

    eng.backend.band_hash = real
    store_snapshot = eng.store.lifecycle_snapshot

    def snapshot_down(now=None):
        raise RuntimeError("telemetry read failed")

    eng.store.lifecycle_snapshot = snapshot_down
    assert ctl.tick(now=2.0) is None  # recorded, swallowed
    assert eng.health()["jobs"]["lifecycle"]["failed"] == 2 and ctl.failed_ticks == 2
    eng.store.lifecycle_snapshot = store_snapshot

    # the cuda backend on CPU tensors runs the plain versions in hopper/ref.py
    eng, ctl = _merge_ready(tri, band_policy=BandPolicy(n_bands=4, min_rows=8),
                            backend="cuda")

    def refuse(*_a, **_k):
        raise ValueError("band_hash: kernel needs a CUDA tensor")

    monkeypatch.setattr(ref, "band_hash_ref", refuse)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ctl.tick(now=1.0)
    assert eng.health()["jobs"]["lifecycle"]["failed"] == 1 and ctl.failed_ticks == 1
    monkeypatch.undo()
    r = ctl.tick(now=2.0)  # the kernel's plain version is back: the merge launches
    assert r["action"]["kind"] == "merge"
    assert eng.store.wait_compaction() is not None and len(eng.store.sealed) == 1


def test_controller_jobs_hash_through_the_engine_backend(tri):
    """A merge and a distillation the controller starts hash their band keys
    through the engine's backend (the kernel on ``cuda``), not the host
    ``pk.band_hash``: the merge at its snapshot, the distillation in its swap."""
    eng, ctl = _merge_ready(tri, band_policy=BandPolicy(n_bands=4, min_rows=8))
    calls = []
    real = eng.backend.band_hash

    def spy(packed, n_bands):
        calls.append(packed.shape[0])
        return real(packed, n_bands)

    eng.backend.band_hash = spy
    assert ctl.tick(now=1.0)["action"]["kind"] == "merge"
    assert calls == [24, 24, 24, 24]  # one call a source segment, at the snapshot
    assert eng.store.wait_compaction() is not None
    ctl.policy = ControllerPolicy(tier_min_rows=24, distill_widths=(tri[3].n_bins // 2,),
                                  cold_age=1.0)
    ctl.tick(now=10.0)  # the hits baseline
    r = ctl.tick(now=11.0)
    assert r["action"]["kind"] == "distill"
    calls.clear()
    assert eng.store.wait_compaction() is not None
    assert calls == [96]  # the folded segment's index, in the swap
    assert eng.health()["degraded"] == []


def test_tick_with_a_held_job_never_blocks(tri):
    """With a job in flight (here pinned by ``_hold``), a tick only polls: it
    launches nothing, never reaches ``wait_compaction`` (at the head of
    ``compact_async`` and ``distill_async``), and returns at once; the next
    tick after the job lands launches the merge it held back."""
    eng, ctl = _merge_ready(tri)
    store = eng.store
    eng.delete([1])  # something to reclaim in segment 0
    hold = threading.Event()
    assert store.compact_async(groups=[[0]], _hold=hold)
    job = store._compaction.job
    waited = []

    def no_wait():  # would block until the hold is released: fail instead
        waited.append(store.job_pending)
        raise AssertionError("a tick reached wait_compaction with a job in flight")

    store.wait_compaction = no_wait
    try:
        r = ctl.tick(now=1.0)
        assert waited == [] and r is not None
        assert r["action"] is None and not r["swapped"] and store.job_pending == "compact"
    finally:
        del store.wait_compaction
        hold.set()
    join_attempt(job)
    r = ctl.tick(now=2.0)  # swaps the held job in, then merges the tier
    assert r["swapped"] and r["action"]["kind"] == "merge"
    assert store.wait_compaction() is not None and len(store.sealed) == 1
    assert store.sealed[0].n_live == 95


def test_controller_hung_merge_abandoned_then_tier_retried(tri):
    """``tests/test_faults.py``'s hung-merge case, on a ``ManualClock``: the
    merge the controller launches is held (``_hold``) past the watchdog's
    deadline, and the next tick's poll abandons it: one abandon, no retry,
    nothing swapped, and the same tick launches the still-over-fanout tier
    again. Once the hang clears, the zombie's late result is dropped and the
    new merge lands: one sealed segment of 96 live rows, two merges."""
    clock = ManualClock()
    sup = JobSupervisor(SupervisionPolicy(max_retries=3, deadline=0.05, backoff_base=0.0,
                                          backoff_cap=0.0), clock=clock)
    eng = Port(tri).build(n=96, seal_rows=24, supervisor=sup)  # 4 segments == fanout
    ctl = LifecycleController(eng, ControllerPolicy(tier_min_rows=24))
    store = eng.store
    hold = threading.Event()

    def held_once(*a, **kw):  # the controller's first merge hangs until released
        del store.compact_async
        return store.compact_async(*a, _hold=hold, **kw)

    store.compact_async = held_once
    q = tri[2][100:104]
    try:
        r = ctl.tick(now=1.0)
        assert r["action"]["kind"] == "merge"  # launched into the hang
        zombie = store._compaction.job._job  # the attempt: the abandon drops the job's reference
        eng.query(q, 3)  # inside the deadline: serving never blocks on the hung worker
        assert store.job_pending == "compact" and not sup.health()["abandoned"]
        clock.advance(1.0)  # past the deadline
        r = ctl.tick(now=2.0)
        h = sup.health()
        assert h["abandoned"] == 1
        assert h["jobs"]["compact"]["retries"] == 0  # hangs are not retried
        assert not r["swapped"]
        assert r["action"]["kind"] == "merge", \
            "the abandoning tick must re-launch the over-fanout tier"
        fresh = store._compaction.job
    finally:
        hold.set()
    join_attempt(zombie)
    join_attempt(fresh)
    assert store.wait_compaction() is not None
    assert len(store.sealed) == 1
    assert store.sealed[0].n_live == 96
    assert ctl.merges == 2


# ---------------------------------------------------------- serve --autopilot
SOAK = ["--autopilot", "--seal-rows", "24", "--churn-docs", "16", "--queries", "96",
        "--batch", "8", "--mutate-rate", "0.2", "--probe", "64",
        "--autopilot-max-segments", "8"]


def test_serve_autopilot_soak_matches_the_jax_serve(tri, tmp_path, monkeypatch, capsys):
    """The CI soak's arguments on ``tiny``: the port's ``serve`` with the JAX
    Ψ table against the JAX serve. The same final segment count, ticks,
    merges and probe launches, the probe's recall within 1e-6 (and within
    the CI's gate, 0.620 +- 0.05), the segment gate held, and the same
    controller state in the metrics snapshot."""
    from repro.launch import serve as jserve
    from repro_torch.data.synthetic import DATASETS
    from repro_torch.launch.serve import serve

    from repro.engine.segments import SegmentedStore as JSegmentedStore
    from repro_torch.engine.segments import SegmentedStore

    # every job a tick starts, and the JAX probe's truth, is joined as it
    # starts, so that both packages swap it in at the same poll
    for cls, name, job in ((jprobe.RecallProbe, "launch", lambda o: o._job),
                           (JSegmentedStore, "compact_async", lambda o: o._compaction.job),
                           (JSegmentedStore, "distill_async", lambda o: o._compaction.job),
                           (SegmentedStore, "compact_async", lambda o: o._compaction.job),
                           (SegmentedStore, "distill_async", lambda o: o._compaction.job)):
        def launch_and_join(self, *a, _real=getattr(cls, name), _job=job, **k):
            ok = _real(self, *a, **k)
            if ok:
                join_attempt(_job(self))
            return ok

        monkeypatch.setattr(cls, name, launch_and_join)
    try:
        jserve.main(SOAK + ["--backend", "oracle", "--metrics-json", str(tmp_path / "j.json")])
    finally:
        jobs.disable()
    j = json.loads((tmp_path / "j.json").read_text())
    out = serve(DATASETS["tiny"], queries=96, topk=10, batch=8, mutate_rate=0.2, seal_rows=24,
                backend="reference", device=CPU, mapping=tri[4], probe=64, autopilot=True,
                churn_docs=16, autopilot_max_segments=8,
                metrics_json=str(tmp_path / "t.json"))
    t = json.loads((tmp_path / "t.json").read_text())
    ap = out["autopilot"]
    assert ap["ok"] and ap["segments"] <= 8
    assert ap["segments"] == len(j["lifecycle"]["segments"]) == len(t["lifecycle"]["segments"])
    cj, ct = j["controller"], t["controller"]
    assert ct == ap["controller"]
    for key in ("ticks", "merges", "distills", "probes", "failed_ticks", "state",
                "last_action", "policy"):
        assert ct[key] == cj[key], key
    assert ct["failed_ticks"] == 0 and ct["merges"] >= 1 and ct["probes"] >= 1
    assert len(ap["tick_ms"]) == ct["ticks"]
    assert [(s["live"], s["width"]) for s in t["lifecycle"]["segments"]] == \
        [(s["live"], s["width"]) for s in j["lifecycle"]["segments"]]
    assert abs(out["probe"]["recall"] - j["probe"]["recall"]) <= 1e-6
    assert abs(out["probe"]["recall"] - 0.620) <= 0.05  # the JAX CI's probe gate
    assert out["probe"]["recall"] == t["probe"]["recall"]
    assert "autopilot: segment count" in capsys.readouterr().out
    assert obs_metrics.active() is None and faults.active() is None
