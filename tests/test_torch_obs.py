"""Port parity, the telemetry plane: ``repro_torch.obs`` (registry, sampled
traces, the recall probe, the clock) and its wiring into ``SketchEngine`` and
``SegmentedStore``, held to what ``tests/test_obs.py`` asserts of the
reference, on the ``tiny`` corpus with the JAX package's Ψ table.

Each of ``tests/test_obs.py``'s 15 tests is replayed here under its own name:
the pure-Python pieces (histogram quantiles, the registry, Prometheus text)
are fed the same values in both packages and their outputs compared
directly; the engine cases run the JAX engine on ``oracle`` and the port on
``reference`` over the same rows and compare counters, trace structure
(stage names, per-segment candidates, widths, degraded flags, overflow),
segment hits, ``lifecycle_snapshot`` fields, ``metrics()`` key sets and the
probe's recall; timings are never compared. The new cases hold what only the
port has: a disarmed or unsampled query creates no CUDA event and calls no
synchronise; a sampled one on the card creates two events a stage and
synchronises once; the probe's ground truth is a supervised op whose failure
leaves the gauge stale and whose device fault propagates; ``serve
--metrics-json`` writes the reference's keys and ``--probe-baseline`` gates.

Every case arms telemetry through ``scoped`` (or disarms in a ``finally``),
runs its clocks as ``ManualClock`` where time matters, waits on jobs only
through the supervisor with a bound, and asserts no real-time duration. The
autouse fixture fails a case that leaves a registry, a collector or a fault
plan armed, or a thread it started alive.
"""

import contextlib
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import faults as jfaults
from repro import obs as jobs
from repro.engine import BandPolicy as JBandPolicy
from repro.engine import JobSupervisor as JSupervisor
from repro.engine import SketchEngine as JEngine
from repro.obs.probe import RecallProbe as JRecallProbe
from repro_torch import faults, obs
from repro_torch.engine import BandPolicy, JobSupervisor, SketchEngine, SupervisionPolicy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import probe as probe_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.probe import RecallProbe, exact_topk

from test_torch_segments import tiny  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _nothing_left():
    """After every case: no registry, collector or fault plan armed in the
    port, and no thread the case started still alive. Both packages are
    disarmed either way, so one failure cannot leak into the next case."""
    before = set(threading.enumerate())
    yield
    left = {"metrics": obs_metrics.active(), "trace": obs_trace.active(),
            "faults": faults.active()}
    obs.disable()
    faults.clear()
    jobs.disable()
    jfaults.clear()
    alive = [t.name for t in threading.enumerate() if t not in before and t.is_alive()]
    assert all(v is None for v in left.values()), f"left armed: {left}"
    assert not alive, f"threads left alive: {alive}"


@contextlib.contextmanager
def telemetry(sample=1, capacity=64, jclock=None, tclock=None):
    """Both packages armed for the block: a registry and a collector feeding
    it, each installed with ``scoped``. Yields ((jreg, jcol), (treg, tcol))."""
    jreg = jobs.metrics.MetricsRegistry(clock=jclock)
    jcol = jobs.trace.TraceCollector(sample=sample, capacity=capacity, clock=jclock,
                                     registry=jreg)
    treg = obs_metrics.MetricsRegistry(clock=tclock)
    tcol = obs_trace.TraceCollector(sample=sample, capacity=capacity, clock=tclock,
                                    registry=treg)
    with jobs.metrics.scoped(jreg), jobs.trace.scoped(jcol), \
            obs_metrics.scoped(treg), obs_trace.scoped(tcol):
        yield (jreg, jcol), (treg, tcol)


def _banded_pair(tiny, n=96, seal_rows=24, jclock=None, tclock=None, max_candidate_frac=1.0,
                 ttl=None):
    """The reference's ``_banded_engine`` in both packages over the same rows:
    ``n // seal_rows`` sealed segments, each banded (8 bands, min_rows 8)."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    pol = dict(n_bands=8, min_rows=8, max_candidate_frac=max_candidate_frac)
    je = JEngine.build(jcfg, jmap, backend="oracle", mutable=True, seal_rows=seal_rows,
                       band_policy=JBandPolicy(**pol), clock=jclock, ttl=ttl)
    te = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, seal_rows=seal_rows,
                            band_policy=BandPolicy(**pol), clock=tclock, ttl=ttl)
    for s in range(0, n, seal_rows):
        je.add(jnp.asarray(idx[s : s + seal_rows]))
        te.add(idx[s : s + seal_rows])
    return je, te


def _structure(tr: dict) -> dict:
    """A trace without its times: stage names (as a set), segments, widths,
    degraded flags, overflow, candidate fraction, path and shape."""
    out = {k: v for k, v in tr.items() if k not in ("started_at", "duration_s", "stages_s")}
    out["stages"] = set(tr["stages_s"])
    return out


def _key_tree(d, depth=3):
    """The nested key paths of a JSON snapshot (lists read through their
    first element), ``depth`` levels deep."""
    out = set()

    def walk(x, path, level):
        if level == depth:
            return
        if isinstance(x, dict):
            for k, v in x.items():
                out.add(path + "/" + str(k))
                walk(v, path + "/" + str(k), level + 1)
        elif isinstance(x, list) and x and isinstance(x[0], dict):
            walk(x[0], path + "[]", level)

    walk(d, "", 0)
    return out


# ------------------------------------------------------------- histogram
@pytest.mark.parametrize("name,values", [
    ("lognormal", np.random.default_rng(0).lognormal(0.0, 2.0, 20000)),
    ("heavy_tail", np.random.default_rng(1).pareto(1.1, 20000) + 1e-6),
    ("bimodal", np.concatenate([
        np.random.default_rng(2).normal(1e-4, 1e-5, 10000),
        np.random.default_rng(3).normal(10.0, 1.0, 10000),
    ]).clip(min=1e-7)),
    ("constant", np.full(5000, 0.125)),
])
def test_histogram_quantiles_bounded_relative_error(name, values):
    """Both packages' histograms report the same quantiles, each within 5%
    relative error of the exact order statistic."""
    jh, th = jobs.metrics.Histogram(alpha=0.05), obs_metrics.Histogram(alpha=0.05)
    for v in values:
        jh.observe(float(v))
        th.observe(float(v))
    s = np.sort(values)
    for q in (0.50, 0.90, 0.99):
        exact = float(s[min(len(s) - 1, int(q * len(s)))])
        got = th.quantile(q)
        assert got == jh.quantile(q), f"{name} p{int(q * 100)}"
        assert abs(got - exact) <= 0.05 * exact + 1e-12, (
            f"{name} p{int(q * 100)}: got {got}, exact {exact}")
    assert th.snapshot() == jh.snapshot()


def test_histogram_zero_and_tiny_values_hit_zero_bucket():
    jh, th = jobs.metrics.Histogram(), obs_metrics.Histogram()
    for v in (0.0, 1e-12, 1e-10):
        jh.observe(v)
        th.observe(v)
    assert th.count == 3 and th.quantile(0.5) == 0.0
    snap = th.snapshot()
    assert snap["p99"] == 0.0 and snap["count"] == 3
    assert snap == jh.snapshot()


# -------------------------------------------------------------- registry
def test_registry_snapshot_json_round_trip_and_prometheus():
    regs = (jobs.metrics.MetricsRegistry(clock=jobs.ManualClock(42.0)),
            obs_metrics.MetricsRegistry(clock=obs.ManualClock(42.0)))
    for reg in regs:
        reg.inc("query.calls", 3)
        reg.set_gauge("probe.recall", 0.625)
        for v in (0.001, 0.002, 0.5):
            reg.observe("query.stage.kernel_score_s", v)
    jreg, reg = regs
    snap = json.loads(json.dumps(reg.snapshot()))
    assert snap == json.loads(json.dumps(jreg.snapshot()))
    assert snap["at"] == 42.0
    assert snap["counters"]["query.calls"] == 3
    assert snap["gauges"]["probe.recall"] == 0.625
    hist = snap["histograms"]["query.stage.kernel_score_s"]
    assert hist["count"] == 3 and hist["min"] == 0.001
    text = reg.to_prometheus()
    assert text == jreg.to_prometheus()
    assert "# TYPE repro_query_calls counter" in text
    assert "repro_query_calls 3" in text
    assert 'repro_query_stage_kernel_score_s{quantile="0.99"}' in text
    assert "repro_probe_recall 0.625" in text


def test_free_helpers_are_noops_disarmed_and_land_when_armed():
    obs_metrics.inc("x")  # disarmed: must not raise, must not record
    with obs_metrics.scoped(obs_metrics.MetricsRegistry()) as reg:
        obs_metrics.inc("x", 2)
        obs_metrics.set_gauge("g", 1.5)
        obs_metrics.observe("h", 0.25)
        assert reg.counter("x") == 2
        assert reg.gauge("g") == 1.5
        assert reg.histogram("h").count == 1
    assert obs_metrics.active() is None


# ----------------------------------------------------------------- trace
def test_trace_completeness_on_banded_multi_segment_query(tiny):
    """One sampled banded multi-segment query records every stage, the same
    per-segment candidates, widths and counters as the reference, and the
    same segment hits."""
    je, te = _banded_pair(tiny)
    idx = tiny[4]
    rows = idx[[0, 10, 30, 50, 70, 90]]
    with telemetry() as ((jreg, jcol), (treg, tcol)):
        je.query(jnp.asarray(rows), 5)
        te.query(rows, 5)
        assert treg.counter("query.calls") == 1 and treg.counter("query.rows") == 6
        assert treg.snapshot()["counters"] == jreg.snapshot()["counters"]
        jtr, ttr = jcol.last(), tcol.last()
    assert ttr is not None and ttr["path"] == "query"
    assert set(ttr["stages_s"]) == set(obs_trace.STAGES)
    assert list(ttr["stages_s"]) == list(obs_trace.STAGES)  # listed in pipeline order
    assert all(dt >= 0.0 for dt in ttr["stages_s"].values())
    assert len(ttr["segments"]) >= 2
    for seg in ttr["segments"]:
        assert 0.0 <= seg["candidate_frac"] <= 1.0
    assert ttr["widths"] == [tiny[2].n_bins]
    assert ttr["degraded"] == [] and ttr["k_overflow"] is False
    assert ttr["duration_s"] > 0.0
    assert _structure(ttr) == _structure(jtr)
    assert [s.hits for s in te.store.sealed] == [s.hits for s in je.store.sealed]
    assert te.store.head_hits == je.store.head_hits


def test_trace_sampling_keeps_counters_exact(tiny):
    je, te = _banded_pair(tiny)
    rows = tiny[4][:4]
    with telemetry(sample=2) as ((jreg, jcol), (treg, tcol)):
        for _ in range(4):
            je.query(jnp.asarray(rows), 3)
            te.query(rows, 3)
        assert treg.counter("query.calls") == 4  # exact, engine-side
        assert treg.counter("query.rows") == 16
        assert len(tcol.traces()) == 2 == len(jcol.traces())  # every other call traced
        assert treg.snapshot()["counters"] == jreg.snapshot()["counters"]
        assert [_structure(t) for t in tcol.traces()] == [_structure(t) for t in jcol.traces()]


def test_trace_flags_degraded_band_lookup(tiny):
    je, te = _banded_pair(tiny)
    rows = tiny[4][:4]
    with telemetry() as ((jreg, jcol), (treg, tcol)):
        with jfaults.scoped(jfaults.FaultPlan({"band.lookup": jfaults.FaultSpec("raise")})):
            je.query(jnp.asarray(rows), 5)  # degrades, must not raise
        with faults.scoped(faults.FaultPlan({"band.lookup": faults.FaultSpec("raise")})):
            te.query(rows, 5)
        ttr = tcol.last()
        assert "band_lookup" in ttr["degraded"]
        assert ttr["degraded"] == jcol.last()["degraded"]
        assert treg.counter("query.degraded.band_lookup") >= 1
        assert treg.counter("degraded.band_lookup") >= 1  # the supervisor's twin
        assert treg.snapshot()["counters"] == jreg.snapshot()["counters"]


def test_k_overflow_counted_and_flagged(tiny):
    jcfg, jmap, tcfg, tmap, idx = tiny
    je = JEngine.build(jcfg, jmap, jnp.asarray(idx[:16]), backend="oracle")
    te = SketchEngine.build(tcfg, tmap, idx[:16], backend="reference")
    with telemetry() as ((jreg, jcol), (treg, tcol)):
        je.query(jnp.asarray(idx[:2]), 32)  # k > live corpus
        te.query(idx[:2], 32)
        assert treg.counter("query.k_overflow") == 1
        assert tcol.last()["k_overflow"] is True
        assert treg.snapshot()["counters"] == jreg.snapshot()["counters"]
        assert _structure(tcol.last()) == _structure(jcol.last())


# ------------------------------------------------- lifecycle + hit counters
def test_segment_hits_and_lifecycle_snapshot(tiny):
    """Hits and the whole lifecycle snapshot, ages from a ManualClock, equal
    the reference's after the same history."""
    jclock, tclock = jobs.ManualClock(0.0), obs.ManualClock(0.0)
    je, te = _banded_pair(tiny, jclock=jclock, tclock=tclock)
    idx = tiny[4]
    je.add(jnp.asarray(idx[96:100]))  # live head rows
    te.add(idx[96:100])
    jclock.advance(7.0)
    tclock.advance(7.0)
    q = idx[[0, 30, 60, 90]]
    for _ in range(2):
        je.query(jnp.asarray(q), 5)
        te.query(q, 5)
    m = te.metrics()
    life = m["lifecycle"]
    assert life == je.metrics()["lifecycle"]
    assert life["live_docs"] == 100
    assert life["head"]["rows"] == 4 and life["head"]["hits"] == 2
    assert len(life["segments"]) == 4
    assert sum(s["hits"] for s in life["segments"]) >= 2
    for s in life["segments"]:
        assert s["width"] == tiny[2].n_bins
        assert s["age_min"] == 7.0  # from the ManualClock; docs born at 0
    assert life["width_mix"] == {str(tiny[2].n_bins): 100}  # the head counts too
    assert life["tombstone_density"] == 0.0
    je.delete([0, 1, 2])
    te.delete([0, 1, 2])
    life2 = te.metrics()["lifecycle"]
    assert life2["tombstone_density"] > 0.0
    assert life2 == je.metrics()["lifecycle"]
    json.dumps(m)  # the whole snapshot is JSON-safe


def test_mixed_width_traces_and_hits_match(tiny):
    """After a distillation to N/2 and new head rows, a sampled query scores
    both widths: the widths touched, the per-width counters and the hits
    equal the reference's (the fold itself is timed by no stage)."""
    je, te = _banded_pair(tiny, n=48, seal_rows=24)
    n_half = tiny[2].n_bins // 2
    je.distill(widths=(n_half,), background=False)
    te.distill(widths=(n_half,))
    idx = tiny[4]
    je.add(jnp.asarray(idx[48:56]))
    te.add(idx[48:56])
    with telemetry() as ((jreg, jcol), (treg, tcol)):
        je.query(jnp.asarray(idx[:8]), 5, prefilter=False)
        te.query(idx[:8], 5, prefilter=False)
        ttr = tcol.last()
        assert ttr["widths"] == sorted([n_half, tiny[2].n_bins])
        assert _structure(ttr) == _structure(jcol.last())
        assert treg.snapshot()["counters"] == jreg.snapshot()["counters"]
    assert te.metrics()["lifecycle"] == je.metrics()["lifecycle"]


def test_metrics_snapshot_acceptance_fields(tiny):
    """``metrics()`` carries the reference's keys, nested, JSON-safe: stage
    histograms, per-segment counters, lifecycle gauges, the probe slot,
    health, prefilter and the last trace."""
    je, te = _banded_pair(tiny)
    rows = tiny[4][:8]
    with telemetry():
        je.query(jnp.asarray(rows), 5)
        te.query(rows, 5)
        jm = json.loads(json.dumps(je.metrics()))
        m = json.loads(json.dumps(te.metrics()))
    assert set(m) == set(jm)
    assert _key_tree(m) == _key_tree(jm)
    assert set(m["histograms"]) == set(jm["histograms"])
    assert m["armed"] is True
    assert any(k.startswith("query.stage.") for k in m["histograms"])
    assert {"p50", "p99", "count"} <= set(next(iter(m["histograms"].values())))
    assert all("hits" in s and "tombstones" in s and "width" in s
               for s in m["lifecycle"]["segments"])
    assert "tombstone_density" in m["lifecycle"] and "width_mix" in m["lifecycle"]
    assert set(m["probe"]) == {"recall", "at", "runs"}
    assert "jobs" in m["health"] and "degraded" in m["health"]
    assert m["last_trace"]["path"] == "query"
    assert m["prefilter"] == jm["prefilter"]
    disarmed = te.metrics()
    assert disarmed["armed"] is False and "last_trace" not in disarmed
    assert set(disarmed) == set(je.metrics())


# ----------------------------------------------------------------- probe
def test_recall_probe_agrees_with_exact_ground_truth(tiny):
    """The port's probe publishes the JAX probe's recall at the same seed,
    which equals the recall recomputed from ``exact_topk`` and the engine's
    own answers; the supervisor accounts for the op as the reference's."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    n, k = 80, 5
    je = JEngine.build(jcfg, jmap, jnp.asarray(idx[:n]), backend="oracle")
    te = SketchEngine.build(tcfg, tmap, idx[:n], backend="reference")
    ids = np.arange(n)
    with telemetry() as ((jreg, _), (treg, _)):
        jpr = JRecallProbe(je, k=k, sample=16, seed=3)
        assert jpr.launch(ids, idx[:n])
        jgot = jpr.wait()
        pr = RecallProbe(te, k=k, sample=16, seed=3)
        assert pr.launch(ids, idx[:n])
        got = pr.wait()
        assert got is not None and 0.0 <= got <= 1.0
        assert got == jgot
        assert treg.gauge("probe.recall") == got
        assert treg.counter("probe.runs") == 1
    # independent recomputation over the same seeded query sample
    pick = np.random.default_rng(3).choice(n, 16, replace=False)
    queries = idx[:n][pick]
    truth_ids = ids[exact_topk(idx[:n], queries, k, device=CPU)]
    got_ids = te.query(queries, k)[1].numpy()
    hits = sum(len(set(got_ids[i].tolist()) & set(truth_ids[i].tolist()))
               for i in range(len(queries)))
    assert got == hits / (len(queries) * k)
    jh, th = je.health(), te.health()
    assert th["jobs"] == jh["jobs"] == {"probe": {"launched": 1, "succeeded": 1, "failed": 0,
                                                  "retries": 0, "abandoned": 0, "refused": 0}}
    assert th["latency_s"]["probe"]["count"] == jh["latency_s"]["probe"]["count"] == 1


def test_probe_is_single_flight_and_supervised(tiny):
    """The reference's ``test_probe_runs_off_thread_and_is_single_flight``:
    here the truth is a supervised op enqueued on the caller's thread (a
    side stream on the card), so no thread starts; one probe in flight."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    te = SketchEngine.build(tcfg, tmap, idx[:40], backend="reference")
    before = set(threading.enumerate())
    with telemetry():
        pr = RecallProbe(te, k=3, sample=8, seed=0)
        assert pr.launch(np.arange(40), idx[:40])
        assert set(threading.enumerate()) <= before  # no worker thread
        assert pr.running
        assert not pr.launch(np.arange(40), idx[:40])  # single in-flight probe
        assert pr.wait() is not None
        assert not pr.running
        assert pr.snapshot()["runs"] == 1
        assert set(pr.snapshot()) == set(JRecallProbe(None, clock=lambda: 0.0).snapshot())


def test_probe_failure_leaves_gauge_stale_and_device_fault_propagates(tiny, monkeypatch):
    """A failing ground truth is retried, then recorded as a failed ``probe``
    op with the gauge left at its last reading (as the reference's worker
    failure); a quarantined op refuses the launch; a fault of the card
    propagates out of ``launch``."""
    _, _, tcfg, tmap, idx = tiny
    sup = JobSupervisor(SupervisionPolicy(max_retries=1, backoff_base=0.0, backoff_cap=0.0,
                                          quarantine_after=1, probation=60.0),
                        clock=obs.ManualClock())
    te = SketchEngine.build(tcfg, tmap, idx[:40], backend="reference", supervisor=sup)
    rows, ids = idx[:40], np.arange(40)
    with telemetry() as (_, (treg, _)):
        pr = RecallProbe(te, k=3, sample=8, seed=0)
        assert pr.launch(ids, rows)
        first = pr.wait()
        assert first is not None

        def broken(*a, **k):
            raise ValueError("truth failed")

        monkeypatch.setattr(probe_mod, "exact_topk_positions", broken)
        assert pr.launch(ids, rows)
        assert pr.wait() == first and not pr.running  # stale, not raised
        assert treg.gauge("probe.recall") == first and treg.counter("probe.runs") == 1
        jobs_ = te.health()["jobs"]["probe"]
        assert (jobs_["launched"], jobs_["succeeded"], jobs_["failed"], jobs_["retries"]) \
            == (2, 1, 1, 1)
        assert te.health()["last_error"]["error"] == "ValueError: truth failed"
        assert not pr.launch(ids, rows)  # ("recall", 1) is quarantined now
        assert te.health()["jobs"]["probe"]["refused"] == 1

        def card_fault(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(probe_mod, "exact_topk_positions", card_fault)
        pr.runs = 2  # a fresh (op, key): not quarantined
        with pytest.raises(RuntimeError, match="CUDA error"):
            pr.launch(ids, rows)
        assert not pr.running


# ----------------------------------------------------------------- clock
def test_one_manual_clock_drives_ttl_supervision_and_metrics(tiny):
    """One injected ManualClock is the time source of lazy TTL expiry (no
    explicit ``now`` at query time), the supervisor and the registry's
    timestamp, in both packages alike."""
    jcfg, jmap, tcfg, tmap, idx = tiny
    jclock, tclock = jobs.ManualClock(0.0), obs.ManualClock(0.0)
    je = JEngine.build(jcfg, jmap, backend="oracle", mutable=True, ttl=5.0, clock=jclock)
    te = SketchEngine.build(tcfg, tmap, backend="reference", mutable=True, ttl=5.0,
                            clock=tclock)
    je.add(jnp.asarray(idx[:12]), now=0.0)
    te.add(idx[:12], now=0.0)
    try:
        jreg = je.enable_metrics()
        jids = []
        treg = te.enable_metrics()
        assert te.supervisor._clock() == 0.0 == je.supervisor._clock()
        ids0 = te.query(idx[:4], 3)[1].numpy()  # now from the clock: t=0
        jids.append(np.asarray(je.query(jnp.asarray(idx[:4]), 3)[1]))
        assert (ids0 >= 0).any()
        jclock.advance(10.0)
        tclock.advance(10.0)  # everything born at 0 is now past ttl=5
        ids1 = te.query(idx[:4], 3)[1].numpy()  # no explicit now
        jids.append(np.asarray(je.query(jnp.asarray(idx[:4]), 3)[1]))
        assert (ids1 == -1).all()
        np.testing.assert_array_equal(ids1, jids[1])
        assert treg.snapshot()["at"] == 10.0 == jreg.snapshot()["at"]
        assert te.metrics()["at"] == 10.0
        assert te.store.resolve_now() == 10.0 and te._auto_now(3.0) == 3.0
    finally:
        obs.disable()
        jobs.disable()


def test_supervision_health_reports_latency_quantiles():
    """The probe op's latency in ``health()``, with the reference's keys;
    the job is waited for through the supervisor (its thread joined)."""
    sup = JobSupervisor(clock=obs.ManualClock(0.0))
    job = sup.submit("probe", ("x", 0), lambda: 1)
    assert job is not None
    assert sup.wait(job) == "succeeded"
    lat = sup.health()["latency_s"]["probe"]
    jsup = JSupervisor(clock=jobs.ManualClock(0.0))
    assert jsup.wait(jsup.submit("probe", ("x", 0), lambda: 1)) == "succeeded"
    assert set(lat) == set(jsup.health()["latency_s"]["probe"])
    assert {"count", "mean_s", "max_s", "p50_s", "p99_s"} <= set(lat)
    assert lat["count"] == 1 and lat["p50_s"] >= 0.0


# ------------------------------------------------------- enable/disable
def test_enable_disable_idempotent_and_scoped():
    reg = obs.enable(clock=obs.ManualClock(1.0), sample=3, capacity=7)
    try:
        assert obs_metrics.active() is reg
        assert obs_trace.active().sample == 3
    finally:
        obs.disable()
    assert obs_metrics.active() is None and obs_trace.active() is None
    obs.disable()  # idempotent
    with obs_trace.scoped(obs_trace.TraceCollector()) as col:
        assert obs_trace.active() is col
    assert obs_trace.active() is None


# -------------------------------------------------- what a trace costs
class _FakeEvent:
    """Stands in for ``torch.cuda.Event`` on a host with no card: counts the
    events made and their synchronises; every stage reads 2 ms."""

    made = 0
    syncs = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1

    def record(self, stream=None):
        pass

    def synchronize(self):
        type(self).syncs += 1

    def elapsed_time(self, other):
        return 2.0


def test_disarmed_and_unsampled_queries_create_no_event_and_no_sync(tiny, monkeypatch):
    """A disarmed query and an armed but unsampled one create no CUDA event
    and call no synchronise; a sampled one, traced as on the card (the trace
    told the device is CUDA), makes two events a stage and synchronises once,
    in ``finish``."""
    syncs = []
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(_FakeEvent, "syncs", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(1))
    start = obs_trace.start
    monkeypatch.setattr(obs_trace, "start",
                        lambda path, n, k, device=None: start(path, n, k, "cuda"))
    _, te = _banded_pair(tiny)
    rows = tiny[4][[0, 30, 60, 90]]
    te.query(rows, 5)  # disarmed
    assert (_FakeEvent.made, _FakeEvent.syncs, len(syncs)) == (0, 0, 0)
    with telemetry(sample=2) as (_, (treg, tcol)):
        te.query(rows, 5)  # sampled
        made, n_sync = _FakeEvent.made, _FakeEvent.syncs
        te.query(rows, 5)  # unsampled
        assert (_FakeEvent.made, _FakeEvent.syncs) == (made, n_sync)
        tr = tcol.last()
        hist = treg.snapshot()["histograms"]
    n_stages = sum(round(v / 2e-3) for v in tr["stages_s"].values())
    assert made == 2 * n_stages and n_stages >= len(obs_trace.STAGES)
    assert n_sync == 1 and not syncs  # one event synchronise, no device-wide one
    for name, v in tr["stages_s"].items():
        assert hist[f"query.stage.{name}_s"]["sum"] == v


def test_cpu_stage_times_need_no_event(tiny, monkeypatch):
    """On the CPU a sampled query times its stages with the host clock: no
    event, no synchronise, and every stage present with a time."""
    monkeypatch.setattr(torch.cuda, "Event", None)
    monkeypatch.setattr(torch.cuda, "synchronize", None)
    _, te = _banded_pair(tiny)
    with telemetry() as (_, (_, tcol)):
        te.query(tiny[4][[0, 30, 60, 90]], 5)
        tr = tcol.last()
    assert list(tr["stages_s"]) == list(obs_trace.STAGES)
    assert all(v >= 0.0 for v in tr["stages_s"].values())


# ------------------------------------------------------------------ serve
def test_serve_metrics_json_keys_match_reference_and_probe_gate(tmp_path, capsys):
    """``serve --metrics-json`` writes a snapshot with the JAX serve's keys
    (nested) and counter and histogram names on the same arguments; the port's
    serve leaves nothing armed; ``--probe-baseline`` outside ``--probe-tol``
    exits nonzero."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    args = ["--dataset", "tiny", "--queries", "16", "--topk", "5", "--prefilter", "--probe", "8",
            "--stats-every", "1"]
    tserve.main(args + ["--backend", "reference", "--device", CPU,
                        "--metrics-json", str(tmp_path / "t.json")])
    assert obs_metrics.active() is None and obs_trace.active() is None
    try:
        jserve.main(args + ["--backend", "oracle", "--metrics-json", str(tmp_path / "j.json")])
    finally:
        jobs.disable()
    t = json.loads((tmp_path / "t.json").read_text())
    j = json.loads((tmp_path / "j.json").read_text())
    assert _key_tree(t, depth=4) == _key_tree(j, depth=4)
    assert set(t["counters"]) == set(j["counters"])
    assert set(t["histograms"]) == set(j["histograms"])
    assert t["counters"]["query.calls"] == j["counters"]["query.calls"] == 2
    assert t["probe"]["runs"] == 1 and t["probe"]["recall"] is not None
    assert "stats: batch 1: calls=1 rows=16" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tserve.main(args + ["--backend", "reference", "--device", CPU,
                            "--probe-baseline", "0.0", "--probe-tol", "0.01"])
    assert e.value.code not in (None, 0)
    assert obs_metrics.active() is None

