"""LifecycleController — the hands-off maintenance loop (the port of
``repro.engine.lifecycle``).

The store's maintenance verbs (``compact_async``, ``distill_async``) are
operator-pulled; the controller pulls them from observed signals instead:

  signal                               policy                  action
  ──────                               ──────                  ──────
  per-segment live / width          →  size-tiered merge    →  compact_async
  tombstone density per tier           (LSM-style buckets)     over one tier
  per-segment hits deltas + age     →  cold-set distill     →  distill_async
  sealed-slab bytes                 →  ladder under budget     (only=cold)
  probe.recall                      →  recall guardrail     →  halt distills,
                                                               abandon in-flight

As in the reference:

  1. **The query path is never touched.** Every action is one of the
     store's snapshot -> work -> swap jobs, launched on the caller's thread
     (the serving loop's heartbeat) with the engine's backend, so on
     ``cuda`` a merge's band keys and a distillation's index come from the
     ``band_hash`` kernel. A tick launches only while the store's one job
     slot is free (``job_pending is None``): ``compact_async`` and
     ``distill_async`` begin with ``wait_compaction()``, which a tick must
     never reach with a job in flight. At most one launch a tick.
  2. **Supervised.** The tick body runs under
     :meth:`JobSupervisor.run_inline`: a tick that raises is recorded
     (failure count, last error), consecutive failures quarantine the
     ``("lifecycle", ("tick",))`` pair, and the retry is the next tick.
     One difference: a fault that ``hopper.build.is_device_fault`` names (a
     kernel's failure, an error of the card, any error raised inside
     ``repro_torch.hopper``) is recorded as well and then re-raised by
     :meth:`LifecycleController.tick`, so no tick hides a kernel fault or an
     illegal memory access in a merge's snapshot or a probe launch. Every
     other exception is recorded and swallowed.
  3. **Deterministic.** Time comes only from the injected ``Clock`` or an
     explicit ``now``; there is no RNG.

The **recall guardrail**: a :class:`~repro_torch.obs.probe.RecallProbe`
reading below ``probe_baseline - probe_tol`` flips the controller to
``"halted"``: distillation stops, an in-flight distillation is abandoned
through the supervisor (its result never swaps in), the halt is recorded as
the degraded mode ``lifecycle_distill`` and counted
(``controller.guardrail_trips``). Merges go on while halted (they are
lossless); a recovered reading clears the halt.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Optional, Tuple

from ..hopper.build import is_device_fault
from ..obs import metrics as obs_metrics
from ..obs.clock import Clock, ensure_clock
from .segments import DistillPolicy, SegmentedStore

__all__ = ["ControllerPolicy", "LifecycleController"]

log = logging.getLogger("repro_torch.lifecycle")

# Controller states (strings: they go straight into controller_state() and
# log lines, as the supervisor's do).
STEADY = "steady"
HALTED = "halted"


@dataclasses.dataclass(frozen=True)
class ControllerPolicy:
    """The controller's knobs.

    **Tiers** (size-tiered merges): a sealed segment with ``live`` rows is in
    tier 0 while ``live <= tier_min_rows`` and in tier
    ``floor(log_factor(live / tier_min_rows)) + 1`` above. A ``(width,
    tier)`` bucket merges when it holds ``tier_fanout`` segments or its
    pooled tombstone density reaches ``tombstone_density``: one bucket a
    tick. With fanout F, churn that seals S segments leaves at most
    ``F * ceil(log_F S)`` segments a width.

    **Distillation**: the ladder (``distill_widths``) runs only while the
    sealed slabs' bytes exceed ``memory_budget`` (None: always; ``()``: never),
    and folds only **cold** segments: a hits delta since the last tick of at
    most ``cold_hits`` and a youngest live row at least ``cold_age`` old.

    **Guardrail**: with ``probe_baseline`` set, a probe reading below
    ``baseline - probe_tol`` halts distillation. ``probe_interval`` spaces the
    probe rounds the controller launches (None: it launches none, but still
    polls and honours a probe launched elsewhere)."""

    tier_min_rows: int = 16
    tier_factor: float = 4.0
    tier_fanout: int = 4
    tombstone_density: float = 0.25
    distill_widths: Tuple[int, ...] = ()
    memory_budget: Optional[int] = None
    cold_age: float = 60.0
    cold_hits: int = 0
    probe_baseline: Optional[float] = None
    probe_tol: float = 0.05
    probe_interval: Optional[float] = None

    def __post_init__(self):
        if self.tier_min_rows < 1:
            raise ValueError(f"tier_min_rows must be >= 1, got {self.tier_min_rows}")
        if self.tier_factor <= 1.0:
            raise ValueError(f"tier_factor must be > 1, got {self.tier_factor}")
        if self.tier_fanout < 2:
            raise ValueError(f"tier_fanout must be >= 2, got {self.tier_fanout}")
        if not 0.0 < self.tombstone_density <= 1.0:
            raise ValueError(
                f"tombstone_density must be in (0, 1], got {self.tombstone_density}")
        object.__setattr__(self, "distill_widths",
                           tuple(sorted((int(w) for w in self.distill_widths), reverse=True)))

    def tier(self, live: int) -> int:
        """Size tier of a segment with ``live`` rows (0: the smallest)."""
        if live <= self.tier_min_rows:
            return 0
        return int(math.log(live / self.tier_min_rows, self.tier_factor)) + 1

    def snapshot(self) -> dict:
        def opt(v, cast):
            return cast(v) if v is not None else None

        return {
            "tier_min_rows": int(self.tier_min_rows),
            "tier_factor": float(self.tier_factor),
            "tier_fanout": int(self.tier_fanout),
            "tombstone_density": float(self.tombstone_density),
            "distill_widths": [int(w) for w in self.distill_widths],
            "memory_budget": opt(self.memory_budget, int),
            "cold_age": float(self.cold_age),
            "cold_hits": int(self.cold_hits),
            "probe_baseline": opt(self.probe_baseline, float),
            "probe_tol": float(self.probe_tol),
            "probe_interval": opt(self.probe_interval, float),
        }


class LifecycleController:
    """Closes the loop from telemetry to maintenance on one mutable engine::

        ctl = LifecycleController(engine, ControllerPolicy(...),
                                  probe=RecallProbe(engine),
                                  probe_feed=lambda: (surv_ids, surv_rows))
        ...serve loop...
            ctl.tick(now=serve_now)      # cheap; launches at most one job

    ``probe_feed`` returns the catalog a probe launch needs (aligned global
    ids and index rows): the store keeps sketches, not documents, so the
    truth comes from whoever keeps the rows. Without a feed the guardrail
    still reads probe rounds launched elsewhere. Attaching sets
    ``engine.controller``, so ``engine.metrics()["controller"]`` is
    :meth:`controller_state`; the engine never calls the controller."""

    def __init__(self, engine, policy: Optional[ControllerPolicy] = None, *, probe=None,
                 probe_feed: Optional[Callable[[], tuple]] = None,
                 clock: Optional[Callable[[], float]] = None):
        if not isinstance(engine.store, SegmentedStore):
            raise TypeError("LifecycleController needs a mutable engine (SegmentedStore): "
                            "an append-only SketchStore has no lifecycle to control")
        self.engine = engine
        self.policy = policy or ControllerPolicy()
        self.probe = probe
        self.probe_feed = probe_feed
        self.clock: Clock = ensure_clock(
            clock if clock is not None
            else (engine.clock if engine.clock is not None else engine.store.clock))
        self.state = STEADY
        self.ticks = 0
        self.failed_ticks = 0
        self.merges = 0
        self.distills = 0
        self.probes = 0
        self.guardrail_trips = 0
        self.abandoned_distills = 0
        self.halted_since: Optional[float] = None
        self.last_action: Optional[dict] = None
        self.last_tick_at: Optional[float] = None
        # per-segment hits at the last tick, valid within one layout epoch
        # only (indexes shift at every swap, and rewritten segments start at
        # zero hits, so a delta across epochs would lie)
        self._prev_hits: Dict[int, int] = {}
        self._prev_epoch: Optional[int] = None
        self._last_probe_launch: Optional[float] = None
        engine.controller = self

    # ------------------------------------------------------------------ tick
    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        """One supervised control step; it never blocks on background work.
        Returns the tick report, or None when the tick failed or the pair is
        quarantined (the next tick is the retry). A device fault is recorded
        and then raised (see the module docstring); nothing else is."""
        t = float(now) if now is not None else self.clock()
        fault: List[BaseException] = []

        def body():
            try:
                return self._tick(t)
            except Exception as e:
                if is_device_fault(e):
                    fault.append(e)
                raise

        report = self.engine.supervisor.run_inline("lifecycle", ("tick",), body)
        if report is None:
            self.failed_ticks += 1
            obs_metrics.inc("controller.failed_ticks")
        if fault:
            raise fault[0]
        return report

    def _tick(self, now: float) -> dict:
        st = self.engine.store
        self.ticks += 1
        self.last_tick_at = now
        obs_metrics.inc("controller.ticks")

        # 1. heartbeat: adopt finished background work (a failed or abandoned
        #    job is dropped by the store)
        swapped = st.poll_compaction()

        # 2. observe: one snapshot of the store's lifecycle gauges
        snap = st.lifecycle_snapshot(now=now)
        hits_delta = self._hits_deltas(st, snap)

        # 3. guardrail before any action, so a dip stops the next distill
        self._probe_step(now)
        self._guardrail_step(now, st)

        # 4. act: at most one launch, and only with the job slot free
        action = None
        if st.job_pending is None:
            action = self._maybe_merge(st, snap)
            if action is None and self.state != HALTED:
                action = self._maybe_distill(st, snap, hits_delta, now)
        if action is not None:
            self.last_action = dict(action, at=now)

        # 5. the hits baseline of the next tick's cold test
        self._prev_epoch = st._layout_epoch
        self._prev_hits = {ent["segment"]: ent["hits"] for ent in snap["segments"]}
        return {"at": now, "state": self.state, "swapped": bool(swapped), "action": action,
                "segments": len(snap["segments"]),
                "tombstone_density": snap["tombstone_density"]}

    # --------------------------------------------------------------- signals
    def _hits_deltas(self, st, snap) -> Dict[int, Optional[int]]:
        """Hits of each segment since the last tick; None when unknown (the
        first tick, or a layout change since), which counts as hot, so a
        fresh swap is never distilled at once."""
        same_epoch = self._prev_epoch == st._layout_epoch
        out: Dict[int, Optional[int]] = {}
        for ent in snap["segments"]:
            i = ent["segment"]
            prev = self._prev_hits.get(i) if same_epoch else None
            out[i] = ent["hits"] - prev if prev is not None else None
        return out

    def _probe_step(self, now: float) -> None:
        """Poll the probe for a landed reading; launch a round when one is
        due. A failing launch or feed fails the tick, not serving."""
        probe = self.probe
        if probe is None:
            return
        probe.poll(now=now)
        p = self.policy
        if p.probe_interval is None or self.probe_feed is None or probe.running:
            return
        if (self._last_probe_launch is not None
                and now - self._last_probe_launch < p.probe_interval):
            return
        surv_ids, surv_rows = self.probe_feed()
        if len(surv_ids) and probe.launch(surv_ids, surv_rows):
            self._last_probe_launch = now
            self.probes += 1
            obs_metrics.inc("controller.probes")

    def _guardrail_step(self, now: float, st) -> None:
        p = self.policy
        if p.probe_baseline is None or self.probe is None:
            return
        recall = self.probe.last_recall
        if recall is None:
            return
        floor = p.probe_baseline - p.probe_tol
        if recall < floor:
            if self.state != HALTED:
                self.state = HALTED
                self.halted_since = now
                self.guardrail_trips += 1
                obs_metrics.inc("controller.guardrail_trips")
                self.engine.supervisor.record_degraded(
                    "lifecycle_distill",
                    f"probe recall {recall:.3f} below floor {floor:.3f} "
                    f"(baseline {p.probe_baseline:.3f} - tol {p.probe_tol:.3f})")
                log.warning("guardrail tripped: recall %.3f < %.3f; distillation halted",
                            recall, floor)
            # an in-flight distillation is presumed tainted: the supervisor
            # drops its result; a running merge (lossless) goes on
            if st.abandon_compaction(op="distill"):
                self.abandoned_distills += 1
                obs_metrics.inc("controller.abandoned_distills")
        elif self.state == HALTED:
            self.state = STEADY
            self.halted_since = None
            self.engine.supervisor.clear_degraded("lifecycle_distill")
            obs_metrics.inc("controller.guardrail_recoveries")
            log.info("guardrail cleared: recall %.3f back above %.3f", recall, floor)

    # --------------------------------------------------------------- actions
    def _maybe_merge(self, st, snap) -> Optional[dict]:
        """Bucket sealed segments by ``(width, tier)`` and launch the first
        bucket, smallest tier first, over its occupancy or tombstone
        threshold."""
        p = self.policy
        buckets: Dict[Tuple[int, int], List[dict]] = {}
        for ent in snap["segments"]:
            buckets.setdefault((ent["width"], p.tier(ent["live"])), []).append(ent)
        for (width, tier), members in sorted(buckets.items(),
                                             key=lambda kv: (kv[0][1], kv[0][0])):
            rows = sum(e["rows"] for e in members)
            tomb = sum(e["tombstones"] for e in members)
            over_occupancy = len(members) >= p.tier_fanout
            over_density = rows > 0 and tomb / rows >= p.tombstone_density
            if not (over_occupancy or over_density):
                continue
            group = [e["segment"] for e in members]
            # False: nothing to reclaim (one clean segment); try the next bucket
            if st.compact_async(groups=[group], backend=self.engine.backend):
                self.merges += 1
                obs_metrics.inc("controller.merges")
                return {"kind": "merge", "width": int(width), "tier": int(tier),
                        "segments": [int(i) for i in group],
                        "trigger": "occupancy" if over_occupancy else "tombstones"}
        return None

    def _maybe_distill(self, st, snap, hits_delta, now) -> Optional[dict]:
        """Under memory pressure, fold the cold set one width down the
        ladder; a segment with hits since the last tick never folds."""
        p = self.policy
        if not p.distill_widths:
            return None
        if p.memory_budget is not None and self._sealed_bytes(snap) <= p.memory_budget:
            return None
        floor_w = p.distill_widths[-1]
        cold = [ent["segment"] for ent in snap["segments"]
                if ent["live"] > 0 and ent["width"] > floor_w
                and ent.get("age_min", 0.0) >= p.cold_age
                and hits_delta.get(ent["segment"]) is not None
                and hits_delta[ent["segment"]] <= p.cold_hits]
        if not cold:
            return None
        dp = DistillPolicy(widths=p.distill_widths, min_age=p.cold_age)
        if not st.distill_async(dp, now=now, only=cold, backend=self.engine.backend):
            return None
        self.distills += 1
        obs_metrics.inc("controller.distills")
        return {"kind": "distill", "segments": [int(i) for i in cold],
                "widths": [int(w) for w in p.distill_widths]}

    @staticmethod
    def _sealed_bytes(snap) -> int:
        """Bytes of the sealed slabs (rows x words x 4; tombstoned rows hold
        slab memory until merged out, so they count): what the budget bounds."""
        return sum(ent["rows"] * ((ent["width"] + 31) // 32) * 4 for ent in snap["segments"])

    # ----------------------------------------------------------------- state
    def controller_state(self) -> dict:
        """JSON-safe snapshot: ``SketchEngine.metrics()["controller"]``."""
        def opt(v):
            return float(v) if v is not None else None

        return {
            "state": self.state,
            "ticks": int(self.ticks),
            "failed_ticks": int(self.failed_ticks),
            "merges": int(self.merges),
            "distills": int(self.distills),
            "probes": int(self.probes),
            "guardrail_trips": int(self.guardrail_trips),
            "abandoned_distills": int(self.abandoned_distills),
            "halted_since": opt(self.halted_since),
            "last_tick_at": opt(self.last_tick_at),
            "last_action": dict(self.last_action) if self.last_action is not None else None,
            "policy": self.policy.snapshot(),
        }
