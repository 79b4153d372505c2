"""Deterministic, seeded fault injection (the port of ``repro.faults``).

The supervision layer (:mod:`repro_torch.engine.supervision`) exists to
survive maintenance failures; this module causes them, on demand and
reproducibly, so the tests can prove the survival story:

  1. **Zero overhead when disabled.** Every injection point is one
     module-global ``None`` check (``_ACTIVE is None``) on the hot path.
  2. **Deterministic.** A :class:`FaultPlan` is seeded: per point, the
     decision stream is a pure function of ``(seed, point, hit ordinal)``,
     drawn from ``random.Random`` exactly as the reference draws it, so a
     plan makes the same decisions in both packages.
  3. **Typed failure modes.** ``raise`` (a :class:`FaultError`, the
     transient error the supervisor retries), ``delay`` (a sleep, for
     watchdog paths), and ``torn-write`` (truncate a just-written file
     without raising: silent corruption only checkpoint CRCs can catch).

The injection points are named (:data:`POINTS`, the reference's set, so a
plan written for it validates here); a plan naming an unknown point fails at
construction. In the port they thread through the background compaction and
distillation workers, checkpoint write and restore, and band-index build and
lookup; the ``placement.*`` points have no port code yet.

Usage::

    plan = FaultPlan({"compact.work": FaultSpec("raise", times=2)}, seed=7)
    with faults.scoped(plan):
        ...            # first two compaction attempts raise FaultError
    plan.counters()    # {"hits": {...}, "fired": {...}}
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
import time
import zlib
from typing import Dict, Optional

__all__ = [
    "POINTS",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "active",
    "clear",
    "fire",
    "inject",
    "install",
    "scoped",
    "torn_write",
]

#: The named injection points (DESIGN.md §13 table). A FaultPlan naming a
#: point outside this set raises at construction.
POINTS = frozenset({
    "compact.work",        # background compaction merge (worker thread)
    "distill.work",        # background distillation fold (worker thread)
    "distill.corrupt",     # silently zero a distilled fold (recall-dip target)
    "band.build",          # BandIndex construction (seal / worker / restore)
    "band.lookup",         # BandIndex.candidates (query thread)
    "placement.build",     # SegmentPlacer.place (slab upload)
    "placement.refresh",   # WidthSlab.valid_mask (tombstone/TTL refresh)
    "checkpoint.write",    # whole checkpoint write job
    "checkpoint.leaf",     # per-leaf file write (torn-write target)
    "checkpoint.restore",  # per-generation read during restore/verify
})

_MODES = ("raise", "delay", "torn-write")


class FaultError(RuntimeError):
    """An injected failure. Transient by construction: the operation that
    raised it would succeed if simply re-run after the plan's trigger
    budget is spent — exactly the failure class the supervisor's
    retry/backoff loop is specified against."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """What happens at one injection point.

    ``mode``: ``"raise"`` | ``"delay"`` | ``"torn-write"``. ``p`` is the
    per-hit firing probability (1.0 = every eligible hit). ``times`` caps
    the total number of firings (None = unbounded) — ``times=2`` models a
    transient failure that clears on the third retry. ``after`` skips the
    first N hits (arm the fault mid-run). ``delay_s`` is the sleep for
    ``delay`` mode."""

    mode: str = "raise"
    p: float = 1.0
    times: Optional[int] = None
    after: int = 0
    delay_s: float = 0.02

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.times is not None and self.times < 0:
            raise ValueError(f"times must be >= 0, got {self.times}")
        if self.after < 0:
            raise ValueError(f"after must be >= 0, got {self.after}")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` per injection point, with
    deterministic per-point decision streams and thread-safe counters
    (injection points are hit from worker threads and the query thread
    concurrently)."""

    def __init__(self, specs: Dict[str, FaultSpec], seed: int = 0):
        unknown = set(specs) - POINTS
        if unknown:
            raise ValueError(
                f"unknown injection point(s) {sorted(unknown)}; "
                f"known: {sorted(POINTS)}"
            )
        self.specs = dict(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {p: 0 for p in specs}
        self._fired: Dict[str, int] = {p: 0 for p in specs}
        # one independent, seeded stream per point: the decision at hit k
        # of point P never depends on traffic at other points
        self._rng: Dict[str, random.Random] = {
            p: random.Random(self.seed ^ zlib.crc32(p.encode()))
            for p in specs
        }

    def decide(self, point: str) -> Optional[FaultSpec]:
        """Record a hit at ``point``; return the spec iff the fault fires."""
        spec = self.specs.get(point)
        if spec is None:
            return None
        with self._lock:
            k = self._hits[point]
            self._hits[point] = k + 1
            if k < spec.after:
                return None
            if spec.times is not None and self._fired[point] >= spec.times:
                return None
            if spec.p < 1.0 and self._rng[point].random() >= spec.p:
                return None
            self._fired[point] += 1
            return spec

    def counters(self) -> Dict[str, Dict[str, int]]:
        """{"hits": per-point reach counts, "fired": per-point injections}."""
        with self._lock:
            return {"hits": dict(self._hits), "fired": dict(self._fired)}

    @property
    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired.values())


_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan`` process-wide (one plan at a time)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    """Disarm fault injection (back to the zero-overhead path)."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def scoped(plan: FaultPlan):
    """``with faults.scoped(plan): ...`` — install for the block, always
    disarm on exit (the chaos tests' idiom; a failed assertion cannot leak
    an armed plan into the next test)."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def inject(point: str) -> None:
    """The injection point: no-op unless a plan is armed and fires.

    ``raise`` -> :class:`FaultError`; ``delay`` -> sleep; ``torn-write``
    at a pointless (no file) site degrades to ``raise`` so a misplanned
    spec is loud rather than silent."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan.decide(point)
    if spec is None:
        return
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return
    raise FaultError(f"injected fault at {point!r}")


def fire(point: str) -> bool:
    """Non-raising injection point: True iff an armed plan fires here.

    For faults whose *effect* lives in the instrumented code itself —
    e.g. ``distill.corrupt`` zeroes the fold it just computed so the swap
    installs garbage without any error surfacing. The supervisor cannot
    see this class of failure; only downstream verification (the recall
    probe) can — which is exactly what the guardrail tests need."""
    plan = _ACTIVE
    if plan is None:
        return False
    return plan.decide(point) is not None


def torn_write(point: str, path: str) -> bool:
    """File-targeted injection point: with a ``torn-write`` spec armed,
    truncate ``path`` to half its size and return True — *without*
    raising. The write path believes it succeeded; only content
    verification (checkpoint CRCs) can notice. ``raise``/``delay`` specs
    at this point behave as in :func:`inject`."""
    plan = _ACTIVE
    if plan is None:
        return False
    spec = plan.decide(point)
    if spec is None:
        return False
    if spec.mode == "delay":
        time.sleep(spec.delay_s)
        return False
    if spec.mode == "raise":
        raise FaultError(f"injected fault at {point!r}")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return True
