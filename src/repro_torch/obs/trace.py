"""Sampled per-query traces (the port of ``repro.obs.trace``).

A :class:`QueryTrace` is one query call's worth of structure: per-stage time
(``rebucket`` -> ``band_lookup`` -> ``candidate_gather`` -> ``kernel_score``
-> ``merge``), the candidate fraction each segment contributed, the sketch
widths touched, which degraded modes fired, and whether ``k`` overflowed the
live corpus. The engine threads the trace through its query internals; every
instrumentation site is guarded by ``tr is not None``, so a disarmed or
unsampled query pays one ``None`` check per site (the contract of
:mod:`.metrics`).

What a stage time means. On the CPU a stage is host ``perf_counter`` time
around its work, which is exact: the work is done when the call returns. On
the card a kernel launch returns at once, so a host clock read after it
measures the launch, not the work. A sampled query on a CUDA device therefore
records a pair of ``torch.cuda.Event(enable_timing=True)`` on the current
stream around each stage (:meth:`QueryTrace.begin` / :meth:`QueryTrace.end`),
and :meth:`TraceCollector.finish` resolves them all after one synchronise of
the last event. A stage time on the card is the elapsed time on the stream
between its two events: the device work the stage enqueued, plus any time the
stream sat idle while the host prepared that work (the bucket lookup of
``band_lookup`` is host numpy, so it shows as idle stream time). Every kernel
a stage launches lies between its events, so a stage is never shorter than
its kernels. The stages of one query tile the stream's timeline of that
query; ``duration_s`` is the host time from start to the resolved finish,
which includes the device work. An unsampled or disarmed query creates no
event and calls no synchronise.

The collector keeps the last ``capacity`` traces in a ring and, when a
:class:`~repro_torch.obs.metrics.MetricsRegistry` is attached, folds every
finished trace into it: ``query.stage.<stage>_s`` histograms,
``query.candidate_frac``, per-width touch counters and per-component degraded
counters. (``query.calls`` / ``query.rows`` / ``query.k_overflow`` come from
the engine itself, so they stay exact under sampling.)
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional

import torch

from . import metrics as _metrics
from .clock import Clock, ensure_clock

__all__ = [
    "QueryTrace",
    "TraceCollector",
    "STAGES",
    "active",
    "clear",
    "finish",
    "install",
    "scoped",
    "start",
]

#: Canonical stage names, in pipeline order. A single-segment unbanded query
#: skips band_lookup/candidate_gather (and merge); a banded multi-segment
#: query exercises all five.
STAGES = ("rebucket", "band_lookup", "candidate_gather", "kernel_score", "merge")


class QueryTrace:
    """One sampled query call. Mutated in place by the engine, then handed
    back to :func:`finish`. ``device`` is the engine's: a CUDA device times
    stages with events, anything else with the host clock."""

    __slots__ = ("path", "n_queries", "k", "started_at", "duration_s", "stages", "segments",
                 "widths", "degraded", "k_overflow", "_t0", "_events", "_pending")

    def __init__(self, path: str, n_queries: int, k: int, started_at: float, device=None):
        self.path = path  # "query"
        self.n_queries = int(n_queries)
        self.k = int(k)
        self.started_at = float(started_at)
        self.duration_s = 0.0
        self.stages: Dict[str, float] = {}
        # per-segment candidate stats: (label, rows, candidates)
        self.segments: List[dict] = []
        self.widths: List[int] = []
        self.degraded: List[str] = []
        self.k_overflow = False
        self._events = device is not None and torch.device(device).type == "cuda"
        self._pending: list = []  # (stage, start event, end event) until finish
        self._t0 = time.perf_counter()

    # -- engine-side recording hooks ------------------------------------
    def begin(self):
        """Mark the start of a stage: an event recorded on the current
        stream on the card, the host clock elsewhere."""
        if self._events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def end(self, name: str, mark) -> None:
        """Close the stage ``name`` opened by :meth:`begin` (``mark``). On the
        card the pair is kept and resolved in :meth:`resolve`."""
        if self._events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._pending.append((name, mark, ev))
        else:
            self.add_stage(name, time.perf_counter() - mark)

    def add_stage(self, name: str, dt: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + float(dt)

    def note_segment(self, label: str, rows: int, candidates: int) -> None:
        self.segments.append({
            "segment": label,
            "rows": int(rows),
            "candidates": int(candidates),
            "candidate_frac": float(candidates) / float(rows) if rows else 0.0,
        })

    def note_width(self, n_bins: int) -> None:
        if int(n_bins) not in self.widths:
            self.widths.append(int(n_bins))

    def note_degraded(self, component: str) -> None:
        self.degraded.append(str(component))

    def resolve(self) -> None:
        """Fold the pending event pairs into :attr:`stages` after one
        synchronise of the last event (events of one stream complete in
        order), then stamp :attr:`duration_s`."""
        if self._pending:
            self._pending[-1][2].synchronize()
            for name, start, stop in self._pending:
                self.add_stage(name, start.elapsed_time(stop) / 1e3)
            self._pending = []
        self.duration_s = time.perf_counter() - self._t0

    # -- derived --------------------------------------------------------
    @property
    def candidate_frac(self) -> Optional[float]:
        rows = sum(s["rows"] for s in self.segments)
        if rows == 0:
            return None
        return sum(s["candidates"] for s in self.segments) / rows

    def snapshot(self) -> dict:
        """JSON-safe record, the reference's trace schema; ``stages_s`` is
        listed in :data:`STAGES` order."""
        order = {name: i for i, name in enumerate(STAGES)}
        stages = sorted(self.stages.items(), key=lambda kv: order.get(kv[0], len(STAGES)))
        return {
            "path": self.path,
            "n_queries": self.n_queries,
            "k": self.k,
            "started_at": self.started_at,
            "duration_s": self.duration_s,
            "stages_s": {k: float(v) for k, v in stages},
            "segments": list(self.segments),
            "candidate_frac": self.candidate_frac,
            "widths": sorted(self.widths),
            "degraded": list(self.degraded),
            "k_overflow": bool(self.k_overflow),
        }


class TraceCollector:
    """Sampling + retention + registry export for query traces."""

    def __init__(self, sample: int = 1, capacity: int = 64,
                 clock: Optional[Callable[[], float]] = None,
                 registry: Optional[_metrics.MetricsRegistry] = None):
        if sample < 1:
            raise ValueError(f"sample must be >= 1, got {sample}")
        self.sample = int(sample)
        self.clock: Clock = ensure_clock(clock)
        self.registry = registry
        self._lock = threading.Lock()
        self._calls = 0
        self._ring: deque = deque(maxlen=int(capacity))

    def maybe_start(self, path: str, n_queries: int, k: int, device=None
                    ) -> Optional[QueryTrace]:
        with self._lock:
            self._calls += 1
            if (self._calls - 1) % self.sample != 0:
                return None
        return QueryTrace(path, n_queries, k, started_at=self.clock(), device=device)

    def finish(self, tr: QueryTrace) -> None:
        tr.resolve()
        with self._lock:
            self._ring.append(tr)
        reg = self.registry
        if reg is None:
            return
        # query.calls / query.rows / query.k_overflow are counted by the
        # engine on every call (exact under sampling); the collector exports
        # only what a sampled trace observes
        reg.observe(f"query.{tr.path}_s", tr.duration_s)
        for name, dt in tr.stages.items():
            reg.observe(f"query.stage.{name}_s", dt)
        cf = tr.candidate_frac
        if cf is not None:
            reg.observe("query.candidate_frac", cf)
        for w in tr.widths:
            reg.inc(f"query.width.{w}")
        for component in tr.degraded:
            reg.inc(f"query.degraded.{component}")

    def traces(self) -> List[dict]:
        with self._lock:
            return [t.snapshot() for t in self._ring]

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._ring[-1].snapshot() if self._ring else None


# --------------------------------------------------------------------------
# Module-global arming, mirroring metrics/faults.

_ACTIVE: Optional[TraceCollector] = None


def install(collector: TraceCollector) -> TraceCollector:
    global _ACTIVE
    _ACTIVE = collector
    return collector


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[TraceCollector]:
    return _ACTIVE


@contextlib.contextmanager
def scoped(collector: TraceCollector) -> Iterator[TraceCollector]:
    prev = active()
    install(collector)
    try:
        yield collector
    finally:
        install(prev) if prev is not None else clear()


def start(path: str, n_queries: int, k: int, device=None) -> Optional[QueryTrace]:
    """A trace for this call when a collector is armed and samples it, else
    None. ``device`` picks the stage clock (see the module docstring)."""
    col = _ACTIVE
    if col is None:
        return None
    return col.maybe_start(path, n_queries, k, device)


def finish(tr: Optional[QueryTrace]) -> None:
    if tr is None:
        return
    col = _ACTIVE
    if col is not None:
        col.finish(tr)
