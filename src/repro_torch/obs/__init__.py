"""repro_torch.obs — the telemetry plane (the port of ``repro.obs``).

==============================  ============================================
module                          what it holds
==============================  ============================================
:mod:`repro_torch.obs.clock`    one injectable time source (`Clock`,
                                `ManualClock`) shared by supervision, TTL,
                                ages and metrics
:mod:`repro_torch.obs.metrics`  `MetricsRegistry`: counters / gauges /
                                log-bucketed histograms, JSON snapshot,
                                Prometheus text
:mod:`repro_torch.obs.trace`    sampled per-query `QueryTrace` (stage times,
                                on the card from CUDA events; candidate
                                fractions, widths, degraded hits)
:mod:`repro_torch.obs.probe`    `RecallProbe`: online recall against exact
                                ground truth, supervised; `exact_topk`
==============================  ============================================

Arming follows :mod:`repro_torch.faults`: a module-global registry and
collector that the engine's instrumentation checks with a single ``is None``
when disarmed. :func:`enable` / :func:`disable` flip both at once::

    from repro_torch import obs
    reg = obs.enable()            # arm metrics + tracing
    engine.query(q, k)
    print(engine.metrics())       # JSON-safe composite snapshot
    obs.disable()
"""

from __future__ import annotations

from typing import Callable, Optional

from . import metrics, trace
from .clock import MONOTONIC, Clock, ManualClock, SystemClock, ensure_clock
from .metrics import Histogram, MetricsRegistry
from .probe import RecallProbe, exact_topk
from .trace import STAGES, QueryTrace, TraceCollector

__all__ = [
    "Clock",
    "Histogram",
    "ManualClock",
    "MetricsRegistry",
    "MONOTONIC",
    "QueryTrace",
    "RecallProbe",
    "STAGES",
    "SystemClock",
    "TraceCollector",
    "disable",
    "enable",
    "ensure_clock",
    "exact_topk",
    "metrics",
    "trace",
]


def enable(clock: Optional[Callable[[], float]] = None, *, sample: int = 1,
           capacity: int = 64, alpha: float = 0.05) -> MetricsRegistry:
    """Arm the telemetry plane: install a fresh `MetricsRegistry` and a
    `TraceCollector` feeding it. Returns the registry (also reachable via
    ``metrics.active()``)."""
    reg = metrics.install(MetricsRegistry(clock=clock, alpha=alpha))
    trace.install(TraceCollector(sample=sample, capacity=capacity, clock=clock, registry=reg))
    return reg


def disable() -> None:
    """Disarm both metrics and tracing (instrumentation reverts to the
    one-None-check path)."""
    metrics.clear()
    trace.clear()
