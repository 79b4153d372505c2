"""MetricsRegistry — counters, gauges, log-bucketed histograms (the port of
``repro.obs.metrics``).

Standard library only, so any module of the port can import it without a
cycle. Arming follows :mod:`repro_torch.faults` exactly: one module-global
``_ACTIVE`` registry, :func:`install` / :func:`clear` / :func:`active` /
:func:`scoped`, and free helpers (:func:`inc`, :func:`observe`,
:func:`set_gauge`) whose disarmed body is a single ``None`` check, so
instrumentation stays in place and costs nothing without a registry.

Histograms are log-bucketed (DDSketch-style): a value ``v`` lands in bucket
``ceil(log_gamma(v))`` with ``gamma = (1+a)/(1-a)``, and a quantile is the
geometric midpoint of its bucket, which bounds the relative error of every
quantile by ``a`` (default 5%). Buckets are a sparse dict. The supervisor
keeps its job latencies in them.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Iterator, Optional

from .clock import Clock, ensure_clock

__all__ = [
    "Histogram",
    "MetricsRegistry",
    "active",
    "clear",
    "inc",
    "install",
    "observe",
    "scoped",
    "set_gauge",
]


class Histogram:
    """Streaming log-bucketed histogram with bounded relative error.

    ``observe(v)`` is O(1); ``quantile(q)`` walks the sorted sparse
    buckets (tens, in practice). Values below ``min_value`` (including
    zero — durations can round to it) count in a dedicated zero bucket
    reported as 0.0. Not thread-safe by itself; the registry serializes
    access, and standalone users (supervision) already hold their own
    lock.
    """

    __slots__ = ("alpha", "_gamma", "_lg", "_min", "_buckets", "_zero",
                 "count", "sum", "min", "max")

    def __init__(self, alpha: float = 0.05, min_value: float = 1e-9):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0,1), got {alpha}")
        self.alpha = float(alpha)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self._min = float(min_value)
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v < self._min:
            self._zero += 1
            return
        i = math.ceil(math.log(v) / self._lg)
        self._buckets[i] = self._buckets.get(i, 0) + 1

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` in [0,1], relative error <= alpha."""
        if self.count == 0:
            return 0.0
        # rank 0 is the smallest observation (q=0 -> min, q=1 -> max)
        rank = min(self.count - 1, int(q * self.count))
        if rank < self._zero:
            return 0.0
        seen = self._zero
        for i in sorted(self._buckets):
            seen += self._buckets[i]
            if rank < seen:
                # geometric midpoint of (gamma^(i-1), gamma^i]
                return 2.0 * self._gamma ** i / (self._gamma + 1.0)
        return self.max  # unreachable unless counts drifted

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
        return {
            "count": int(self.count),
            "sum": float(self.sum),
            "min": float(self.min),
            "max": float(self.max),
            "mean": float(self.mean),
            "p50": float(self.quantile(0.50)),
            "p90": float(self.quantile(0.90)),
            "p99": float(self.quantile(0.99)),
        }


class MetricsRegistry:
    """Named counters + gauges + histograms behind one lock.

    Names are dotted strings (``"jobs.compact.latency_s"``); the
    snapshot keeps them verbatim, the Prometheus formatter rewrites
    them to ``repro_jobs_compact_latency_s``.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 alpha: float = 0.05):
        self._clock: Clock = ensure_clock(clock)
        self._alpha = float(alpha)
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    @property
    def clock(self) -> Clock:
        return self._clock

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def set_gauge(self, name: str, v: float) -> None:
        with self._lock:
            self._gauges[name] = float(v)

    def observe(self, name: str, v: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(alpha=self._alpha)
            h.observe(v)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def snapshot(self) -> dict:
        """JSON-safe dict: plain str keys, int/float leaves only."""
        with self._lock:
            return {
                "at": float(self._clock()),
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in sorted(self._hists.items())},
            }

    def to_prometheus(self, prefix: str = "repro") -> str:
        """Text exposition format (one sample per line, quantiles as
        summary labels) — what a scrape endpoint would serve."""
        snap = self.snapshot()
        out = []

        def _name(raw: str) -> str:
            return prefix + "_" + "".join(
                c if (c.isalnum() or c == "_") else "_" for c in raw)

        for k in sorted(snap["counters"]):
            n = _name(k)
            out.append(f"# TYPE {n} counter")
            out.append(f"{n} {snap['counters'][k]}")
        for k in sorted(snap["gauges"]):
            n = _name(k)
            out.append(f"# TYPE {n} gauge")
            out.append(f"{n} {snap['gauges'][k]}")
        for k, h in snap["histograms"].items():
            n = _name(k)
            out.append(f"# TYPE {n} summary")
            for q in ("0.5", "0.9", "0.99"):
                p = h[{"0.5": "p50", "0.9": "p90", "0.99": "p99"}[q]]
                out.append(f'{n}{{quantile="{q}"}} {p}')
            out.append(f"{n}_sum {h['sum']}")
            out.append(f"{n}_count {h['count']}")
        return "\n".join(out) + "\n"


# --------------------------------------------------------------------------
# Module-global arming — the faults.py pattern. Disarmed, every helper is
# one attribute load + None-check; no registry, no lock, no dict touch.

_ACTIVE: Optional[MetricsRegistry] = None


def install(registry: MetricsRegistry) -> MetricsRegistry:
    global _ACTIVE
    _ACTIVE = registry
    return registry


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[MetricsRegistry]:
    return _ACTIVE


@contextlib.contextmanager
def scoped(registry: MetricsRegistry) -> Iterator[MetricsRegistry]:
    prev = active()
    install(registry)
    try:
        yield registry
    finally:
        install(prev) if prev is not None else clear()


def inc(name: str, n: int = 1) -> None:
    reg = _ACTIVE
    if reg is None:
        return
    reg.inc(name, n)


def set_gauge(name: str, v: float) -> None:
    reg = _ACTIVE
    if reg is None:
        return
    reg.set_gauge(name, v)


def observe(name: str, v: float) -> None:
    reg = _ACTIVE
    if reg is None:
        return
    reg.observe(name, v)
