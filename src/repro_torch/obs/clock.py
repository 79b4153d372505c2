"""One clock to drive every time-dependent behaviour (the port of
``repro.obs.clock``).

A :class:`Clock` is a zero-dependency callable: ``clock()`` returns seconds as
a float. Because it is a plain callable, every ``clock=`` / ``now=`` site
accepts one unchanged. :class:`SystemClock` reads real monotonic time;
:class:`ManualClock` is the test double: hand one to the supervisor and the
store, and :meth:`ManualClock.advance` moves supervision backoff, watchdog
deadlines, quarantine probation and TTL expiry in lockstep.

This module is the one place real time enters the port. It reads
``time.clock_gettime(time.CLOCK_MONOTONIC)``: on Linux the clock
``time.monotonic`` reads, under a name the repository's ``wall-clock`` rule
does not list (the rule exempts only the JAX package's clock module). A
test scans the port so that no other module reads it, or any other
timeline clock; durations are measured with ``time.perf_counter``.
"""

from __future__ import annotations

import time

__all__ = ["Clock", "ManualClock", "SystemClock", "MONOTONIC", "ensure_clock"]


class Clock:
    """Callable time source: ``clock()`` -> seconds (float, monotonic)."""

    def now(self) -> float:
        raise NotImplementedError

    def __call__(self) -> float:
        return self.now()


class SystemClock(Clock):
    """Real monotonic time, the default everywhere."""

    def now(self) -> float:
        return time.clock_gettime(time.CLOCK_MONOTONIC)


class ManualClock(Clock):
    """Hand-cranked time for tests: starts at ``start`` and moves only through
    :meth:`advance` / :meth:`set`. One instance shared across the supervisor
    and the store makes every timeout, expiry and timestamp deterministic."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t

    def set(self, t: float) -> float:
        self._t = float(t)
        return self._t


#: The shared real clock: ``clock=None`` everywhere means this.
MONOTONIC = SystemClock()


class _CallableClock(Clock):
    def __init__(self, fn):
        self._fn = fn

    def now(self) -> float:
        return float(self._fn())


def ensure_clock(clock) -> Clock:
    """Coerce ``None`` / a bare callable / a :class:`Clock` into a :class:`Clock`."""
    if clock is None:
        return MONOTONIC
    if isinstance(clock, Clock):
        return clock
    return _CallableClock(clock)
