"""JobSupervisor — supervised lifecycle for background maintenance (the port
of ``repro.engine.supervision``).

A background maintenance failure must not become a serving failure: the
caller that adopts a background result is ``poll_compaction`` inside the
query path. The supervisor gives the store the classic supervision-tree
answer:

  * **retry with capped exponential backoff** — a failed attempt is
    relaunched against the *same snapshot* (snapshots are host copies; the
    swap reconciles against live tombstones, so a late retry is as correct
    as a fast first try), after ``backoff_base · factor^(attempt-1)``
    seconds, capped, at most ``max_retries`` times;
  * **watchdog deadlines** — an attempt still running past ``deadline``
    seconds is *abandoned*: its snapshot is dropped and its result, even if
    the thread produces one later, is never swapped in. Hangs are not
    retried;
  * **quarantine** — after ``quarantine_after`` consecutive exhausted
    launches of one ``(operation, key)`` pair, further launches of it are
    refused until ``probation`` seconds pass; then exactly one probe launch
    is allowed, and a healthy run clears the quarantine;
  * **degraded-mode bookkeeping** — query-path accelerators (the banded
    prefilter) that fail fall back to the exhaustive path and record a
    :class:`DegradedMode` here;
  * **health()** — one JSON-safe snapshot of all of the above.

All time comes from the injected clock (:mod:`repro_torch.obs.clock`), so a
``ManualClock`` drives backoff, deadlines and probation deterministically.
The invariant the module defends: **no maintenance error ever propagates
into a query**. ``poll()`` and ``wait()`` never raise; failed jobs leave the
store serving the consistent pre-swap state.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..checkpoint.manager import BackgroundJob
from ..obs import metrics as obs_metrics
from ..obs.clock import Clock, ensure_clock

__all__ = [
    "DegradedMode",
    "JobSupervisor",
    "SupervisedJob",
    "SupervisionPolicy",
]

log = logging.getLogger("repro_torch.supervision")

# Terminal/poll states (strings, not an enum: they go straight into health
# snapshots and log lines).
RUNNING = "running"
SUCCEEDED = "succeeded"
FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class SupervisionPolicy:
    """Retry / watchdog / quarantine knobs.

    ``max_retries`` is *re*-tries: a launch makes at most
    ``1 + max_retries`` attempts. ``deadline`` (seconds, None = no
    watchdog) bounds a single attempt's runtime; past it the attempt is
    abandoned, terminally. ``quarantine_after`` counts consecutive
    *exhausted launches* (not attempts) of one (op, key) pair before the
    pair is quarantined; ``probation`` is how long the quarantine holds
    before one probe launch is allowed through."""

    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_cap: float = 2.0
    deadline: Optional[float] = None
    quarantine_after: int = 3
    probation: float = 30.0

    def backoff(self, attempt: int) -> float:
        """Delay before attempt ``attempt+1`` (attempt counts from 1)."""
        return min(
            self.backoff_base * self.backoff_factor ** max(attempt - 1, 0),
            self.backoff_cap,
        )


@dataclasses.dataclass
class DegradedMode:
    """One degraded query-path component: the engine is serving correct
    results through a slower fallback (the exhaustive scan instead of the
    banded prefilter). ``reason`` is
    the first failure's message; ``count`` accumulates repeats."""

    component: str
    reason: str
    count: int = 1
    last_at: float = 0.0

    def snapshot(self) -> dict:
        return {
            "component": self.component,
            "reason": self.reason,
            "count": int(self.count),
            "last_at": float(self.last_at),
        }


class SupervisedJob:
    """One supervised background launch: a (re-launchable) work fn plus
    its retry/backoff/watchdog state. Construct via
    :meth:`JobSupervisor.submit`; advance via :meth:`JobSupervisor.poll`.
    Each attempt is ``attempt(fn)``: by default a
    :class:`~repro_torch.checkpoint.manager.BackgroundJob` (``fn`` on a
    daemon thread); any object with its ``done()`` / ``error`` / ``value`` /
    ``join()`` will do (the recall probe's ``StreamAttempt`` enqueues its
    work on the card instead).

    ``result`` is valid only once ``state == "succeeded"``; ``error``
    holds the last attempt's exception once ``state == "failed"``."""

    def __init__(
        self,
        op: str,
        key: Tuple,
        fn: Callable[[], Any],
        policy: SupervisionPolicy,
        clock: Callable[[], float],
        attempt: Callable[[Callable[[], Any]], Any] = BackgroundJob,
    ):
        self.op = op
        self.key = key
        self.fn = fn
        self.policy = policy
        self._clock = clock
        self.state = RUNNING
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.attempts = 1
        self.retries = 0
        self.abandoned = False
        self.launched_at = clock()
        self.attempt_started = self.launched_at
        self.finished_at: Optional[float] = None
        self._next_retry: Optional[float] = None  # set while backing off
        self._attempt = attempt
        self._job = attempt(fn)

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.launched_at


class JobSupervisor:
    """Supervises background maintenance jobs; see the module docstring.

    One instance per :class:`~repro_torch.engine.segments.SegmentedStore` by
    default (shareable — a checkpoint manager can point at the same one).
    All methods are thread-safe and none of them raise job errors."""

    def __init__(
        self,
        policy: Optional[SupervisionPolicy] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.policy = policy or SupervisionPolicy()
        # obs.Clock unification: None -> the shared monotonic clock; a
        # bare callable (the old time.monotonic convention) still works
        self._clock: Clock = ensure_clock(clock)
        self._lock = threading.Lock()
        # (op, key) -> consecutive exhausted-launch count
        self._consec: Dict[Tuple[str, Tuple], int] = {}
        # (op, key) -> (quarantined_at, probing: bool)
        self._quarantine: Dict[Tuple[str, Tuple], List] = {}
        self._counters: Dict[str, Dict[str, int]] = {}
        self._latency: Dict[str, "obs_metrics.Histogram"] = {}
        self._last_error: Optional[dict] = None
        self._degraded: Dict[str, DegradedMode] = {}

    # ------------------------------------------------------------- internals
    @staticmethod
    def _norm_key(key) -> Tuple:
        if isinstance(key, (list, tuple)):
            return tuple(key)
        return (key,)

    def _count(self, op: str, field: str, n: int = 1) -> None:
        ops = self._counters.setdefault(
            op,
            {"launched": 0, "succeeded": 0, "failed": 0, "retries": 0,
             "abandoned": 0, "refused": 0},
        )
        ops[field] = ops.get(field, 0) + n

    def _note_error(self, job: SupervisedJob, err: BaseException) -> None:
        self._last_error = {
            "op": job.op,
            "key": list(job.key),
            "error": f"{type(err).__name__}: {err}",
            "at": self._clock(),
        }

    def _record_latency(self, job: SupervisedJob) -> None:
        # log-bucketed histogram (not a running mean): one watchdog-
        # abandoned outlier used to drag the reported mean_s for the
        # rest of the process lifetime; p50/p99 are robust to it.
        # Caller holds self._lock (Histogram itself is not thread-safe).
        lat = job.latency
        if lat is None:
            return
        h = self._latency.get(job.op)
        if h is None:
            h = self._latency[job.op] = obs_metrics.Histogram()
        h.observe(lat)
        obs_metrics.observe(f"jobs.{job.op}.latency_s", lat)

    def _record_failure(self, job: SupervisedJob) -> None:
        """Terminal failure of one launch: consecutive-failure accounting
        plus (maybe) quarantine. Caller holds the lock."""
        k = (job.op, job.key)
        n = self._consec.get(k, 0) + 1
        self._consec[k] = n
        self._count(job.op, "failed")
        ent = self._quarantine.get(k)
        if ent is not None:
            # a probe launch failed: restart the probation window (the
            # probing flag must not stick, or the pair could never heal)
            ent[0] = self._clock()
            ent[1] = False
            log.warning("probe of quarantined %s %s failed; probation "
                        "restarted", job.op, job.key)
        elif n >= self.policy.quarantine_after:
            self._quarantine[k] = [self._clock(), False]
            log.warning(
                "quarantined %s %s after %d consecutive failed launches",
                job.op, job.key, n,
            )

    def _record_success(self, job: SupervisedJob) -> None:
        k = (job.op, job.key)
        self._consec.pop(k, None)
        self._quarantine.pop(k, None)  # a healthy run clears quarantine
        self._count(job.op, "succeeded")

    # ------------------------------------------------------------ public API
    def quarantined(self, op: str, key) -> bool:
        """Is ``(op, key)`` currently refusing launches? Probation expiry
        does not clear the quarantine — it admits one probe launch whose
        *success* clears it (checked/consumed by :meth:`submit`)."""
        with self._lock:
            ent = self._quarantine.get((op, self._norm_key(key)))
            if ent is None:
                return False
            at, probing = ent
            return probing or self._clock() - at < self.policy.probation

    def submit(self, op: str, key, fn: Callable[[], Any],
               attempt: Callable[[Callable[[], Any]], Any] = BackgroundJob
               ) -> Optional[SupervisedJob]:
        """Launch ``fn`` under supervision, each attempt as ``attempt(fn)``
        (default: on a daemon thread); returns the job, or None when
        ``(op, key)`` is quarantined (the caller keeps its current state and
        moves on — refusal is not an error)."""
        nkey = self._norm_key(key)
        with self._lock:
            ent = self._quarantine.get((op, nkey))
            if ent is not None:
                at, probing = ent
                if probing or self._clock() - at < self.policy.probation:
                    self._count(op, "refused")
                    return None
                ent[1] = True  # probation over: admit exactly one probe
            self._count(op, "launched")
        return SupervisedJob(op, nkey, fn, self.policy, self._clock, attempt)

    def poll(self, job: Optional[SupervisedJob]) -> str:
        """Advance a job's state machine without blocking; returns
        ``"running"`` | ``"succeeded"`` | ``"failed"``. Never raises:
        errors are recorded, retried (with backoff) while the budget
        lasts, and terminal failures just come back as ``"failed"``."""
        if job is None:
            return FAILED
        if job.state != RUNNING:
            return job.state
        now = self._clock()
        if job._next_retry is not None:  # backing off between attempts
            if now < job._next_retry:
                return RUNNING
            job._next_retry = None
            job.attempts += 1
            job.retries += 1
            job.attempt_started = now
            job._job = job._attempt(job.fn)
            with self._lock:
                self._count(job.op, "retries")
            return RUNNING
        bg = job._job
        if not bg.done():
            dl = self.policy.deadline
            if dl is not None and now - job.attempt_started > dl:
                # watchdog: the attempt is hung — abandon the launch.
                # The thread is a daemon touching only its snapshot; we
                # drop every reference to its (future) result so it can
                # never be swapped in.
                job.state = FAILED
                job.abandoned = True
                job.error = TimeoutError(
                    f"{job.op} attempt exceeded deadline {dl:.3f}s"
                )
                job.finished_at = now
                job._job = None
                with self._lock:
                    self._count(job.op, "abandoned")
                    self._note_error(job, job.error)
                    self._record_failure(job)
                log.warning("abandoned hung %s %s (deadline %.3fs)",
                            job.op, job.key, dl)
            return job.state
        err = bg.error
        if err is None:
            job.state = SUCCEEDED
            job.result = bg.value
            job.finished_at = now
            with self._lock:
                self._record_success(job)
                self._record_latency(job)
            return SUCCEEDED
        # attempt failed
        with self._lock:
            self._note_error(job, err)
        if job.attempts <= self.policy.max_retries:
            delay = self.policy.backoff(job.attempts)
            job._next_retry = now + delay
            log.info("retrying %s %s in %.3fs after: %s",
                     job.op, job.key, delay, err)
            return RUNNING
        job.state = FAILED
        job.error = err
        job.finished_at = now
        job._job = None
        with self._lock:
            self._record_failure(job)
            self._record_latency(job)
        log.warning("gave up on %s %s after %d attempt(s): %s",
                    job.op, job.key, job.attempts, err)
        return FAILED

    def abandon(self, job: Optional[SupervisedJob]) -> bool:
        """Terminally abandon an in-flight job *now* (a recall guardrail
        kills a distillation mid-fold with it). Same contract
        as the watchdog branch of :meth:`poll`: every reference to the
        worker's (future) result is dropped, so even if the daemon thread
        finishes later its output can never be swapped in. Returns True
        if the job was running and is now abandoned; False for None or
        already-terminal jobs (idempotent, never raises)."""
        if job is None or job.state != RUNNING:
            return False
        job.state = FAILED
        job.abandoned = True
        job.error = RuntimeError(f"{job.op} abandoned by caller")
        job.finished_at = self._clock()
        job._job = None
        job._next_retry = None
        with self._lock:
            self._count(job.op, "abandoned")
            self._note_error(job, job.error)
            self._record_failure(job)
        log.warning("abandoned %s %s on caller request", job.op, job.key)
        return True

    def run_inline(self, op: str, key, fn: Callable[[], Any]) -> Optional[Any]:
        """Run ``fn`` on the *caller's* thread under the supervisor's
        failure bookkeeping — quarantine refusal, consecutive-failure
        accounting, last-error capture — without spawning a worker.

        For work that must stay on the serving thread (it owns the store
        under the threading contract), such as a lifecycle controller's
        tick, whose exceptions must still be recorded and repeated failures
        quarantined like background work. There is no backoff loop: the
        "retry" of a failed call is the next call. Returns ``fn()``'s value, or None when the pair is
        quarantined or ``fn`` raised (the error is recorded, never
        propagated)."""
        nkey = self._norm_key(key)
        with self._lock:
            ent = self._quarantine.get((op, nkey))
            if ent is not None:
                at, probing = ent
                if probing or self._clock() - at < self.policy.probation:
                    self._count(op, "refused")
                    return None
                ent[1] = True  # probation over: admit exactly one probe
            self._count(op, "launched")
        started = self._clock()
        try:
            result = fn()
        except Exception as err:  # recorded, never propagated (§13)
            shim = SupervisedJob.__new__(SupervisedJob)
            shim.op, shim.key = op, nkey
            shim.launched_at = started
            shim.finished_at = self._clock()
            with self._lock:
                self._note_error(shim, err)
                self._record_failure(shim)
                self._record_latency(shim)
            log.warning("inline %s %s failed: %s\n%s", op, nkey, err,
                        traceback.format_exc())
            return None
        shim = SupervisedJob.__new__(SupervisedJob)
        shim.op, shim.key = op, nkey
        shim.launched_at = started
        shim.finished_at = self._clock()
        with self._lock:
            self._record_success(shim)
            self._record_latency(shim)
        return result

    def wait(self, job: Optional[SupervisedJob], poll_s: float = 0.005) -> str:
        """Drive ``job`` to a terminal state (joining threads, sleeping
        through backoff windows); returns it. Never raises."""
        if job is None:
            return FAILED
        while True:
            st = self.poll(job)
            if st != RUNNING:
                return st
            bg = job._job
            if bg is not None and job._next_retry is None \
                    and self.policy.deadline is None:
                bg.join()  # no watchdog: a plain join is exact
            else:
                time.sleep(poll_s)

    # ------------------------------------------------------- degraded modes
    def record_degraded(self, component: str, reason: str) -> None:
        """A query-path accelerator failed and its fallback engaged."""
        obs_metrics.inc(f"degraded.{component}")
        with self._lock:
            ent = self._degraded.get(component)
            if ent is None:
                self._degraded[component] = DegradedMode(
                    component, reason, 1, self._clock()
                )
                log.warning("degraded mode: %s (%s)", component, reason)
            else:
                ent.count += 1
                ent.reason = reason
                ent.last_at = self._clock()

    def clear_degraded(self, component: str) -> None:
        with self._lock:
            self._degraded.pop(component, None)

    # --------------------------------------------------------------- health
    def health(self) -> dict:
        """JSON-safe operational snapshot: job counters per op, quarantine
        and degraded-mode state, last error, latencies. The ops surface —
        ``SketchEngine.health()`` and ``serve.py`` print this."""
        with self._lock:
            now = self._clock()
            lat = {
                op: {
                    "count": int(h.count),
                    "mean_s": h.mean,
                    "max_s": float(h.max) if h.count else 0.0,
                    "p50_s": h.quantile(0.50),
                    "p99_s": h.quantile(0.99),
                }
                for op, h in self._latency.items()
            }
            return {
                "jobs": {op: dict(c) for op, c in self._counters.items()},
                "retries": sum(c.get("retries", 0) for c in self._counters.values()),
                "abandoned": sum(c.get("abandoned", 0) for c in self._counters.values()),
                "quarantined": [
                    {"op": op, "key": list(key), "for_s": now - at,
                     "probing": bool(probing)}
                    for (op, key), (at, probing) in self._quarantine.items()
                ],
                "degraded": [d.snapshot() for d in self._degraded.values()],
                "last_error": dict(self._last_error) if self._last_error else None,
                "latency_s": lat,
            }
