"""Exact Jaccard top-k and the online recall probe (the port of
``repro.obs.probe``).

:func:`exact_topk` is the ground truth recall is measured against: (Q, k)
*positions* into the corpus, score descending, position ascending on ties.
|q ∩ c| is a float32 product of {0,1} membership matrices, built one corpus
chunk at a time on the given device; |q ∪ c| follows by inclusion-exclusion.
The counts are integers below 2^24, so float32 holds them exactly — as long as
the product runs in full float32: TF32 is switched off for it.

:class:`RecallProbe` samples queries, computes their exact top-k over a
snapshot of the catalog, and scores the engine's own answers against it,
publishing ``probe.recall`` / ``probe.at`` and bumping ``probe.runs``. The
reference runs the ground truth on a supervised worker thread in numpy; here
it stays on the card, where the product is (about 3.4 TFLOP at 255,000
survivors of d = 102,660), and off every worker thread, which this package
keeps free of CUDA. The mechanism: the probe submits the ground truth as op
``"probe"`` to the engine's supervisor with a :class:`StreamAttempt` in place
of the worker thread. An attempt enqueues the product on a side stream on the
caller's thread and records an event; the supervisor's ``poll`` (on the
caller's thread) reads the attempt as done once the event has fired. So
retries with backoff, the watchdog, quarantine, latency and ``health()``
account for the op exactly as they do for the reference's worker. On the CPU
the product runs inside the attempt and the attempt is done at once.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..hopper.build import is_device_fault
from . import metrics as _metrics
from .clock import MONOTONIC, Clock, ensure_clock

__all__ = ["RecallProbe", "StreamAttempt", "exact_topk"]

# float32 membership elements of one corpus chunk (256 MB)
_CHUNK_ELEMS = 1 << 26


def _membership(rows: torch.Tensor, d: int) -> torch.Tensor:
    """(B, d) float32 {0,1} membership of padded index rows. Pads scatter
    into a spare column d, sliced off, so no step depends on the data's
    shape and nothing waits for the device."""
    m = torch.zeros((rows.shape[0], d + 1), dtype=torch.float32, device=rows.device)
    cols = torch.where(rows >= 0, rows, d).to(torch.int64)
    m.scatter_(1, cols, 1.0)
    return m[:, :d]


def exact_topk_positions(corpus_idx, query_idx, k: int, dev: torch.device) -> torch.Tensor:
    """:func:`exact_topk` left on ``dev``: (Q, k) int64 positions, enqueued on
    the current stream. Both index arrays are uploaded first (a copy from
    pageable memory waits for the stream); after that no step waits for the
    device."""
    corpus_idx = np.asarray(corpus_idx)
    query_idx = np.asarray(query_idx)
    d = int(max(corpus_idx.max(initial=0), query_idx.max(initial=0))) + 1

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    rows = upload(corpus_idx)
    qm = _membership(upload(query_idx), d)
    q_sizes = qm.sum(dim=1, keepdim=True)
    n = len(corpus_idx)
    sims = torch.empty((len(query_idx), n), dtype=torch.float32, device=dev)
    chunk = max(1, _CHUNK_ELEMS // d)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # exact integer counts
    try:
        for lo in range(0, n, chunk):
            cm = _membership(rows[lo : lo + chunk], d)
            inter = qm @ cm.T
            union = q_sizes + cm.sum(dim=1)[None, :] - inter
            sims[:, lo : lo + cm.shape[0]] = inter / torch.clamp_min(union, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return torch.sort(sims, dim=1, descending=True, stable=True).indices[:, :k]


def exact_topk(corpus_idx, query_idx, k: int, device="cuda") -> np.ndarray:
    """Exact Jaccard top-k of padded sparse ``query_idx`` rows over
    ``corpus_idx`` rows (both numpy, pad -1). Returns (Q, k) int64 positions."""
    return exact_topk_positions(corpus_idx, query_idx, k, resolve_device(device)).cpu().numpy()


class StreamAttempt:
    """One attempt of a supervised op whose work is enqueued on the card
    rather than run on a worker thread: the supervisor's attempt interface
    (``done`` / ``error`` / ``value`` / ``join``, as
    :class:`~repro_torch.checkpoint.manager.BackgroundJob`), all on the
    caller's thread.

    ``fn`` runs at construction and returns ``(result, event)``: ``result``
    a tensor whose work is enqueued, ``event`` recorded after it (None when
    the work is already done, as on the CPU). A failure of ``fn`` is the
    attempt's error, which the supervisor retries or records; a fault of a
    kernel or the card (``hopper.build.is_device_fault``) propagates
    instead. ``value`` is the result as numpy, read once the event fired."""

    def __init__(self, fn: Callable[[], tuple]):
        self._result = self._event = self._error = None
        try:
            self._result, self._event = fn()
        except Exception as e:
            if is_device_fault(e):
                raise
            self._error = e

    def done(self) -> bool:
        return self._error is not None or self._event is None or self._event.query()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    @property
    def value(self) -> np.ndarray:
        return self._result.cpu().numpy()

    def join(self) -> None:
        if self._event is not None:
            self._event.synchronize()


class RecallProbe:
    """Sampled recall@k against exact ground truth, supervised.

    Lifecycle (as the reference's)::

        probe = RecallProbe(engine, k=10, sample=64, seed=0)
        probe.launch(surv_ids, surv_rows, queries)   # snapshot + enqueue truth
        ...                                          # serve traffic
        probe.poll(now=serve_now)                    # cheap; heartbeat
        recall = probe.wait(now=serve_now)           # block for the reading

    ``launch`` snapshots the catalog arrays (the truth is the catalog *as of
    launch*; later mutations read as recall loss, the drift signal) and
    submits the ground truth as op ``"probe"`` on the engine's supervisor
    (see the module docstring for how it runs on the card). ``poll`` drives
    the supervisor; once the truth has landed it runs the engine query on the
    caller's thread, then publishes ``probe.recall`` / ``probe.at`` and bumps
    ``probe.runs``. A failed probe leaves the gauge stale; a fault of a
    kernel or the card propagates.
    """

    def __init__(self, engine, k: int = 10, sample: int = 64, seed: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        self.engine = engine
        self.k = int(k)
        self.sample = int(sample)
        self.seed = int(seed)
        self.clock: Clock = ensure_clock(
            clock if clock is not None else getattr(engine, "clock", None))
        self.last_recall: Optional[float] = None
        self.last_at: Optional[float] = None
        self.runs = 0
        self._job = None  # the in-flight SupervisedJob
        self._queries = None
        self._ids = None  # the snapshot's global ids, positions -> ids
        self._truth_ids = None  # set when the truth lands
        self._stream = None  # the side stream of the truth, made at first launch

    @property
    def running(self) -> bool:
        return self._queries is not None

    def _truth(self, surv_rows: np.ndarray, queries: np.ndarray, k: int) -> tuple:
        """Enqueue the ground truth: on the card on a side stream of its own
        (its inputs are host arrays, so it waits for nothing the caller's
        stream holds), with an event recorded after it."""
        dev = self.engine.device
        if dev.type != "cuda":
            return exact_topk_positions(surv_rows, queries, k, dev), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(self._stream):
            pos = exact_topk_positions(surv_rows, queries, k, dev)
            done = torch.cuda.Event()
            done.record(self._stream)
        return pos, done

    def launch(self, surv_ids, surv_rows, queries=None) -> bool:
        """Snapshot the catalog + sample queries, submit the truth.

        ``surv_ids``/``surv_rows`` are the live catalog (global ids and raw
        index rows, aligned); ``queries`` defaults to a seeded sample of
        catalog rows — pass the serve query set to probe the traffic itself.
        No-op (False) while a previous probe is in flight, the catalog is
        empty, or the supervisor has the probe op quarantined."""
        if self._queries is not None or len(surv_ids) == 0:
            return False
        surv_ids = np.asarray(surv_ids).copy()
        surv_rows = np.asarray(surv_rows).copy()
        if queries is None:
            rng = np.random.default_rng(self.seed + self.runs)
            pick = rng.choice(len(surv_ids), min(self.sample, len(surv_ids)), replace=False)
            queries = surv_rows[pick]
        else:
            queries = np.asarray(queries)
            if len(queries) > self.sample:
                rng = np.random.default_rng(self.seed + self.runs)
                queries = queries[rng.choice(len(queries), self.sample, replace=False)]
        k = min(self.k, len(surv_ids))
        job = self.engine.supervisor.submit("probe", ("recall", self.runs),
                                            lambda: self._truth(surv_rows, queries, k),
                                            attempt=StreamAttempt)
        if job is None:  # quarantined: skip this round, the gauge stays stale
            return False
        self._job, self._queries, self._ids = job, queries, surv_ids
        return True

    def poll(self, now: Optional[float] = None) -> Optional[float]:
        """Heartbeat: drive the supervisor; when the truth has landed, score
        the engine against it and publish. Returns the fresh recall on the
        tick it completes, else None."""
        if self._queries is None:
            return None
        sup = self.engine.supervisor
        if self._truth_ids is None:
            st = sup.poll(self._job)
            if st == "running":
                return None
            if st == "failed":
                # the supervisor recorded the failure (or quarantine); drop
                # this run, the gauge keeps its last value
                self._job = self._queries = self._ids = None
                return None
            self._truth_ids = self._ids[np.asarray(self._job.result)]  # positions -> ids
            self._job = self._ids = None
        truth_ids = self._truth_ids
        queries, k = self._queries, truth_ids.shape[1]
        self._queries = self._truth_ids = None
        _, ids = self.engine.query(queries, k, now=now)
        ids = ids.cpu().numpy()
        hits = sum(len(set(ids[i].tolist()) & set(truth_ids[i].tolist()))
                   for i in range(len(queries)))
        recall = hits / float(len(queries) * k)
        self.runs += 1
        self.last_recall = recall
        self.last_at = float(now) if now is not None else self.clock()
        _metrics.set_gauge("probe.recall", recall)
        _metrics.set_gauge("probe.at", self.last_at)
        _metrics.inc("probe.runs")
        return recall

    def wait(self, now: Optional[float] = None, timeout: float = 60.0) -> Optional[float]:
        """Poll until the in-flight probe completes or ``timeout`` real
        seconds pass. Returns the reading, or the last one if nothing was in
        flight. The deadline reads ``MONOTONIC`` (real time), not the probe's
        clock: under a ManualClock an injected deadline would never come."""
        import time as _time

        deadline = MONOTONIC() + timeout
        while self._queries is not None and MONOTONIC() < deadline:
            got = self.poll(now=now)
            if got is not None:
                return got
            _time.sleep(0.005)
        return self.last_recall

    def snapshot(self) -> dict:
        return {
            "recall": self.last_recall,
            "at": self.last_at,
            "runs": int(self.runs),
            "k": self.k,
            "sample": self.sample,
            "running": self.running,
        }
