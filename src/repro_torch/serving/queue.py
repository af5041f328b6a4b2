"""Async request pipeline in front of the serving engine.

A copy of ``repro/serving/queue.py`` with its own :class:`LatencyWindow`
(the reference keeps it in ``serving/slo.py``, which imports JAX), so the
port imports nothing of ``repro``.

``MicroBatcher`` (``serving/batching.py``) batches synchronously: the caller
owns the flush.  Production traffic is concurrent — many callers, none of
whom should flush anyone else's work — so the queue here is the continuous
batching loop rtp-llm-style LLM servers run: requests enter from any thread,
a single scheduler thread repeatedly pops the best batch and scores it while
new arrivals accumulate behind it, and every caller gets a
``concurrent.futures.Future`` to poll or block on.

Scheduling policy (deterministic, and what the tests pin down):

* requests are ordered by **(deadline bucket, priority, arrival)** —
  deadlines are quantized into ``deadline_bucket_ms`` buckets, and within a
  bucket lower ``priority`` values go first (priority 0 is the default
  request class; online maintenance work submits at low priority, e.g. 10,
  so model-refresh traffic can never crowd out user requests, while a
  deadline that is a whole bucket earlier still wins regardless of class);
  a batch is formed from the winning request's ``topk`` **bucket** (mixing
  topk values in one launch would change the kernel's output shape), taking
  up to ``max_batch`` same-bucket requests in that order;
* within a batch, duplicate user ids are scored once and fanned back out;
  futures resolve in deadline order;
* **admission control**: at ``max_pending`` queued requests ``submit`` either
  raises :class:`QueueFullError` or, with ``block=True``, waits for space —
  backpressure instead of unbounded memory;
* **timeouts**: a request whose deadline passes before it is *scheduled*
  fails with :class:`RequestTimeout`; a request already in a scoring launch
  completes (the launch is paid for either way);
* results are byte-identical to calling ``engine.topk([user], topk)``
  sequentially — batching never changes numerics, only wall-clock.

The scheduler thread is the only thread that touches the engine, so the
engine itself needs no locking for the async path.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

_INF = float("inf")


class LatencyWindow:
    """Thread-safe ring buffer of per-request ``(latency, priority)`` pairs.

    The queue records one entry per completed request; the controller reads
    percentiles over the surviving window.  ``count`` is the *monotonic*
    total ever recorded (not the window occupancy), so a tick can compute
    "requests completed since my last tick" without a second counter.
    """

    def __init__(self, capacity: int = 2048):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._lat = np.zeros(capacity, np.float64)
        self._prio = np.zeros(capacity, np.int32)
        self._pos = 0
        self._filled = 0
        self._total = 0
        self._lock = threading.Lock()

    def record(self, latency_s: float, priority: int = 0) -> None:
        """Append one completed request's queue-to-completion latency."""
        with self._lock:
            self._lat[self._pos] = latency_s
            self._prio[self._pos] = priority
            self._pos = (self._pos + 1) % self.capacity
            self._filled = min(self._filled + 1, self.capacity)
            self._total += 1

    @property
    def count(self) -> int:
        """Total requests ever recorded (monotonic)."""
        with self._lock:
            return self._total

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """Copies of the windowed ``(latencies_s, priorities)`` arrays."""
        with self._lock:
            n = self._filled
            return self._lat[:n].copy(), self._prio[:n].copy()

    def percentile(self, p: float, *, priority: Optional[int] = None) -> float:
        """Windowed latency percentile in seconds (NaN when empty);
        ``priority`` restricts to one request class."""
        lat, prio = self.snapshot()
        if priority is not None:
            lat = lat[prio == priority]
        if lat.size == 0:
            return float("nan")
        return float(np.percentile(lat, p))


class QueueFullError(RuntimeError):
    """Admission control rejected the request: ``max_pending`` reached."""


class RequestTimeout(TimeoutError):
    """The request's deadline passed before a scheduler slot reached it."""


@dataclass(order=True)
class _Pending:
    bucket: float                        # quantized deadline (inf = none)
    priority: int                        # lower = scheduled sooner
    seq: int
    deadline: float = field(compare=False)   # exact deadline, for expiry
    topk: int = field(compare=False)
    user_id: int = field(compare=False)
    future: Future = field(compare=False)
    submitted: float = field(compare=False, default=0.0)  # arrival time


def _fail(fut: Future, exc: Exception) -> None:
    """set_exception tolerating a future the caller already cancelled —
    an InvalidStateError here would kill the scheduler thread."""
    try:
        fut.set_exception(exc)
    except Exception:  # noqa: BLE001 - cancelled/raced future: nothing to do
        pass


class RequestQueue:
    """Continuous-batching scheduler over a :class:`ServingEngine`.

    ``submit(user_id, topk, timeout=...)`` returns a ``Future`` resolving to
    ``(scores, item_ids)`` — two (topk,) numpy rows, exactly the caller's row
    of :meth:`ServingEngine.topk`.  ``score_fn(users, topk)`` overrides the
    scoring callable; it must accept a
    sorted list of unique user ids and return ``(B, topk)`` arrays.

    ``linger_ms`` trades a bounded scheduling delay for larger batches: the
    scheduler waits that long (or until ``max_batch`` requests are queued)
    before popping a batch.  Leave it at 0 for latency-critical paths —
    continuous batching already coalesces whatever arrives while the previous
    launch is in flight.

    ``deadline_bucket_ms`` quantizes deadlines for the priority comparison:
    requests whose deadlines fall in the same bucket are ordered by
    ``priority`` (then arrival), so a latency-insensitive background request
    cannot jump ahead of user traffic just by carrying a marginally earlier
    deadline, while genuinely earlier deadlines still dominate.  Set it to 0
    to recover strict earliest-deadline-first with priority as a tiebreak.

    ``start=False`` skips the scheduler thread; tests (and anyone wanting
    strict determinism) call :meth:`drain_once` manually.
    """

    def __init__(
        self,
        engine,
        *,
        score_fn: Optional[Callable] = None,
        max_batch: Optional[int] = None,
        max_pending: int = 4096,
        linger_ms: float = 0.0,
        deadline_bucket_ms: float = 50.0,
        latency_window: int = 2048,
        start: bool = True,
    ):
        if max_pending <= 0:
            raise ValueError(f"max_pending must be positive, got {max_pending}")
        self.engine = engine
        self._score = score_fn if score_fn is not None else engine.topk
        self.max_batch = max_batch if max_batch is not None else engine.max_batch
        self.max_pending = max_pending
        self.linger_s = linger_ms / 1e3
        self.bucket_s = deadline_bucket_ms / 1e3
        self._cond = threading.Condition()
        self._heap: List[_Pending] = []
        self._seq = itertools.count()
        self._closed = False
        self._scoring = 0  # requests inside the current scoring launch
        # bench / observability counters
        self.requests_served = 0
        self.batches_served = 0
        self.expired = 0
        self.rejected = 0
        # per-request submit->completion latency histogram over the last
        # ``latency_window`` requests — the p50/p99 load signal
        self.latency = LatencyWindow(latency_window)
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    @property
    def closed(self) -> bool:
        """True once :meth:`close` ran — the queue rejects new submits and
        the engine's ``start()`` may build a fresh one."""
        with self._cond:
            return self._closed

    def start(self) -> None:
        """Launch the scheduler thread (idempotent; ``start=False``
        constructions call this, or drive :meth:`drain_once` manually)."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serving-scheduler", daemon=True
        )
        self._thread.start()

    def close(self, *, cancel_pending: bool = False) -> None:
        """Stop accepting requests.  Pending work is drained (scored) before
        the scheduler exits, unless ``cancel_pending`` fails it fast."""
        with self._cond:
            self._closed = True
            if cancel_pending:
                for req in self._heap:
                    _fail(
                        req.future,
                        RequestTimeout("queue closed before request was scheduled"),
                    )
                self._heap.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        else:
            while self.drain_once():
                pass
            with self._cond:  # anything left is expired-only residue: fail it
                for req in self._heap:
                    _fail(
                        req.future,
                        RequestTimeout("queue closed before request was scheduled"),
                    )
                self._heap.clear()

    def abort(self, exc: Exception) -> None:
        """Crash-stop (the chaos harness's simulated replica death): fail
        every queued request with ``exc`` — not the graceful-drain
        ``RequestTimeout`` — reject new submits, and stop the scheduler
        without scoring the backlog.  A batch already mid-score completes
        (its callers see results), matching a real process whose in-flight
        work raced the crash."""
        with self._cond:
            self._closed = True
            for req in self._heap:
                _fail(req.future, exc)
            self._heap.clear()
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "RequestQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel_pending=exc[0] is not None)

    def __len__(self) -> int:
        with self._cond:
            return len(self._heap)

    @property
    def depth(self) -> int:
        """Requests queued plus in the current scoring launch — the load
        signal a router balances on (a replica whose scheduler is
        mid-launch is busier than its heap length alone says)."""
        with self._cond:
            return len(self._heap) + self._scoring

    # -- submission ----------------------------------------------------------
    def submit(
        self,
        user_id: int,
        topk: int = 10,
        *,
        timeout: Optional[float] = None,
        priority: int = 0,
        block: bool = False,
        block_timeout: Optional[float] = None,
    ) -> Future:
        """Enqueue one top-k request; returns its ``Future``.

        Validation happens here so a bad request fails its own submit and can
        never poison a batch.  ``timeout`` (seconds) bounds time-to-schedule;
        ``priority`` (lower = sooner) orders requests within a deadline
        bucket — use a high value (e.g. 10) for background/maintenance work;
        ``block=True`` waits up to ``block_timeout`` for queue space instead
        of raising :class:`QueueFullError`.
        """
        # engine validation gives the uniform messages for bad ids / topk
        self.engine._validate_request([user_id], topk)
        deadline = _INF if timeout is None else time.monotonic() + timeout
        bucket = (
            deadline if self.bucket_s <= 0 or deadline == _INF
            else (deadline // self.bucket_s) * self.bucket_s
        )
        fut: Future = Future()
        req = _Pending(
            bucket, int(priority), next(self._seq),
            deadline, int(topk), int(user_id), fut,
            time.monotonic(),
        )
        with self._cond:
            if self._closed:
                raise RuntimeError("queue is closed")
            if len(self._heap) >= self.max_pending and block:
                limit = (
                    _INF if block_timeout is None
                    else time.monotonic() + block_timeout
                )
                while len(self._heap) >= self.max_pending and not self._closed:
                    remaining = limit - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(
                        None if remaining == _INF else remaining
                    ):
                        break
                if self._closed:
                    raise RuntimeError("queue is closed")
            if len(self._heap) >= self.max_pending:
                self.rejected += 1
                raise QueueFullError(
                    f"{self.max_pending} requests already pending"
                )
            heapq.heappush(self._heap, req)
            self._cond.notify_all()
        return fut

    # -- scheduling ----------------------------------------------------------
    def _schedulable_locked(self) -> int:
        """Requests the next :meth:`_pop_batch` would actually schedule:
        un-expired entries in the scheduling-order winner's topk bucket.
        This is what the linger wait must count toward ``max_batch`` —
        counting raw heap length (the old behaviour) ends the linger early
        on expired requests and other-bucket requests that cannot join the
        batch.  Caller holds ``self._cond``."""
        now = time.monotonic()
        best: Optional[_Pending] = None
        for req in self._heap:
            if req.deadline < now:
                continue
            if best is None or req < best:
                best = req
        if best is None:
            return 0
        win = best.topk
        return sum(
            1 for req in self._heap
            if req.deadline >= now and req.topk == win
        )

    def _pop_batch(self) -> List[_Pending]:
        """Pop the next batch under the lock: the scheduling-order winner
        (deadline bucket, then priority, then arrival) defines the topk
        bucket; same-bucket requests join in scheduling order up to
        ``max_batch``.  Expired requests fail here, never score."""
        now = time.monotonic()
        batch: List[_Pending] = []
        skipped: List[_Pending] = []
        dropped = 0
        bucket: Optional[int] = None
        while self._heap and len(batch) < self.max_batch:
            req = heapq.heappop(self._heap)
            if req.deadline < now:
                _fail(
                    req.future,
                    RequestTimeout(
                        f"request for user {req.user_id} expired after "
                        f"waiting in queue"
                    ),
                )
                self.expired += 1
                dropped += 1
                continue
            if bucket is None:
                bucket = req.topk
            if req.topk != bucket:
                skipped.append(req)  # stays PENDING: may be claimed later
                continue
            # claim the future: a caller-side cancel() after this point can
            # no longer race the batch's set_result (RUNNING != cancellable)
            if not req.future.set_running_or_notify_cancel():
                dropped += 1
                continue
            batch.append(req)
        for req in skipped:
            heapq.heappush(self._heap, req)
        if batch or dropped:
            self._cond.notify_all()  # space freed: wake blocked submitters
        return batch

    def _serve(self, batch: List[_Pending]) -> None:
        with self._cond:
            self._scoring = len(batch)
        try:
            self._serve_inner(batch)
        finally:
            with self._cond:
                self._scoring = 0

    def _serve_inner(self, batch: List[_Pending]) -> None:
        topk = batch[0].topk
        users = sorted({req.user_id for req in batch})
        try:
            scores, idx = self._score(users, topk)
            scores = np.asarray(scores)
            idx = np.asarray(idx)
        except Exception as exc:  # noqa: BLE001 - fail the batch, not the loop
            for req in batch:
                _fail(req.future, exc)
            return
        row = {uid: i for i, uid in enumerate(users)}
        done = time.monotonic()
        for req in batch:  # deadline order == batch order
            r = row[req.user_id]
            req.future.set_result((scores[r].copy(), idx[r].copy()))
            self.latency.record(done - req.submitted, priority=req.priority)
        self.requests_served += len(batch)
        self.batches_served += 1

    def drain_once(self) -> int:
        """Pop and score one batch (no waiting).  Returns requests served.
        The manual pump for ``start=False`` queues — one call is exactly one
        scoring launch, so tests can pin batch composition."""
        with self._cond:
            batch = self._pop_batch()
        if not batch:
            return 0
        self._serve(batch)
        return len(batch)

    def _loop(self) -> None:
        try:
            while True:
                with self._cond:
                    while not self._heap and not self._closed:
                        self._cond.wait()
                    if self.linger_s > 0 and self._heap and not self._closed:
                        limit = time.monotonic() + self.linger_s
                        while (
                            self._schedulable_locked() < self.max_batch
                            and not self._closed
                        ):
                            remaining = limit - time.monotonic()
                            if remaining <= 0:
                                break
                            self._cond.wait(remaining)
                    batch = self._pop_batch()
                    if not batch and self._closed and not self._heap:
                        return
                if batch:
                    self._serve(batch)
        finally:
            # A scheduler that exits for ANY reason (normal drain included)
            # must leave no pending future behind: anything still queued is
            # failed loudly rather than stranded forever.  After a normal
            # drain the heap is empty and this is a no-op.
            with self._cond:
                for req in self._heap:
                    _fail(
                        req.future,
                        RuntimeError("scheduler exited with request pending"),
                    )
                self._heap.clear()
                self._closed = True
                self._cond.notify_all()
