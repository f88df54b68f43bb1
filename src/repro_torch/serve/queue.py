"""Thread-safe bounded request queue with per-request dispatch
deadlines — the admission-control front door of the async server (port
of ``repro.serve.queue``; numpy and the standard library only).

A request's ``deadline`` is the absolute monotonic time by which it
must be *dispatched* (included in a pipeline launch); the micro-batcher
blocks in ``next_batch`` until either ``max_batch`` requests are
waiting or the earliest deadline in the queue expires, whichever comes
first. Backpressure when the queue is at ``bound``:

  ``reject``       refuse the new request (caller fails its future)
  ``shed_oldest``  drop the oldest queued request to admit the new one
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

ADMISSION_POLICIES = ("reject", "shed_oldest")


class ServeFuture:
    """Completion handle for one submitted query.

    ``status`` is one of ``pending`` / ``done`` / ``shed`` /
    ``rejected`` / ``error: ...``; ``result`` blocks and raises unless
    the request finished ``done``.
    """

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self.status = "pending"

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self.status != "done":
            raise RuntimeError(f"request not served: {self.status}")
        return self._result

    # Completion is first-writer-wins: once the event is set, the
    # (status, result) pair is immutable. A launch that raises AFTER
    # fulfilling part of its batch must not flip already-``done``
    # futures to ``error`` (their result may already be consumed), and
    # a racing shed/fail must not clobber a concurrent fulfil. Both
    # return whether THIS call won the transition, so callers only
    # emit completion side effects (trace end, counters) once.

    def _set(self, result) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
            self.status = "done"
            self._event.set()
            return True

    def _fail(self, status: str) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self.status = status
            self._event.set()
            return True


@dataclasses.dataclass
class Request:
    """One queued query (already normalized to the server's nnz width)."""

    coords: np.ndarray          # int32 [nnz]
    vals: np.ndarray            # float32 [nnz]
    submit_t: float             # monotonic enqueue time
    deadline: float             # absolute monotonic dispatch deadline
    future: ServeFuture
    cache_key: bytes | None = None
    # per-request trace (repro_torch.obs.trace.Trace) minted at submit when
    # the server carries an Observability bundle; rides the queue so
    # the batcher can close the span tree at fulfil time
    trace: object | None = None
    # in-flight coalescing: (future, submit_t, trace) of identical-
    # fingerprint requests submitted while this one was
    # queued/executing — fulfilled from this request's launch slot
    # with their OWN submit times, so per-request latency stays honest
    # (appended only under the batcher's coalesce lock)
    followers: list[tuple[ServeFuture, float, object | None]] = \
        dataclasses.field(default_factory=list)


class RequestQueue:
    """FIFO queue with deadline-aware blocking batch extraction."""

    def __init__(self, bound: int = 1024, policy: str = "reject"):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"unknown admission policy {policy!r}; "
                             f"choose from {ADMISSION_POLICIES}")
        self.bound = bound
        self.policy = policy
        self._q: deque[Request] = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._min_deadline = float("inf")   # running min over self._q

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def put(self, req: Request) -> tuple[str, Request | None]:
        """Admit a request. Returns (status, shed_request) with status
        ``ok`` | ``rejected`` (backpressure) | ``closed`` (shutdown)."""
        with self._cond:
            if self._closed:
                return "closed", None
            shed = None
            if len(self._q) >= self.bound:
                if self.policy == "reject":
                    return "rejected", None
                shed = self._q.popleft()
                if shed.deadline <= self._min_deadline:
                    self._recompute_min()
            self._q.append(req)
            self._min_deadline = min(self._min_deadline, req.deadline)
            self._cond.notify_all()
        return "ok", shed

    def next_batch(self, max_n: int,
                   now_fn=time.monotonic) -> list[Request] | None:
        """Block until a batch is due; None once closed and drained.

        A batch is due when ``max_n`` requests are queued, the earliest
        queued deadline has expired, or the queue was closed (drain
        immediately, don't make shutdown wait out deadlines).
        """
        with self._cond:
            while True:
                if self._q:
                    if self._closed or len(self._q) >= max_n:
                        return self._pop(max_n)
                    now = now_fn()
                    if now >= self._min_deadline:
                        return self._pop(max_n)
                    self._cond.wait(self._min_deadline - now)
                elif self._closed:
                    return None
                else:
                    self._cond.wait()

    def _pop(self, max_n: int) -> list[Request]:
        out = [self._q.popleft()
               for _ in range(min(len(self._q), max_n))]
        self._recompute_min()
        return out

    def _recompute_min(self) -> None:
        # O(len) but only on pop/shed, not on every wakeup
        self._min_deadline = min((r.deadline for r in self._q),
                                 default=float("inf"))

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
