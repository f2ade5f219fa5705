"""Request admission: deadlines, priorities, backpressure, load shedding.

A :class:`Request` is one client decode job (prompt → up to
``max_new_tokens`` tokens) with a priority and an optional absolute
deadline. The :class:`RequestQueue` orders admitted requests by
``(priority, deadline, arrival)`` and enforces two protection mechanisms
the engine's SLO depends on:

* **backpressure** — ``submit(block=True)`` waits for queue space, pacing
  a well-behaved client down to the engine's actual throughput;
* **load shedding** — a non-blocking submit against a full queue, a
  request whose deadline already passed, or an estimated queue wait above
  the SLO budget is rejected *at admission* (cheap) instead of timing out
  after consuming device time (expensive).

The wait estimate is ``queue depth × EWMA(batch-step service time)``; the
engine feeds the EWMA after every decode step.
"""
from __future__ import annotations

import bisect
import itertools
import math
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from .stats import EWMA

__all__ = ["Request", "ServeResult", "RequestQueue",
           "AdmissionError", "QueueOverflow", "QueueClosed", "SLOExceeded"]


class AdmissionError(RuntimeError):
    """Base class for requests rejected at the queue boundary."""


class QueueOverflow(AdmissionError):
    """Non-blocking submit against a full queue (load shed)."""


class QueueClosed(AdmissionError):
    """Submit after the engine began draining/shutdown."""


class SLOExceeded(AdmissionError):
    """Admission would already bust the SLO budget (expired deadline or
    estimated queue wait beyond the budget) — shed instead of serving a
    guaranteed-late response."""


@dataclass
class ServeResult:
    """What a completed request resolves to."""

    request_id: int
    tokens: List[Any]
    latency_s: float          # submit → last token
    ttft_s: float             # submit → first token
    steps: int = 0            # decode steps this request participated in
    prefix_hit: bool = False  # paged engine: prefill served from the
                              # pool's shared-prefix cache (no KV compute)


class Request:
    """One client job travelling through queue → batcher → engine."""

    _ids = itertools.count()

    __slots__ = ("id", "prompt", "max_new_tokens", "priority", "deadline",
                 "bucket", "future", "tokens", "last_token", "t_submit",
                 "t_first", "t_ready")

    def __init__(self, prompt, *, max_new_tokens: int = 8, priority: int = 0,
                 deadline: Optional[float] = None, bucket=None):
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.id = next(Request._ids)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        self.deadline = deadline          # absolute time.monotonic() or None
        #: shape bucket for batch formation — requests only batch with
        #: same-shaped peers, so their caches stack into one batch
        self.bucket = bucket if bucket is not None else np.shape(prompt)
        self.future: Future = Future()
        self.tokens: List[Any] = []
        self.last_token: Any = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        #: paged engine: when prefill finished and the page table became
        #: ready for decode (None in monolithic mode)
        self.t_ready: Optional[float] = None

    def __repr__(self):
        return (f"Request#{self.id}(bucket={self.bucket}, "
                f"prio={self.priority}, n={self.max_new_tokens})")


# sort key: urgent first — lower priority value wins, then earlier
# deadline (None sorts last), then arrival order
def _entry_key(req: Request, seq: int) -> Tuple:
    return (req.priority,
            req.deadline if req.deadline is not None else math.inf,
            seq)


class RequestQueue:
    """Thread-safe admission queue ordered by (priority, deadline, arrival).

    ``pop(bucket=...)`` returns the most urgent request *of that shape
    bucket*, leaving other buckets queued — the batcher uses this to keep
    batches shape-homogeneous without reordering across buckets.
    """

    def __init__(self, *, max_depth: int = 1024,
                 slo_budget_s: Optional[float] = None,
                 clock=time.monotonic):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self.max_depth = max_depth
        self.slo_budget_s = slo_budget_s
        self.clock = clock
        self.service_time = EWMA()
        self._entries: List[Tuple[Tuple, Request]] = []  # sorted by key
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._closed = False
        # shed/admission counters (engine.stats() surfaces these)
        self.admitted = 0
        self.shed = 0

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        with self._cv:
            return len(self._entries)

    def estimated_wait(self) -> float:
        """Seconds a newly admitted request would expect to queue: depth ×
        the engine-fed EWMA of batch-step service time (0 until the first
        step completes)."""
        est = self.service_time.value or 0.0
        return (len(self) + 1) * est

    def note_service_time(self, seconds: float) -> None:
        self.service_time.update(seconds)

    # -- admission --------------------------------------------------------
    def submit(self, req: Request, *, block: bool = False,
               timeout: Optional[float] = None) -> Request:
        """Admit ``req`` or raise an :class:`AdmissionError` subclass."""
        with self._cv:
            if self._closed:
                raise QueueClosed("request queue is closed")
            now = self.clock()
            if req.deadline is not None and req.deadline <= now:
                self.shed += 1
                raise SLOExceeded(
                    f"request {req.id} deadline already passed at admission")
            if len(self._entries) >= self.max_depth:
                if not block:
                    self.shed += 1
                    raise QueueOverflow(
                        f"queue full ({self.max_depth}); request {req.id} "
                        "shed")
                end = None if timeout is None else now + timeout
                while len(self._entries) >= self.max_depth \
                        and not self._closed:
                    remaining = None if end is None else end - self.clock()
                    if remaining is not None and remaining <= 0:
                        self.shed += 1
                        raise QueueOverflow(
                            f"queue full after {timeout}s backpressure wait")
                    self._cv.wait(remaining)
                if self._closed:
                    raise QueueClosed("request queue closed while waiting")
            if self.slo_budget_s is not None:
                est = self.service_time.value
                if est and (len(self._entries) + 1) * est > self.slo_budget_s:
                    self.shed += 1
                    raise SLOExceeded(
                        f"estimated wait {(len(self._entries) + 1) * est:.3f}s"
                        f" exceeds SLO budget {self.slo_budget_s}s")
            entry = (_entry_key(req, next(self._seq)), req)
            bisect.insort(self._entries, entry, key=lambda e: e[0])
            self.admitted += 1
            self._cv.notify_all()
        return req

    # -- consumption ------------------------------------------------------
    def pop(self, *, bucket=None, timeout: Optional[float] = None
            ) -> Optional[Request]:
        """The most urgent request (optionally only from ``bucket``), or
        None after ``timeout`` seconds with no match (``timeout=0`` is a
        non-blocking scan; ``None`` blocks until a match or close)."""
        end = None if timeout is None else self.clock() + timeout
        with self._cv:
            while True:
                for i, (_, req) in enumerate(self._entries):
                    if bucket is None or req.bucket == bucket:
                        del self._entries[i]
                        self._cv.notify_all()  # wake backpressured submits
                        return req
                if self._closed and not self._entries:
                    return None
                if end is not None:
                    remaining = end - self.clock()
                    if remaining <= 0:
                        return None
                    self._cv.wait(remaining)
                else:
                    self._cv.wait()

    def close(self) -> None:
        """Stop admissions; queued requests remain poppable (drain)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
