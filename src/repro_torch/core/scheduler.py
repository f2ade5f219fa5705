"""Heterogeneous scheduling across device pools (paper §5.4, §3.6).

The paper evaluates *fractional offload*: a workload is split between the
CPU and one or more OpenCL devices, the fraction swept from 0 % to 100 %.
This module generalizes that into a small production scheduler:

* :func:`split_offload`      — the paper's experiment: one split by fixed
                               fractions across heterogeneous workers.
* :class:`ChunkScheduler`    — chunked pull-based dispatch (more chunks
                               than workers), which gives
                               - load balancing across devices of unequal
                                 speed (paper §3.6 "scheduling kernels
                                 across multiple devices"),
                               - **straggler mitigation**: once the queue
                                 drains, outstanding chunks are re-issued
                                 speculatively to idle workers and the
                                 first completion wins,
                               - **elastic scaling**: workers may be added
                                 or removed between (or during) runs; a
                                 worker that dies (actor terminates) simply
                                 stops winning chunks and its outstanding
                                 chunks are re-issued.

In the port the paper's CPU/GPU split is literal: a worker bound to the
CPU and one bound to the card (``repro_torch.examples.mandelbrot_offload``).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

from ..analysis.runtime import make_rlock
from .actor import ActorRef
from .errors import DeadlineExceeded
from .memref import tree_release
from .placement import service as placement_service

__all__ = ["split_offload", "ChunkScheduler", "WorkItem"]


def split_offload(workers: Sequence[ActorRef],
                  fractions: Sequence[float],
                  make_payload: Callable[[int, int], tuple],
                  sizes_of: Callable[[Sequence[float]], Sequence[int]],
                  combine: Callable[[List[Any]], Any]) -> Any:
    """One fractional split across heterogeneous workers (paper Fig. 7/8).

    ``sizes_of(fractions)`` returns per-worker item counts; ``make_payload
    (start, size)`` builds each worker's request; ``combine`` reassembles
    ordered results. Zero-sized fractions skip their worker entirely (the
    0 %/100 % endpoints of the paper's sweep).
    """
    if len(workers) != len(fractions):
        raise ValueError("one fraction per worker")
    sizes = list(sizes_of(fractions))
    futures: list[Optional[Future]] = []
    start = 0
    for w, sz in zip(workers, sizes):
        if sz == 0:
            futures.append(None)
        else:
            futures.append(w.request(*make_payload(start, sz)))
        start += sz
    results = [None if f is None else f.result() for f in futures]
    return combine([r for r in results if r is not None])


class WorkItem:
    __slots__ = ("index", "payload", "result", "done", "attempts",
                 "issued_at", "deadline")

    def __init__(self, index: int, payload: tuple,
                 deadline: Optional[float] = None):
        self.index = index
        self.payload = payload
        self.result: Any = None
        self.done = False
        self.attempts = 0
        self.issued_at: float = 0.0
        #: absolute time.monotonic() value; an undispatched chunk whose
        #: deadline has passed is shed (DeadlineExceeded) instead of issued
        self.deadline = deadline


class ChunkScheduler:
    """Pull-based chunk dispatch with speculative re-issue of stragglers.

    Dispatch is **placement-aware** when worker placements are known (an
    :class:`~repro_torch.core.api.ActorPool` provides them, or pass ``devices=``):
    a chunk whose payload carries a :class:`~repro_torch.core.memref.DeviceRef`
    already resident on worker W's device is preferentially handed to W,
    so chunked ref pipelines dispatch zero-copy. (Affinity is a preference,
    not a pin — a worker with no matching chunk falls back to FIFO so
    placement can never starve it.) Refs in chunk payloads must not be
    *donated* by the kernel: a speculative re-issue would replay a
    consumed ref.

    A worker that fails mid-run has its chunk re-queued and re-issued on
    the surviving workers, and first-completion-wins keeps every chunk
    exactly-once.
    """

    def __init__(self, workers, *,
                 straggler_factor: float = 3.0, max_attempts: int = 3,
                 drain_grace: float = 10.0, devices=None):
        placements: dict = {}
        if hasattr(workers, "placements"):  # ActorPool (repro_torch.core.api)
            placements.update(workers.placements)
        if hasattr(workers, "workers"):
            workers = workers.workers
        workers = list(workers)
        if devices is not None:
            if isinstance(devices, dict):
                placements.update(devices)
            else:
                placements.update(
                    {w.actor_id: d for w, d in zip(workers, devices)})
        self._placements = placements
        self._workers: list[ActorRef] = list(workers)
        self.straggler_factor = straggler_factor
        self.max_attempts = max_attempts
        #: how long run() waits for in-flight duplicate/late callbacks to
        #: settle before returning (keeps stats and failure-override
        #: bookkeeping deterministic); 0 restores fire-and-forget returns
        #: at the cost of stats that may still be counting afterwards
        self.drain_grace = drain_grace
        # re-entrant: a request that completes before its done-callback is
        # registered runs on_done synchronously in the issuing thread,
        # which already holds this lock
        self._lock = make_rlock("ChunkScheduler")
        self._cv = threading.Condition(self._lock)
        self.stats = {"dispatched": 0, "speculative": 0, "failed": 0,
                      "expired": 0}

    # -- elastic worker pool -------------------------------------------------
    def add_worker(self, w: ActorRef) -> None:
        with self._lock:
            self._workers.append(w)

    def remove_worker(self, w: ActorRef) -> None:
        with self._lock:
            self._workers = [x for x in self._workers if x.actor_id != w.actor_id]

    @property
    def workers(self) -> list[ActorRef]:
        return list(self._workers)

    # -- placement ------------------------------------------------------
    def _take_pending(self, pending: list, worker: ActorRef) -> "WorkItem":
        """Placement- and deadline-aware pop.

        Candidate set first (zero-copy preference unchanged): chunks whose
        DeviceRef payload is already resident on ``worker``'s device, then
        chunks with no device affinity, else everything. Within the
        candidate set the pick is earliest-deadline-first (chunks without
        a deadline sort last), falling back to FIFO on ties — so an
        SLO-bound serve batch jumps the queue without ever stealing a
        resident chunk from its device."""

        def edf(indices) -> "WorkItem":
            best = min(indices, key=lambda i: (
                pending[i].deadline if pending[i].deadline is not None
                else float("inf"), i))
            return pending.pop(best)

        dev = self._placements.get(worker.actor_id)
        td = getattr(dev, "torch_device", None) if dev is not None else None
        if td is None and not self._placements:
            return edf(range(len(pending)))
        # residency classification is the placement service's call — the
        # same cost source pools and graphs rank by
        local, neutral = placement_service().classify_chunks(
            [item.payload for item in pending], td)
        if local:
            return edf(local)
        if neutral:
            return edf(neutral)
        return edf(range(len(pending)))

    # -- execution ------------------------------------------------------
    def run(self, payloads: Sequence[tuple],
            timeout: Optional[float] = 300.0,
            deadlines: Optional[Sequence[Optional[float]]] = None) -> list:
        """Execute every payload on some worker; returns ordered results.

        ``deadlines`` (one absolute ``time.monotonic`` value or None per
        payload) makes the pick earliest-deadline-first and sheds chunks
        whose deadline already passed before dispatch — those surface as
        :class:`~repro_torch.core.errors.DeadlineExceeded`.
        """
        if deadlines is not None and len(deadlines) != len(payloads):
            raise ValueError("one deadline (or None) per payload")
        items = [WorkItem(i, p, deadlines[i] if deadlines else None)
                 for i, p in enumerate(payloads)]
        pending = list(items)            # not yet issued (FIFO)
        outstanding: dict[int, WorkItem] = {}
        remaining = len(items)
        durations: list[float] = []
        idle: list[ActorRef] = [w for w in self._workers if w.is_alive()]
        if not idle:
            raise RuntimeError("no live workers")
        deadline = None if timeout is None else time.monotonic() + timeout

        inflight = 0                     # issued requests awaiting callback

        def issue(worker: ActorRef, item: WorkItem, speculative: bool) -> None:
            nonlocal inflight
            item.attempts += 1
            item.issued_at = time.monotonic()
            self.stats["dispatched"] += 1
            if speculative:
                self.stats["speculative"] += 1
            inflight += 1
            fut = worker.request(*item.payload)
            fut.add_done_callback(lambda f: on_done(worker, item, f))

        def on_done(worker: ActorRef, item: WorkItem, fut: Future) -> None:
            nonlocal remaining, inflight
            with self._cv:
                inflight -= 1
                failed = fut.exception() is not None
                if failed:
                    self.stats["failed"] += 1
                    if worker.is_alive():
                        idle.append(worker)
                    if not item.done:
                        outstanding.pop(item.index, None)
                        if item.attempts >= self.max_attempts:
                            # permanently failed: record the exception so
                            # run() surfaces it, and stop waiting on it
                            item.done = True
                            item.result = fut.exception()
                            remaining -= 1
                        else:
                            pending.insert(0, item)  # retry soon
                else:
                    durations.append(time.monotonic() - item.issued_at)
                    if not item.done:  # first completion wins
                        item.done = True
                        item.result = fut.result()
                        outstanding.pop(item.index, None)
                        remaining -= 1
                    elif isinstance(item.result, BaseException):
                        # a speculative copy outlived a recorded permanent
                        # failure: prefer the successful result
                        item.result = fut.result()
                    else:
                        # duplicate success from a speculative race: the
                        # loser's DeviceRefs would stay registered forever
                        # (inflating live-bytes placement signals) if
                        # simply dropped
                        tree_release(fut.result())
                    idle.append(worker)
                self._cv.notify_all()

        with self._cv:
            while remaining > 0:
                # issue fresh work
                while pending and idle:
                    w = idle.pop()
                    if not w.is_alive():
                        continue
                    item = self._take_pending(pending, w)
                    if item.done:
                        idle.append(w)  # keep the worker available
                        continue
                    if item.deadline is not None \
                            and time.monotonic() > item.deadline:
                        # shed before dispatch: the deadline already passed,
                        # running it would only waste device time
                        self.stats["expired"] += 1
                        item.done = True
                        item.result = DeadlineExceeded(
                            f"chunk {item.index} missed its deadline "
                            "before dispatch")
                        remaining -= 1
                        idle.append(w)
                        continue
                    outstanding[item.index] = item
                    issue(w, item, speculative=False)
                # speculative re-issue for stragglers
                if not pending and idle and outstanding and durations:
                    med = sorted(durations)[len(durations) // 2]
                    now = time.monotonic()
                    for item in sorted(outstanding.values(), key=lambda x: x.issued_at):
                        if not idle:
                            break
                        if (now - item.issued_at) > self.straggler_factor * max(med, 1e-4) \
                                and item.attempts < self.max_attempts:
                            w = idle.pop()
                            if w.is_alive():
                                issue(w, item, speculative=True)
                if remaining == 0:
                    break
                if pending and not outstanding and inflight == 0 \
                        and not any(w.is_alive() for w in self._workers):
                    # every worker died (e.g. a poison chunk killed the
                    # whole pool): nothing can ever complete — fail fast
                    # instead of spinning until the timeout
                    raise RuntimeError(
                        f"no live workers remain; {len(pending)} chunks "
                        "undispatchable")
                wait_for = 0.05
                if deadline is not None:
                    wait_for = min(wait_for, deadline - time.monotonic())
                    if wait_for <= 0:
                        raise TimeoutError(
                            f"{remaining} chunks unfinished after {timeout}s "
                            f"(outstanding: {sorted(outstanding)}, "
                            f"pending: {len(pending)}, "
                            f"live workers: "
                            f"{sum(w.is_alive() for w in self._workers)}"
                            f"/{len(self._workers)})")
                self._cv.wait(timeout=wait_for)

            # drain callbacks for requests still in flight (speculative
            # duplicates, late failures) so stats — and any success that
            # should override a recorded permanent failure — are settled
            # before results are assembled
            drain_deadline = time.monotonic() + self.drain_grace
            if deadline is not None:
                drain_deadline = min(drain_deadline, deadline)
            while inflight > 0:
                wait_for = drain_deadline - time.monotonic()
                if wait_for <= 0:
                    break
                self._cv.wait(timeout=min(wait_for, 0.05))

        results = []
        for item in items:
            if isinstance(item.result, BaseException):
                raise item.result
            results.append(item.result)
        return results
