"""Continuous-batching serve engine on the actor data plane — the port
of the JAX package's ``repro/serve/engine.py``.

The paper's evaluation argues sub-second duties live or die on offload
efficiency: keep multi-stage work device-resident while messages arrive
asynchronously. :class:`ServeEngine` applies that discipline to request
serving:

* per-request decode state is a pytree of :class:`DeviceRef`\\ s
  (``repro_torch.core.memref.tree_wrap``) that stays device-resident between
  decode steps — the demo test asserts ``RefRegistry.transfer_count``
  stays flat across an entire 32-request run;
* each decode step is one actor message through an
  :class:`~repro_torch.core.api.ActorPool` — placement-aware routing hands the
  batch to a worker whose device already holds the caches;
* the batch composition changes step to step: finished requests **leave**
  immediately (their future resolves) and queued requests **join** free
  slots without stalling the running batch (continuous batching);
* a failed step is re-queued through the
  :class:`~repro_torch.core.scheduler.ChunkScheduler` re-issue machinery — the
  crashed worker is dead to the pool, the retry replays the *unmutated*
  cache refs on another replica (exactly-once results), and permanent
  failures surface as per-request errors, never a crashed engine.

Workers never donate or mutate incoming cache refs; the engine releases a
request's previous-step refs only after the step that superseded them
succeeded. That invariant is what makes mid-batch worker failure
recoverable by replay. Where the JAX package jits the step, the port runs
it eagerly; the step's one host synchronisation is the read-back of the
next tokens. Workers launch on their thread's current stream, and a
``DeviceRef`` read on another stream waits for the stream it was made on.

**Disaggregated paged mode** (``cache_pool=``): instead of a monolithic
``init_fn`` cache built inline in the decode loop, per-request state
lives in a :class:`~repro_torch.serve.kvpool.PagePool` and serving splits into
phases. A prefill worker :class:`~repro_torch.core.api.ActorPool` consumes
admitted prompts off the batcher, writes their KV pages (reusing shared
prompt prefixes copy-free), and hands each request's
:class:`~repro_torch.serve.kvpool.PageTable` to the decode loop by plain ref
handoff — zero host transfers, and a crashed prefill worker is replayed
exactly-once through the same ChunkScheduler machinery the decode step
uses. The decode loop joins prefilled requests into free batch slots the
moment they are ready, so decode batches stay full while long prefills
run on the prefill pool instead of stalling the step loop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..analysis.runtime import make_lock
from ..core.actor import ActorSystem
from ..core.api import ActorPool
from ..core.errors import DeadlineExceeded
from ..core.memref import DeviceRef, to_numpy, tree_release, tree_wrap
from ..core.placement import service as placement_service
from ..core.scheduler import ChunkScheduler

from .batcher import Batcher
from .kvpool import (PagePool, PageTable, make_paged_decode_worker,
                     make_prefill_worker)
from .request import Request, RequestQueue, ServeResult
from .stats import LatencyStats

__all__ = ["ServeEngine", "make_decode_worker", "make_graph_decode_worker",
           "EngineStopped"]


class EngineStopped(RuntimeError):
    """Set on requests abandoned by a non-draining shutdown."""


# ----------------------------------------------------------------------------
# decode worker — the actor behavior a pool replica runs
# ----------------------------------------------------------------------------
def _token_tensor(tokens, device) -> torch.Tensor:
    """The batch's input tokens as an int32 tensor on ``device``."""
    return torch.tensor([int(t) for t in tokens], dtype=torch.int32,
                        device=device)


def _torch_device(device):
    return getattr(device, "torch_device", device)


def make_decode_worker(step_fn: Callable, *, combine: Optional[Callable] = None,
                       split: Optional[Callable] = None,
                       device=None) -> Callable:
    """An actor behavior running one batched decode step.

    ``step_fn(cache, tokens[B]) → (next_tokens[B], new_cache)`` where
    ``cache`` is any pytree batched on the leading axis and ``tokens`` an
    int32 tensor. The worker combines the per-request cache leaves
    (DeviceRefs) on device, runs the step eagerly, and splits the updated
    cache back into per-request DeviceRefs. ``device`` is where the
    tokens go (default: the first cache leaf's device).

    ``combine(leaves, i) → batched leaf`` / ``split(leaf, b, i) → request
    leaf`` override the default stack/index pair (``i`` is the flattened
    leaf index) — model caches whose leaves batch on different axes, or
    carry batch-uniform leaves like a scalar decode position, supply their
    own pair (see ``repro_torch.launch.serve`` for an axis-detecting
    example).

    Input refs are **not** donated or mutated: a step that fails on this
    replica can be replayed verbatim on another (exactly-once results).
    """
    if combine is None:
        combine = lambda leaves, i: torch.stack(leaves)
    if split is None:
        split = lambda leaf, b, i: leaf[b]

    def decode(tag: str, tokens: tuple, caches: tuple, treedef):
        if tag != "step":
            raise ValueError(f"decode worker got unknown message {tag!r}")
        nreq = len(caches)
        nleaves = len(caches[0])
        cols = [combine([caches[b][i].array for b in range(nreq)], i)
                for i in range(nleaves)]
        cache = pytree.tree_unflatten(cols, treedef)
        dev = _torch_device(device) or (cols[0].device if cols else None)
        with torch.no_grad():
            new_tokens, new_cache = step_fn(cache, _token_tensor(tokens, dev))
        leaves = pytree.tree_leaves(new_cache)
        if len(leaves) != nleaves:
            raise ValueError("step_fn changed the cache pytree structure")
        created = []
        try:
            out = []
            for b in range(nreq):
                row = []
                for i, leaf in enumerate(leaves):
                    ref = DeviceRef(split(leaf, b, i))
                    created.append(ref)
                    row.append(ref)
                out.append(tuple(row))
            return to_numpy(new_tokens), tuple(out)
        except BaseException:
            # a failing split/read-back must not leak the per-request
            # refs already carved out — the step will be retried
            for r in created:
                r.release()
            raise

    return decode


def make_graph_decode_worker(step_graph, *, combine: Optional[Callable] = None,
                             split: Optional[Callable] = None,
                             timeout: float = 120.0,
                             device=None) -> Callable:
    """An actor behavior whose decode step is a **built dataflow graph**
    (:meth:`repro_torch.core.graph.Graph.build`), instead of a
    ``step_fn`` — multi-kernel decode steps (fan-out heads, gather/merge
    stages) plug straight into continuous batching.

    Graph contract: sources are ``(tokens[B], *cache_leaves)`` and outputs
    are ``(next_tokens[B], *new_cache_leaves)``, leaves batched on the
    leading axis (override with ``combine``/``split`` as in
    :func:`make_decode_worker`). Cache-leaf outputs declared with
    ``as_ref=True`` stay device-resident across steps; the batched inputs
    are handed to the graph as read-only :class:`DeviceRef`\\ s so interior
    edges dispatch zero-copy. Like the plain worker, nothing is donated
    or mutated: a failed step replays verbatim on another replica.
    """
    if combine is None:
        combine = lambda leaves, i: torch.stack(leaves)
    if split is None:
        split = lambda leaf, b, i: leaf[b]

    def decode(tag: str, tokens: tuple, caches: tuple, treedef):
        if tag != "step":
            raise ValueError(f"decode worker got unknown message {tag!r}")
        nreq = len(caches)
        nleaves = len(caches[0])
        cols = [DeviceRef(combine([caches[b][i].array for b in range(nreq)],
                                  i), access="r")
                for i in range(nleaves)]
        dev = _torch_device(device) or (cols[0].device if cols else None)
        try:
            # running the step graph is the whole of this worker's job:
            # it waits for the step, bounded by ``timeout``, and nothing
            # else queues behind it
            res = step_graph.ask(  # lint: the graph step is this worker's job
                _token_tensor(tokens, dev), *cols, timeout=timeout)
            # a single-output graph resolves to its bare value (the
            # cache-less nleaves == 0 case); normalize before the check
            if not isinstance(res, tuple):
                res = (res,)
            created: List[DeviceRef] = []
            try:
                if len(res) != 1 + nleaves:
                    raise ValueError(
                        "graph step must return (next_tokens, "
                        f"*cache_leaves); got {len(res)} outputs for "
                        f"{nleaves} cache leaves")
                new_tokens, new_cols = res[0], res[1:]
                leaves = [c.array if isinstance(c, DeviceRef)
                          else torch.as_tensor(c) for c in new_cols]
                out = []
                for b in range(nreq):
                    row = []
                    for i, leaf in enumerate(leaves):
                        ref = DeviceRef(split(leaf, b, i))
                        created.append(ref)
                        row.append(ref)
                    out.append(tuple(row))
                for c in new_cols:
                    if isinstance(c, DeviceRef):
                        c.release()
                if isinstance(new_tokens, DeviceRef):
                    toks = new_tokens.to_value()
                    new_tokens.release()
                elif isinstance(new_tokens, torch.Tensor):
                    toks = to_numpy(new_tokens)
                else:
                    toks = np.asarray(new_tokens)
                return toks, tuple(out)
            except BaseException:
                # the graph handed us ownership of its output refs; a
                # failed split/read-back must not leak them (or the
                # per-request refs already carved out) on every retry
                for r in created:
                    r.release()
                tree_release(res)
                raise
        finally:
            # released last: a graph may pass an input leaf through
            # unchanged, so its tensor must stay readable until the split
            # above has consumed it (release is idempotent for that case)
            for c in cols:
                c.release()

    return decode


class _Active:
    """A request resident in the running batch: its queue entry plus the
    flattened DeviceRef leaves of its device-resident cache."""

    __slots__ = ("req", "leaves", "treedef")

    def __init__(self, req: Request, leaves: List[DeviceRef], treedef):
        self.req = req
        self.leaves = leaves
        self.treedef = treedef

    prefix_hit = False

    def release(self) -> None:
        for ref in self.leaves:
            ref.release()
        self.leaves = []


class _ActivePaged:
    """A request resident in the running batch of a paged engine: its
    queue entry plus its page table (the pages live in the engine's
    :class:`~repro_torch.serve.kvpool.PagePool`)."""

    __slots__ = ("req", "table", "prefix_hit")

    def __init__(self, req: Request, table: PageTable, prefix_hit: bool):
        self.req = req
        self.table = table
        self.prefix_hit = prefix_hit

    def release(self) -> None:
        self.table.release_pages()


# ----------------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------------
class ServeEngine:
    """Asynchronous continuous-batching request engine.

    **Monolithic mode** (default): ``init_fn(prompt) → (cache_pytree,
    first_token)`` builds one request's decode state inline in the decode
    loop; ``step_fn(cache, tokens[B]) → (next_tokens[B], new_cache)``
    advances a whole batch one token. The engine owns a worker pool (or
    adopts one via ``pool=``), an admission :class:`RequestQueue`, and a
    :class:`Batcher`; ``submit()`` is the client surface, ``stats()`` the
    observability surface.

    **Paged mode** (``cache_pool=`` a
    :class:`~repro_torch.serve.kvpool.PagePool`): serving disaggregates into a
    prefill phase and a decode phase. ``prefill_fn(prompt) → (entries,
    first_token)`` (entry leaves ``[T, *per_token]``) runs on a dedicated
    prefill worker pool driven by ``prefill_workers`` threads, each
    dispatching through its own ChunkScheduler chunk so a crashed prefill
    worker replays exactly-once; ``step_fn(kv, lengths, tokens) →
    (next_tokens, entries)`` is the paged decode contract
    (:func:`~repro_torch.serve.kvpool.make_paged_decode_worker`). Prefilled
    requests hand their page tables to the decode loop by in-process ref
    handoff (zero host transfers) and join the running batch immediately,
    so long prefills never stall the decode step; identical prompts map
    the same read-sealed pages through the pool's prefix cache.

    ``allow_join=False`` degrades to gang scheduling — a batch runs to
    completion before the next forms. Models whose cache carries
    batch-uniform leaves (e.g. a scalar decode position) need this, since
    a mid-batch joiner would be at a different position.
    """

    def __init__(self, system: ActorSystem, step_fn: Optional[Callable] = None,
                 init_fn: Optional[Callable] = None, *,
                 step_graph=None,
                 cache_pool: Optional[PagePool] = None,
                 prefill_fn: Optional[Callable] = None,
                 prefill_workers: int = 2,
                 share_prefixes: bool = True,
                 pool: Optional[ActorPool] = None, n_workers: int = 2,
                 max_batch: int = 8, max_wait_ms: float = 2.0,
                 allow_join: bool = True, max_attempts: int = 3,
                 step_timeout: float = 120.0,
                 queue: Optional[RequestQueue] = None, device=None,
                 combine: Optional[Callable] = None,
                 split: Optional[Callable] = None):
        self._paged = cache_pool is not None
        if self._paged:
            if prefill_fn is None:
                raise ValueError(
                    "cache_pool mode needs prefill_fn (prompt → (entries, "
                    "first_token)); init_fn is the monolithic path")
            if init_fn is not None:
                raise ValueError(
                    "pass init_fn (monolithic) or cache_pool+prefill_fn "
                    "(paged), not both")
            if step_fn is None or step_graph is not None:
                raise ValueError(
                    "cache_pool mode needs a paged step_fn "
                    "(kv, lengths, tokens) → (next_tokens, entries)")
            if pool is not None:
                raise ValueError(
                    "cache_pool mode builds its own prefill/decode pools; "
                    "adopted pools are a monolithic-mode feature")
        else:
            if init_fn is None:
                raise ValueError(
                    "init_fn is required (per-request cache setup)")
            if step_fn is not None and step_graph is not None:
                raise ValueError("pass step_fn or step_graph, not both")
            if pool is not None and (step_fn is not None
                                     or step_graph is not None):
                raise ValueError(
                    "an adopted pool brings its own decode behavior; "
                    "step_fn/step_graph would be silently ignored — pass "
                    "one or the other")
        behavior = None
        self._prefill_behavior = None
        self._prefill_workers = 0
        self.prefill_pool: Optional[ActorPool] = None
        self._prefill_scheduler: Optional[ChunkScheduler] = None
        if pool is None:
            if device is None:
                # worker placement goes through the cost-model service:
                # least live bytes, then queue depth, deterministic
                # name tie-break (the system's device when it was made
                # with one; LookupError without a card unless the system
                # binds the CPU)
                device = placement_service().pick_device(
                    system.opencl_manager().devices(),
                    context="serve-engine").chosen
            else:
                device = system.opencl_manager().resolve(device)
            if self._paged:
                behavior = make_paged_decode_worker(step_fn, cache_pool)
                self._prefill_behavior = make_prefill_worker(
                    prefill_fn, cache_pool, share_prefixes=share_prefixes)
                self._prefill_workers = max(1, int(prefill_workers))
                prefill_refs = [system.spawn(self._prefill_behavior)
                                for _ in range(self._prefill_workers)]
                self.prefill_pool = ActorPool(
                    system, prefill_refs, policy="round_robin",
                    devices=[device] * len(prefill_refs))
                # straggler speculation stays off: a duplicated prefill
                # would burn compute and allocate a second page set (the
                # scheduler reclaims the loser via tree_release, but the
                # work is wasted); crash *replay* — the exactly-once path
                # this scheduler exists for — does not need it
                self._prefill_scheduler = ChunkScheduler(
                    self.prefill_pool, max_attempts=max_attempts,
                    straggler_factor=float("inf"))
            elif step_graph is not None:
                # the model step is a built dataflow graph (multi-kernel
                # DAG); replicas share the graph's node actors, so the
                # pool here buys step pipelining + crash replay, not
                # extra device parallelism. An *unbuilt* Graph is accepted
                # and built with the fusion pass — contiguous kernel runs
                # in the decode step collapse into single dispatches, and
                # the worker's step_graph.ask() rides the inline-dispatch
                # fast path
                from ..core.graph import Graph as _Graph
                if isinstance(step_graph, _Graph):
                    step_graph = step_graph.build(fuse=True)
                behavior = make_graph_decode_worker(
                    step_graph, combine=combine, split=split,
                    timeout=step_timeout, device=device)
            else:
                behavior = make_decode_worker(step_fn, combine=combine,
                                              split=split, device=device)
            workers = [system.spawn(behavior) for _ in range(n_workers)]
            pool = ActorPool(system, workers, policy="least_loaded",
                             devices=[device] * len(workers))
        elif device is None:
            device = next((d for d in pool.placements.values()
                           if d is not None), None)
        #: engine-owned pools self-heal: a crashed replica (any exception
        #: terminates its actor) is replaced before the next step so
        #: transient faults never permanently shrink capacity; adopted
        #: pools (pool=...) are the caller's to manage
        self._behavior = behavior
        self._n_workers = n_workers if behavior is not None else 0
        self.system = system
        self.pool = pool
        self.device = device
        self.init_fn = init_fn
        self.cache_pool = cache_pool
        self.queue = queue if queue is not None else RequestQueue()
        self.batcher = Batcher(self.queue, max_batch=max_batch,
                               max_wait_ms=max_wait_ms)
        self.max_batch = max_batch
        self.allow_join = allow_join
        self.step_timeout = step_timeout
        self._scheduler = ChunkScheduler(pool, max_attempts=max_attempts)
        self.latency = LatencyStats()
        self.ttft = LatencyStats()
        self._counters: Dict[str, int] = {
            "steps": 0, "tokens": 0, "joined": 0, "left": 0,
            "completed": 0, "failed": 0, "expired": 0, "requeues": 0,
            "respawned": 0, "peak_batch": 0, "batch_slots": 0,
            "prefills": 0, "prefix_hits": 0, "respawned_prefill": 0,
        }
        # prefill threads and the decode loop both bump shared counters
        self._ct_lock = make_lock("ServeEngine")
        self._max_step_gap = 0.0
        self._last_step_end: Optional[float] = None
        self._clock = time.monotonic
        self._stop = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        # paged handoff: prefill threads publish (req, table, first_token,
        # prefix_hit) here; the decode loop joins them into free slots
        self._ready: deque = deque()
        self._ready_cv = threading.Condition()
        self._prefill_inflight = 0
        self._prefill_threads: List[threading.Thread] = []

    def _bump(self, key: str, n: int = 1) -> None:
        with self._ct_lock:
            self._counters[key] += n

    # -- client surface ----------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 8, priority: int = 0,
               slo_ms: Optional[float] = None, block: bool = False,
               timeout: Optional[float] = None) -> Future:
        """Admit one request; returns a future resolving to a
        :class:`ServeResult` (or raising the per-request error). Raises an
        :class:`~repro_torch.serve.request.AdmissionError` when shed."""
        deadline = None if slo_ms is None else self._clock() + slo_ms / 1e3
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      priority=priority, deadline=deadline)
        self.queue.submit(req, block=block, timeout=timeout)
        return req.future

    def start(self) -> "ServeEngine":
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if self._paged:
            self._prefill_threads = [
                threading.Thread(target=self._prefill_loop,
                                 name=f"serve-prefill-{i}", daemon=True)
                for i in range(self._prefill_workers)]
            for t in self._prefill_threads:
                t.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 120.0
             ) -> None:
        """Close admissions and stop the engine thread. ``drain=True``
        (default) serves everything already queued first; ``drain=False``
        fails queued requests with :class:`EngineStopped` (the running
        batch still finishes — its results are already paid for)."""
        self.queue.close()
        self._drain = drain
        self._stop.set()
        with self._ready_cv:
            self._ready_cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
        for t in self._prefill_threads:
            t.join(timeout)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def stats(self) -> Dict[str, Any]:
        with self._ct_lock:
            s: Dict[str, Any] = dict(self._counters)
        s["shed"] = self.queue.shed
        s["admitted"] = self.queue.admitted
        s["queue_depth"] = len(self.queue)
        s["latency"] = self.latency.summary()
        s["ttft"] = self.ttft.summary()
        s["dispatch"] = dict(self._scheduler.stats)
        s["max_step_gap_ms"] = self._max_step_gap * 1e3
        #: fraction of decode-batch slots filled, over every step taken —
        #: the disaggregation win is this staying high under mixed load
        s["occupancy"] = (s["batch_slots"] / (s["steps"] * self.max_batch)
                          if s["steps"] else 0.0)
        if self._paged:
            s["prefill_dispatch"] = dict(self._prefill_scheduler.stats)
            s["pool"] = self.cache_pool.stats()
        return s

    def load_snapshot(self) -> Dict[str, Any]:
        """A small, cheap load summary for a mesh router's scheduling
        tick: queue depth, the queue's EWMA-derived wait estimate, batch
        occupancy, and the lifetime completed/failed counts. Unlike
        :meth:`stats` this touches no latency reservoirs and builds no
        nested dicts — it is polled per tick per replica."""
        with self._ct_lock:
            joined = self._counters["joined"]
            left = self._counters["left"]
            steps = self._counters["steps"]
            slots = self._counters["batch_slots"]
            completed = self._counters["completed"]
            failed = self._counters["failed"]
        return {
            "queue_depth": len(self.queue),
            "queue_wait_s": self.queue.estimated_wait(),
            "active": joined - left,
            "occupancy": (slots / (steps * self.max_batch)
                          if steps else 0.0),
            "max_batch": self.max_batch,
            "steps": steps,
            "completed": completed,
            "failed": failed,
        }

    def drain_async(self) -> Future:
        """Close admissions and drain in the background; the returned
        future resolves (to the final :meth:`stats`) once everything
        already queued has been served and the engine thread has exited.
        This is the mesh scale-in entrypoint: the router stops routing to
        the replica, calls this, and releases the node only after the
        future resolves — so scale-in never sheds admitted work."""
        fut: Future = Future()

        def _drain() -> None:
            try:
                self.stop(drain=True)
                fut.set_result(self.stats())
            except BaseException as exc:  # pragma: no cover - defensive
                if not fut.done():
                    fut.set_exception(exc)

        threading.Thread(target=_drain, name="serve-drain",
                         daemon=True).start()
        return fut

    # -- engine loop -------------------------------------------------------
    def _loop(self) -> None:
        active: list = []
        try:
            if self._paged:
                self._serve_paged(active)
            else:
                self._serve(active)
        except BaseException as exc:  # defensive: never die silently
            for a in list(active):
                self._leave(a, active, error=exc)
            raise

    def _serve(self, active: List[_Active]) -> None:
        while True:
            if self._stop.is_set() and not self._drain:
                self._abandon_queue()
            free = self.max_batch - len(active)
            if free > 0 and (self.allow_join or not active):
                bucket = active[0].req.bucket if active else None
                if active:
                    # join path: grab whatever is ready, never stall the
                    # running batch waiting for company
                    newcomers = self.batcher.take(free, bucket=bucket,
                                                  wait_s=0.0, max_wait_s=0.0)
                else:
                    newcomers = self.batcher.take(free, wait_s=0.02)
                for req in newcomers:
                    self._admit(req, active)
            if not active:
                if self._stop.is_set() and len(self.queue) == 0:
                    return
                continue  # take() above already waited for work
            self._expire(active)
            if active:
                self._step(active)

    def _abandon_queue(self) -> None:
        while True:
            req = self.queue.pop(timeout=0)
            if req is None:
                return
            if not req.future.done():
                req.future.set_exception(
                    EngineStopped("engine stopped before serving request"))

    # -- batch membership --------------------------------------------------
    def _admit(self, req: Request, active: List[_Active]) -> None:
        now = self._clock()
        if req.deadline is not None and req.deadline <= now:
            self._bump("expired")
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.id} expired while queued"))
            return
        created: List[DeviceRef] = []
        try:
            cache, first_token = self.init_fn(req.prompt)
            refs = tree_wrap(cache, device=self.device, created=created)
        except Exception as exc:
            # a bad prompt fails its own request, never the engine — and
            # a wrap that died mid-tree (one bad leaf after several good
            # ones) must not leak the refs already created (shed-path
            # leak regression)
            for ref in created:
                ref.release()
            self._bump("failed")
            if not req.future.done():
                req.future.set_exception(exc)
            return
        leaves, treedef = pytree.tree_flatten(refs)
        # init_fn may be a long prefill: re-check the deadline *after* it
        # ran and release the just-built cache on the shed path instead
        # of parking it in the batch for a doomed decode step
        now = self._clock()
        if req.deadline is not None and req.deadline <= now:
            for ref in leaves:
                ref.release()
            self._bump("expired")
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.id} expired during cache init"))
            return
        if active:
            # the prompt-shape bucket is only a proxy for cache
            # compatibility; verify the real invariant so one malformed
            # joiner sheds itself instead of crashing the whole batch in
            # the worker's tree_unflatten/stack
            seed = active[0]
            if treedef != seed.treedef or \
                    [(l.shape, l.dtype) for l in leaves] != \
                    [(l.shape, l.dtype) for l in seed.leaves]:
                for ref in leaves:
                    ref.release()
                self._bump("failed")
                if not req.future.done():
                    req.future.set_exception(ValueError(
                        f"request {req.id}: cache structure does not match "
                        "the running batch (init_fn inconsistent with the "
                        "shape bucket)"))
                return
        req.last_token = first_token
        active.append(_Active(req, leaves, treedef))
        self._bump("joined")
        with self._ct_lock:
            self._counters["peak_batch"] = max(self._counters["peak_batch"],
                                               len(active))

    def _leave(self, a, active: list,
               error: Optional[BaseException] = None) -> None:
        a.release()
        active.remove(a)
        self._bump("left")
        req = a.req
        if error is not None:
            self._bump("failed")
            if not req.future.done():
                req.future.set_exception(error)
            return
        now = self._clock()
        lat = now - req.t_submit
        self.latency.record(lat)
        self._bump("completed")
        ttft = (req.t_first - req.t_submit
                if req.t_first is not None else lat)
        if not req.future.done():
            req.future.set_result(ServeResult(
                request_id=req.id, tokens=list(req.tokens), latency_s=lat,
                ttft_s=ttft, steps=len(req.tokens),
                prefix_hit=getattr(a, "prefix_hit", False)))

    def _expire(self, active: list) -> None:
        now = self._clock()
        for a in list(active):
            if a.req.deadline is not None and now > a.req.deadline:
                self._bump("expired")
                self._leave(a, active, error=DeadlineExceeded(
                    f"request {a.req.id} missed its deadline mid-decode "
                    f"after {len(a.req.tokens)} tokens"))

    def _heal_pool(self) -> None:
        """Replace crashed replicas in an engine-owned pool (no-op for
        adopted pools). New workers join both the pool and the scheduler's
        worker set, so the very next step can route to them.

        Healing an adopted pool is the caller's job: this engine cannot
        respawn an actor it did not spawn."""
        if self._behavior is None:
            return
        missing = self._n_workers - len(self.pool.live_workers())
        for _ in range(missing):
            ref = self.system.spawn(self._behavior)
            self.pool.add_worker(ref, self.device)
            self._scheduler.add_worker(ref)
            self._bump("respawned")

    def _heal_prefill(self) -> None:
        """Same self-healing for the engine-owned prefill pool: a prefill
        worker killed by a crash (or a poison prompt) is replaced before
        the next prefill dispatch."""
        if self._prefill_behavior is None:
            return
        missing = self._prefill_workers - len(self.prefill_pool.live_workers())
        for _ in range(missing):
            ref = self.system.spawn(self._prefill_behavior)
            self.prefill_pool.add_worker(ref, self.device)
            self._prefill_scheduler.add_worker(ref)
            self._bump("respawned_prefill")

    def _note_step_gap(self) -> None:
        now = self._clock()
        if self._last_step_end is not None:
            self._max_step_gap = max(self._max_step_gap,
                                     now - self._last_step_end)

    # -- one decode step ---------------------------------------------------
    def _step(self, active: List[_Active]) -> None:
        self._heal_pool()
        self._note_step_gap()
        payload = ("step",
                   tuple(a.req.last_token for a in active),
                   tuple(tuple(a.leaves) for a in active),
                   active[0].treedef)
        failed_before = self._scheduler.stats["failed"]
        t0 = self._clock()
        try:
            # one chunk through the ChunkScheduler: its re-issue machinery
            # retries a failed step on another live worker (the crashed
            # one is dead to the pool) up to max_attempts
            result = self._scheduler.run([payload],
                                         timeout=self.step_timeout)[0]
        except Exception as exc:
            # permanent failure: every member surfaces it per-request;
            # the engine itself keeps serving
            self._bump("requeues",
                       self._scheduler.stats["failed"] - failed_before)
            for a in list(active):
                self._leave(a, active, error=exc)
            self._last_step_end = self._clock()
            return
        self._bump("requeues",
                   self._scheduler.stats["failed"] - failed_before)
        self.queue.note_service_time(self._clock() - t0)
        self._bump("steps")
        self._bump("batch_slots", len(active))
        tokens, new_caches = result
        now = self._clock()
        self._last_step_end = now
        for a, tok, new_leaves in zip(list(active), tokens, new_caches):
            for old in a.leaves:
                old.release()
            a.leaves = list(new_leaves)
            token = tok.item() if hasattr(tok, "item") else tok
            a.req.tokens.append(token)
            a.req.last_token = token
            self._bump("tokens")
            if a.req.t_first is None:
                a.req.t_first = now
                self.ttft.record(now - a.req.t_submit)
            if len(a.req.tokens) >= a.req.max_new_tokens:
                self._leave(a, active)

    # ------------------------------------------------------------------
    # paged mode: prefill threads + the paged decode loop
    # ------------------------------------------------------------------
    def _prefill_loop(self) -> None:
        """One prefill thread: pull a prompt off the batcher, prefill it
        through the ChunkScheduler (exactly-once replay of a crashed
        prefill worker), and publish the page table to the decode loop.
        ``prefill_workers`` of these run concurrently, so several long
        prefills overlap each other *and* the decode steps."""
        while True:
            if self._stop.is_set() and not self._drain:
                return
            with self._ready_cv:
                self._prefill_inflight += 1
            try:
                req = self.batcher.take_one(wait_s=0.05)
                if req is None:
                    if self.queue.closed and len(self.queue) == 0:
                        return
                    continue
                self._do_prefill(req)
            finally:
                with self._ready_cv:
                    self._prefill_inflight -= 1
                    self._ready_cv.notify_all()

    def _do_prefill(self, req: Request) -> None:
        now = self._clock()
        if req.deadline is not None and req.deadline <= now:
            self._bump("expired")
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.id} expired while queued for prefill"))
            return
        self._heal_prefill()
        try:
            table, first, hit = self._prefill_scheduler.run(
                [("prefill", req.prompt)], timeout=self.step_timeout)[0]
        except Exception as exc:
            self._bump("failed")
            if not req.future.done():
                req.future.set_exception(exc)
            return
        self._bump("prefills")
        if hit:
            self._bump("prefix_hits")
        req.t_ready = self._clock()
        # shed-path page return: a request whose deadline passed *during*
        # prefill hands its pages straight back to the pool instead of
        # leaking them into a batch it can never finish in
        if req.deadline is not None and req.deadline <= req.t_ready:
            table.release_pages()
            self._bump("expired")
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.id} expired during prefill"))
            return
        with self._ready_cv:
            self._ready.append((req, table, first, hit))
            self._ready_cv.notify_all()

    def _take_ready(self, n: int, wait: bool) -> list:
        with self._ready_cv:
            if wait and not self._ready and not self._stop.is_set():
                self._ready_cv.wait(timeout=0.02)
            out = []
            while self._ready and len(out) < n:
                out.append(self._ready.popleft())
            return out

    def _abandon_ready(self) -> None:
        with self._ready_cv:
            entries = list(self._ready)
            self._ready.clear()
        for req, table, _first, _hit in entries:
            table.release_pages()
            if not req.future.done():
                req.future.set_exception(
                    EngineStopped("engine stopped before serving request"))

    def _paged_idle(self) -> bool:
        with self._ready_cv:
            return (len(self.queue) == 0 and self._prefill_inflight == 0
                    and not self._ready)

    def _serve_paged(self, active: List[_ActivePaged]) -> None:
        while True:
            if self._stop.is_set() and not self._drain:
                self._abandon_queue()
                self._abandon_ready()
            free = self.max_batch - len(active)
            if free > 0:
                for req, table, first, hit in self._take_ready(
                        free, wait=not active):
                    self._admit_paged(req, table, first, hit, active)
            if not active:
                if self._stop.is_set() and self._paged_idle():
                    return
                if self._stop.is_set() and not self._drain:
                    return
                continue  # _take_ready waited for work above
            self._expire(active)
            if active:
                self._step_paged(active)

    def _admit_paged(self, req: Request, table: PageTable, first,
                     hit: bool, active: List[_ActivePaged]) -> None:
        now = self._clock()
        if req.deadline is not None and req.deadline <= now:
            table.release_pages()
            self._bump("expired")
            if not req.future.done():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.id} expired between prefill and join"))
            return
        req.last_token = first
        active.append(_ActivePaged(req, table, hit))
        self._bump("joined")
        with self._ct_lock:
            self._counters["peak_batch"] = max(self._counters["peak_batch"],
                                               len(active))

    def _step_paged(self, active: List[_ActivePaged]) -> None:
        self._heal_pool()
        self._note_step_gap()
        # reserve every request's append slot *before* dispatch: page
        # allocation at a boundary, copy-on-write when the tail is a
        # shared prefix page — so the worker only ever writes private
        # tails, and a replayed step re-reads unmodified pages
        for a in list(active):
            try:
                a.table.prepare_append()
            except Exception as exc:   # PoolExhausted: shed this request
                self._leave(a, active, error=exc)
        if not active:
            return
        payload = ("pstep",
                   tuple(a.req.last_token for a in active),
                   tuple((tuple(a.table.pages), a.table.length)
                         for a in active))
        failed_before = self._scheduler.stats["failed"]
        t0 = self._clock()
        try:
            result = self._scheduler.run([payload],
                                         timeout=self.step_timeout)[0]
        except Exception as exc:
            self._bump("requeues",
                       self._scheduler.stats["failed"] - failed_before)
            for a in list(active):
                self._leave(a, active, error=exc)
            self._last_step_end = self._clock()
            return
        self._bump("requeues",
                   self._scheduler.stats["failed"] - failed_before)
        self.queue.note_service_time(self._clock() - t0)
        self._bump("steps")
        self._bump("batch_slots", len(active))
        tokens, new_tails = result
        now = self._clock()
        self._last_step_end = now
        for a, tok, tail_arrays in zip(list(active), tokens, new_tails):
            a.table.commit_append(tail_arrays)
            token = tok.item() if hasattr(tok, "item") else tok
            a.req.tokens.append(token)
            a.req.last_token = token
            self._bump("tokens")
            if a.req.t_first is None:
                a.req.t_first = now
                self.ttft.record(now - a.req.t_submit)
            if len(a.req.tokens) >= a.req.max_new_tokens:
                self._leave(a, active)
