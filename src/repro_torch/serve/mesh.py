"""Elastic multi-node serve mesh — the port of the JAX package's
``repro/serve/mesh.py``.

The paper's composability claim — "transparent message passing in
distributed systems on heterogeneous hardware" — means the pieces built
so far should stack into a cluster-scale service without new primitives.
This module does exactly that: a :class:`MeshRouter` on the driver node
shards requests across :class:`EngineReplica` actors (each wrapping one
:class:`~repro_torch.serve.engine.ServeEngine`) that may live in other
processes behind :class:`repro_torch.net.RemoteActorRef` handles. Because
a remote replica is just an :class:`~repro_torch.core.actor.ActorRef`, the
router's dispatch, supervision, and replay paths are identical for local
and remote replicas — the network transparency is inherited, not
re-implemented.

Three behaviors compose on top of existing machinery:

* **replica-aware routing** — requests carrying a ``session`` key (or a
  shared prompt prefix, when ``route_by_prefix`` is on) pick their
  replica by rendezvous (HRW) hashing, so a paged engine's prefix cache
  stays warm; keyless requests go to the replica with the least
  EWMA queue-wait (fed by each replica's
  :meth:`~repro_torch.serve.engine.ServeEngine.load_snapshot`).
* **autoscaling** — when even the *least* loaded replica's EWMA
  queue-wait exceeds the SLO budget there is nowhere good to route, so
  the router spawns a new replica (``NodeRuntime.spawn_remote`` on the
  least-populated worker); when the *most* loaded replica undershoots,
  one replica is drained (``ServeEngine.drain_async``) and released only
  after everything it admitted has been served — scale-in never sheds
  work.
* **failure transparency** — every replica is monitored
  (``system.monitor``, which for remote refs rides the cross-node relay
  of ``repro_torch.net``). A worker SIGKILL becomes NodeDown →
  DownMessage; the router sweeps that replica's in-flight requests and
  replays each on a surviving replica. Exactly-once holds by
  construction: a request's in-flight entry is popped under the router
  lock by whichever of the two death signals (failed reply future vs.
  DownMessage sweep) arrives first, and client futures resolve first-wins
  (:func:`~repro_torch.core.actor._safe_set_result`) — never lost, never
  double-completed. Engine workers never mutate their inputs (the
  ChunkScheduler invariant), so a replayed request recomputes from the
  prompt with no torn state. A completed request's future carries the
  key of the replica that served it (``future.replica``).

Requests *shed* by a replica's admission control (queue overflow, SLO
budget) are **not** replayed — shedding is the overload policy answering
correctly, not a failure. The one admission error the router does retry
is :class:`~repro_torch.serve.request.QueueClosed`: it means the pick
raced a drain, which is a replica lifecycle artifact, not the client's problem.
"""
from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import Future
from functools import partial
from typing import Any, Callable, Dict, List, Optional

from ..analysis.runtime import make_lock
from ..core.actor import (Actor, ActorRef, ActorSystem,
                          _safe_set_exception, _safe_set_result)
from ..core.errors import ActorError, ActorFailed, DownMessage
from ..core.placement import service as placement_service

from .engine import EngineStopped, ServeEngine
from .request import AdmissionError, QueueClosed
from .stats import EWMA

__all__ = ["MeshRouter", "EngineReplica", "ReplicaSpec", "MeshDown",
           "local_replica_stats"]


class MeshDown(ActorError):
    """No live replica remains to route (or replay) a request to."""


# ----------------------------------------------------------------------------
# replica side
# ----------------------------------------------------------------------------
class ReplicaSpec:
    """Picklable recipe for building one engine replica.

    ``factory(system, **kwargs) → ServeEngine`` must be a module-level
    callable (pickled by reference — the worker process imports it, the
    same contract ``spawn_remote`` behaviors already follow) and
    ``kwargs`` must be picklable (names, numbers, dtype names; never
    tensors). The spec crosses the wire inside the ``spawn_remote``
    payload; the engine itself is built *on the worker*, on that
    worker's system, so device handles and actor pools never travel.
    """

    def __init__(self, factory: Callable[..., ServeEngine], **kwargs: Any):
        self.factory = factory
        self.kwargs = kwargs

    def build(self, system: ActorSystem) -> ServeEngine:
        return self.factory(system, **self.kwargs)

    def __repr__(self):
        return f"ReplicaSpec({getattr(self.factory, '__name__', '?')})"


#: engines hosted by this process's EngineReplica actors, keyed by the
#: replica actor id — read by ``local_replica_stats`` so a worker node
#: can expose per-replica load through ``peer_stats`` (see
#: ``NodeRuntime.add_stats_provider``)
_local_replicas: Dict[int, ServeEngine] = {}
_local_lock = make_lock("MeshLocalReplicas")


def local_replica_stats() -> Dict[str, Any]:
    """Load snapshots of every engine replica hosted in this process —
    a node stats provider (cheap by design: ``load_snapshot`` touches no
    latency reservoirs)."""
    with _local_lock:
        engines = dict(_local_replicas)
    return {str(aid): eng.load_snapshot() for aid, eng in engines.items()}


class EngineReplica(Actor):
    """One serve-engine replica behind an actor mailbox.

    Spawned locally (``system.spawn(EngineReplica(spec))``) or on a
    worker (``node.spawn_remote(peer, EngineReplica, spec)``); either way
    the router talks to the same four messages:

    ``("serve", prompt, max_new_tokens, priority, slo_ms)``
        admits the request and **delegates the reply** to the engine's
        per-request future — the actor answers when the request finishes,
        not when it is queued. A shed (:class:`AdmissionError`) comes
        back as a failed future rather than an exception raised from
        ``receive``: raising would terminate the replica actor, turning
        every load shed into a fake replica death.
    ``("stats",)`` → :meth:`ServeEngine.load_snapshot` (cheap, per-tick).
    ``("drain",)`` → delegates to :meth:`ServeEngine.drain_async`; the
        reply arrives once everything admitted has been served.
    ``("ping",)`` → ``"pong"`` (liveness probe).
    """

    def __init__(self, spec: ReplicaSpec):
        super().__init__()
        self.spec = spec
        self.engine: Optional[ServeEngine] = None

    def on_start(self) -> None:
        self.engine = self.spec.build(self.system).start()
        with _local_lock:
            _local_replicas[self.ref.actor_id] = self.engine

    def on_exit(self, reason: Any) -> None:
        with _local_lock:
            _local_replicas.pop(self.ref.actor_id, None)
        if self.engine is not None:
            # non-draining: a replica killed by its supervisor must not
            # block shutdown serving a backlog nobody is routing to —
            # queued requests fail with EngineStopped and the router (if
            # any survives) replays them elsewhere
            self.engine.stop(drain=False, timeout=5.0)

    def receive(self, tag: str, *rest: Any) -> Any:
        if tag == "serve":
            prompt, max_new_tokens, priority, slo_ms = rest
            try:
                return self.engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    priority=priority, slo_ms=slo_ms)
            except AdmissionError as exc:
                fut: Future = Future()
                fut.set_exception(exc)
                return fut
        if tag == "stats":
            return self.engine.load_snapshot()
        if tag == "drain":
            return self.engine.drain_async()
        if tag == "ping":
            return "pong"
        raise ValueError(f"EngineReplica got unknown message {tag!r}")


# ----------------------------------------------------------------------------
# router side
# ----------------------------------------------------------------------------
class _MeshRequest:
    __slots__ = ("id", "prompt", "max_new_tokens", "priority", "slo_ms",
                 "key", "future", "attempts", "t_submit")

    def __init__(self, rid: int, prompt: Any, max_new_tokens: int,
                 priority: int, slo_ms: Optional[float], key: Optional[str]):
        self.id = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        self.slo_ms = slo_ms
        self.key = key
        self.future: Future = Future()
        self.attempts = 0
        self.t_submit = time.monotonic()


class _Replica:
    __slots__ = ("key", "ref", "peer", "state", "inflight", "wait_ewma",
                 "load", "watcher")

    def __init__(self, ref: ActorRef, peer: Optional[str]):
        self.key = str(ref.actor_id)
        self.ref = ref
        self.peer = peer                       # None for local replicas
        self.state = "live"                    # live → draining → released
        self.inflight: Dict[int, _MeshRequest] = {}
        self.wait_ewma = EWMA(alpha=0.3)
        self.load: Dict[str, Any] = {}
        self.watcher: Optional[ActorRef] = None

    def wait_estimate(self) -> float:
        v = self.wait_ewma.value
        return 0.0 if v is None else v


class MeshRouter:
    """Front-end sharding requests across engine replicas (module doc).

    Parameters
    ----------
    system : the driver-side actor system (watchers and the optional
        front-end actor are spawned here).
    node : the driver's :class:`repro_torch.net.NodeRuntime`, or None for a
        purely in-process mesh (autoscale then spawns local replicas).
    spec : the :class:`ReplicaSpec` autoscale uses to spawn replicas;
        optional when the replica set is managed by hand.
    slo_budget_s : the queue-wait the mesh is sized to keep; the
        autoscaler's reference point.
    scale_out_ratio / scale_in_ratio : scale out when the **least**
        loaded replica's EWMA wait exceeds ``slo_budget_s ×
        scale_out_ratio`` (nowhere good to route); scale in when the
        **most** loaded one undershoots ``slo_budget_s ×
        scale_in_ratio``.
    spawn_targets : peers eligible for scale-out (default: the node's
        live peers at decision time; ``[None]`` spawns locally).
    route_by_prefix / prefix_tokens : key session-less requests by their
        prompt prefix so paged prefix caches stay warm.
    """

    def __init__(self, system: ActorSystem, node=None, *,
                 spec: Optional[ReplicaSpec] = None,
                 slo_budget_s: float = 1.0,
                 scale_out_ratio: float = 1.0,
                 scale_in_ratio: float = 0.25,
                 min_replicas: int = 1, max_replicas: int = 4,
                 cooldown_s: float = 5.0,
                 control_interval: float = 0.2,
                 max_attempts: int = 3,
                 route_by_prefix: bool = False, prefix_tokens: int = 8,
                 spawn_targets: Optional[List[Optional[str]]] = None):
        self.system = system
        self.node = node
        self.spec = spec
        self.slo_budget_s = slo_budget_s
        self.scale_out_ratio = scale_out_ratio
        self.scale_in_ratio = scale_in_ratio
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.cooldown_s = cooldown_s
        self.control_interval = control_interval
        self.max_attempts = max_attempts
        self.route_by_prefix = route_by_prefix
        self.prefix_tokens = prefix_tokens
        self.spawn_targets = spawn_targets
        self._lock = make_lock("MeshRouter")
        self._replicas: Dict[str, _Replica] = {}
        self._req_ids = 0
        self._counters: Dict[str, int] = {
            "submitted": 0, "routed": 0, "completed": 0, "failed": 0,
            "shed": 0, "replayed": 0, "replicas_lost": 0,
            "scale_outs": 0, "scale_ins": 0, "prefix_routed": 0,
        }
        self._clock = time.monotonic
        self._last_scale = self._clock()
        self._last_scale_error: Optional[str] = None
        self._stop_evt = threading.Event()
        self._control: Optional[threading.Thread] = None
        self._front: Optional[ActorRef] = None

    # -- replica membership ------------------------------------------------
    def add_replica(self, ref: ActorRef,
                    peer: Optional[str] = None) -> _Replica:
        """Adopt ``ref`` (an :class:`EngineReplica`, local or remote) into
        the routing set and monitor it for death."""
        rep = _Replica(ref, peer)
        router = self

        def on_down(msg):
            if isinstance(msg, DownMessage):
                router._mark_dead(rep, msg.reason)

        rep.watcher = self.system.spawn(on_down)
        with self._lock:
            self._replicas[rep.key] = rep
        self.system.monitor(rep.watcher, ref)
        return rep

    def spawn_replica(self, peer: Optional[str] = None) -> _Replica:
        """Spawn a fresh replica from :attr:`spec` — on ``peer`` via
        ``spawn_remote``, or in-process when ``peer`` is None."""
        if self.spec is None:
            raise ValueError("MeshRouter needs spec= to spawn replicas")
        if peer is not None:
            if self.node is None:
                raise ValueError("remote spawn needs node=")
            ref = self.node.spawn_remote(peer, EngineReplica, self.spec)
        else:
            ref = self.system.spawn(EngineReplica(self.spec))
        return self.add_replica(ref, peer)

    # -- client surface ----------------------------------------------------
    def submit(self, prompt: Any, *, max_new_tokens: int = 8,
               priority: int = 0, slo_ms: Optional[float] = None,
               session: Optional[str] = None) -> Future:
        """Route one request; the returned future resolves to the serving
        replica's :class:`~repro_torch.serve.request.ServeResult` (replays
        on replica death are invisible to the caller; ``future.replica``
        names the replica that served it) or raises the per-request error
        (:class:`AdmissionError` when shed, :class:`MeshDown` when no
        replica survives)."""
        key = session if session is not None else self._prefix_key(prompt)
        with self._lock:
            self._req_ids += 1
            req = _MeshRequest(self._req_ids, prompt, max_new_tokens,
                               priority, slo_ms, key)
            self._counters["submitted"] += 1
        self._dispatch(req)
        return req.future

    def _prefix_key(self, prompt: Any) -> Optional[str]:
        if not self.route_by_prefix:
            return None
        try:
            if isinstance(prompt, (str, bytes)):
                return repr(prompt[:self.prefix_tokens])
            return repr(list(prompt[:self.prefix_tokens]))
        except Exception:
            return None

    # -- dispatch / replay -------------------------------------------------
    def _pick_locked(self, key: Optional[str],
                     exclude: Optional[_Replica] = None) -> Optional[_Replica]:
        live = [r for r in self._replicas.values()
                if r.state == "live" and r is not exclude]
        if not live:
            # replaying after the last healthy replica died: a draining
            # one that is still up beats losing the request
            live = [r for r in self._replicas.values()
                    if r.state == "draining" and r is not exclude]
        if not live:
            return None
        if key is not None:
            # rendezvous (HRW) hashing: each (key, replica) pair scores
            # independently, so replica churn only remaps the keys that
            # hashed to the lost replica — warm prefix caches elsewhere
            # stay warm
            self._counters["prefix_routed"] += 1
            return max(live, key=lambda r: hashlib.md5(
                f"{key}|{r.key}".encode()).digest())
        # keyless requests: least expected wait, ranked by the placement
        # service from (EWMA queue-wait, this router's own inflight
        # fan-in) snapshots — the same auditable cost source every other
        # dispatcher queries. EWMA alone is stale between polls; inflight
        # is always current, so it degrades a replica's score as requests
        # are routed to it
        decision = placement_service().rank_replicas(
            [(r.key, r.wait_estimate(), len(r.inflight)) for r in live],
            context="mesh")
        return next(r for r in live if r.key == decision.chosen)

    def _dispatch(self, req: _MeshRequest) -> None:
        with self._lock:
            rep = self._pick_locked(req.key)
            if rep is None:
                self._counters["failed"] += 1
                exhausted = True
            else:
                rep.inflight[req.id] = req
                self._counters["routed"] += 1
                exhausted = False
        if exhausted:
            _safe_set_exception(req.future, MeshDown(
                f"no live replica to serve request {req.id}"))
            return
        fut = rep.ref.request("serve", req.prompt, req.max_new_tokens,
                              req.priority, req.slo_ms)
        fut.add_done_callback(partial(self._on_serve_done, req, rep))

    def _on_serve_done(self, req: _MeshRequest, rep: _Replica,
                       fut: Future) -> None:
        with self._lock:
            owner = rep.inflight.pop(req.id, None)
        if owner is None:
            # the DownMessage sweep got here first and already replayed
            # (or this request was resolved by a replay) — exactly-once
            # means exactly one path owns the outcome
            return
        exc = fut.exception() if not fut.cancelled() else \
            ActorFailed("request cancelled")
        if exc is None:
            with self._lock:
                self._counters["completed"] += 1
            req.future.replica = rep.key
            _safe_set_result(req.future, fut.result())
            return
        if isinstance(exc, QueueClosed) or \
                isinstance(exc, (ActorFailed, EngineStopped)):
            # replica death (NodeDown is an ActorFailed) or a drain race:
            # the request did not run to completion — replay it
            self._replay(req, rep, exc)
            return
        with self._lock:
            self._counters["shed" if isinstance(exc, AdmissionError)
                           else "failed"] += 1
        _safe_set_exception(req.future, exc)

    def _replay(self, req: _MeshRequest, failed: _Replica,
                reason: BaseException) -> None:
        req.attempts += 1
        if req.attempts >= self.max_attempts:
            with self._lock:
                self._counters["failed"] += 1
            _safe_set_exception(req.future, MeshDown(
                f"request {req.id} failed on {req.attempts} replicas; "
                f"last: {reason!r}"))
            return
        with self._lock:
            rep = self._pick_locked(req.key, exclude=failed)
            if rep is None:
                self._counters["failed"] += 1
            else:
                rep.inflight[req.id] = req
                self._counters["replayed"] += 1
        if rep is None:
            _safe_set_exception(req.future, MeshDown(
                f"request {req.id}: no surviving replica to replay on "
                f"(last failure: {reason!r})"))
            return
        fut = rep.ref.request("serve", req.prompt, req.max_new_tokens,
                              req.priority, req.slo_ms)
        fut.add_done_callback(partial(self._on_serve_done, req, rep))

    def _mark_dead(self, rep: _Replica, reason: Any) -> None:
        """A monitored replica terminated. Sweep its in-flight requests
        into replays — unless it was *released* (scale-in drained it and
        asked it to exit; its inflight is empty and its death is policy,
        not failure)."""
        with self._lock:
            if rep.state == "released":
                return
            was = rep.state
            rep.state = "dead"
            swept = list(rep.inflight.values())
            rep.inflight.clear()
            if was in ("live", "draining"):
                self._counters["replicas_lost"] += 1
        err = reason if isinstance(reason, BaseException) else \
            ActorFailed(f"replica {rep.key} terminated: {reason!r}")
        for req in swept:
            self._replay(req, rep, err)

    # -- control loop: load polling + autoscale ----------------------------
    def start(self) -> "MeshRouter":
        if self._control is not None:
            raise RuntimeError("router already started")
        self._control = threading.Thread(target=self._control_loop,
                                         name="mesh-control", daemon=True)
        self._control.start()
        return self

    def _control_loop(self) -> None:
        # Event.wait, not time.sleep: shutdown() must not linger a full
        # control interval (the node heartbeat had this exact bug)
        while not self._stop_evt.wait(self.control_interval):
            self._poll_replicas()
            try:
                self._autoscale()
            except Exception as exc:
                # a failed scale action retries next tick, but the fault
                # stays visible in stats() instead of vanishing
                with self._lock:
                    self._last_scale_error = repr(exc)

    def _poll_replicas(self) -> None:
        with self._lock:
            reps = [r for r in self._replicas.values() if r.state == "live"]
        for rep in reps:
            try:
                fut = rep.ref.request("stats")
            except Exception:  # lint: dead conn; the monitor path sweeps it
                continue
            fut.add_done_callback(partial(self._on_stats, rep))

    def _on_stats(self, rep: _Replica, fut: Future) -> None:
        if fut.cancelled() or fut.exception() is not None:
            return
        snap = fut.result()
        with self._lock:
            rep.load = snap
            rep.wait_ewma.update(float(snap.get("queue_wait_s", 0.0)))
            # feed the snapshot into the placement service: replica load
            # becomes just another cost source, and per-peer expected
            # waits inform cross-node graph placement
            placement_service().observe_replica(
                rep.key, rep.wait_estimate(), len(rep.inflight),
                peer=rep.peer, load={"queue_depth": snap.get("queue_depth")})

    def _autoscale(self) -> None:
        now = self._clock()
        with self._lock:
            if now - self._last_scale < self.cooldown_s:
                return
            live = [r for r in self._replicas.values() if r.state == "live"]
            if not live:
                return
            waits = [r.wait_estimate() for r in live]
            scale_out = (min(waits) > self.slo_budget_s * self.scale_out_ratio
                         and len(live) < self.max_replicas
                         and self.spec is not None)
            victim = None
            if not scale_out and len(live) > self.min_replicas and \
                    max(waits) < self.slo_budget_s * self.scale_in_ratio:
                victim = min(live, key=lambda r: (len(r.inflight),
                                                  r.wait_estimate()))
                victim.state = "draining"
                self._counters["scale_ins"] += 1
            if scale_out or victim is not None:
                self._last_scale = now
        if scale_out:
            self._scale_out()
        elif victim is not None:
            self._drain_release(victim)

    def _scale_out(self) -> None:
        targets = self.spawn_targets
        if targets is None:
            targets = (self.node.peers() or [None]) if self.node else [None]
        with self._lock:
            pop = {t: 0 for t in targets}
            for r in self._replicas.values():
                if r.state in ("live", "draining") and r.peer in pop:
                    pop[r.peer] += 1
        peer = min(targets, key=lambda t: pop[t])
        self.spawn_replica(peer)
        with self._lock:
            self._counters["scale_outs"] += 1

    def _drain_release(self, rep: _Replica) -> None:
        """Drain-then-release: ``rep`` is already out of the routing set
        (state ``draining``); ask it to serve out its backlog, and only
        on the drain *reply* mark it released and stop the actor."""
        def on_drained(fut: Future, rep=rep) -> None:
            with self._lock:
                # a node death mid-drain already swept it via _mark_dead
                if rep.state != "draining":
                    return
                rep.state = "released"
            try:
                rep.ref.exit(None)
            except Exception:  # lint: replica already dead; exit is best-effort
                pass

        try:
            rep.ref.request("drain").add_done_callback(on_drained)
        except Exception:  # lint: dead replica; the monitor path sweeps it
            pass

    # -- observability / lifecycle -----------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            s: Dict[str, Any] = dict(self._counters)
            s["last_scale_error"] = self._last_scale_error
            s["replicas"] = {
                r.key: {"state": r.state, "peer": r.peer,
                        "inflight": len(r.inflight),
                        "ewma_wait_s": r.wait_estimate(),
                        "load": dict(r.load)}
                for r in self._replicas.values()}
            s["inflight"] = sum(len(r.inflight)
                                for r in self._replicas.values())
        return s

    def live_replicas(self) -> List[str]:
        with self._lock:
            return [r.key for r in self._replicas.values()
                    if r.state == "live"]

    def actor_ref(self) -> ActorRef:
        """The router as an actor: ``("serve", prompt, {kwargs})``
        delegates to :meth:`submit`'s future, ``("stats",)`` snapshots.
        Publish it on the driver's node and any process in the cluster
        can talk to the whole mesh through one network-transparent
        handle."""
        if self._front is not None:
            return self._front
        router = self

        def front(tag: str, *rest: Any) -> Any:
            if tag == "serve":
                prompt = rest[0]
                kwargs = dict(rest[1]) if len(rest) > 1 else {}
                return router.submit(prompt, **kwargs)
            if tag == "stats":
                return router.stats()
            raise ValueError(f"mesh front-end got unknown message {tag!r}")

        self._front = self.system.spawn(front)
        return self._front

    def shutdown(self, drain: bool = False,
                 timeout: Optional[float] = 120.0) -> None:
        """Stop the control loop; with ``drain=True`` also drain every
        live replica (waiting up to ``timeout`` each) and stop it."""
        self._stop_evt.set()
        if self._control is not None:
            self._control.join(timeout=5.0)
            self._control = None
        if not drain:
            return
        with self._lock:
            reps = [r for r in self._replicas.values() if r.state == "live"]
            for r in reps:
                r.state = "draining"
        for rep in reps:
            try:
                rep.ref.request("drain").result(timeout)
            except Exception:  # lint: shutdown drain is best-effort
                pass
            with self._lock:
                if rep.state == "draining":
                    rep.state = "released"
            try:
                rep.ref.exit(None)
            except Exception:  # lint: replica may already be gone at shutdown
                pass

    def __enter__(self) -> "MeshRouter":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False
