"""Declarative kernel-actor API (v2) — the unified surface.

The v1 surface scattered kernel declaration, composition, placement, and
pooling across four call conventions (``DeviceManager.spawn`` with
positional specs, ``ActorRef.__mul__``, the free function ``fuse``, and
``ChunkScheduler``). v2 collapses them into three declarative objects:

* :func:`kernel` — capture the signature and ND-range **at definition
  site**::

      @kernel(In(torch.float32), In(torch.float32),
              Out(torch.float32, shape=(n, n)),
              nd_range=NDRange(dim_vec(n, n)))
      def m_mult(a, b):
          return ops.matmul(a, b)

      worker = system.spawn(m_mult)           # or mngr.spawn(m_mult)
      result = worker.ask(a, b)

* :class:`Pipeline` — one graph object subsuming staged composition
  (paper §3.5 promise chaining) and fused composition (§3.6 single-actor
  nesting)::

      pipe = (Pipeline(system, mode="auto")    # staged | fused | auto
              .stage(prepare).stage(count).stage(move)
              .build())

  ``auto`` fuses when every stage is a kernel or an adapter callable
  placed on one device, and builds staged composition otherwise.

* :class:`ActorPool` / ``DeviceManager.spawn_pool`` — N replicas behind
  one ref, routed round-robin or by load (outstanding requests + device
  queue depth).

The v1 functions (``compose``, ``fuse``, positional ``spawn``) remain as
thin shims over this module.
"""
from __future__ import annotations

import inspect
import itertools
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, List, Optional, Sequence, Union

from ..analysis.runtime import make_lock
from .actor import ActorRef, ActorSystem
from .placement import service as placement_service
from .signature import KernelSignature, NDRange

__all__ = ["kernel", "KernelDecl", "Pipeline", "ActorPool"]

#: distinguishes "caller passed no timeout" from an explicit ``None``
#: (= wait forever) in :meth:`ActorPool.ask`
_UNSET = object()


# ----------------------------------------------------------------------------
# @kernel — declaration-site capture
# ----------------------------------------------------------------------------
class KernelDecl:
    """A declared kernel: callable + captured signature/ND-range.

    Remains directly callable (the undecorated behavior), and is accepted
    by ``ActorSystem.spawn``, ``DeviceManager.spawn``/``spawn_pool``, and
    ``Pipeline.stage``.
    """

    def __init__(self, fn: Callable, specs: Sequence, *,
                 nd_range: Optional[NDRange] = None,
                 name: Optional[str] = None,
                 preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None,
                 donate: bool = True):
        self.fn = fn
        self.specs = tuple(specs)
        self.nd_range = nd_range
        self.name = name or getattr(fn, "__name__", "kernel")
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.donate = donate
        self.signature = KernelSignature(*self.specs)
        self.__name__ = self.name
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def with_options(self, **overrides) -> "KernelDecl":
        """A copy with some declaration fields replaced (e.g. a resized
        ``nd_range`` for a different problem shape)."""
        cfg = dict(nd_range=self.nd_range, name=self.name,
                   preprocess=self.preprocess, postprocess=self.postprocess,
                   donate=self.donate)
        specs = overrides.pop("specs", self.specs)
        fn = overrides.pop("fn", self.fn)
        unknown = set(overrides) - set(cfg)
        if unknown:
            raise TypeError(f"unknown kernel options: {sorted(unknown)}")
        cfg.update(overrides)
        return KernelDecl(fn, specs, **cfg)

    def out_structs(self, input_structs: Sequence):
        """Output meta tensors (shape and dtype only) for the given input
        meta tensors — how :class:`repro_torch.core.graph.Graph` derives
        typed ports from the signature at build time (paper §3.5)."""
        from .facade import detect_fn_kwargs, eval_output_structs
        return eval_output_structs(self.fn, self.signature, self.nd_range,
                                   detect_fn_kwargs(self.fn), input_structs)

    def __repr__(self):
        return (f"<kernel {self.name!r} {self.signature} "
                f"nd_range={self.nd_range}>")


def kernel(*specs, nd_range: Optional[NDRange] = None,
           name: Optional[str] = None,
           preprocess: Optional[Callable] = None,
           postprocess: Optional[Callable] = None,
           donate: bool = True) -> Callable[[Callable], KernelDecl]:
    """Declare a data-parallel kernel at definition site (see module doc)."""

    def decorate(fn: Callable) -> KernelDecl:
        return KernelDecl(fn, specs, nd_range=nd_range, name=name,
                          preprocess=preprocess, postprocess=postprocess,
                          donate=donate)

    return decorate


# ----------------------------------------------------------------------------
# Pipeline — unified staged/fused composition
# ----------------------------------------------------------------------------
class _Stage:
    __slots__ = ("target", "device", "name")

    def __init__(self, target, device, name):
        self.target = target
        self.device = device
        self.name = name


class Pipeline:
    """Builder for multi-stage kernel graphs.

    Stages may be :class:`KernelDecl`\\ s, existing actor refs (kernel or
    plain), or bare callables (adapters between kernel stages). ``build``
    returns an ordinary :class:`ActorRef`; messages flow through stages
    left to right.
    """

    def __init__(self, system: ActorSystem, *, mode: str = "auto",
                 name: str = "pipeline", device=None,
                 nd_range: Optional[NDRange] = None):
        if mode not in ("auto", "staged", "fused"):
            raise ValueError(f"mode must be auto|staged|fused, got {mode!r}")
        self.system = system
        self.mode = mode
        self.name = name
        self.device = device
        self.nd_range = nd_range
        self._stages: List[_Stage] = []

    # -- construction ------------------------------------------------------
    def stage(self, target, *, device=None, name: Optional[str] = None
              ) -> "Pipeline":
        """Append a stage; returns ``self`` for chaining."""
        if not (isinstance(target, (KernelDecl, ActorRef))
                or callable(target)):
            raise TypeError(f"cannot stage {target!r}")
        self._stages.append(_Stage(target, device, name))
        return self

    def stages(self, targets: Sequence) -> "Pipeline":
        """Append several stages at once."""
        for t in targets:
            self.stage(t)
        return self

    # -- introspection -----------------------------------------------------
    def _kernel_actor_of(self, ref: ActorRef):
        from .facade import KernelActor
        st = self.system._actors.get(ref.actor_id)
        actor = st.actor if st else None
        return actor if isinstance(actor, KernelActor) else None

    def _composed_stages_of(self, ref: ActorRef):
        from .compose import ComposedActor
        st = self.system._actors.get(ref.actor_id)
        actor = st.actor if st else None
        return list(actor.stages) if isinstance(actor, ComposedActor) else None

    def resolved_mode(self) -> str:
        """The mode ``build`` will use (resolves ``auto``)."""
        if self.mode != "auto":
            return self.mode
        return "fused" if self._fusable() else "staged"

    def _fusable(self) -> bool:
        devices = set()
        if self.device is not None:
            devices.add(self.device)
        has_kernel = False
        for s in self._stages:
            if s.device is not None:
                devices.add(s.device)
            if isinstance(s.target, KernelDecl):
                has_kernel = True
            elif isinstance(s.target, ActorRef):
                ka = self._kernel_actor_of(s.target)
                if ka is None:
                    return False  # opaque actor: only staged works
                has_kernel = True
                devices.add(ka.device)
            # bare callables are adapters between kernels: fusable
        return has_kernel and len(devices) <= 1

    # -- build -------------------------------------------------------------
    def build(self) -> ActorRef:
        if not self._stages:
            raise ValueError("pipeline has no stages")
        mode = self.resolved_mode()
        if mode == "staged":
            return self._build_staged()
        return self._build_fused()

    def _graph_stages_of(self, ref: ActorRef):
        """The underlying stage refs of a Graph-backed linear pipe (the
        Graph analogue of :meth:`_composed_stages_of` inlining)."""
        from .graph import GraphRef
        if isinstance(ref, GraphRef) and ref.plan.chain_refs:
            return list(ref.plan.chain_refs)
        return None

    def _build_staged(self) -> ActorRef:
        """Staged (event-chained) composition, Listing 4 style — built as a
        **linear dataflow graph** (:class:`repro_torch.core.graph.Graph`).

        Pipeline is the thin linear wrapper over the DAG builder: each
        stage becomes a chain node joined by untyped splat edges (the
        whole payload tuple flows per hop, exactly the v1 semantics), and
        the Graph lowering decides ref emission — an intermediate kernel
        stage is spawned (or cloned, never mutated) with ``emit="ref"``
        whenever its successor can unwrap a
        :class:`~repro_torch.core.memref.DeviceRef`, so data stays
        device-resident between hops and only the final stage honours its
        declared value/reference semantics (paper §3.5).
        """
        from .graph import Graph
        mngr = self.system.opencl_manager()
        # flatten to (kind, target, device), inlining pre-composed chains
        # (v1 ComposedActor refs and Graph-backed linear pipes alike)
        entries: List[tuple] = []
        for s in self._stages:
            if isinstance(s.target, KernelDecl):
                entries.append(("decl", s.target, s.device or self.device))
            elif isinstance(s.target, ActorRef):
                inner = (self._composed_stages_of(s.target)
                         or self._graph_stages_of(s.target))
                for r in (inner if inner else [s.target]):
                    entries.append(("ref", r, None))
            else:
                entries.append(("fn", s.target, None))

        if len(entries) == 1:
            kind, target, device = entries[0]
            if kind == "decl":
                return mngr.spawn(target, device=device)
            if kind == "fn":
                return self.system.spawn(target)
            return target

        g = Graph(self.system, name=self.name)
        cur = g.chain_source()
        for kind, target, device in entries:
            cur = g.chain(target, cur, device=device)
        g.output(cur)
        return g.build()

    def _build_fused(self) -> ActorRef:
        """Fused (single-actor) composition, §3.6 style — re-routed through
        the Graph **fusion pass**: stages become a linear chain graph and
        ``Graph.build(fuse=True)`` collapses the contiguous kernel runs
        into single actors running one composed callable. Staged and fused composition therefore
        converge on one lowering path, and fused pipelines inherit the
        graph's build-time validation, ref accounting, and the
        :meth:`~repro_torch.core.graph.GraphRef.ask` inline-dispatch fast path.
        """
        from .graph import Graph

        entries: List[Any] = []
        device = self.device
        has_kernel = False
        for s in self._stages:
            target = s.target
            if isinstance(target, ActorRef):
                ka = self._kernel_actor_of(target)
                if ka is None:
                    raise TypeError(f"{target} is not a kernel actor; "
                                    "cannot fuse")
                # re-declare the actor's kernel so the graph pass can chain
                # it; the running actor itself is never touched
                entries.append(KernelDecl(
                    ka.fn, ka.signature.specs, nd_range=ka.nd_range,
                    name=ka.kernel_name, preprocess=ka.preprocess,
                    postprocess=ka.postprocess, donate=ka.donate))
                has_kernel = True
                device = device or s.device or ka.device
            elif isinstance(target, KernelDecl):
                entries.append(target)
                has_kernel = True
                device = device or s.device
            elif callable(target):
                entries.append(target)
            else:  # pragma: no cover - guarded in stage()
                raise TypeError(f"cannot fuse {target!r}")
        if not has_kernel:
            raise ValueError("fuse needs at least one kernel stage")
        if self.nd_range is not None:
            # the pipeline-level override resizes the first kernel's index
            # space (the old builder carried it on the fused actor, where
            # it was inert for dispatch)
            for i, e in enumerate(entries):
                if isinstance(e, KernelDecl):
                    entries[i] = e.with_options(nd_range=self.nd_range)
                    break

        g = Graph(self.system, name=self.name)
        cur = g.chain_source()
        for e in entries:
            cur = g.chain(e, cur, device=device,
                          traceable=not isinstance(e, KernelDecl))
        g.output(cur)
        return g.build(fuse=True)


def _bound_fn(fn: Callable, nd_range, local_specs,
              known_kwargs=None) -> Callable:
    """The stage's callable with its static keyword arguments
    (``nd_range``/``local_shapes``) bound, mirroring the facade.
    ``known_kwargs`` reuses a :class:`KernelActor`'s cached detection."""
    if known_kwargs is not None:
        params = known_kwargs
    else:
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):  # pragma: no cover - builtins
            params = {}
    kwargs = {}
    if "nd_range" in params:
        kwargs["nd_range"] = nd_range
    if "local_shapes" in params:
        kwargs["local_shapes"] = tuple(s.resolved_shape()
                                       for s in local_specs)
    if not kwargs:
        return fn

    def bound(*inputs):
        return fn(*inputs, **kwargs)

    return bound


# ----------------------------------------------------------------------------
# ActorPool — replicated kernel actors behind one ref
# ----------------------------------------------------------------------------
class ActorPool:
    """Routes messages across worker replicas.

    Policies:

    * ``round_robin``  — cycle over live workers.
    * ``least_loaded`` — pick the live worker with the fewest outstanding
      requests, tie-broken by its device's command-queue depth
      (``Device.queue_depth()``) and then by the device's live ref bytes
      (the ``DeviceManager`` memory watermark); a slow or memory-pressured
      replica therefore stops winning work as soon as it backs up.

    Routing is **placement-aware**: when a payload carries a
    :class:`~repro_torch.core.memref.DeviceRef`, workers whose device already
    holds that data are preferred (zero-copy dispatch), load-ranked among
    themselves.

    Pools are network-transparent: members may be
    :class:`~repro_torch.net.RemoteActorRef`\\ s (they quack identically and
    key the routing tables by their ``"<peer>/<id>"`` ids). Off-node refs have
    no local device, so placement preference never selects them for a
    device-resident payload — when *no* member matches the payload's
    device, a round-robin pool falls back to round-robin over everyone
    (local and remote alike) instead of pretending to know their load.

    Quacks like an :class:`ActorRef` (``send``/``request``/``ask``/
    ``is_alive``) and exposes ``.workers``/``.placements`` for a chunk
    scheduler to route by.

    Both policies and the residency preference are evaluated by the
    process-wide :class:`~repro_torch.core.placement.PlacementService` — the
    pool feeds its candidates and outstanding counters in and routes to
    whatever the service's auditable
    :class:`~repro_torch.core.placement.PlacementDecision` picks.
    """

    def __init__(self, system: ActorSystem, workers: Sequence[ActorRef], *,
                 policy: str = "round_robin", devices: Optional[Sequence] = None,
                 default_timeout: Optional[float] = 120.0):
        if not workers:
            raise ValueError("pool needs at least one worker")
        if policy not in ("round_robin", "least_loaded"):
            raise ValueError(f"unknown policy {policy!r}")
        self.system = system
        self.policy = policy
        #: default ``ask`` timeout in seconds (None = wait forever); set
        #: per-pool instead of relying on the old hardcoded 120 s
        self.default_timeout = default_timeout
        self._workers = list(workers)
        devices = list(devices) if devices else [None] * len(self._workers)
        self._devices = {w.actor_id: d for w, d in zip(self._workers, devices)}
        self._outstanding = {w.actor_id: 0 for w in self._workers}
        self._rr = itertools.count()
        self._lock = make_lock("ActorPool")

    # -- membership ------------------------------------------------------
    @property
    def workers(self) -> List[ActorRef]:
        with self._lock:
            return list(self._workers)

    @property
    def placements(self) -> dict:
        """``actor_id → Device`` (or None), for placement-aware routing."""
        with self._lock:
            return dict(self._devices)

    def live_workers(self) -> List[ActorRef]:
        return [w for w in self.workers if w.is_alive()]

    def add_worker(self, ref: ActorRef, device=None) -> None:
        with self._lock:
            self._workers.append(ref)
            self._devices[ref.actor_id] = device
            self._outstanding.setdefault(ref.actor_id, 0)

    def is_alive(self) -> bool:
        return bool(self.live_workers())

    def outstanding(self, ref: ActorRef) -> int:
        with self._lock:
            return self._outstanding.get(ref.actor_id, 0)

    # -- routing ------------------------------------------------------
    def _pick(self, payload: tuple = (), exclude=frozenset()) -> ActorRef:
        # caller must hold self._lock (routing state: _rr, _outstanding).
        # Ranking itself — residency preference, least-loaded ordering,
        # round-robin fallback — lives in the process-wide placement
        # service; the pool only maintains membership and the outstanding
        # counters it feeds in as a cost term
        live = [w for w in self._workers if w.is_alive()]
        if not live:
            raise RuntimeError("no live workers in pool")
        if exclude:
            kept = [w for w in live if w.actor_id not in exclude]
            if kept:  # exclusion is a preference: never strand a payload
                live = kept
        decision = placement_service().rank(
            [(w.actor_id, self._devices.get(w.actor_id)) for w in live],
            payload, outstanding=self._outstanding, policy=self.policy,
            rr_tick=lambda: next(self._rr),
            context=f"pool:{self.policy}")
        return next(w for w in live if w.actor_id == decision.chosen)

    def send(self, *payload: Any) -> None:
        with self._lock:
            w = self._pick(payload)
        w.send(*payload)

    def submit(self, *payload: Any, exclude: Sequence[ActorRef] = ()
               ) -> Future:
        """Asynchronous submit: route the payload, bump the chosen worker's
        outstanding count, and return the reply future with ``.worker`` set
        to the chosen ref. Callers that track misbehaving-but-alive
        replicas (slow, suspected-bad) steer retries away from them via
        ``exclude``; a *crashed* replica is excluded implicitly by being
        dead. Exclusion is a preference, not a pin: if every live worker is excluded it is
        ignored rather than stranding the payload.
        """
        excluded = {getattr(w, "actor_id", w) for w in exclude}
        with self._lock:
            w = self._pick(payload, excluded)
            aid = w.actor_id
            self._outstanding[aid] = self._outstanding.get(aid, 0) + 1
        fut = w.request(*payload)

        # the decrement runs in the done-callback *under the pool lock*,
        # pairing with the locked increment above so the counter can never
        # go negative or be lost under concurrent request() callers
        def _done(_f, aid=aid):
            with self._lock:
                self._outstanding[aid] = self._outstanding.get(aid, 0) - 1

        fut.add_done_callback(_done)
        fut.worker = w
        return fut

    def request(self, *payload: Any) -> Future:
        return self.submit(*payload)

    def ask(self, *payload: Any, timeout: Any = _UNSET) -> Any:
        """Synchronous routed request. ``timeout`` defaults to the pool's
        ``default_timeout``; on expiry the raised :class:`TimeoutError`
        names the worker the payload was routed to, so a wedged replica is
        identifiable from the exception alone."""
        if timeout is _UNSET:
            timeout = self.default_timeout
        fut = self.submit(*payload)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeout:
            if fut.done():
                # the *worker* raised a TimeoutError (on 3.11+ the futures
                # class is the builtin) — surface it, don't relabel it as
                # a pool timeout pointing at a healthy replica
                raise
            w = getattr(fut, "worker", None)
            wid = getattr(w, "actor_id", "?")
            # FuturesTimeout: the class existing except-clauses around a
            # future-based API already catch (the builtin alias on 3.11+)
            raise FuturesTimeout(
                f"pool request timed out after {timeout}s; routed to worker "
                f"ActorRef#{wid} ({'alive' if w is not None and w.is_alive() else 'dead'}, "
                f"{self.outstanding(w) if w is not None else '?'} outstanding)"
            ) from None

    def map(self, payloads: Sequence[tuple], *,
            timeout: Optional[float] = 300.0, deadlines=None,
            **scheduler_kwargs) -> list:
        """Run every payload on some worker via :class:`ChunkScheduler`
        (pull-based balancing + straggler re-issue); ``deadlines`` (one
        absolute ``time.monotonic`` value or None per payload) turns on
        the scheduler's earliest-deadline-first pick."""
        from .scheduler import ChunkScheduler
        return ChunkScheduler(self, **scheduler_kwargs).run(
            payloads, timeout=timeout, deadlines=deadlines)

    def __repr__(self):
        return (f"ActorPool({len(self._workers)} workers, "
                f"policy={self.policy!r})")
