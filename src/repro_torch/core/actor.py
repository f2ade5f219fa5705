"""A CAF-style actor runtime in Python (paper §2.1, §3.2).

Actors are sub-thread entities with mailboxes, run by a cooperative
scheduler (a shared thread pool approximating CAF's work-stealing
scheduler). They communicate exclusively by asynchronous message passing:

* ``send``     — fire-and-forget (CAF ``send``)
* ``request``  — returns a future for the response (CAF ``request``)
* behaviors may return a *promise* (another future) to delegate the
  response to a different actor — the mechanism the paper's composition
  builds on ("actors may return a 'promise' ... delegated to another actor
  which then becomes responsible for responding to the sender", §3.5).

Fault tolerance (paper §2.1): actors can ``monitor`` each other (the
runtime delivers a :class:`DownMessage` on termination) or ``link``
(bidirectional, delivers :class:`ExitMessage`, killing the receiver unless
it traps exits). This is the substrate a distributed supervisor builds
checkpoint/restart on.
"""
from __future__ import annotations

import itertools
import threading
import traceback
import weakref
from collections import deque
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Optional, Tuple

from .. import trace
from ..analysis.runtime import make_lock
from .errors import ActorFailed, DownMessage, ExitMessage, MailboxClosed

__all__ = ["Actor", "ActorRef", "ActorSystem", "Message"]

_MAX_MSGS_PER_SLICE = 16  # fairness: yield the worker thread periodically

#: distinguishes "caller passed no timeout" from an explicit ``None``
#: (= wait forever) in :meth:`ActorRef.ask`
_UNSET = object()


def _safe_set_result(fut: Optional[Future], value: Any) -> None:
    """Resolve a reply future, tolerating a caller that already cancelled
    it (or a racing duplicate resolution) — a cancelled request must never
    crash the actor that eventually answers it."""
    if fut is None or fut.cancelled():
        return
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


def _safe_set_exception(fut: Optional[Future], exc: BaseException) -> None:
    if fut is None or fut.cancelled():
        return
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


class Message:
    __slots__ = ("payload", "reply_to", "sender", "stamp")

    def __init__(self, payload: Tuple[Any, ...], reply_to: Optional[Future] = None,
                 sender: Optional["ActorRef"] = None):
        self.payload = payload
        self.reply_to = reply_to
        self.sender = sender
        #: while recording, the sender's ``trace.stamp()`` at enqueue: the
        #: receiver's ``actor.mailbox`` and ``actor.receive`` spans carry
        #: its request id
        self.stamp = None


class ActorRef:
    """Network-transparent actor handle (paper: OpenCL actors "use the same
    handle type as actors running on the CPU")."""

    __slots__ = ("actor_id", "_system",)

    def __init__(self, actor_id: int, system: "ActorSystem"):
        self.actor_id = actor_id
        self._system = system

    # -- messaging ------------------------------------------------------
    def send(self, *payload: Any, sender: Optional["ActorRef"] = None) -> None:
        self._system._enqueue(self.actor_id, Message(payload, None, sender))

    def request(self, *payload: Any) -> Future:
        fut: Future = Future()
        self._system._enqueue(self.actor_id, Message(payload, fut, None))
        return fut

    def ask(self, *payload: Any, timeout: Any = _UNSET) -> Any:
        """Synchronous request/receive (paper's ``scoped_actor`` pattern).

        ``timeout`` defaults to the owning system's ``default_ask_timeout``
        (an explicit ``None`` waits forever). On expiry the raised
        :class:`TimeoutError` names the actor and its liveness, so a
        wedged-vs-dead target is identifiable from the exception alone.
        """
        if timeout is _UNSET:
            timeout = getattr(self._system, "default_ask_timeout", 120.0)
        fut = self.request(*payload)
        try:
            return fut.result(timeout=timeout)
        except FuturesTimeout:
            if fut.done():
                # the *behavior* raised a TimeoutError — surface it rather
                # than relabeling it as an ask() timeout
                raise
            alive = "alive" if self.is_alive() else "dead"
            raise FuturesTimeout(
                f"ask() timed out after {timeout}s waiting on actor "
                f"#{self.actor_id} ({alive})") from None

    # -- supervision ------------------------------------------------------
    def monitor(self, watcher: "ActorRef") -> None:
        self._system.monitor(watcher, self)

    def link(self, other: "ActorRef") -> None:
        self._system.link(self, other)

    def exit(self, reason: Any = None) -> None:
        self._system._terminate(self.actor_id, reason)

    def is_alive(self) -> bool:
        return self._system._is_alive(self.actor_id)

    # -- distribution policy ----------------------------------------------
    def __reduce__(self):
        # Mirrors DeviceRef's explicit refusal: a ref is a process-local
        # handle (it closes over the ActorSystem and its scheduler), so
        # shipping one inside a cross-node payload fails here with an
        # actionable message instead of deep inside pickle.
        raise TypeError(
            "ActorRef is a process-local handle and cannot be pickled; "
            "for cross-node use, publish the actor on its node "
            "(NodeRuntime.publish) and resolve it with remote_actor(), "
            "or send plain data instead")

    # -- composition ------------------------------------------------------
    def __mul__(self, other: "ActorRef") -> "ActorRef":
        """``C = B * A`` applies ``A`` first, then ``B`` (paper §3.5,
        Listing 5: ``fuse = move_elems * count_elems * prepare``)."""
        from .api import Pipeline  # local import: avoid cycle
        return Pipeline(self._system, mode="staged").stages(
            [other, self]).build()

    def __repr__(self):
        return f"ActorRef#{self.actor_id}"


class Actor:
    """Base class; subclasses override :meth:`receive`."""

    def __init__(self):
        self.ref: Optional[ActorRef] = None
        self.system: Optional["ActorSystem"] = None
        self.trap_exit = False

    def receive(self, *payload: Any) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def on_start(self) -> None:
        """Hook run before the first message (lazy init, paper §5.1)."""

    def on_exit(self, reason: Any) -> None:
        """Cleanup hook."""


class _FunctionActor(Actor):
    def __init__(self, fn: Callable[..., Any]):
        super().__init__()
        self._fn = fn

    def receive(self, *payload: Any) -> Any:
        return self._fn(*payload)


class _ActorState:
    __slots__ = ("actor", "mailbox", "lock", "scheduled", "alive", "reason",
                 "monitors", "links", "started", "inline")

    def __init__(self, actor: Actor):
        self.actor = actor
        self.mailbox: deque = deque()
        self.lock = make_lock("ActorState")
        self.scheduled = False
        self.alive = True
        self.reason: Any = None
        self.monitors: list = []   # ActorRefs to notify with DownMessage
        self.links: list = []      # ActorRefs to notify with ExitMessage
        self.started = False
        #: True while a synchronous inline call (``try_call_inline``) is
        #: executing the behavior on a caller thread; excludes the drain
        #: loop the same way ``scheduled`` does, so the single-threaded
        #: actor contract holds across both dispatch paths
        self.inline = False


class ActorSystem:
    """Owns actors, the scheduler, and (via ``opencl_manager``) devices.

    Mirrors CAF's ``actor_system``: create one, optionally load the device
    module, spawn actors, shut down.
    """

    def __init__(self, name: str = "repro", max_workers: int = 8,
                 default_ask_timeout: Optional[float] = 120.0,
                 device: Any = None):
        self.name = name
        #: default device of this system's manager (a ``torch.device`` or
        #: its string, e.g. ``"cpu"``); ``None`` binds the first CUDA
        #: device and never falls back to the CPU
        self.device = device
        #: system-wide default for :meth:`ActorRef.ask` (seconds; ``None``
        #: waits forever) — mirrors ``ActorPool.default_timeout`` so the
        #: old hardcoded 120 s is a policy, not a constant
        self.default_ask_timeout = default_ask_timeout
        self._executor = ThreadPoolExecutor(max_workers=max_workers,
                                            thread_name_prefix=f"{name}-sched")
        self._actors: dict[int, _ActorState] = {}
        self._ids = itertools.count(1)
        self._registry_lock = make_lock("ActorSystem")
        self._shutdown = False
        self._manager = None

    # -- spawning ------------------------------------------------------
    def spawn(self, behavior, *args, lazy_init: bool = True, **kwargs) -> ActorRef:
        """Create an actor from a function, an :class:`Actor` subclass, or
        a ``@kernel``-decorated callable (paper §2.1: "actors are created
        using the function spawn"; kernel declarations route through the
        device manager so one ``spawn`` covers both worlds)."""
        from .api import KernelDecl  # local import: avoid cycle
        if isinstance(behavior, KernelDecl):
            return self.opencl_manager().spawn(behavior, *args,
                                               lazy_init=lazy_init, **kwargs)
        if isinstance(behavior, Actor):
            actor = behavior
        elif isinstance(behavior, type) and issubclass(behavior, Actor):
            actor = behavior(*args, **kwargs)
        elif callable(behavior):
            actor = _FunctionActor(behavior)
        else:
            raise TypeError(f"cannot spawn {behavior!r}")
        with self._registry_lock:
            if self._shutdown:
                raise MailboxClosed("actor system is shut down")
            aid = next(self._ids)
            state = _ActorState(actor)
            self._actors[aid] = state
        ref = ActorRef(aid, self)
        actor.ref = ref
        actor.system = self
        if not lazy_init:
            actor.on_start()
            state.started = True
        return ref

    def opencl_manager(self):
        """Device-module accessor named after the paper's
        ``system.opencl_manager()`` (Listing 2)."""
        if self._manager is None:
            from .manager import DeviceManager
            self._manager = DeviceManager(self)
        return self._manager

    # -- supervision ------------------------------------------------------
    def monitor(self, watcher: ActorRef, target: ActorRef) -> None:
        """Register ``watcher`` for a :class:`DownMessage` when ``target``
        terminates.

        The liveness re-check happens **under the target's lock**: a target
        that terminates between an unlocked check and the registration
        would otherwise have already snapshotted its monitor list, and the
        watcher would never hear about the death. If the target is (or
        just became) dead, the ``DownMessage`` is delivered immediately.

        Remote targets (``repro_torch.net.RemoteActorRef``) carry their own
        registration path; dispatching here keeps ``system.monitor`` the
        single network-transparent entry point.
        """
        if getattr(target, "is_remote", False):
            target.monitor(watcher)
            return
        st = self._actors.get(target.actor_id)
        if st is not None:
            with st.lock:
                if st.alive:
                    st.monitors.append(watcher)
                    return
        watcher.send(DownMessage(target.actor_id, st.reason if st else None))

    def link(self, a: ActorRef, b: ActorRef) -> None:
        """Bidirectional link: built from two one-way halves, each
        registered (or fired immediately) under the dying side's lock — a
        link to an actor mid-termination can no longer leave a one-sided
        link whose ``ExitMessage`` never arrives."""
        for x in (a, b):
            if getattr(x, "is_remote", False):
                x.link(b if x is a else a)
                return
        self._link_half(a, b)
        self._link_half(b, a)

    def _link_half(self, target: ActorRef, listener: ActorRef) -> None:
        """One-way link registration: when ``target`` dies, ``listener``
        receives an :class:`ExitMessage`. Re-checks liveness under the
        target's lock and delivers immediately when the target is already
        dead (the cross-node link in ``repro_torch.net`` is two such
        halves)."""
        st = self._actors.get(target.actor_id)
        if st is not None:
            with st.lock:
                if st.alive:
                    st.links.append(listener)
                    return
        listener.send(ExitMessage(target.actor_id, st.reason if st else None))

    # -- inline fast path --------------------------------------------------
    def try_call_inline(self, actor_id: int, payload: tuple
                        ) -> Tuple[bool, Any]:
        """Attempt to run ``actor_id``'s behavior synchronously on the
        calling thread, bypassing the mailbox/scheduler hop (the graph
        orchestrator's dispatch fast path).

        Returns ``(True, result)`` on success, ``(False, None)`` on a
        *miss* — the caller must then fall back to the ordinary mailbox
        path. A miss means the fast path cannot preserve actor semantics
        right now: the actor is dead, has queued messages (mailbox ordering
        must hold), is already executing (``scheduled``/``inline`` — the
        single-threaded contract), or has monitors/links attached (a
        supervised actor keeps the fully-ordered mailbox path so PR 5
        supervision semantics are untouched).

        The reentrancy guard (``_ActorState.inline``) excludes the drain
        loop exactly like ``scheduled`` does: while it is held, newly
        enqueued messages park in the mailbox and are rescheduled when the
        inline call finishes. A behavior that raises terminates the actor
        with the exception as the reason — identical to the mailbox path —
        and the exception propagates to the caller.
        """
        st = self._actors.get(actor_id)
        if st is None:
            return False, None
        with st.lock:
            if (not st.alive or st.mailbox or st.scheduled or st.inline
                    or st.monitors or st.links):
                return False, None
            st.inline = True
        try:
            actor = st.actor
            if not st.started:
                actor.on_start()
                st.started = True
            with (trace.span("actor.receive", actor=actor_id, inline=1)
                  if trace.enabled() else trace.NOOP):
                result = actor.receive(*payload)
        except Exception as exc:
            # terminate *before* releasing the guard: messages that arrived
            # mid-call are failed by the termination sweep rather than
            # handed to a drain racing the death
            self._terminate(actor_id, exc)
            self._release_inline(st, actor_id)
            raise
        self._release_inline(st, actor_id)
        return True, result

    def _release_inline(self, st: "_ActorState", actor_id: int) -> None:
        resubmit = False
        with st.lock:
            st.inline = False
            if st.mailbox and st.alive and not st.scheduled:
                st.scheduled = True
                resubmit = True
        if resubmit:
            try:
                self._executor.submit(self._drain, actor_id)
            except RuntimeError:        # executor shut down: drain inline
                self._drain(actor_id)

    # -- scheduling internals ----------------------------------------------
    def _enqueue(self, actor_id: int, msg: Message) -> None:
        msg.stamp = trace.stamp()
        st = self._actors.get(actor_id)
        delivered = False
        if st is not None:
            # liveness re-checked under the lock: a concurrent
            # _terminate/shutdown() snapshots-and-clears the mailbox under
            # this lock, so appending after an unlocked check would strand
            # the message (and its reply future) forever
            with st.lock:
                if st.alive:
                    st.mailbox.append(msg)
                    delivered = True
                    if st.scheduled or st.inline:
                        # already claimed: a running drain will see the new
                        # message, and an inline call reschedules the drain
                        # in its release path
                        return
                    st.scheduled = True
        if not delivered:
            _safe_set_exception(
                msg.reply_to, ActorFailed(f"actor #{actor_id} is not alive"))
            return
        try:
            self._executor.submit(self._drain, actor_id)
        except RuntimeError:
            # executor already shut down: drain synchronously so the
            # mailbox (and any reply futures) cannot be stranded
            self._drain(actor_id)

    def _drain(self, actor_id: int) -> None:
        st = self._actors.get(actor_id)
        if st is None:
            return
        processed = 0
        while True:
            with st.lock:
                if not st.mailbox or not st.alive or processed >= _MAX_MSGS_PER_SLICE:
                    if st.mailbox and st.alive:
                        # re-submit for fairness instead of hogging the worker
                        self._executor.submit(self._drain, actor_id)
                    else:
                        st.scheduled = False
                    return
                msg = st.mailbox.popleft()
            processed += 1
            self._process(st, actor_id, msg)

    def _process(self, st: _ActorState, actor_id: int, msg: Message) -> None:
        if msg.stamp is None:                     # sent while not recording
            self._receive(st, actor_id, msg)
            return
        trace.waited(msg.stamp, "actor.mailbox", actor=actor_id)
        # the reply is delivered inside the span: the callbacks it runs (a
        # graph's next hop) send under the request's id
        with trace.span_from(msg.stamp, "actor.receive", actor=actor_id,
                             inline=0):
            self._receive(st, actor_id, msg)

    def _receive(self, st: _ActorState, actor_id: int, msg: Message) -> None:
        actor = st.actor
        try:
            if not st.started:
                actor.on_start()
                st.started = True
            if isinstance(msg.payload, tuple) and len(msg.payload) == 1 and \
                    isinstance(msg.payload[0], ExitMessage) and not actor.trap_exit:
                self._terminate(actor_id, msg.payload[0].reason)
                return
            result = actor.receive(*msg.payload)
        except Exception as exc:  # abnormal termination → fault propagation
            _safe_set_exception(msg.reply_to, exc)
            traceback.clear_frames(exc.__traceback__) if exc.__traceback__ else None
            self._terminate(actor_id, exc)
            return
        if msg.reply_to is None:
            return
        if isinstance(result, Future):
            # response promise: delegate (paper §3.5)
            _chain_future(result, msg.reply_to)
        else:
            _safe_set_result(msg.reply_to, result)

    def _terminate(self, actor_id: int, reason: Any) -> None:
        st = self._actors.get(actor_id)
        if st is None:
            return
        with st.lock:
            if not st.alive:
                return
            st.alive = False
            st.reason = reason
            pending = list(st.mailbox)
            st.mailbox.clear()
            monitors, links = list(st.monitors), list(st.links)
        for msg in pending:
            _safe_set_exception(msg.reply_to, ActorFailed(
                f"actor #{actor_id} terminated: {reason!r}"))
        try:
            st.actor.on_exit(reason)
        except Exception:  # pragma: no cover - cleanup must not crash runtime
            pass  # lint: on_exit is user code; the drain loop must survive it
        for m in monitors:
            m.send(DownMessage(actor_id, reason))
        for l in links:
            l.send(ExitMessage(actor_id, reason))

    def _is_alive(self, actor_id: int) -> bool:
        st = self._actors.get(actor_id)
        return bool(st and st.alive)

    # -- lifecycle ------------------------------------------------------
    def shutdown(self, wait: bool = True) -> None:
        with self._registry_lock:
            self._shutdown = True
            ids = list(self._actors)
        for aid in ids:
            self._terminate(aid, None)
        self._executor.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def _chain_future(src: Future, dst: Future) -> None:
    """Forward ``src``'s outcome into ``dst`` (promise delegation).

    Cancellation propagates **backwards** (dst → src): a caller that
    cancels the outer ``request()`` future also cancels the delegated
    promise, so the in-flight work it represents is not silently leaked.
    The back-edge is a *weak* reference — a strong one would close a
    reference cycle with the forward callback and keep chained futures
    (and the DeviceRefs in their results) alive until a gc pass instead
    of dropping promptly; while the promise is pending, its owner (the
    delegate's mailbox) holds it strongly, which is exactly the window
    where cancelling it matters.
    Forward resolution guards against a dst that was cancelled between the
    check and the set (the race is unavoidable — ``Future`` has no
    compare-and-set), so a lost race never crashes the resolving actor.
    """
    src_ref = weakref.ref(src)

    def _src_done(f: Future):
        try:
            if f.cancelled():
                dst.cancel()
                return
            exc = f.exception()
            if exc is not None:
                _safe_set_exception(dst, exc)
            else:
                _safe_set_result(dst, f.result())
        except InvalidStateError:
            pass

    def _dst_done(f: Future):
        if f.cancelled():
            s = src_ref()
            if s is not None:
                s.cancel()

    dst.add_done_callback(_dst_done)
    src.add_done_callback(_src_done)
