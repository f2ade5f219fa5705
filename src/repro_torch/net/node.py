"""Network-transparent nodes: the broker/node layer (paper §2.1, CAF's
``middleman``; "Revisiting Actor Programming in C++" describes the
original) — the port of the JAX package's ``repro/net/node.py``.

A :class:`NodeRuntime` wraps one :class:`~repro_torch.core.ActorSystem`
with a socket transport and a per-node **broker actor**. Remote actors are held
through :class:`RemoteActorRef` — an :class:`~repro_torch.core.ActorRef`
subclass, so ``send``/``request``/``ask``/``monitor``/``link`` (and every
consumer built on them: pools, schedulers, pipelines, graphs) work
unchanged on actors living in another process. That is the paper's
network-transparency claim made concrete: local and remote actors share
one handle type.

Payloads cross the wire via :mod:`repro_torch.net.wire` — pickle with
:class:`~repro_torch.core.memref.DeviceRef` leaves auto-spilled at the
boundary (optionally int8-compressed) and unspilled onto a
receiver-chosen device.

Supervision crosses nodes: monitoring a remote actor registers a relay on
its node that forwards the :class:`~repro_torch.core.errors.DownMessage`
home; links are two one-way halves (``ActorSystem._link_half``), one per node.
A heartbeat loop (plus immediate socket-EOF detection) declares a peer
dead, which fails every pending request future to that peer and delivers
``DownMessage``/``ExitMessage`` to local monitors/links of its actors —
so supervisors built on monitors and links and the
:class:`~repro_torch.core.scheduler.ChunkScheduler`'s exactly-once
re-issue work across process boundaries with no special cases.
"""
from __future__ import annotations

import itertools
import os
import pickle
import socket
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from concurrent.futures import TimeoutError as FuturesTimeout

from ..analysis.runtime import make_lock, make_rlock
from ..core.actor import (Actor, ActorRef, ActorSystem, Message,
                          _safe_set_exception, _safe_set_result)
from ..core.errors import ActorError, ActorFailed, DownMessage, ExitMessage

from . import wire

__all__ = ["NodeRuntime", "RemoteActorRef", "NodeDown", "PayloadError"]

#: distinguishes "caller passed no timeout" from an explicit ``None``
#: (= wait forever) in the node-level RPCs (peer_stats, remote_actor,
#: spawn_remote) — mirrors ``ActorRef.ask``
_UNSET = object()


class NodeDown(ActorFailed):
    """A peer node died (socket EOF, heartbeat timeout, or graceful bye);
    raised from pending request futures and carried as the ``reason`` of
    the DownMessages/ExitMessages delivered to its actors' local
    monitors/links."""


class PayloadError(ActorError):
    """A payload blob could not be decoded on the receiving node (e.g. a
    ``spawn_remote`` behavior defined in the driver's ``__main__``, which
    the worker cannot import). Fails only the carrying request — the
    target actor is still alive and the connection stays up, so this is
    deliberately *not* an :class:`ActorFailed` (which would mark the
    remote actor dead on the requesting side)."""


class RemoteActorRef(ActorRef):
    """Handle to an actor living on another node.

    ``actor_id`` is the cluster-unique string ``"<peer>/<id>"`` (pools and
    schedulers key their routing tables by it); ``remote_id`` is the id —
    or published name — in the owning node's namespace. Everything else is
    the plain :class:`ActorRef` surface: ``ask`` inherits the system
    default timeout, ``__mul__`` still builds pipelines, and
    ``system.monitor``/``link`` dispatch here via ``is_remote``.
    """

    __slots__ = ("node", "peer", "remote_id")

    #: duck-typed dispatch flag checked by ActorSystem.monitor/link
    is_remote = True

    def __init__(self, node: "NodeRuntime", peer: str, remote_id):
        super().__init__(f"{peer}/{remote_id}", node.system)
        self.node = node
        self.peer = peer
        self.remote_id = remote_id

    # -- messaging ------------------------------------------------------
    def send(self, *payload: Any, sender: Optional[ActorRef] = None) -> None:
        self.node._send_to(self.peer, self.remote_id, payload)

    def request(self, *payload: Any) -> Future:
        return self.node._request_to(self.peer, self.remote_id, payload)

    # -- supervision ------------------------------------------------------
    def monitor(self, watcher: ActorRef) -> None:
        self.node._monitor_remote(self, watcher)

    def link(self, other: ActorRef) -> None:
        self.node._link_remote(self, other)

    def exit(self, reason: Any = None) -> None:
        self.node._exit_remote(self, reason)

    def is_alive(self) -> bool:
        return self.node._remote_alive(self.peer, self.remote_id)

    def __repr__(self):
        return f"RemoteActorRef#{self.peer}/{self.remote_id}"


class _Relay(Actor):
    """Exit-trapping forwarder: turns a locally delivered DownMessage /
    ExitMessage into a wire frame (or any side effect ``fn`` encodes)."""

    def __init__(self, fn: Callable[[Any], None]):
        super().__init__()
        self.trap_exit = True
        self._fn = fn

    def receive(self, msg):
        self._fn(msg)


class _Broker(Actor):
    """The per-node broker: every inbound frame (except heartbeats, which
    the reader threads answer inline for liveness) funnels through this
    actor's mailbox, so cross-node delivery shares the local runtime's
    ordering and isolation guarantees."""

    def __init__(self, node: "NodeRuntime"):
        super().__init__()
        self.trap_exit = True
        self._node = node

    def receive(self, peer: str, frame: tuple):
        self._node._handle(peer, frame)


#: sentinel for _send_reply: the reply answers a node-level rpc, not an
#: actor request — there is no target actor whose liveness to report
_RPC_TARGET = object()


class _Conn:
    __slots__ = ("peer", "sock", "alive", "last_rx", "wlock", "reader")

    def __init__(self, peer: str, sock: socket.socket):
        self.peer = peer
        self.sock = sock
        self.alive = True
        self.last_rx = time.monotonic()
        self.wlock = make_lock("ConnWrite")
        self.reader: Optional[threading.Thread] = None


def _safe_reason(reason: Any) -> Any:
    """Failure reasons travel inside control frames; an unpicklable one is
    downgraded to an ActorFailed carrying its repr rather than poisoning
    the frame."""
    try:
        pickle.dumps(reason)
        return reason
    except Exception:
        return ActorFailed(repr(reason))


class NodeRuntime:
    """One process's membership in the cluster (see module doc).

    Parameters
    ----------
    system : the local actor system this node fronts.
    name : cluster-unique node name (default: pid-derived).
    listen : optional ``(host, port)`` to accept peers on (port 0 picks a
        free port; see :attr:`address`).
    compress : int8-compress float refs at the wire boundary
        (:func:`repro_torch.dist.collectives.quantize_ref` wire format).
        ``True``/``False`` force the choice; ``"auto"`` delegates it per
        payload to the process-wide placement service's wire-cost model
        (:meth:`repro_torch.core.placement.PlacementService.choose_compress`),
        which compresses only when the estimated bytes saved amortize the
        quantization pass on this hop.
    unspill_device : where inbound refs land (``Device`` wrapper,
        ``torch.device`` or device string) — the paper's "receiver
        chooses" policy. ``None`` lands them on the wrapped system's
        device: ``cuda:0`` unless the system was made with
        ``device="cpu"``; without a card that raises
        :class:`LookupError` here, at construction.
    rpc_timeout : default timeout for the node-level RPCs (``peer_stats``,
        ``remote_actor``, ``spawn_remote``); unset inherits the wrapped
        system's ``default_ask_timeout``, so cluster-wide latency policy is
        configured in one place instead of per-call constants. An explicit
        ``None`` waits forever.
    """

    def __init__(self, system: ActorSystem, name: Optional[str] = None,
                 listen: Optional[Tuple[str, int]] = None, *,
                 compress: Any = False, unspill_device=None,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 5.0,
                 rpc_timeout: Any = _UNSET):
        self.system = system
        self.name = name or f"node-{os.getpid():x}"
        self.compress = compress
        self.unspill_device = (
            system.opencl_manager().find_device().torch_device
            if unspill_device is None
            else getattr(unspill_device, "torch_device", unspill_device))
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.rpc_timeout = (getattr(system, "default_ask_timeout", 120.0)
                            if rpc_timeout is _UNSET else rpc_timeout)
        self._lock = make_rlock("NodeRuntime")
        self._cv = threading.Condition(self._lock)
        self._conns: Dict[str, _Conn] = {}
        self._pending: Dict[int, tuple] = {}   # req_id -> (peer, rid, Future)
        self._req_ids = itertools.count(1)
        self._published: Dict[str, ActorRef] = {}
        self._watchers: Dict[tuple, List[ActorRef]] = {}   # (peer,rid) -> refs
        self._link_locals: Dict[tuple, List[ActorRef]] = {}
        self._monitored_out: set = set()   # (peer, rid) monitor frames sent
        self._linked_out: set = set()
        self._relays: Dict[tuple, ActorRef] = {}  # serving-side forwarders
        self._dead_remote: set = set()
        self._dead_peers: set = set()
        self._closed = False
        #: set by shutdown(); sleep-free loops (heartbeat) wait on it so a
        #: node leaves the cluster promptly instead of lingering up to a
        #: full interval in time.sleep (mesh scale-in inherits that latency)
        self._closed_evt = threading.Event()
        #: extra peer_stats sections: name -> zero-arg callable merged into
        #: the "stats" rpc reply (e.g. the serve mesh's replica load report)
        self._stats_providers: Dict[str, Callable[[], Any]] = {}
        self.stats = {"frames_in": 0, "frames_out": 0, "frames_bad": 0,
                      "peers_lost": 0, "errors_swallowed": 0}
        #: last N exceptions a service loop chose to survive — surfaced
        #: through the "stats" rpc so swallowed faults stay observable
        self._swallowed: deque = deque(maxlen=32)
        self._broker = system.spawn(_Broker(self))
        self._listener: Optional[socket.socket] = None
        if listen is not None:
            self._listener = socket.create_server(listen)
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"{self.name}-accept",
                daemon=True)
            self._accept_thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name=f"{self.name}-heartbeat",
            daemon=True)
        self._hb_thread.start()

    # -- cluster surface ---------------------------------------------------
    @property
    def address(self) -> Optional[Tuple[str, int]]:
        """The ``(host, port)`` peers connect to (None when not listening)."""
        if self._listener is None:
            return None
        return self._listener.getsockname()[:2]

    def connect(self, addr: Tuple[str, int], timeout: float = 30.0) -> str:
        """Dial a listening node; returns the peer's name after the
        hello handshake."""
        sock = socket.create_connection(tuple(addr), timeout=timeout)
        sock.settimeout(timeout)
        wire.write_frame(sock, wire.encode_frame(("hello", self.name)))
        data = wire.read_frame(sock)
        if data is None:
            raise ConnectionError(f"peer at {addr} closed during handshake")
        frame = wire.decode_frame(data)
        if frame[0] != "hello":
            raise ConnectionError(f"bad handshake frame {frame[0]!r}")
        peer = frame[1]
        sock.settimeout(None)
        self._register_conn(peer, sock)
        return peer

    def peers(self) -> List[str]:
        with self._lock:
            return [p for p, c in self._conns.items() if c.alive]

    def wait_for_peer(self, name: str, timeout: float = 30.0) -> bool:
        """Block until ``name`` connects (True) or ``timeout`` expires."""
        with self._cv:
            return self._cv.wait_for(
                lambda: name in self._conns and self._conns[name].alive,
                timeout=timeout)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until every connection has closed (a worker node's main
        loop: serve until the driver goes away)."""
        with self._cv:
            return self._cv.wait_for(
                lambda: self._closed
                or not any(c.alive for c in self._conns.values()),
                timeout=timeout)

    # -- registry ------------------------------------------------------
    def publish(self, name: str, ref: ActorRef) -> ActorRef:
        """Expose ``ref`` to remote lookups under ``name`` (node-local
        namespace)."""
        with self._lock:
            self._published[name] = ref
        return ref

    def _rpc_result(self, peer: str, fut: Future, timeout: Any,
                    what: str) -> Any:
        """Await a node-level rpc reply with the configured timeout. On
        expiry the raised TimeoutError names the peer and its last-rx age
        — a wedged-but-talking peer (recent rx) is distinguishable from a
        silently dead one (stale rx) from the exception alone."""
        if timeout is _UNSET:
            timeout = self.rpc_timeout
        try:
            return fut.result(timeout)
        except FuturesTimeout:
            if fut.done():
                raise  # the rpc itself returned a TimeoutError result
            with self._lock:
                conn = self._conns.get(peer)
            if conn is None:
                age = "never connected"
            else:
                age = (f"last rx {time.monotonic() - conn.last_rx:.1f}s ago, "
                       f"conn {'alive' if conn.alive else 'dead'}")
            raise FuturesTimeout(
                f"{what} to node {peer!r} timed out after {timeout}s "
                f"({age})") from None

    def remote_actor(self, peer: str, name: str,
                     timeout: Any = _UNSET) -> RemoteActorRef:
        """Look up an actor ``peer`` published under ``name``."""
        rid = self._rpc_result(peer, self._rpc(peer, "lookup", (name,)),
                               timeout, f"remote_actor({name!r})")
        return RemoteActorRef(self, peer, rid)

    def spawn_remote(self, peer: str, behavior, *args, publish=None,
                     spawn_kwargs: Optional[dict] = None,
                     timeout: Any = _UNSET) -> RemoteActorRef:
        """Spawn ``behavior`` (a picklable callable / Actor subclass /
        KernelDecl) inside ``peer``'s actor system; optionally publish it
        there under ``publish``. ``spawn_kwargs`` forwards keyword
        arguments to the remote ``spawn`` (e.g. ``emit="ref"`` for a
        kernel declaration placed cross-node by the graph builder).
        Returns the network-transparent handle."""
        rid = self._rpc_result(peer,
                               self._rpc(peer, "spawn",
                                         (behavior, args, publish,
                                          spawn_kwargs or {})),
                               timeout, "spawn_remote")
        return RemoteActorRef(self, peer, rid)

    def peer_stats(self, peer: str, timeout: Any = _UNSET) -> dict:
        """The peer process's ``memory_stats()`` snapshot (plus any
        sections the peer registered via :meth:`add_stats_provider`, e.g.
        the serve mesh's per-replica load report) — how the two-process
        tests assert one spill/unspill pair per wire hop on *both* sides,
        and how a mesh router reads a worker node's load."""
        return self._rpc_result(peer, self._rpc(peer, "stats", ()),
                                timeout, "peer_stats")

    def add_stats_provider(self, name: str,
                           fn: Callable[[], Any]) -> None:
        """Merge ``fn()`` into this node's ``peer_stats`` reply under
        ``name``. A provider that raises contributes its error string
        instead of failing the whole stats rpc."""
        with self._lock:
            self._stats_providers[name] = fn

    def _note_error(self, where: str, exc: BaseException) -> None:
        """Record an exception a service loop survived. deque.append is
        atomic so it stays lock-free, but the counter is a
        read-modify-write and is bumped under the runtime lock (cheap —
        error paths only, and no caller holds another lock here)."""
        self._swallowed.append((where, repr(exc)))
        with self._lock:
            self.stats["errors_swallowed"] += 1

    def swallowed_errors(self) -> list:
        """The last few survived exceptions, newest last."""
        return list(self._swallowed)

    def shutdown(self) -> None:
        """Leave the cluster: graceful byes, close sockets, stop threads.
        Idempotent; does not shut the wrapped ActorSystem down.

        Returns promptly: the heartbeat loop waits on an event rather than
        sleeping through its interval, so a node with a long
        ``heartbeat_interval`` still leaves in milliseconds (regression:
        mesh scale-in used to inherit up to a full interval of latency per
        released node)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns.values())
        self._closed_evt.set()
        for c in conns:
            if c.alive:
                try:
                    self._write(c, ("bye",))
                except Exception:  # lint: best-effort farewell on a closing link
                    pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        for c in conns:
            self._drop_conn(c, NodeDown(f"node {self.name} shut down"),
                            notify=False)
        with self._cv:
            self._cv.notify_all()
        if threading.current_thread() is not self._hb_thread:
            # the event above wakes the loop immediately, so this join is
            # bounded by one liveness sweep, not by heartbeat_interval
            self._hb_thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- outbound (RemoteActorRef backend) ---------------------------------
    def _conn_for(self, peer: str) -> _Conn:
        with self._lock:
            conn = self._conns.get(peer)
        if conn is None or not conn.alive:
            raise NodeDown(f"no live connection to node {peer!r}")
        return conn

    def _write(self, conn: _Conn, frame: tuple) -> None:
        """Send an envelope frame: primitives plus pre-encoded payload
        blobs only (see ``wire.encode_frame``), so the receiver's envelope
        decode cannot fail on user objects."""
        data = wire.encode_frame(frame)
        try:
            with conn.wlock:
                wire.write_frame(conn.sock, data)
        except OSError as exc:
            self._drop_conn(conn, NodeDown(f"write to {conn.peer} failed: "
                                           f"{exc}"))
            raise NodeDown(f"node {conn.peer} unreachable: {exc}") from exc
        self.stats["frames_out"] += 1

    def _encode_payload(self, obj, consume: bool = False,
                        peer: Optional[str] = None) -> bytes:
        return wire.encode(obj, compress=self.compress, consume=consume,
                           peer=peer)

    def _decode_payload(self, blob: bytes):
        return wire.decode(blob, device=self.unspill_device)

    def _send_to(self, peer: str, rid, payload: tuple) -> None:
        conn = self._conn_for(peer)
        self._write(conn, ("send", rid,
                           self._encode_payload(payload, peer=peer)))

    def _pending_request(self, peer: str, rid, make_frame) -> Future:
        """Shared request/reply plumbing: allocate a req_id, register the
        reply future, write ``make_frame(req_id)``; any failure along the
        way (dead peer, payload encode error) fails the future instead of
        leaking a pending entry. ``rid`` tags actor requests (None for
        node-level rpc) so a runtime-refused reply can mark that actor
        dead.

        Every successful round trip is reported to the placement
        service's wire-cost model (payload bytes + elapsed seconds), so
        the hop-latency/throughput estimates that drive cross-node graph
        placement refine themselves from real traffic. The samples
        include remote compute time, which the model treats as smoothed
        upper bounds."""
        fut: Future = Future()
        req_id = next(self._req_ids)
        with self._lock:
            self._pending[req_id] = (peer, rid, fut)
        try:
            # make_frame also encodes the payload blob, so encode errors
            # fail this future like any other send failure
            frame = make_frame(req_id)
            self._write(self._conn_for(peer), frame)
        except Exception as exc:
            with self._lock:
                self._pending.pop(req_id, None)
            _safe_set_exception(fut, exc if isinstance(exc, ActorFailed)
                                else ActorFailed(str(exc)))
            return fut
        blob = frame[-1]
        nbytes = len(blob) if isinstance(blob, (bytes, bytearray)) else 0
        t0 = time.monotonic()
        compressed = self.compress is True

        def _observe(f: Future) -> None:
            if f.cancelled() or f.exception() is not None:
                return      # failures say nothing about hop cost
            from ..core.placement import service as placement_service
            placement_service().observe_hop(
                peer, nbytes, time.monotonic() - t0, compressed=compressed)

        fut.add_done_callback(_observe)
        return fut

    def _request_to(self, peer: str, rid, payload: tuple) -> Future:
        return self._pending_request(
            peer, rid, lambda req_id: ("request", req_id, rid,
                                       self._encode_payload(payload,
                                                            peer=peer)))

    def _rpc(self, peer: str, op: str, args: tuple) -> Future:
        return self._pending_request(
            peer, None, lambda req_id: ("rpc", req_id, op,
                                        self._encode_payload(args,
                                                             peer=peer)))

    def _exit_remote(self, ref: RemoteActorRef, reason: Any) -> None:
        self._write(self._conn_for(ref.peer),
                    ("exit", ref.remote_id, self._reason_blob(reason)))

    def _remote_alive(self, peer: str, rid) -> bool:
        with self._lock:
            conn = self._conns.get(peer)
            return (conn is not None and conn.alive
                    and (peer, rid) not in self._dead_remote)

    # -- cross-node supervision -------------------------------------------
    def _monitor_remote(self, ref: RemoteActorRef, watcher: ActorRef) -> None:
        key = (ref.peer, ref.remote_id)
        with self._lock:
            dead = (key in self._dead_remote
                    or ref.peer in self._dead_peers
                    or ref.peer not in self._conns
                    or not self._conns[ref.peer].alive)
            if not dead:
                self._watchers.setdefault(key, []).append(watcher)
                first = key not in self._monitored_out
                self._monitored_out.add(key)
        if dead:
            watcher.send(DownMessage(ref.actor_id,
                                     NodeDown(f"node {ref.peer} is down")))
            return
        if first:
            try:
                self._write(self._conn_for(ref.peer),
                            ("monitor", ref.remote_id))
            except ActorFailed:
                pass  # the drop path already notified the watcher list

    def _link_remote(self, ref: RemoteActorRef, other: ActorRef) -> None:
        if getattr(other, "is_remote", False):
            raise TypeError(
                "linking two remote actors is not supported from a third "
                "node; link on the node that owns one of them")
        key = (ref.peer, ref.remote_id)
        with self._lock:
            dead = key in self._dead_remote or not self._remote_alive(*key)
            if not dead:
                self._link_locals.setdefault(key, []).append(other)
                first = key not in self._linked_out
                self._linked_out.add(key)
        if dead:
            other.send(ExitMessage(ref.actor_id,
                                   NodeDown(f"node {ref.peer} is down")))
            return
        if first:
            try:
                self._write(self._conn_for(ref.peer), ("link", ref.remote_id))
            except ActorFailed:
                return
        # reverse half: when the local side dies, terminate the remote
        # one. One shared relay per (peer, rid) — the ExitMessage names
        # the dying local actor, so every linked local registers the same
        # forwarder (spawning one per call would grow without bound)
        peer, rid = key
        rkey = ("r", peer, rid)
        with self._lock:
            relay = self._relays.get(rkey)
        if relay is None:
            def forward_exit(msg, peer=peer, rid=rid):
                if isinstance(msg, ExitMessage):
                    try:
                        self._write(self._conn_for(peer),
                                    ("exit_to", rid, msg.actor_id,
                                     self._reason_blob(msg.reason)))
                    except ActorFailed:
                        pass

            relay = self.system.spawn(_Relay(forward_exit))
            with self._lock:
                existing = self._relays.setdefault(rkey, relay)
            if existing is not relay:
                relay.exit(None)   # lost a racing registration
                relay = existing
        self.system._link_half(other, relay)

    # -- connection plumbing ----------------------------------------------
    def _register_conn(self, peer: str, sock: socket.socket) -> _Conn:
        conn = _Conn(peer, sock)
        with self._cv:
            old = self._conns.get(peer)
            if old is not None and old.alive:
                sock.close()
                raise ConnectionError(
                    f"a live peer named {peer!r} is already connected")
            self._conns[peer] = conn
            self._dead_peers.discard(peer)
            # a reconnect is a fresh incarnation: its actor ids restart,
            # so per-actor death/registration state from the dead
            # incarnation must not shadow the new one (stale _dead_remote
            # entries would report live actors dead; stale _monitored_out
            # / _relays entries would swallow new registrations)
            self._dead_remote = {k for k in self._dead_remote
                                 if k[0] != peer}
            self._monitored_out = {k for k in self._monitored_out
                                   if k[0] != peer}
            self._linked_out = {k for k in self._linked_out if k[0] != peer}
            stale_relays = [self._relays.pop(k)
                            for k in list(self._relays) if k[1] == peer]
            self._cv.notify_all()
        for r in stale_relays:
            r.exit(None)   # purged from the dict — also stop the actor
        conn.reader = threading.Thread(
            target=self._read_loop, args=(conn,),
            name=f"{self.name}-rx-{peer}", daemon=True)
        conn.reader.start()
        return conn

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            try:
                sock.settimeout(30.0)
                data = wire.read_frame(sock)
                frame = wire.decode_frame(data) if data else None
                if not frame or frame[0] != "hello":
                    sock.close()
                    continue
                wire.write_frame(sock, wire.encode_frame(("hello", self.name)))
                sock.settimeout(None)
                self._register_conn(frame[1], sock)
            except Exception as exc:
                # a failed handshake must not kill the accept loop, but
                # the fault stays visible in peer_stats
                self._note_error("accept", exc)
                try:
                    sock.close()
                except OSError:
                    pass

    def _read_loop(self, conn: _Conn) -> None:
        def touch():
            # liveness = bytes arriving, not frames completing: a large
            # spill mid-transfer must not read as missed heartbeats
            conn.last_rx = time.monotonic()

        while conn.alive:
            try:
                data = wire.read_frame(conn.sock, on_chunk=touch)
            except (OSError, ConnectionError) as exc:
                self._drop_conn(conn, NodeDown(
                    f"connection to {conn.peer} failed: {exc}"))
                return
            if data is None:
                self._drop_conn(conn, NodeDown(
                    f"node {conn.peer} closed the connection"))
                return
            conn.last_rx = time.monotonic()
            self.stats["frames_in"] += 1
            try:
                frame = wire.decode_frame(data)
            except Exception as exc:
                # envelope frames are primitives-only, so this is a rare
                # malformed/incompatible control frame (e.g. an exotic
                # failure reason) — framing is length-prefixed, the stream
                # is still in sync: skip it rather than killing every
                # in-flight request on a healthy link
                self.stats["frames_bad"] += 1
                self._note_error(f"decode from {conn.peer}", exc)
                continue
            tag = frame[0]
            if tag == "ping":
                try:
                    self._write(conn, ("pong",))
                except ActorFailed:
                    return
                continue
            if tag == "pong":
                continue
            if tag == "bye":
                self._drop_conn(conn, NodeDown(
                    f"node {conn.peer} left the cluster"))
                return
            # everything else is ordered through the broker actor
            self._broker.send(conn.peer, frame)

    def _heartbeat_loop(self) -> None:
        # wait(interval) instead of time.sleep(interval): shutdown() sets
        # the event, so the loop exits immediately instead of finishing a
        # blind sleep first (slow-shutdown regression)
        while not self._closed_evt.wait(self.heartbeat_interval):
            with self._lock:
                conns = [c for c in self._conns.values() if c.alive]
            now = time.monotonic()
            for c in conns:
                if now - c.last_rx > self.heartbeat_timeout:
                    self._drop_conn(c, NodeDown(
                        f"node {c.peer} missed heartbeats for "
                        f"{now - c.last_rx:.1f}s"))
                    continue
                try:
                    self._write(c, ("ping",))
                except ActorFailed:
                    pass  # _write already dropped the conn

    def _drop_conn(self, conn: _Conn, reason: Exception,
                   notify: bool = True) -> None:
        """Peer death: fail its pending futures, deliver DownMessage /
        ExitMessage to local monitors/links of its actors. Idempotent."""
        with self._cv:
            if not conn.alive:
                return
            conn.alive = False
            self._dead_peers.add(conn.peer)
            self.stats["peers_lost"] += 1
            pending = [(k, v) for k, v in self._pending.items()
                       if v[0] == conn.peer]
            for k, _ in pending:
                self._pending.pop(k, None)
            watchers = [(key, refs) for key, refs in self._watchers.items()
                        if key[0] == conn.peer]
            for key, _ in watchers:
                self._watchers.pop(key, None)
            links = [(key, refs) for key, refs in self._link_locals.items()
                     if key[0] == conn.peer]
            for key, _ in links:
                self._link_locals.pop(key, None)
            # relays serving (or forwarding to) the dead peer have nothing
            # left to forward — stop the actors, don't just forget them
            relays = [self._relays.pop(k)
                      for k in list(self._relays) if k[1] == conn.peer]
            self._cv.notify_all()
        try:
            conn.sock.close()
        except OSError:
            pass
        for r in relays:
            r.exit(None)
        for _, (peer, rid, fut) in pending:
            # _safe_set_exception loses the race to a concurrent reply
            # silently — that is the legal outcome, not a hidden fault
            _safe_set_exception(fut, NodeDown(
                f"request to {peer}/{rid} lost: {reason}"))
        if not notify:
            return
        for (peer, rid), refs in watchers:
            for w in refs:
                w.send(DownMessage(f"{peer}/{rid}", reason))
        for (peer, rid), refs in links:
            for l in refs:
                l.send(ExitMessage(f"{peer}/{rid}", reason))

    # -- inbound frame handling (broker-ordered) ----------------------------
    def _resolve(self, rid) -> Optional[int]:
        if isinstance(rid, str):
            with self._lock:
                ref = self._published.get(rid)
            return ref.actor_id if ref is not None else None
        return rid

    def _handle(self, peer: str, frame: tuple) -> None:
        tag = frame[0]
        handler = getattr(self, f"_on_{tag}", None)
        if handler is None:
            return  # unknown frame: forward compatibility
        handler(peer, *frame[1:])

    def _on_send(self, peer: str, rid, blob: bytes) -> None:
        aid = self._resolve(rid)
        if aid is None:
            return
        try:
            payload = self._decode_payload(blob)
        except Exception as exc:
            self.stats["frames_bad"] += 1   # fire-and-forget: drop it
            self._note_error(f"send-payload from {peer}", exc)
            return
        self.system._enqueue(aid, Message(tuple(payload), None, None))

    def _on_request(self, peer: str, req_id: int, rid, blob: bytes) -> None:
        aid = self._resolve(rid)
        fut: Future = Future()
        fut.add_done_callback(
            lambda f: self._send_reply(peer, req_id, f, target_aid=aid))
        if aid is None:
            fut.set_exception(ActorFailed(
                f"node {self.name} has no actor {rid!r}"))
            return
        try:
            payload = self._decode_payload(blob)
        except Exception as exc:
            # a payload only this request can't use (e.g. a behavior class
            # unimportable here) fails this request, not the connection
            fut.set_exception(PayloadError(
                f"node {self.name} could not decode the payload for "
                f"{rid!r}: {exc!r}"))
            return
        self.system._enqueue(aid, Message(tuple(payload), fut, None))

    def _send_reply(self, peer: str, req_id: int, fut: Future,
                    target_aid=_RPC_TARGET) -> None:
        if fut.cancelled():
            ok, value = False, _safe_reason(ActorFailed("request cancelled"))
        else:
            exc = fut.exception()
            if exc is not None:
                ok, value = False, _safe_reason(exc)
            else:
                ok, value = True, fut.result()
        # liveness sampled at reply time: a behavior exception has already
        # terminated the target by now, while a failed *delegated* promise
        # (or a decode error) leaves it alive — this flag, not the error
        # type, is what tells the requester whether to mark the remote
        # actor dead
        if target_aid is _RPC_TARGET:
            alive = True
        else:
            alive = target_aid is not None and self.system._is_alive(target_aid)
        try:
            conn = self._conn_for(peer)
        except ActorFailed:
            return
        try:
            # consume=True: reply refs transfer ownership — spilled in
            # place so the sender's device buffer is dropped at the wire
            blob = self._encode_payload(value, consume=True, peer=peer)
        except Exception as exc:   # unserializable result
            ok, blob = False, self._encode_payload(_safe_reason(exc))
        try:
            self._write(conn, ("reply", req_id, ok, blob, alive))
        except ActorFailed:
            pass

    def _on_reply(self, peer: str, req_id: int, ok: bool, blob: bytes,
                  alive: bool = True) -> None:
        with self._lock:
            entry = self._pending.pop(req_id, None)
        if entry is None:
            return
        _, rid, fut = entry
        try:
            value = self._decode_payload(blob)
        except Exception as exc:
            ok, value = False, PayloadError(
                f"reply from {peer} could not be decoded: {exc!r}")
        if not alive and rid is not None:
            with self._lock:
                self._dead_remote.add((peer, rid))
        if ok:
            _safe_set_result(fut, value)
        else:
            _safe_set_exception(
                fut, value if isinstance(value, BaseException)
                else ActorFailed(repr(value)))

    def _on_rpc(self, peer: str, req_id: int, op: str, blob: bytes) -> None:
        fut: Future = Future()
        fut.add_done_callback(lambda f: self._send_reply(peer, req_id, f))
        try:
            args = self._decode_payload(blob)
        except Exception as exc:
            fut.set_exception(PayloadError(
                f"node {self.name} could not decode rpc payload: {exc!r}"))
            return
        try:
            if op == "spawn":
                # older peers send a 3-tuple (no spawn kwargs)
                behavior, sp_args, publish = args[:3]
                sp_kwargs = args[3] if len(args) > 3 else {}
                ref = self.system.spawn(behavior, *sp_args, **sp_kwargs)
                if publish:
                    self.publish(publish, ref)
                fut.set_result(ref.actor_id)
            elif op == "lookup":
                (name,) = args
                with self._lock:
                    ref = self._published.get(name)
                if ref is None:
                    raise LookupError(
                        f"node {self.name} publishes no actor named "
                        f"{name!r}; available: {sorted(self._published)}")
                fut.set_result(ref.actor_id)
            elif op == "stats":
                from ..core.memref import memory_stats
                snap = memory_stats()
                snap["errors_swallowed"] = self.stats["errors_swallowed"]
                snap["swallowed_errors"] = self.swallowed_errors()
                with self._lock:
                    providers = dict(self._stats_providers)
                for pname, pfn in providers.items():
                    try:
                        snap[pname] = pfn()
                    except Exception as exc:
                        # one broken provider must not cost the whole
                        # stats reply (routers poll this on every tick)
                        snap[pname] = {"error": repr(exc)}
                fut.set_result(snap)
            else:
                raise ValueError(f"unknown rpc op {op!r}")
        except Exception as exc:
            fut.set_exception(exc)

    def _reason_blob(self, reason: Any) -> bytes:
        """Failure reasons are arbitrary user exceptions, so they travel
        as payload blobs like every other user object — never in the
        primitives-only envelope, where a receiver-undecodable reason
        would cost the whole death notification."""
        return self._encode_payload(_safe_reason(reason))

    def _decode_reason(self, peer: str, blob: bytes) -> Any:
        try:
            return self._decode_payload(blob)
        except Exception as exc:
            # the notification must survive even if its reason doesn't
            return PayloadError(
                f"failure reason from {peer} could not be decoded: {exc!r}")

    def _on_exit(self, peer: str, rid, blob: bytes) -> None:
        aid = self._resolve(rid)
        if aid is not None:
            self.system._terminate(aid, self._decode_reason(peer, blob))

    def _on_exit_to(self, peer: str, rid, from_key, blob: bytes) -> None:
        """The peer's side of a link died: deliver an ExitMessage into the
        local target's mailbox (trap_exit-aware via the normal path)."""
        aid = self._resolve(rid)
        if aid is not None:
            ActorRef(aid, self.system).send(
                ExitMessage(f"{peer}/{from_key}",
                            self._decode_reason(peer, blob)))

    def _register_relay(self, peer: str, rid, kind: str) -> None:
        """Serve a peer's monitor ('m') or link ('l') registration for
        local actor ``rid``: spawn (once per key) an exit-trapping relay
        that forwards the death event home as a wire frame, and register
        it through the same locked runtime paths local supervision uses —
        so an already-dead (or unknown) target fires immediately."""
        msg_type, evt_tag = ((DownMessage, "down_evt") if kind == "m"
                             else (ExitMessage, "exit_evt"))
        key = (kind, peer, rid)
        with self._lock:
            if key in self._relays:
                return

        def forward(msg, peer=peer, rid=rid):
            if isinstance(msg, msg_type):
                try:
                    self._write(self._conn_for(peer),
                                (evt_tag, rid, self._reason_blob(msg.reason)))
                except ActorFailed:
                    pass

        relay = self.system.spawn(_Relay(forward))
        with self._lock:
            self._relays[key] = relay
        aid = self._resolve(rid)
        if aid is None:
            relay.send(msg_type(rid, ActorFailed(
                f"node {self.name} has no actor {rid!r}")))
            return
        target = ActorRef(aid, self.system)
        if kind == "m":
            self.system.monitor(relay, target)
        else:
            self.system._link_half(target, relay)

    def _on_monitor(self, peer: str, rid) -> None:
        self._register_relay(peer, rid, "m")

    def _on_link(self, peer: str, rid) -> None:
        self._register_relay(peer, rid, "l")

    def _on_down_evt(self, peer: str, rid, blob: bytes) -> None:
        key = (peer, rid)
        with self._lock:
            self._dead_remote.add(key)
            refs = self._watchers.pop(key, [])
        reason = self._decode_reason(peer, blob)
        for w in refs:
            w.send(DownMessage(f"{peer}/{rid}", reason))

    def _on_exit_evt(self, peer: str, rid, blob: bytes) -> None:
        key = (peer, rid)
        with self._lock:
            self._dead_remote.add(key)
            refs = self._link_locals.pop(key, [])
        reason = self._decode_reason(peer, blob)
        for l in refs:
            l.send(ExitMessage(f"{peer}/{rid}", reason))

    def __repr__(self):
        return (f"NodeRuntime({self.name!r}, peers={self.peers()}, "
                f"published={sorted(self._published)})")
