"""Cluster-wide placement: one cost model, one decision point (§3, §5.2).

The paper's promise is that the *runtime* decides where data-parallel work
lands. As the reproduction grew, that decision scattered into five private
policies: :meth:`Graph._place` ranked by live DeviceRef bytes,
:meth:`ActorPool._pick` by payload residency, ``ChunkScheduler`` kept its
own preferred-candidate sets, ``MeshRouter`` used EWMA×inflight, and
``repro.net`` int8-compressed at whatever boundary it happened to cross.
This module unifies them behind a single process-wide
:class:`PlacementService` that owns

* the **device cost source** — per-device live/peak bytes and queue depth
  (read straight from :class:`~repro_torch.core.memref.RefRegistry` through the
  :class:`~repro_torch.core.manager.Device` wrappers),
* the **wire cost source** — a :class:`WireCostModel` of per-hop latency
  and bytes-on-wire for raw vs int8 transfers, seeded from BENCH_PR5's
  measured numbers and refined online from observed ``repro.net``
  round-trips (:meth:`PlacementService.observe_hop`), and
* the **replica cost source** — mesh load snapshots fed in through
  :meth:`PlacementService.observe_replica`.

Every query returns an auditable :class:`PlacementDecision` carrying the
chosen target, the scored losing alternatives, and the cost terms that
produced each score; the service keeps a bounded ring of recent decisions
(:meth:`PlacementService.decisions`) so placement behavior is testable and
debuggable in one place with a fake cost table — no multi-process setup
needed.

Lock discipline: the service lock ranks between ``DeviceManager`` and the
``RefRegistry`` leaf (see ``repro/analysis/ORDER.md``) — every dispatcher
(pool, scheduler, router, node runtime) may call in while holding its own
lock, and ranking reads device live-bytes through the registry while the
service lock is held.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..analysis.runtime import make_lock
from .memref import payload_device

__all__ = [
    "WireCostModel", "PlacementDecision", "ScoredAlternative",
    "NodeTarget", "GraphSite", "PlacementService", "service", "set_service",
]


# ----------------------------------------------------------------------------
# wire cost model
# ----------------------------------------------------------------------------
class WireCostModel:
    """Per-hop cost of moving a payload across ``repro.net``.

    A hop costs ``latency + wire_bytes / throughput``; int8 compression
    shrinks ``wire_bytes`` by :attr:`int8_ratio` at the price of a
    quantize/dequantize pass (:attr:`compress_overhead_s` plus a
    throughput term). The defaults are seeded from the BENCH_PR5
    measurements (localhost socket pair, in-process nodes): the n=1024
    round trip pins the base latency, the n=262144 one the throughput,
    and the measured ``wire_raw/wire_int8`` ratio converges on 4.0.

    :meth:`observe` refines the estimate online from real transfer
    timings — small payloads update the latency EWMA, large ones the
    throughput EWMA, optionally per peer. Observed round-trips include
    the remote compute, so they are treated as upper bounds smoothed with
    a small ``alpha`` rather than ground truth.

    Instances are plain mutable state; concurrent mutation goes through
    the owning :class:`PlacementService`'s lock.
    """

    #: payloads at or below this many bytes are latency probes
    SMALL_BYTES = 4096

    def __init__(self, *, latency_s: float = 4.5e-3,
                 bytes_per_s: float = 100e6, int8_ratio: float = 4.0,
                 compress_overhead_s: float = 3e-4,
                 compress_bytes_per_s: float = 1e9,
                 envelope_bytes: int = 256,
                 min_compress_bytes: int = 1024,
                 alpha: float = 0.2):
        self.latency_s = float(latency_s)
        self.bytes_per_s = float(bytes_per_s)
        self.int8_ratio = float(int8_ratio)
        self.compress_overhead_s = float(compress_overhead_s)
        self.compress_bytes_per_s = float(compress_bytes_per_s)
        self.envelope_bytes = int(envelope_bytes)
        self.min_compress_bytes = int(min_compress_bytes)
        self.alpha = float(alpha)
        #: peer -> [latency_s, bytes_per_s] learned from observations
        self._peer: Dict[str, List[float]] = {}
        self.observations = 0

    # -- seeding -----------------------------------------------------------
    @classmethod
    def from_bench(cls, data, **overrides) -> "WireCostModel":
        """Seed a model from a BENCH_PR5-style snapshot: a dict (or path
        to a JSON file) whose ``"sizes"`` section maps ``n<N>`` entries to
        ``remote_hop_us`` / ``wire_raw_bytes`` / ``wire_int8_bytes`` /
        ``compression_ratio``. The smallest size pins latency, the
        largest pins throughput."""
        if isinstance(data, (str, bytes)):
            with open(data, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        sizes = data.get("sizes", data)
        rows = sorted(sizes.values(), key=lambda r: r["wire_raw_bytes"])
        if not rows:
            return cls(**overrides)
        small, big = rows[0], rows[-1]
        kw: Dict[str, Any] = {}
        kw["latency_s"] = small["remote_hop_us"] * 1e-6
        span_s = (big["remote_hop_us"] - small["remote_hop_us"]) * 1e-6
        span_b = big["wire_raw_bytes"] - small["wire_raw_bytes"]
        if span_s > 0 and span_b > 0:
            kw["bytes_per_s"] = span_b / span_s
        ratios = [r["compression_ratio"] for r in rows
                  if r.get("compression_ratio")]
        if ratios:
            kw["int8_ratio"] = max(ratios)
        kw.update(overrides)
        return cls(**kw)

    # -- queries -----------------------------------------------------------
    def _params(self, peer: Optional[str]) -> Tuple[float, float]:
        if peer is not None and peer in self._peer:
            return tuple(self._peer[peer])  # type: ignore[return-value]
        return self.latency_s, self.bytes_per_s

    def wire_bytes(self, nbytes: int, compressed: bool) -> int:
        """Bytes a payload of ``nbytes`` occupies on the wire."""
        body = int(nbytes / self.int8_ratio) if compressed else int(nbytes)
        return body + self.envelope_bytes

    def hop_seconds(self, nbytes: int, compressed: bool = False,
                    peer: Optional[str] = None) -> float:
        """Estimated one-way cost of shipping ``nbytes`` to ``peer``."""
        lat, bps = self._params(peer)
        s = lat + self.wire_bytes(nbytes, compressed) / bps
        if compressed:
            s += self.compress_overhead_s + nbytes / self.compress_bytes_per_s
        return s

    def round_trip_seconds(self, in_bytes: int, out_bytes: int, *,
                           allow_compress: bool = False,
                           peer: Optional[str] = None
                           ) -> Tuple[float, str]:
        """Cheapest request+reply cost and the encoding that achieves it
        (``"raw"`` or ``"int8"``)."""
        raw = (self.hop_seconds(in_bytes, False, peer)
               + self.hop_seconds(out_bytes, False, peer))
        if not allow_compress:
            return raw, "raw"
        c = (self.hop_seconds(in_bytes, True, peer)
             + self.hop_seconds(out_bytes, True, peer))
        return (c, "int8") if c < raw else (raw, "raw")

    def amortizes(self, nbytes: int, peer: Optional[str] = None) -> bool:
        """Does int8 compression pay for itself on this hop?"""
        return (self.hop_seconds(nbytes, True, peer)
                < self.hop_seconds(nbytes, False, peer))

    def choose_compress(self, nbytes: int,
                        peer: Optional[str] = None) -> bool:
        """The wire-boundary decision ``repro.net`` delegates here when a
        node is configured with ``compress="auto"``."""
        return nbytes >= self.min_compress_bytes and \
            self.amortizes(nbytes, peer)

    # -- online refinement -------------------------------------------------
    def observe(self, nbytes: int, seconds: float, *,
                compressed: bool = False,
                peer: Optional[str] = None) -> None:
        """Fold one observed round-trip into the estimate."""
        if seconds <= 0:
            return
        self.observations += 1
        a = self.alpha
        if peer is not None and peer not in self._peer:
            self._peer[peer] = [self.latency_s, self.bytes_per_s]
        cells = ([self._peer[peer]] if peer is not None else []) or []
        if nbytes <= self.SMALL_BYTES:
            self.latency_s += a * (seconds - self.latency_s)
            for c in cells:
                c[0] += a * (seconds - c[0])
        else:
            lat = self.latency_s
            wire = self.wire_bytes(nbytes, compressed)
            rate = wire / max(seconds - lat, 1e-6)
            self.bytes_per_s += a * (rate - self.bytes_per_s)
            for c in cells:
                c[1] += a * (rate - c[1])

    def snapshot(self) -> dict:
        return {"latency_s": self.latency_s, "bytes_per_s": self.bytes_per_s,
                "int8_ratio": self.int8_ratio,
                "observations": self.observations,
                "peers": {p: {"latency_s": v[0], "bytes_per_s": v[1]}
                          for p, v in self._peer.items()}}


# ----------------------------------------------------------------------------
# decisions
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScoredAlternative:
    """One candidate the service considered, with its score and the cost
    terms that produced it (lower cost wins)."""

    target: str
    cost: Any
    terms: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """The auditable outcome of one placement query.

    ``chosen`` is the picked object (a ``Device``, worker id, replica key,
    or :class:`NodeTarget`); ``target`` is its display name;
    ``alternatives`` are *all* scored candidates including the winner, so
    a losing candidate's terms are always reconstructible from the
    record."""

    context: str
    target: str
    chosen: Any
    cost: Any
    terms: Dict[str, Any]
    alternatives: Tuple[ScoredAlternative, ...]
    reason: str = ""

    def explain(self) -> str:
        alts = ", ".join(f"{a.target}={a.cost}" for a in self.alternatives)
        return (f"[{self.context}] -> {self.target} ({self.reason}; "
                f"cost={self.cost}; considered: {alts or 'none'})")


# ----------------------------------------------------------------------------
# remote placement targets
# ----------------------------------------------------------------------------
class NodeTarget:
    """A remote node as a graph-placement candidate.

    Wraps a :class:`~repro.net.NodeRuntime` and the name of a connected
    peer; :meth:`spawn` lands a kernel declaration in the peer's actor
    system via ``spawn_remote`` and returns the network-transparent
    handle, so a remotely placed graph node needs no data-path changes —
    requests auto-spill at the wire and replies unspill onto the driver's
    device like any other remote interaction."""

    def __init__(self, node, peer: str, *, load_s: float = 0.0):
        self.node = node
        self.peer = peer
        #: static load hint in seconds, superseded by live replica
        #: snapshots the service has for this peer
        self.static_load_s = float(load_s)

    @property
    def name(self) -> str:
        return f"node:{self.peer}"

    @property
    def allows_compress(self) -> bool:
        """May the hop use the int8 wire format? True when the wrapped
        node compresses (``compress=True``) or lets the cost model decide
        per payload (``compress="auto"``)."""
        return bool(getattr(self.node, "compress", False))

    def spawn(self, decl, **kwargs):
        return self.node.spawn_remote(self.peer, decl, spawn_kwargs=kwargs)

    def __repr__(self):
        return f"NodeTarget({self.peer!r})"


@dataclasses.dataclass
class GraphSite:
    """What :meth:`Graph.build` tells the service about one placeable
    node: identity, any pinned device, which upstream nodes feed it, and
    the typed edge sizes a wire-cost estimate needs. ``in_bytes`` /
    ``out_bytes`` are None when a port is untyped — an unknown edge is
    never routed over the wire."""

    idx: int
    path: str
    pinned: Any = None
    #: pinned-only nodes (existing actor refs) never fall through to
    #: cost-ranked placement — they already live somewhere
    fixed: bool = False
    producers: Tuple[int, ...] = ()
    in_bytes: Optional[int] = None
    out_bytes: Optional[int] = None
    remote_ok: bool = False


# ----------------------------------------------------------------------------
# the service
# ----------------------------------------------------------------------------
class PlacementService:
    """Process-wide placement authority; see module doc.

    Cost knobs (all injectable for tests):

    * ``dispatch_s`` — estimated seconds a queued dispatch ahead of us
      costs (seeded from BENCH_PR5's ~300 µs local hop).
    * ``mem_s_per_byte`` — pressure penalty per live byte on a device: a
      loaded device keeps winning until its watermark, not forever.
    * ``host_bytes_per_s`` — intra-host device-to-device copy throughput,
      charged when a node lands off its producer's device.
    * ``wire`` — the :class:`WireCostModel` for cross-node hops.
    """

    def __init__(self, *, wire: Optional[WireCostModel] = None,
                 dispatch_s: float = 3e-4,
                 mem_s_per_byte: float = 1e-12,
                 host_bytes_per_s: float = 10e9,
                 audit: int = 256):
        self.wire = wire if wire is not None else WireCostModel()
        self.dispatch_s = float(dispatch_s)
        self.mem_s_per_byte = float(mem_s_per_byte)
        self.host_bytes_per_s = float(host_bytes_per_s)
        self._lock = make_lock("PlacementService")
        self._decisions: deque = deque(maxlen=max(1, int(audit)))
        #: replica key -> latest load snapshot (a mesh cost source)
        self._replica_load: Dict[str, Dict[str, Any]] = {}
        #: peer name -> expected queue wait seconds, from replica feeds
        self._peer_load_s: Dict[str, float] = {}

    # -- audit -------------------------------------------------------------
    def _record(self, decision: PlacementDecision) -> PlacementDecision:
        self._decisions.append(decision)
        return decision

    def decisions(self, context: Optional[str] = None
                  ) -> List[PlacementDecision]:
        """Recent decisions, newest last; ``context`` filters by prefix
        (e.g. ``"graph"``, ``"pool"``, ``"mesh"``)."""
        with self._lock:
            snap = list(self._decisions)
        if context is None:
            return snap
        return [d for d in snap if d.context.startswith(context)]

    def clear_decisions(self) -> None:
        with self._lock:
            self._decisions.clear()

    # -- shared device scoring --------------------------------------------
    @staticmethod
    def _device_terms(dev) -> Dict[str, Any]:
        return {"live_bytes": dev.live_bytes(),
                "queue_depth": dev.queue_depth()}

    def _device_seconds(self, terms: Dict[str, Any]) -> float:
        return (terms["queue_depth"] * self.dispatch_s
                + terms["live_bytes"] * self.mem_s_per_byte)

    # -- pool / worker ranking --------------------------------------------
    def rank(self, candidates: Sequence[Tuple[Any, Any]],
             payload: tuple = (), *,
             outstanding: Optional[Dict[Any, int]] = None,
             policy: str = "least_loaded",
             rr_tick: Optional[Callable[[], int]] = None,
             context: str = "pool") -> PlacementDecision:
        """Rank worker ``(key, device)`` candidates for one payload —
        the query :class:`~repro_torch.core.api.ActorPool` routes through.

        Residency first: when the payload carries a resident
        :class:`~repro_torch.core.memref.DeviceRef`, workers on that device are
        preferred (zero-copy dispatch) and load-ranked among themselves.
        ``least_loaded`` then orders by (outstanding, queue depth, live
        bytes); ``round_robin`` with no residency match cycles via
        ``rr_tick`` (called only when actually cycling, preserving the
        pool's rotation semantics). Ties keep candidate order, so equal
        workers behave exactly as the pre-service pools did."""
        if not candidates:
            raise ValueError("rank() needs at least one candidate")
        outstanding = outstanding or {}
        pref = payload_device(payload)
        idx = list(range(len(candidates)))
        matched = False
        if pref is not None:
            local = [i for i in idx
                     if (d := candidates[i][1]) is not None
                     and d.torch_device == pref]
            if local:
                idx, matched = local, True

        def terms_of(i: int) -> Dict[str, Any]:
            key, dev = candidates[i]
            t = {"outstanding": outstanding.get(key, 0),
                 "queue_depth": dev.queue_depth() if dev is not None else 0,
                 "live_bytes": dev.live_bytes() if dev is not None else 0,
                 "resident": matched}
            return t

        with self._lock:
            if policy == "round_robin" and not matched:
                tick = rr_tick() if rr_tick is not None else 0
                pick = idx[tick % len(idx)]
                key, _ = candidates[pick]
                alts = tuple(
                    ScoredAlternative(str(candidates[i][0]), i == pick,
                                      {"round_robin": True}) for i in idx)
                return self._record(PlacementDecision(
                    context=context, target=str(key), chosen=key,
                    cost=tick % len(idx), terms={"round_robin": True},
                    alternatives=alts, reason="round-robin"))
            scored = [(terms_of(i), i) for i in idx]
            best_terms, best = min(
                scored, key=lambda ti: (ti[0]["outstanding"],
                                        ti[0]["queue_depth"],
                                        ti[0]["live_bytes"], ti[1]))
            key, _ = candidates[best]
            alts = tuple(ScoredAlternative(
                str(candidates[i][0]),
                (t["outstanding"], t["queue_depth"], t["live_bytes"]), t)
                for t, i in scored)
            return self._record(PlacementDecision(
                context=context, target=str(key), chosen=key,
                cost=(best_terms["outstanding"], best_terms["queue_depth"],
                      best_terms["live_bytes"]),
                terms=best_terms, alternatives=alts,
                reason="residency" if matched else "least-loaded"))

    # -- bare device ranking ----------------------------------------------
    def pick_device(self, devices: Sequence[Any], *,
                    context: str = "device") -> PlacementDecision:
        """Least-loaded device by (live bytes, queue depth), tie-broken
        deterministically by device name — the fallback
        :meth:`Graph.build` and the serve engine use."""
        if not devices:
            raise LookupError("no devices to place on")
        with self._lock:
            scored = [(self._device_terms(d), d) for d in devices]
            terms, dev = min(scored, key=lambda td: (
                td[0]["live_bytes"], td[0]["queue_depth"], td[1].name))
            alts = tuple(ScoredAlternative(
                d.name, (t["live_bytes"], t["queue_depth"]), t)
                for t, d in scored)
            return self._record(PlacementDecision(
                context=context, target=dev.name, chosen=dev,
                cost=(terms["live_bytes"], terms["queue_depth"]),
                terms=terms, alternatives=alts, reason="least-loaded"))

    # -- chunk-scheduler candidate classes --------------------------------
    def classify_chunks(self, payloads: Sequence[tuple], torch_device
                        ) -> Tuple[List[int], List[int]]:
        """Partition pending chunk indices for a worker on ``torch_device``
        into (resident-local, no-affinity) — the candidate classes
        :class:`~repro_torch.core.scheduler.ChunkScheduler` pops from, in
        preference order; everything else stays a last resort."""
        local: List[int] = []
        neutral: List[int] = []
        for i, payload in enumerate(payloads):
            pd = payload_device(payload)
            if pd is None:
                neutral.append(i)
            elif torch_device is not None and pd == torch_device:
                local.append(i)
        return local, neutral

    # -- mesh replica ranking ---------------------------------------------
    def rank_replicas(self, snapshots: Sequence[Tuple[str, float, int]], *,
                      context: str = "mesh") -> PlacementDecision:
        """Least expected wait over ``(key, wait_s, inflight)`` replica
        snapshots: the polled EWMA queue wait scaled by the router's own
        outstanding fan-in (EWMA alone is stale between polls; inflight
        is always current). Ties keep snapshot order."""
        if not snapshots:
            raise ValueError("rank_replicas() needs at least one snapshot")

        def score(s: Tuple[str, float, int]) -> float:
            _, wait_s, inflight = s
            return (wait_s + 1e-3) * (1 + inflight)

        with self._lock:
            best_i = min(range(len(snapshots)),
                         key=lambda i: (score(snapshots[i]), i))
            key, wait_s, inflight = snapshots[best_i]
            alts = tuple(ScoredAlternative(
                k, score((k, w, f)), {"wait_s": w, "inflight": f})
                for k, w, f in snapshots)
            return self._record(PlacementDecision(
                context=context, target=key, chosen=key,
                cost=score(snapshots[best_i]),
                terms={"wait_s": wait_s, "inflight": inflight},
                alternatives=alts, reason="least-expected-wait"))

    # -- cost-source feeds -------------------------------------------------
    def observe_replica(self, key: str, wait_s: float, inflight: int, *,
                        peer: Optional[str] = None,
                        load: Optional[Dict[str, Any]] = None) -> None:
        """Mesh routers feed replica load snapshots here; per-peer
        expected waits become the remote load term in
        :meth:`place_graph`."""
        with self._lock:
            self._replica_load[key] = {"wait_s": wait_s,
                                       "inflight": inflight, "peer": peer,
                                       **(load or {})}
            if peer is not None:
                self._peer_load_s[peer] = (wait_s + 1e-3) * (1 + inflight)

    def observe_hop(self, peer: Optional[str], nbytes: int,
                    seconds: float, *, compressed: bool = False) -> None:
        """``repro.net`` reports observed request round-trips here; the
        wire model refines its latency/throughput estimates from them."""
        with self._lock:
            self.wire.observe(nbytes, seconds, compressed=compressed,
                              peer=peer)

    def choose_compress(self, nbytes: int,
                        peer: Optional[str] = None) -> bool:
        """Per-payload wire-format decision for ``compress="auto"``."""
        with self._lock:
            return self.wire.choose_compress(nbytes, peer)

    def peer_load_s(self, peer: str) -> float:
        with self._lock:
            return self._peer_load_s.get(peer, 0.0)

    def replica_load(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return dict(self._replica_load)

    # -- whole-DAG placement ----------------------------------------------
    def place_graph(self, sites: Sequence[GraphSite],
                    devices: Sequence[Any],
                    remotes: Sequence[NodeTarget] = (), *,
                    context: str = "graph"
                    ) -> Tuple[Dict[int, Any], List[PlacementDecision]]:
        """Place a topologically ordered DAG over local devices and
        remote nodes.

        Per site, in order: an explicitly pinned device wins outright;
        otherwise the local candidate is the first placed upstream
        producer's device (inheritance: zero-move) or the least-loaded
        device, and every :class:`NodeTarget` is scored as estimated
        seconds — peer load plus the request/reply wire round trip at the
        site's typed edge sizes, using the cheaper of raw or int8 when
        the target's node allows compression. A cross-node edge is chosen
        only when that total undercuts the local candidate — i.e. only
        where compression (or a genuinely idle peer) amortizes the hop.
        Sites with untyped edges never go remote."""
        placements: Dict[int, Any] = {}
        out: List[PlacementDecision] = []
        with self._lock:
            for site in sites:
                d = self._place_site(site, placements, devices, remotes,
                                     context)
                if d is None:
                    continue
                out.append(self._record(d))
                if d.chosen is not None:
                    placements[site.idx] = d.chosen
        return placements, out

    def _place_site(self, site: GraphSite, placements: Dict[int, Any],
                    devices: Sequence[Any], remotes: Sequence[NodeTarget],
                    context: str) -> Optional[PlacementDecision]:
        ctx = f"{context}:{site.path}"
        if site.pinned is not None or site.fixed:
            if site.pinned is None:
                return None     # an unplaced existing actor: leave it be
            name = getattr(site.pinned, "name", str(site.pinned))
            return PlacementDecision(
                context=ctx, target=name, chosen=site.pinned, cost=0.0,
                terms={"pinned": True}, alternatives=(), reason="explicit")

        alts: List[ScoredAlternative] = []
        local_dev = None
        local_cost = None
        local_reason = ""
        for pidx in site.producers:
            up = placements.get(pidx)
            if up is not None and not isinstance(up, NodeTarget):
                local_dev, local_reason = up, "inherit-upstream"
                break
        if local_dev is None and devices:
            scored = [(self._device_terms(d), d) for d in devices]
            # deterministic fallback: live bytes, queue depth, then the
            # device *name* — never the manager's enumeration order
            _, local_dev = min(scored, key=lambda td: (
                td[0]["live_bytes"], td[0]["queue_depth"], td[1].name))
            local_reason = "least-loaded"
            for t, d in scored:
                if d is not local_dev:
                    alts.append(ScoredAlternative(
                        d.name, self._device_seconds(t), t))
        if local_dev is not None:
            terms = self._device_terms(local_dev)
            terms["reason"] = local_reason
            local_cost = self._device_seconds(terms)
            alts.insert(0, ScoredAlternative(local_dev.name, local_cost,
                                             terms))

        best = local_dev
        best_cost = local_cost
        best_terms: Dict[str, Any] = alts[0].terms if alts else {}
        best_reason = local_reason
        if site.remote_ok and site.in_bytes is not None \
                and site.out_bytes is not None:
            for target in remotes:
                wire_s, encoding = self.wire.round_trip_seconds(
                    site.in_bytes, site.out_bytes,
                    allow_compress=target.allows_compress,
                    peer=target.peer)
                load_s = self._peer_load_s.get(target.peer,
                                               target.static_load_s)
                cost = load_s + wire_s
                terms = {"wire_s": wire_s, "encoding": encoding,
                         "load_s": load_s, "in_bytes": site.in_bytes,
                         "out_bytes": site.out_bytes}
                alts.append(ScoredAlternative(target.name, cost, terms))
                # strict <: on a tie the local device wins — never pay a
                # hop for nothing
                if best_cost is None or cost < best_cost:
                    best, best_cost, best_terms = target, cost, terms
                    best_reason = f"wire-amortized:{encoding}"
        if best is None:
            return None
        return PlacementDecision(
            context=ctx, target=getattr(best, "name", str(best)),
            chosen=best, cost=best_cost, terms=best_terms,
            alternatives=tuple(alts), reason=best_reason)


# ----------------------------------------------------------------------------
# the process-wide instance
# ----------------------------------------------------------------------------
_service: PlacementService = PlacementService()


def service() -> PlacementService:
    """The process-wide :class:`PlacementService` every subsystem
    delegates to."""
    return _service


def set_service(svc: PlacementService) -> PlacementService:
    """Swap the process-wide service (tests inject fake cost tables this
    way); returns the previous one so callers can restore it."""
    global _service
    prev, _service = _service, svc
    return prev
