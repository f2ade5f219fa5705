"""Typed dataflow-graph composition — device-resident DAGs (paper §3.5).

The paper promises that "OpenCL kernels can be composed while encapsulated
in C++ actors, hence operate in a multi-stage fashion on data resident at
the GPU" (§3.5), and that CAF's *typed* actor interfaces make such
compositions statically checkable. :class:`Pipeline` realized the linear
case; this module generalizes composition to a declarative **DAG**:

* **Nodes** are kernel declarations (:class:`~repro_torch.core.api.KernelDecl`),
  existing actor refs (kernel or opaque), plain Python callables, or the
  structural combinators below.
* **Edges** are named, *typed ports*: each :class:`Port` carries a
  :class:`PortType` (shape/dtype) derived from the producer's
  :class:`~repro_torch.core.signature.KernelSignature` by evaluating the
  kernel on ``meta`` tensors (see
  :func:`repro_torch.core.facade.eval_output_structs`).
* **Combinators**: :meth:`Graph.broadcast` (fan-out one value to N
  consumers), :meth:`Graph.zip_join` (fan-in barrier), :meth:`Graph.select`
  (predicate routing, with :meth:`Graph.merge` as its first-wins dual for
  speculative branches), and :meth:`Graph.map_over` (per-chunk fan-out
  through :class:`~repro_torch.core.scheduler.ChunkScheduler`).

``Graph.build()`` validates the topology **at build time** — cycle
detection, dangling/arity/dtype-mismatch errors, each raised as a distinct
:class:`~repro_torch.core.errors.GraphError` subclass naming the offending node
path — then delegates whole-DAG placement to the process-wide
:class:`~repro_torch.core.placement.PlacementService` (explicit ``device=``
wins, else inherit the upstream producer's device, else the cost-ranked
local device — or a remote :class:`~repro_torch.core.placement.NodeTarget`
when the wire cost model says the hop amortizes) and lowers every interior
edge to **ref-emitting** actors: a kernel whose consumers can all unwrap
:class:`~repro_torch.core.memref.DeviceRef`\\ s is spawned (or cloned) with
``emit="ref"``, so interior edges move zero bytes through the host — the
``RefRegistry`` transfer counters stay flat across the whole graph run.

With ``fuse=True`` a linear region of kernels on one device becomes one
actor running the members' callables one after another, eagerly, on the
device's stream.

The result of ``build()`` is a :class:`GraphRef` — an ordinary
:class:`~repro_torch.core.actor.ActorRef` pointing at a spawned orchestrator
actor, so a built graph composes everywhere an actor does: as a
``Pipeline`` stage, behind an :class:`~repro_torch.core.api.ActorPool`, as a
:class:`~repro.dist.pipeline.PipelineRunner` chain, or as a
``ServeEngine`` model step.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import math

import numpy as np
import torch

from .. import trace
from ..analysis.runtime import make_lock, make_rlock
from .actor import _UNSET, Actor, ActorRef, ActorSystem
from .api import KernelDecl, _bound_fn
from .errors import (ArityMismatchError, DanglingPortError, GraphCycleError,
                     GraphError, PortTypeMismatchError)
from .memref import DeviceRef, as_device_array, registry, to_numpy
from .placement import GraphSite, NodeTarget
from .placement import service as placement_service
from .signature import dtype_name, to_torch_dtype

__all__ = ["Graph", "GraphNode", "GraphPlan", "GraphRef", "Port", "PortType"]


# ----------------------------------------------------------------------------
# typed ports
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PortType:
    """Shape/dtype of the value crossing an edge; ``None`` = unknown
    (Python stages and splat chain edges are untyped wildcards)."""

    dtype: Optional[torch.dtype] = None
    shape: Optional[Tuple[int, ...]] = None

    @classmethod
    def of(cls, dtype=None, shape=None) -> "PortType":
        return cls(None if dtype is None else to_torch_dtype(dtype),
                   None if shape is None else tuple(int(s) for s in shape))

    def __repr__(self):
        d = dtype_name(self.dtype) if self.dtype is not None else "?"
        s = list(self.shape) if self.shape is not None else "?"
        return f"PortType<{d}>{s}"


class Port:
    """One named output of a graph node; the handle edges are wired with."""

    __slots__ = ("node", "index")

    def __init__(self, node: "GraphNode", index: int):
        self.node = node
        self.index = index

    @property
    def type(self) -> PortType:
        return self.node.out_types[self.index]

    @property
    def key(self) -> Tuple[int, int]:
        return (self.node.idx, self.index)

    @property
    def path(self) -> str:
        return f"{self.node.path}[{self.index}]"

    def __repr__(self):
        return f"Port({self.path}: {self.type})"


#: structural node kinds are routed by the orchestrator itself — they never
#: spawn an actor, so fan-out/fan-in adds no per-message hop
_STRUCTURAL = ("broadcast", "zip_join", "select", "merge")
#: node kinds backed by a spawned actor at runtime
_ACTOR_KINDS = ("kernel", "actor", "func", "map_over")


def _edge_bytes(types) -> Optional[int]:
    """Total payload bytes crossing a set of typed edges, or None when
    any edge is untyped — an unknown edge size means the wire-cost model
    cannot price the hop, so such nodes are never placed remotely."""
    total = 0
    for t in types:
        if t is None or t.dtype is None or t.shape is None:
            return None
        total += math.prod(t.shape) * t.dtype.itemsize
    return total


class GraphNode:
    """A node plus its input wiring; created via :meth:`Graph.node` /
    :meth:`Graph.apply` / the combinators."""

    def __init__(self, graph: "Graph", idx: int, kind: str, target: Any,
                 name: str, n_in: int, n_out: int, *, device=None,
                 splat: bool = False, options: Optional[dict] = None):
        self.graph = graph
        self.idx = idx
        self.kind = kind
        self.target = target
        self.name = name
        self.device = device
        self.splat = splat          # single input delivered as *payload
        self.options = dict(options or {})
        self.inputs: List[Optional[Port]] = [None] * n_in
        self.out_types: List[PortType] = [PortType()] * n_out

    @property
    def n_in(self) -> int:
        return len(self.inputs)

    @property
    def n_out(self) -> int:
        return len(self.out_types)

    @property
    def path(self) -> str:
        """Node path used in every Graph diagnostic: ``<graph>/<node>``."""
        return f"{self.graph.name}/{self.name}"

    def out(self, index: int = 0) -> Port:
        if not 0 <= index < self.n_out:
            raise GraphError(f"{self.path} has {self.n_out} output ports, "
                             f"no port {index}")
        return Port(self, index)

    def outs(self) -> Tuple[Port, ...]:
        return tuple(Port(self, i) for i in range(self.n_out))

    def __repr__(self):
        return (f"GraphNode({self.path}, kind={self.kind!r}, "
                f"in={self.n_in}, out={self.n_out})")


# ----------------------------------------------------------------------------
# the builder
# ----------------------------------------------------------------------------
class Graph:
    """Declarative DAG builder (see module docstring for the model).

    Functional surface — each call returns the new node's port(s)::

        g = Graph(system, name="diamond")
        x = g.source("x", torch.float32, shape=(N,))
        h = g.apply(prepare, x)
        l, r = g.broadcast(h, 2)
        j1, j2 = g.zip_join(g.apply(left, l), g.apply(right, r))
        g.output(g.apply(merge_k, j1, j2))
        diamond = g.build()                 # validate + place + spawn
        out = diamond.ask(np.arange(N, dtype=np.float32))

    Low-level surface — :meth:`node` creates a node with unbound input
    slots and :meth:`bind` wires them afterwards (this is the only way to
    construct a cyclic topology, which :meth:`build` then rejects).
    """

    def __init__(self, system: ActorSystem, *, name: str = "graph"):
        self.system = system
        self.name = name
        self.nodes: List[GraphNode] = []
        self.outputs: List[Port] = []
        self._used_names: Dict[str, int] = {}

    # -- construction ------------------------------------------------------
    def _unique_name(self, base: str) -> str:
        n = self._used_names.get(base, 0)
        self._used_names[base] = n + 1
        return base if n == 0 else f"{base}.{n}"

    def _add(self, kind: str, target, name: str, n_in: int, n_out: int,
             *, device=None, splat: bool = False,
             options: Optional[dict] = None) -> GraphNode:
        node = GraphNode(self, len(self.nodes), kind, target,
                         self._unique_name(name), n_in, n_out,
                         device=device, splat=splat, options=options)
        self.nodes.append(node)
        return node

    def source(self, name: str = "in", dtype=None, shape=None) -> Port:
        """Declare a graph input; payload values bind to sources in
        declaration order at :meth:`GraphRef.request` time."""
        node = self._add("source", None, name, 0, 1)
        node.out_types[0] = PortType.of(dtype, shape)
        return node.out(0)

    def chain_source(self, name: str = "in") -> Port:
        """A *splat* source: the whole request payload tuple flows as one
        value and is splatted into its consumer — the untyped chain edge
        the linear :class:`~repro_torch.core.api.Pipeline` wrapper is built on."""
        node = self._add("source", None, name, 0, 1, splat=True)
        return node.out(0)

    def node(self, target, *, name: Optional[str] = None, device=None,
             n_in: Optional[int] = None, n_out: Optional[int] = None
             ) -> GraphNode:
        """Add an **unbound** node (wire inputs later with :meth:`bind`).

        Arity defaults come from the target's kernel signature when it has
        one; plain callables default to one input / one output.
        """
        kind, sig = self._classify(target)
        if sig is not None:
            d_in, d_out = len(sig.input_specs), len(sig.output_specs)
        else:
            d_in, d_out = 1, 1
        node = self._add(kind, target, name or _target_name(target),
                         n_in if n_in is not None else d_in,
                         n_out if n_out is not None else d_out,
                         device=device)
        return node

    def bind(self, node: GraphNode, slot: int, port: Port) -> None:
        """Wire ``port`` into ``node``'s input ``slot``."""
        if node.graph is not self or port.node.graph is not self:
            raise GraphError(f"{node.path}: cannot bind across graphs")
        if not 0 <= slot < node.n_in:
            raise GraphError(f"{node.path} has {node.n_in} input slots, "
                             f"no slot {slot}")
        node.inputs[slot] = port

    def apply(self, target, *ports: Port, name: Optional[str] = None,
              device=None, n_out: Optional[int] = None
              ) -> Union[Port, Tuple[Port, ...]]:
        """Add a node for ``target`` wired to ``ports``; returns its output
        port (or a tuple of ports for multi-output kernels)."""
        kind, sig = self._classify(target)
        if sig is not None and n_out is None:
            n_out = len(sig.output_specs)
        node = self._add(kind, target, name or _target_name(target),
                         len(ports), n_out if n_out is not None else 1,
                         device=device)
        for i, p in enumerate(ports):
            self.bind(node, i, p)
        return node.out(0) if node.n_out == 1 else node.outs()

    def chain(self, target, port: Port, *, name: Optional[str] = None,
              device=None, traceable: bool = False) -> Port:
        """Append a splat-edged stage: the upstream value (a whole payload
        tuple) is splatted into ``target`` — ``Pipeline``'s linear hop.

        ``traceable=True`` marks a bare-callable stage as a pure tensor
        adapter, which lets :meth:`build` with ``fuse=True`` pull it
        *inside* a fused region instead of treating it as a Python-stage
        boundary. Kernel declarations may always join a region and ignore
        the flag.
        """
        kind, _sig = self._classify(target)
        node = self._add(kind, target, name or _target_name(target),
                         1, 1, device=device, splat=True,
                         options={"traceable": True} if traceable else None)
        self.bind(node, 0, port)
        return node.out(0)

    # -- combinators -------------------------------------------------------
    def broadcast(self, port: Port, n: int, *, name: str = "broadcast"
                  ) -> Tuple[Port, ...]:
        """Fan-out: the same value (for a :class:`DeviceRef`, the same
        device buffer — no copy) is delivered to ``n`` consumers. Ref
        fan-out is *read-sharing*: each branch receives a read-only view,
        so a donating ``InOut`` consumer raises ``AccessViolation``
        instead of pulling the buffer out from under its siblings."""
        if n < 2:
            raise GraphError(f"{self.name}/{name}: broadcast needs n >= 2")
        node = self._add("broadcast", None, name, 1, n)
        self.bind(node, 0, port)
        return node.outs()

    def zip_join(self, *ports: Port, name: str = "zip_join"
                 ) -> Tuple[Port, ...]:
        """Fan-in barrier: output ``i`` forwards input ``i``, but no output
        is delivered until **every** input has arrived (the paper's
        multi-producer join before a dependent kernel)."""
        if len(ports) < 2:
            raise GraphError(f"{self.name}/{name}: zip_join needs >= 2 ports")
        node = self._add("zip_join", None, name, len(ports), len(ports))
        for i, p in enumerate(ports):
            self.bind(node, i, p)
        return node.outs()

    def select(self, port: Port, pred: Callable[[Any], int], n: int = 2,
               *, name: str = "select") -> Tuple[Port, ...]:
        """Predicate routing: ``pred(value)`` picks which of the ``n``
        branches receives the value; the others are marked *dead* and
        deadness propagates (a :meth:`merge` downstream resolves it).

        ``pred`` sees the raw edge value — a :class:`DeviceRef` when the
        producer emits refs. Routing on data *content* then requires an
        explicit ``.to_value()`` read-back (counted in the registry);
        routing on metadata (``shape``/``dtype``/``nbytes``) stays free.
        """
        if n < 2:
            raise GraphError(f"{self.name}/{name}: select needs n >= 2")
        if not callable(pred):
            raise GraphError(f"{self.name}/{name}: pred must be callable")
        node = self._add("select", None, name, 1, n, options={"pred": pred})
        self.bind(node, 0, port)
        return node.outs()

    def merge(self, *ports: Port, name: str = "merge") -> Port:
        """First-arrival-wins fan-in: forwards the first live value among
        its inputs (losers are released); dead only if *all* inputs are
        dead. The dual of :meth:`select` — together they express
        conditional and speculative branches."""
        if len(ports) < 2:
            raise GraphError(f"{self.name}/{name}: merge needs >= 2 ports")
        node = self._add("merge", None, name, len(ports), 1)
        for i, p in enumerate(ports):
            self.bind(node, i, p)
        return node.out(0)

    def map_over(self, target: KernelDecl, port: Port, *, chunks: int = 4,
                 replicas: int = 2, policy: str = "least_loaded",
                 devices: Optional[Sequence] = None,
                 timeout: Optional[float] = 300.0,
                 name: Optional[str] = None,
                 min_chunk_bytes: int = 1 << 20,
                 **scheduler_kwargs) -> Port:
        """Per-chunk fan-out: split the value along axis 0 into ``chunks``
        device-resident slices, dispatch them through a
        :class:`~repro_torch.core.scheduler.ChunkScheduler` over a pool of
        ``replicas`` kernel actors (placement-aware, straggler re-issuing),
        and concatenate the results on the device.

        Each chunk pays a fixed dispatch constant (a mailbox hop, a
        device-side slice, a scheduler round-trip), so chunking only wins
        once per-chunk compute dwarfs it. ``min_chunk_bytes`` (default
        1 MiB) caps the effective chunk count so no slice drops below that
        size: small inputs degrade to a single whole-array dispatch instead
        of paying ``chunks`` dispatch constants for sub-millisecond
        kernels. Pass ``min_chunk_bytes=0`` to force the requested chunk
        count."""
        if not isinstance(target, KernelDecl):
            raise GraphError(
                f"{self.name}/{name or _target_name(target)}: map_over "
                f"needs a @kernel declaration, got {target!r}")
        if len(target.signature.input_specs) != 1 or \
                len(target.signature.output_specs) != 1:
            raise GraphError(
                f"{self.name}/{name or _target_name(target)}: map_over "
                "kernels must take exactly one input and one output")
        if target.preprocess is not None:
            raise GraphError(
                f"{self.name}/{name or _target_name(target)}: map_over "
                "dispatches device-resident chunk refs, which a kernel "
                "preprocess (running before ref unwrapping) cannot see; "
                "apply the preprocess as a separate stage instead")
        node = self._add(
            "map_over", target, name or f"map_{_target_name(target)}", 1, 1,
            options={"chunks": int(chunks), "replicas": int(replicas),
                     "policy": policy, "devices": devices, "timeout": timeout,
                     "min_chunk_bytes": int(min_chunk_bytes),
                     "scheduler": dict(scheduler_kwargs)})
        self.bind(node, 0, port)
        return node.out(0)

    def output(self, *ports: Port) -> "Graph":
        """Declare the graph's result port(s); a single output resolves to
        its bare value, several to a tuple."""
        for p in ports:
            if p.node.graph is not self:
                raise GraphError(f"{p.path}: port belongs to another graph")
            self.outputs.append(p)
        return self

    # -- introspection -----------------------------------------------------
    def _classify(self, target):
        """(kind, kernel_signature_or_None) for an apply/node target."""
        if isinstance(target, KernelDecl):
            return "kernel", target.signature
        if isinstance(target, ActorRef):
            ka = self._kernel_actor_of(target)
            return "actor", (ka.signature if ka is not None else None)
        if callable(target):
            return "func", None
        raise GraphError(f"{self.name}: cannot add node for {target!r}")

    def _kernel_actor_of(self, ref: ActorRef):
        from .facade import KernelActor
        st = self.system._actors.get(ref.actor_id)
        actor = st.actor if st else None
        return actor if isinstance(actor, KernelActor) else None

    # -- validation --------------------------------------------------------
    def validate(self) -> List[GraphNode]:
        """Check the topology and propagate port types; returns the nodes
        in topological order. All errors are
        :class:`~repro_torch.core.errors.GraphError` subclasses naming the
        offending node path."""
        if not self.nodes:
            raise GraphError(f"graph {self.name!r} has no nodes")
        if not self.outputs:
            raise GraphError(f"graph {self.name!r} declares no outputs; "
                             "call Graph.output(port) before build()")
        for node in self.nodes:
            for slot, p in enumerate(node.inputs):
                if p is None:
                    raise DanglingPortError(
                        f"{node.path}: input slot {slot} was never bound "
                        f"(wire it with Graph.bind or Graph.apply)")
        topo = self._toposort()
        consumers = self._consumers()
        outset = {p.key for p in self.outputs}
        for node in self.nodes:
            for oi in range(node.n_out):
                if not consumers.get((node.idx, oi)) and \
                        (node.idx, oi) not in outset:
                    raise DanglingPortError(
                        f"{node.path}: output port {oi} has no consumer and "
                        "is not a graph output — device-resident data would "
                        "be produced and leaked")
        for node in topo:
            self._type_node(node)
        return topo

    def _consumers(self) -> Dict[Tuple[int, int], List[Tuple[int, int]]]:
        consumers: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for node in self.nodes:
            for slot, p in enumerate(node.inputs):
                consumers.setdefault(p.key, []).append((node.idx, slot))
        return consumers

    def _toposort(self) -> List[GraphNode]:
        """Kahn's algorithm; a leftover node set means a cycle — report it
        by walking the cycle's node paths."""
        indeg = {n.idx: 0 for n in self.nodes}
        succ: Dict[int, List[int]] = {n.idx: [] for n in self.nodes}
        for node in self.nodes:
            for p in node.inputs:
                indeg[node.idx] += 1
                succ[p.node.idx].append(node.idx)
        ready = [n.idx for n in self.nodes if indeg[n.idx] == 0]
        order: List[int] = []
        while ready:
            i = ready.pop()
            order.append(i)
            for j in succ[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != len(self.nodes):
            stuck = {i for i, d in indeg.items() if d > 0}
            # walk one cycle for the diagnostic
            start = min(stuck)
            cycle, cur = [start], start
            while True:
                cur = next(p.node.idx for p in self.nodes[cur].inputs
                           if p.node.idx in stuck)
                if cur in cycle:
                    cycle.append(cur)
                    break
                cycle.append(cur)
            path = " -> ".join(self.nodes[i].path for i in reversed(cycle))
            raise GraphCycleError(
                f"graph {self.name!r} contains a cycle: {path}")
        return [self.nodes[i] for i in order]

    def _type_node(self, node: GraphNode) -> None:
        """Propagate/validate port types for one node (topo order)."""
        in_types = [p.type for p in node.inputs]
        if node.kind in ("kernel", "actor"):
            sig, pre = self._sig_of(node)
            if sig is None or node.splat:
                return
            if node.n_in != len(sig.input_specs):
                raise ArityMismatchError(
                    f"{node.path}: kernel signature declares "
                    f"{len(sig.input_specs)} inputs, wired with {node.n_in}")
            structs: Optional[List] = []
            for slot, (spec, t) in enumerate(zip(sig.input_specs, in_types)):
                self._check_edge(node, slot, spec, t)
                if structs is not None and t.shape is not None:
                    structs.append(torch.empty(t.shape, dtype=spec.torch_dtype,
                                               device="meta"))
                else:
                    structs = None      # some shape unknown: cannot eval
            self._type_kernel_outputs(node, sig, structs)
        elif node.kind == "map_over":
            sig = node.target.signature
            self._check_edge(node, 0, sig.input_specs[0], in_types[0])
            node.out_types[0] = PortType.of(sig.output_specs[0].torch_dtype)
        elif node.kind == "broadcast":
            node.out_types = [in_types[0]] * node.n_out
        elif node.kind in ("zip_join",):
            node.out_types = list(in_types)
        elif node.kind == "select":
            node.out_types = [in_types[0]] * node.n_out
        elif node.kind == "merge":
            node.out_types = [in_types[0] if len(set(in_types)) == 1
                              else PortType()]
        # func/source: declared or unknown — nothing to derive

    def _sig_of(self, node: GraphNode):
        """(signature, preprocess) of a kernel-backed node, else (None, _)."""
        if node.kind == "kernel":
            return node.target.signature, node.target.preprocess
        ka = self._kernel_actor_of(node.target)
        if ka is None:
            return None, None
        return ka.signature, ka.preprocess

    def _check_edge(self, node: GraphNode, slot: int, spec, t: PortType
                    ) -> None:
        producer = node.inputs[slot].node
        if t.dtype is not None and t.dtype != spec.torch_dtype:
            raise PortTypeMismatchError(
                f"{node.path}: input {slot} expects dtype "
                f"{dtype_name(spec.torch_dtype)}, but upstream port "
                f"{producer.path} carries {dtype_name(t.dtype)}")
        if t.shape is not None and spec.shape is not None and \
                t.shape != tuple(spec.shape):
            raise PortTypeMismatchError(
                f"{node.path}: input {slot} expects shape "
                f"{tuple(spec.shape)}, but upstream port {producer.path} "
                f"carries {t.shape}")

    def _type_kernel_outputs(self, node: GraphNode, sig, structs) -> None:
        """Derive output port types, preferring the meta-tensor evaluation
        over the declared specs; an eval'd dtype contradicting the declared Out spec
        is a build-time type error (it would die at runtime anyway)."""
        evaled = None
        if structs is not None and len(structs) == len(sig.input_specs):
            try:
                evaled = self._out_structs_of(node, structs)
            except Exception:
                evaled = None       # not evaluable: keep the declared specs
        types = []
        for oi, spec in enumerate(sig.output_specs):
            if evaled is not None and oi < len(evaled):
                st = evaled[oi]
                if st.dtype != spec.torch_dtype:
                    raise PortTypeMismatchError(
                        f"{node.path}: output {oi} declared as "
                        f"{dtype_name(spec.torch_dtype)} but the kernel "
                        f"computes {dtype_name(st.dtype)}")
                types.append(PortType.of(st.dtype, st.shape))
            else:
                types.append(PortType.of(spec.torch_dtype, spec.shape))
        if len(types) == node.n_out:
            node.out_types = types

    def _out_structs_of(self, node: GraphNode, structs):
        if node.kind == "kernel":
            return node.target.out_structs(structs)
        return self._kernel_actor_of(node.target).out_structs(structs)

    # -- lowering ----------------------------------------------------------
    def build(self, fuse: bool = False,
              remotes: Sequence[NodeTarget] = ()) -> "GraphRef":
        """Validate, place, lower, and spawn; returns a :class:`GraphRef`.

        Placement is delegated to the process-wide
        :class:`~repro_torch.core.placement.PlacementService`: explicit
        ``device=`` pins win, then upstream inheritance, then the
        least-loaded local device — and with ``remotes=`` (a sequence of
        :class:`~repro_torch.core.placement.NodeTarget`\\ s wrapping connected
        peers) kernel nodes may land *cross-node*, but only where the
        wire cost model says the hop is cheaper than staying local (e.g.
        because int8 compression amortizes it, or the peer is idle while
        every local device is saturated). The per-node
        :class:`~repro_torch.core.placement.PlacementDecision` audit records are
        exposed as ``GraphRef.placement_decisions``.

        Interior kernel edges are lowered to ``emit="ref"`` actors (zero
        host transfers between nodes); terminal kernels — those feeding a
        graph output or a non-ref-capable consumer — keep their declared
        value/reference semantics.

        With ``fuse=True`` the placed DAG first runs through a
        **build-time fusion pass**: maximal linear regions of kernel nodes
        (plus ``traceable`` adapter callables) on one device — containing
        no fan-out/fan-in/``select``/``merge`` boundary, no opaque actor
        node, and no port escaping as a graph output — collapse into a
        *single* composed callable behind one
        :class:`~repro_torch.core.facade.KernelActor` (the paper's §3.6 kernel
        composition done once at build time instead of per-message at
        actor-hop time). Region boundaries keep exactly the emission
        semantics the unfused graph would have had, and the grouping is
        reported via ``GraphRef.plan.fused_regions``.
        """
        topo = self.validate()
        consumers = self._consumers()
        outset = {p.key for p in self.outputs}
        mngr = self.system.opencl_manager()

        refcap = {n.idx: self._ref_capable(n) for n in self.nodes}
        # placement runs over the whole DAG before anything is spawned:
        # the fusion pass and the inline-dispatch table both need every
        # node's device up front. The cost-model service decides; this
        # module only describes the sites (pins, edges, typed byte sizes)
        sites = [self._placement_site(n) for n in topo
                 if n.kind in _ACTOR_KINDS]
        placements, decisions = placement_service().place_graph(
            sites, mngr.devices(), remotes=list(remotes),
            context=f"graph:{id(self):x}")

        regions = (self._fuse_regions(topo, consumers, outset, placements)
                   if fuse else [])
        member_of: Dict[int, int] = {}
        tail_of: Dict[int, int] = {}
        by_head: Dict[int, List[GraphNode]] = {}
        for region in regions:
            head = region[0].idx
            by_head[head] = region
            tail_of[head] = region[-1].idx
            for n in region:
                member_of[n.idx] = head

        refs: Dict[int, Optional[ActorRef]] = {}
        private: set = set()        # node idxs whose ref this build spawned
        for node in topo:
            if node.kind not in _ACTOR_KINDS:
                refs[node.idx] = None
                continue
            head = member_of.get(node.idx)
            if head is not None and head != node.idx:
                refs[node.idx] = None   # interior member of a fused region
                continue
            device = placements.get(node.idx)
            if head is not None:
                region = by_head[head]
                want = self._wants_ref(region[-1], consumers, outset, refcap)
                refs[node.idx] = self._spawn_fused(region, device, want)
                private.add(node.idx)
            else:
                want = self._wants_ref(node, consumers, outset, refcap)
                refs[node.idx] = self._spawn_node(node, device, want, mngr)
                if node.kind != "actor" or refs[node.idx] is not node.target:
                    private.add(node.idx)

        inline_ok = {
            n.idx: self._inline_eligible(n, refs[n.idx], consumers, outset,
                                         placements, private)
            for n in self.nodes if refs.get(n.idx) is not None}
        plan = GraphPlan(self, topo, consumers, refs, placements,
                         regions=regions, member_of=member_of,
                         tail_of=tail_of, inline_ok=inline_ok)
        plan.decisions = decisions
        ref = self.system.spawn(_GraphActor(plan))
        gref = GraphRef(ref.actor_id, self.system)
        gref.plan = plan
        gref.placements = {self.nodes[i].path: d
                           for i, d in placements.items()}
        gref.node_refs = {self.nodes[i].path: r
                          for i, r in refs.items() if r is not None}
        gref.placement_decisions = decisions
        return gref

    # -- fusion pass -------------------------------------------------------
    def _fusible_node(self, node: GraphNode) -> bool:
        """May this node live *inside* a fused region? Kernel declarations
        always; bare callables only when marked ``traceable`` (an opaque
        Python stage may block, perform I/O, or keep state, and must keep
        its own actor). Existing actor refs never fuse: their behavior is
        not a plain function of its inputs."""
        if node.kind == "kernel":
            return True
        return node.kind == "func" and bool(node.options.get("traceable"))

    def _fuse_successor(self, u: GraphNode, consumers, outset, placements
                        ) -> Optional[GraphNode]:
        """The unique node a region ending in ``u`` may extend into, or
        ``None`` at a fusion boundary: fan-out (several consumers), an
        escaping output port, external fan-in into the successor, a
        postprocess on ``u`` (must stay a region tail — it runs on the
        emitted representation), a preprocess on the successor (must stay
        a region head — it runs on the raw payload), or a device change."""
        if u.kind == "kernel" and u.target.postprocess is not None:
            return None
        v: Optional[GraphNode] = None
        for oi in range(u.n_out):
            key = (u.idx, oi)
            if key in outset:
                return None
            for dst, _slot in consumers.get(key, ()):
                cand = self.nodes[dst]
                if v is None:
                    v = cand
                elif cand is not v:
                    return None
        if v is None:
            return None
        if any(p.node is not u for p in v.inputs):
            return None
        if v.kind == "kernel" and v.target.preprocess is not None:
            return None
        du, dv = placements.get(u.idx), placements.get(v.idx)
        if isinstance(du, NodeTarget) or isinstance(dv, NodeTarget):
            # a remotely placed node runs inside another process; its
            # callable cannot join a locally composed region
            return None
        if du is None and dv is None:
            return v
        if du is None or dv is None:
            return None
        if du is not dv and getattr(du, "torch_device", du) != \
                getattr(dv, "torch_device", dv):
            return None
        return v

    def _fuse_regions(self, topo, consumers, outset, placements
                      ) -> List[List[GraphNode]]:
        """Greedy maximal linear regions over the placed DAG (topo order
        guarantees a chain's earliest node is visited first, so every
        region starts at its true head). Single-node regions are dropped —
        nothing to fuse — as are all-adapter regions (no kernel signature
        to anchor the fused actor's specs on)."""
        regions: List[List[GraphNode]] = []
        assigned: set = set()
        for node in topo:
            if node.idx in assigned or not self._fusible_node(node) or \
                    isinstance(placements.get(node.idx), NodeTarget):
                continue
            region = [node]
            while True:
                nxt = self._fuse_successor(region[-1], consumers, outset,
                                           placements)
                if nxt is None or nxt.idx in assigned or \
                        not self._fusible_node(nxt):
                    break
                region.append(nxt)
            if len(region) >= 2 and any(n.kind == "kernel" for n in region):
                regions.append(region)
                assigned.update(n.idx for n in region)
        return regions

    def _spawn_fused(self, region: List[GraphNode], device, want_ref: bool
                     ) -> ActorRef:
        """One :class:`~repro_torch.core.facade.KernelActor` for a fused region:
        the members' callables run one after another inside one behavior,
        eagerly on the device's stream, so the whole region costs one actor
        hop. Specs are
        the first kernel member's inputs plus the last kernel member's
        outputs (the fused-``Pipeline`` contract); the head's preprocess
        and the tail's postprocess — the only ones a region may contain —
        carry over to the fused actor."""
        from .facade import KernelActor
        steps: List[Tuple[GraphNode, Callable]] = []
        first_sig = last_sig = None
        first_nd = None
        donate = True
        for node in region:
            if node.kind == "kernel":
                decl: KernelDecl = node.target
                steps.append((node, _bound_fn(decl.fn, decl.nd_range,
                                              decl.signature.local_specs)))
                if first_sig is None:
                    first_sig, first_nd = decl.signature, decl.nd_range
                    donate = decl.donate
                last_sig = decl.signature
            else:               # traceable adapter callable
                steps.append((node, node.target))

        def fused_fn(*inputs):
            outs: Any = ()
            for pos, (node, f) in enumerate(steps):
                if pos == 0:
                    args = inputs
                elif node.splat:
                    args = outs if isinstance(outs, tuple) else (outs,)
                else:
                    norm = outs if isinstance(outs, tuple) else (outs,)
                    args = tuple(norm[p.index] for p in node.inputs)
                outs = f(*args)
            return outs

        head, tail = region[0], region[-1]
        specs = tuple(first_sig.input_specs) + tuple(last_sig.output_specs)
        mngr = self.system.opencl_manager()
        actor = KernelActor(
            fn=fused_fn,
            name="fused[" + "+".join(n.name for n in region) + "]",
            nd_range=first_nd, specs=specs,
            device=device if device is not None else mngr.find_device(),
            program=None,
            preprocess=(head.target.preprocess if head.kind == "kernel"
                        else None),
            postprocess=(tail.target.postprocess if tail.kind == "kernel"
                         else None),
            donate=donate,
            emit="ref" if want_ref else "declared",
            fused_from=tuple(n.path for n in region))
        return self.system.spawn(actor)

    # -- inline-dispatch eligibility ---------------------------------------
    def _effective_producer(self, port: Port) -> Optional[GraphNode]:
        """The actor/source node whose value actually flows through
        ``port``, walking back through structural nodes; ``None`` when the
        path crosses a value-sharing node (``broadcast`` — inlining one
        arm would serialize its siblings on the producer's thread) or a
        racy fan-in (``merge`` — the loser's speculative work must keep
        its own mailbox)."""
        node = port.node
        while node.kind in _STRUCTURAL:
            if node.kind in ("broadcast", "merge"):
                return None
            port = (node.inputs[0] if node.kind == "select"
                    else node.inputs[port.index])
            node = port.node
        return node

    def _inline_eligible(self, node: GraphNode, ref, consumers, outset,
                         placements, private) -> bool:
        """May the orchestrator dispatch this node by calling its behavior
        directly instead of enqueueing (the hot-path bypass)? Only when
        the ref is private to this build (nobody else can observe its
        mailbox ordering) and local, and every in-edge is single-consumer
        from a same-device unshared producer. Monitors/links are a runtime
        condition and are re-checked per call in
        :meth:`~repro_torch.core.actor.ActorSystem.try_call_inline`."""
        if node.idx not in private or getattr(ref, "is_remote", False):
            return False
        vd = placements.get(node.idx)
        for p in node.inputs:
            if p.key in outset or len(consumers.get(p.key, ())) != 1:
                return False
            prod = self._effective_producer(p)
            if prod is None:
                return False
            if prod.kind == "source":
                continue        # payload arrives host-side anyway
            pd = placements.get(prod.idx)
            if pd is not None and vd is not None and pd is not vd and \
                    getattr(pd, "torch_device", pd) != \
                    getattr(vd, "torch_device", vd):
                return False
        return True

    def _ref_capable(self, node: GraphNode) -> bool:
        """Can this node consume DeviceRef payloads? Kernel-backed nodes
        without a preprocess can (the preprocess runs on the raw payload
        *before* ref unwrapping); map_over splits refs device-side."""
        if node.kind == "kernel":
            return node.target.preprocess is None
        if node.kind == "actor":
            ka = self._kernel_actor_of(node.target)
            return ka is not None and ka.preprocess is None
        return node.kind == "map_over"

    def _terminals(self, key: Tuple[int, int], consumers, outset,
                   acc: set, seen: set) -> None:
        """Terminal consumers of a port, walking *through* structural
        nodes; graph outputs contribute the sentinel ``-1`` (host)."""
        if key in seen:
            return
        seen.add(key)
        if key in outset:
            acc.add(-1)
        for dst, slot in consumers.get(key, ()):
            node = self.nodes[dst]
            if node.kind == "broadcast" or node.kind == "select":
                for oi in range(node.n_out):
                    self._terminals((dst, oi), consumers, outset, acc, seen)
            elif node.kind == "zip_join":
                self._terminals((dst, slot), consumers, outset, acc, seen)
            elif node.kind == "merge":
                self._terminals((dst, 0), consumers, outset, acc, seen)
            else:
                acc.add(dst)

    def _wants_ref(self, node: GraphNode, consumers, outset, refcap) -> bool:
        """Should this producer emit DeviceRefs? Only when every terminal
        consumer of every output port can unwrap them, none of its ports
        escapes as a graph output, and it has no postprocess (which runs on
        the emitted representation)."""
        if node.kind == "kernel":
            if node.target.postprocess is not None:
                return False
        elif node.kind == "actor":
            ka = self._kernel_actor_of(node.target)
            if ka is None or ka.postprocess is not None:
                return False
        elif node.kind != "map_over":
            return False
        for oi in range(node.n_out):
            acc: set = set()
            self._terminals((node.idx, oi), consumers, outset, acc, set())
            if not acc or -1 in acc or not all(refcap[t] for t in acc):
                return False
        return True

    def _placement_site(self, node: GraphNode) -> GraphSite:
        """Describe one node to the placement service: explicit pins,
        upstream producers (inheritance candidates), and the typed edge
        byte sizes the wire-cost model prices a cross-node hop by.
        Existing actor refs are *fixed* — they already live somewhere —
        and only kernel declarations may be spawned remotely (their
        declarations pickle; opaque Python stages and map_over pools stay
        in the local process)."""
        pinned, fixed = node.device, False
        if node.kind == "actor":
            ka = self._kernel_actor_of(node.target)
            pinned = ka.device if ka is not None else None
            fixed = True
        return GraphSite(
            idx=node.idx, path=node.path, pinned=pinned, fixed=fixed,
            producers=tuple(p.node.idx for p in node.inputs
                            if p is not None),
            in_bytes=_edge_bytes(p.type for p in node.inputs
                                 if p is not None),
            out_bytes=_edge_bytes(node.out_types),
            remote_ok=node.kind == "kernel" and node.device is None)

    def _spawn_node(self, node: GraphNode, device, want_ref: bool, mngr
                    ) -> ActorRef:
        if node.kind == "kernel":
            if isinstance(device, NodeTarget):
                # cross-node placement: the declaration pickles over the
                # wire and spawns in the peer's actor system; data routing
                # is unchanged (requests auto-spill at the wire, replies
                # unspill onto the driver's device)
                return device.spawn(node.target,
                                    emit="ref" if want_ref else "declared")
            return mngr.spawn(node.target, device=device,
                              emit="ref" if want_ref else "declared")
        if node.kind == "actor":
            ka = self._kernel_actor_of(node.target)
            if want_ref and ka is not None and ka.emit != "ref":
                # clone, never mutate: the original actor keeps its
                # declared semantics for direct callers
                return self.system.spawn(ka.clone(emit="ref"))
            return node.target
        if node.kind == "func":
            return self.system.spawn(node.target)
        return self._spawn_map(node, device, want_ref, mngr)

    def _spawn_map(self, node: GraphNode, device, want_ref: bool, mngr
                   ) -> ActorRef:
        from .scheduler import ChunkScheduler
        opts = node.options
        decl: KernelDecl = node.target
        devices = opts["devices"]
        if devices is None and device is not None:
            devices = [device]
        pool = mngr.spawn_pool(
            decl, opts["replicas"], policy=opts["policy"], devices=devices,
            emit="ref" if decl.postprocess is None else "declared")
        # a host value is moved to the first replica's device once; the
        # chunks are slices of that tensor, never copies through the host
        home = next(iter(pool.placements.values()))
        chunks, timeout = opts["chunks"], opts["timeout"]
        min_bytes = opts.get("min_chunk_bytes", 0)
        sched_kwargs = opts["scheduler"]

        def run_map(x):
            arr = x.array if isinstance(x, DeviceRef) \
                else as_device_array(x, device=home)
            n = int(arr.shape[0])
            nbytes = arr.numel() * arr.element_size()
            k = max(1, min(chunks, n))
            if min_bytes and nbytes and nbytes // k < min_bytes:
                # sub-threshold slices can't amortize the per-chunk
                # dispatch constant; shrink the chunk count (down to a
                # single whole-array dispatch) instead of paying it k times
                k = max(1, min(k, nbytes // min_bytes))
            bounds = np.linspace(0, n, k + 1).astype(int)
            owned, payloads = [], []
            for a, b in zip(bounds[:-1], bounds[1:]):
                if a == b:
                    continue
                c = DeviceRef(arr[a:b], access="r")   # device-side slice
                owned.append(c)
                payloads.append((c,))
            if not payloads:
                # empty leading axis: run one empty chunk through the
                # kernel so the result has the kernel's output dtype/shape
                c = DeviceRef(arr[:0], access="r")
                owned.append(c)
                payloads.append((c,))
            results: list = []
            try:
                results = ChunkScheduler(pool, **sched_kwargs).run(
                    payloads, timeout=timeout)
                parts = [r.array if isinstance(r, DeviceRef)
                         else as_device_array(r, device=home)
                         for r in results]
                out = torch.cat(parts, dim=0)
            finally:
                for c in owned:
                    c.release()
                # chunk result refs too — on success their tensors are
                # already captured by the concat, on failure nobody else
                # will release them
                for r in results:
                    if isinstance(r, DeviceRef):
                        r.release()
            if want_ref:
                return DeviceRef(out)
            registry.count_readback()
            return to_numpy(out)

        return self.system.spawn(run_map)


def _target_name(target) -> str:
    return getattr(target, "name", None) or \
        getattr(target, "__name__", None) or type(target).__name__


# ----------------------------------------------------------------------------
# runtime plan + orchestrator
# ----------------------------------------------------------------------------
class GraphPlan:
    """Everything the orchestrator needs at runtime, frozen at build.

    The fusion pass and the dispatch fast path surface here:
    ``fused_regions`` (node-path groups, one list per fused
    :class:`~repro_torch.core.facade.KernelActor`), ``member_of``/``produce_as``
    (member idx → region head / head idx → region tail — how a fused
    actor's single reply is attributed to the tail's output ports),
    ``inline_ok`` (per-node verdict of the build-time inline-dispatch
    analysis), and ``counters`` (``inline`` vs ``mailbox`` dispatch
    counts, served by :attr:`GraphRef.dispatch_stats` and, summed over the
    live graphs, by ``trace.counters()`` as ``graph.inline`` and
    ``graph.mailbox``)."""

    __slots__ = ("name", "nodes", "order", "sources", "outputs", "outset",
                 "consumers", "refs", "placements", "chain_refs",
                 "fused_regions", "member_of", "produce_as", "inline_ok",
                 "counters", "_counters_lock", "decisions", "__weakref__")

    def __init__(self, graph: Graph, topo, consumers, refs, placements, *,
                 regions=(), member_of=None, tail_of=None, inline_ok=None):
        self.name = graph.name
        self.nodes = list(graph.nodes)
        self.order = [n.idx for n in topo]
        self.sources = [n.idx for n in graph.nodes if n.kind == "source"]
        self.outputs = [p.key for p in graph.outputs]
        self.outset = set(self.outputs)
        self.consumers = consumers
        self.refs = refs
        self.placements = placements
        #: per-node PlacementDecision audit records (set by build())
        self.decisions: list = []
        self.fused_regions = [[n.path for n in r] for r in regions]
        self.member_of = dict(member_of or {})
        self.produce_as = dict(tail_of or {})
        self.inline_ok = dict(inline_ok or {})
        self.counters = {"inline": 0, "mailbox": 0}
        self._counters_lock = make_lock("GraphCounters")
        self.chain_refs = self._linear_chain()
        trace.reads(self, GraphPlan._dispatch_counts)

    def _dispatch_counts(self) -> Dict[str, int]:
        """The dispatch counters as ``trace.counters()`` names them."""
        with self._counters_lock:
            return {f"graph.{k}": n for k, n in self.counters.items()}

    def count_dispatch(self, kind: str) -> None:
        with self._counters_lock:
            self.counters[kind] += 1

    def _linear_chain(self) -> Optional[List[ActorRef]]:
        """The underlying stage refs when this graph is a pure linear
        chain — lets an outer ``Pipeline`` inline a built pipe's stages
        (the pre-composed-chain flattening the v1 builder did for
        :class:`~repro_torch.core.compose.ComposedActor`). Fused interiors carry
        no ref of their own; the region's single fused actor stands in as
        one chain stage."""
        if len(self.sources) != 1 or len(self.outputs) != 1:
            return None
        if any(n.kind not in ("source",) + _ACTOR_KINDS or n.n_out != 1
               or n.n_in > 1 for n in self.nodes):
            return None
        prev, chain = self.sources[0], []
        for idx in self.order:
            node = self.nodes[idx]
            if node.kind == "source":
                continue
            p = node.inputs[0]
            if p.node.idx != prev or p.index != 0:
                return None
            r = self.refs[idx]
            if r is not None:
                chain.append(r)
            prev = idx
        if self.outputs[0] != (prev, 0) or not chain:
            return None
        return chain


#: backward-compat alias (pre-PR7 internal name)
_Plan = GraphPlan


class _GraphActor(Actor):
    """The spawned orchestrator: each message starts one :class:`_GraphRun`
    and responds with its promise (paper §3.5 response delegation).

    Runs entered through the mailbox keep ``allow_inline=False``: pools
    and chunk schedulers issue ``request``\\ s while holding their own
    locks, and running whole graph traversals synchronously under those
    locks would serialize their dispatch. The inline fast path belongs to
    :meth:`GraphRef.ask`, whose caller blocks on the result anyway."""

    def __init__(self, plan: GraphPlan):
        super().__init__()
        self.plan = plan

    def receive(self, *payload: Any) -> Future:
        out: Future = Future()
        _GraphRun(self.plan, payload, out).start()
        return out


class GraphRef(ActorRef):
    """An :class:`ActorRef` to a built graph, plus build artifacts:
    ``placements`` (node path → Device or
    :class:`~repro_torch.core.placement.NodeTarget`), ``node_refs`` (node path →
    ActorRef), ``placement_decisions`` (the cost-model service's auditable
    per-node records), and the plan used by Pipeline inlining (which also
    carries ``plan.fused_regions`` and the dispatch counters behind
    :attr:`dispatch_stats`).

    :meth:`ask` runs the plan **directly on the calling thread** instead
    of hopping through the orchestrator's mailbox, with the
    inline-dispatch fast path enabled: on a fused linear chain a request
    costs one composed kernel call plus plain function dispatch — the paper's
    "negligible overhead" claim. ``send``/``request`` keep the ordinary
    mailbox path (and with it PR 5's supervision semantics end to end).
    """

    __slots__ = ("plan", "placements", "node_refs", "placement_decisions")

    @property
    def dispatch_stats(self) -> dict:
        """Cumulative ``{"inline": n, "mailbox": m}`` dispatch counts
        across every run of this graph since build."""
        with self.plan._counters_lock:
            return dict(self.plan.counters)

    def ask(self, *payload: Any, timeout: Any = _UNSET) -> Any:
        st = self._system._actors.get(self.actor_id)
        if st is None or not st.alive:
            # dead/killed orchestrator: fall through to the mailbox path
            # so the caller sees the same ActorFailed it always did
            return super().ask(*payload, timeout=timeout)
        if timeout is _UNSET:
            timeout = getattr(self._system, "default_ask_timeout", 120.0)
        out: Future = Future()
        _GraphRun(self.plan, payload, out, allow_inline=True).start()
        try:
            return out.result(timeout=timeout)
        except FuturesTimeout:
            if out.done():
                raise       # the graph itself raised a TimeoutError
            raise FuturesTimeout(
                f"ask() timed out after {timeout}s waiting on graph "
                f"{self.plan.name!r}") from None

    def __repr__(self):
        return (f"GraphRef#{self.actor_id}({self.plan.name!r}, "
                f"{len(self.plan.nodes)} nodes)")


#: sentinel flowing down unselected select() branches
_DEAD = object()


def _iter_refs(value):
    if isinstance(value, DeviceRef):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _iter_refs(v)


class _GraphRun:
    """One request's traversal of the plan.

    Values are routed node-to-node as they become available; structural
    nodes (broadcast / zip_join / select / merge) are resolved inline,
    actor-backed nodes get an asynchronous ``request`` whose completion
    continues the traversal. Every :class:`DeviceRef` produced inside the
    run is registered and — once the run has settled (result delivered and
    all in-flight node futures done) — released, unless it escaped into
    the final result or came in with the caller's payload. This is the DAG
    generalization of ``ComposedActor``'s chain ownership: a graph run
    leaves no live intermediate refs behind, on success *or* failure.
    """

    def __init__(self, plan: GraphPlan, payload: tuple, out: Future,
                 allow_inline: bool = False):
        self.plan = plan
        self.payload = payload
        self.out = out
        #: GraphRef.ask sets this: dispatch inline-eligible nodes by
        #: calling their behavior on this thread (caller blocks on the
        #: result anyway); mailbox-entered runs never do
        self.allow_inline = allow_inline
        # request() may complete synchronously in the issuing thread, so
        # the callback can re-enter while we still hold the lock
        self.lock = make_rlock("GraphRun")
        n = len(plan.nodes)
        self.slot_vals: List[List[Any]] = [[None] * node.n_in
                                           for node in plan.nodes]
        self.got = [0] * n
        self.fired = [False] * n
        self.merge_dead = [0] * n
        self.inflight = 0
        self.refs: Dict[int, DeviceRef] = {}
        self.protected: set = set()
        self.out_vals: Dict[Tuple[int, int], Any] = {}
        self.failed: Optional[BaseException] = None
        self.resolved = False
        self.finished = False

    # -- entry ----------------------------------------------------------
    def start(self) -> None:
        plan = self.plan
        requests: List[Tuple[int, tuple]] = []
        with self.lock:
            for r in _iter_refs(self.payload):
                self.protected.add(id(r))   # caller owns its input refs
            srcs = plan.sources
            if len(srcs) == 1 and plan.nodes[srcs[0]].splat:
                vals = [self.payload]
            elif len(self.payload) == len(srcs):
                vals = list(self.payload)
            else:
                self._record_failure(GraphError(
                    f"graph {plan.name!r} has {len(srcs)} source(s), "
                    f"request carried {len(self.payload)} value(s)"))
                self._settle()
                return
            # zero-input non-source nodes (constant producers) have no
            # delivery to trigger them — they are ready immediately
            stack: List[int] = [n.idx for n in plan.nodes
                                if n.kind != "source" and n.n_in == 0]
            for idx, v in zip(srcs, vals):
                self.fired[idx] = True
                self._produce(idx, [v], stack)
            self._drain(stack, requests)
        self._issue(requests)
        self._settle()

    # -- routing (lock held) --------------------------------------------
    def _produce(self, idx: int, outs: List[Any], stack: List[int]) -> None:
        for oi, v in enumerate(outs):
            for r in _iter_refs(v):
                self.refs[id(r)] = r
            key = (idx, oi)
            if key in self.plan.outset:
                self.out_vals[key] = v
            for dst, slot in self.plan.consumers.get(key, ()):
                self._deliver(dst, slot, v, stack)

    def _deliver(self, dst: int, slot: int, v: Any, stack: List[int]) -> None:
        node = self.plan.nodes[dst]
        if node.kind == "merge":
            if v is _DEAD:
                self.merge_dead[dst] += 1
                if self.merge_dead[dst] == node.n_in and not self.fired[dst]:
                    self.fired[dst] = True
                    self._produce(dst, [_DEAD], stack)
            elif not self.fired[dst]:
                self.fired[dst] = True          # first live value wins
                self._produce(dst, [v], stack)
            return                              # losers: swept at settle
        self.slot_vals[dst][slot] = v
        self.got[dst] += 1
        if self.got[dst] == node.n_in and not self.fired[dst]:
            stack.append(dst)

    def _drain(self, stack: List[int],
               requests: List[Tuple[int, tuple]]) -> None:
        """Fire ready nodes: structural ones inline, actor-backed ones by
        queueing a request to issue once the lock is released."""
        while stack:
            idx = stack.pop()
            if self.fired[idx] or self.failed is not None:
                continue
            self.fired[idx] = True
            node = self.plan.nodes[idx]
            vals = self.slot_vals[idx]
            if node.kind == "broadcast":
                v = vals[0]
                if isinstance(v, DeviceRef) and not v.is_spilled \
                        and v.readable and v.writable:
                    # fan-out is read-sharing: hand each branch a
                    # read-only view so a donating (InOut) consumer in
                    # one branch gets a deterministic AccessViolation
                    # instead of invalidating the buffer under siblings
                    outs = [v.restrict("r") for _ in range(node.n_out)]
                else:
                    outs = [v] * node.n_out
                self._produce(idx, outs, stack)
            elif node.kind == "zip_join":
                outs = ([_DEAD] * node.n_out if any(v is _DEAD for v in vals)
                        else list(vals))
                self._produce(idx, outs, stack)
            elif node.kind == "select":
                self._fire_select(idx, node, vals[0], stack)
            else:  # actor-backed
                if any(v is _DEAD for v in vals):
                    # deadness skips the whole fused region: attribute the
                    # dead outputs to the region tail, as a reply would be
                    out_idx = self.plan.produce_as.get(idx, idx)
                    self._produce(out_idx,
                                  [_DEAD] * self.plan.nodes[out_idx].n_out,
                                  stack)
                    continue
                if node.splat:
                    v = vals[0]
                    args = tuple(v) if isinstance(v, tuple) else (v,)
                else:
                    args = tuple(vals)
                self.inflight += 1
                requests.append((idx, args))

    def _fire_select(self, idx: int, node: GraphNode, v: Any,
                     stack: List[int]) -> None:
        if v is _DEAD:
            self._produce(idx, [_DEAD] * node.n_out, stack)
            return
        try:
            branch = int(node.options["pred"](v))
            if not 0 <= branch < node.n_out:
                raise GraphError(
                    f"{node.path}: predicate picked branch {branch}, node "
                    f"has {node.n_out}")
        except Exception as exc:
            self._record_failure(exc)
            return
        outs: List[Any] = [_DEAD] * node.n_out
        outs[branch] = v
        self._produce(idx, outs, stack)

    # -- async continuation ---------------------------------------------
    def _issue(self, requests: List[Tuple[int, tuple]]) -> None:
        plan = self.plan
        for idx, args in requests:
            ref = plan.refs[idx]
            if self.allow_inline and plan.inline_ok.get(idx):
                try:
                    ok, result = ref._system.try_call_inline(
                        ref.actor_id, args)
                except Exception as exc:
                    # the behavior raised: the actor is already terminated
                    # (monitors notified) — identical to the mailbox path
                    plan.count_dispatch("inline")
                    self._finish_node(idx, None, exc)
                    continue
                if ok:
                    plan.count_dispatch("inline")
                    if isinstance(result, Future):
                        # behavior delegated to a promise: continue async
                        result.add_done_callback(
                            lambda f, idx=idx: self._on_node_done(idx, f))
                    else:
                        self._finish_node(idx, result, None)
                    continue
                # miss (queued messages / concurrent drain / monitors
                # attached since build): fall back to the mailbox
            plan.count_dispatch("mailbox")
            fut = ref.request(*args)
            fut.add_done_callback(
                lambda f, idx=idx: self._on_node_done(idx, f))

    def _on_node_done(self, idx: int, fut: Future) -> None:
        exc = fut.exception()
        self._finish_node(idx, None if exc is not None else fut.result(), exc)

    def _finish_node(self, idx: int, result: Any,
                     exc: Optional[BaseException]) -> None:
        requests: List[Tuple[int, tuple]] = []
        with self.lock:
            self.inflight -= 1
            if exc is not None:
                self._record_failure(exc)
            else:
                for r in _iter_refs(result):
                    if self.finished:
                        # a straggler (merge loser) finished after the run
                        # settled: release immediately, nobody will
                        if id(r) not in self.protected:
                            r.release()
                    else:
                        self.refs[id(r)] = r
                if self.failed is None and not self.finished:
                    # a fused head replies for its whole region: outputs
                    # belong to the region *tail*'s ports
                    out_idx = self.plan.produce_as.get(idx, idx)
                    node = self.plan.nodes[out_idx]
                    if node.n_out > 1:
                        if not isinstance(result, tuple) or \
                                len(result) != node.n_out:
                            self._record_failure(GraphError(
                                f"{node.path}: expected {node.n_out} "
                                f"outputs, actor returned {result!r}"))
                        else:
                            stack: List[int] = []
                            self._produce(out_idx, list(result), stack)
                            self._drain(stack, requests)
                    else:
                        stack = []
                        self._produce(out_idx, [result], stack)
                        self._drain(stack, requests)
        self._issue(requests)
        self._settle()

    # -- completion ------------------------------------------------------
    def _record_failure(self, exc: BaseException) -> None:
        # lock held; first failure wins the response
        if self.failed is None:
            self.failed = exc

    def _settle(self) -> None:
        """Resolve the response as soon as it is determined; sweep
        intermediate refs once everything in flight has landed."""
        do_set = False
        set_exc: Optional[BaseException] = None
        set_val: Any = None
        cleanup: List[DeviceRef] = []
        with self.lock:
            if not self.resolved:
                if self.failed is not None:
                    self.resolved = do_set = True
                    set_exc = self.failed
                elif len(self.out_vals) == len(self.plan.outset):
                    self.resolved = do_set = True
                    vals = [self.out_vals[k] for k in self.plan.outputs]
                    vals = [None if v is _DEAD else v for v in vals]
                    for v in vals:
                        for r in _iter_refs(v):
                            self.protected.add(id(r))
                    set_val = vals[0] if len(vals) == 1 else tuple(vals)
            if self.resolved and self.inflight == 0 and not self.finished:
                self.finished = True
                cleanup = [r for rid, r in self.refs.items()
                           if rid not in self.protected]
        if do_set:          # exactly one caller flips resolved
            if set_exc is not None:
                self.out.set_exception(set_exc)
            else:
                self.out.set_result(set_val)
        for r in cleanup:
            try:
                r.release()
            except Exception:       # pragma: no cover - defensive
                pass  # lint: reclaiming a failed run's refs is best-effort
