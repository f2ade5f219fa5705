"""``repro_torch.serve`` — asynchronous continuous-batching request engine,
the port of the JAX package's ``repro.serve``.

Layered on the actor data plane: requests are admitted with deadlines and
priorities (:class:`RequestQueue`), formed into shape-bucketed dynamic
batches (:class:`Batcher`), and decoded multi-step by the
:class:`ServeEngine`, whose per-request caches stay device-resident as
:class:`~repro_torch.core.memref.DeviceRef` pytrees between steps. The
paged mode (:class:`PagePool` + ``ServeEngine(cache_pool=...)``)
disaggregates serving into prefill and decode phases over a page-granular
KV-cache allocator with copy-free prefix sharing. The mesh layer
(:class:`MeshRouter` + :class:`EngineReplica`) shards requests across
engine replicas, in this process or on worker nodes reached through
``repro_torch.net``, with prefix/session-affine routing, SLO-driven
autoscaling, and exactly-once replay of requests in flight on a node
that dies.
"""
from .batcher import Batcher
from .engine import (EngineStopped, ServeEngine, make_decode_worker,
                     make_graph_decode_worker)
from .kvpool import (Page, PagePool, PageTable, PoolExhausted,
                     make_paged_decode_worker, make_prefill_worker)
from .mesh import (EngineReplica, MeshDown, MeshRouter, ReplicaSpec,
                   local_replica_stats)
from .request import (AdmissionError, QueueClosed, QueueOverflow, Request,
                      RequestQueue, ServeResult, SLOExceeded)
from .stats import EWMA, LatencyStats

__all__ = [
    "Batcher",
    "EngineStopped", "ServeEngine", "make_decode_worker",
    "make_graph_decode_worker",
    "Page", "PagePool", "PageTable", "PoolExhausted",
    "make_paged_decode_worker", "make_prefill_worker",
    "EngineReplica", "MeshDown", "MeshRouter", "ReplicaSpec",
    "local_replica_stats",
    "AdmissionError", "QueueClosed", "QueueOverflow", "Request",
    "RequestQueue", "ServeResult", "SLOExceeded",
    "EWMA", "LatencyStats",
]
