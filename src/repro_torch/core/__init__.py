"""The paper's contribution: OpenCL-style kernel actors, on PyTorch.

The surface is declarative — signature and index space are captured at
definition site, composition is a builder, pooling is one call:

    import torch
    from repro_torch.core import ActorSystem, NDRange, In, Out, dim_vec, kernel
    from repro_torch.kernels import ops

    @kernel(In(torch.float32), In(torch.float32),
            Out(torch.float32, shape=(n, n)),
            nd_range=NDRange(dim_vec(n, n)))
    def m_mult(a, b):
        return ops.matmul(a, b)

    sys_ = ActorSystem()                  # binds cuda:0; device="cpu" asks for the CPU
    worker = sys_.spawn(m_mult)
    result = worker.ask(a, b)

    pipe = Pipeline(sys_, mode="auto").stage(m_mult).stage(scale).build()
    pool = sys_.opencl_manager().spawn_pool(m_mult, 4, policy="least_loaded")

Non-linear compositions use the typed DAG builder (``Graph``): nodes are
kernels/actors/Python stages, edges are shape/dtype-checked ports, and
``build()`` validates the topology before spawning.

The v1 positional surface (``mngr.spawn(fn, name, nd_range, *specs)``,
``compose``, ``fuse``) remains available as deprecated shims.
"""
from .actor import Actor, ActorRef, ActorSystem, Message
from .api import ActorPool, KernelDecl, Pipeline, kernel
from .compose import ComposedActor, compose, fuse
from .errors import (AccessViolation, ActorError, ActorFailed,
                     ArityMismatchError, DanglingPortError, DeadlineExceeded,
                     DownMessage, ExitMessage, GraphCycleError, GraphError,
                     MailboxClosed, PortTypeMismatchError, SignatureMismatch)
from .facade import KernelActor
from .graph import Graph, GraphNode, GraphPlan, GraphRef, Port, PortType
from .manager import Device, DeviceManager, Platform, Program
from .memref import (DeviceRef, RefRegistry, as_device_array, default_device,
                     live_ref_count, memory_stats, payload_nbytes,
                     reset_transfer_stats, transfer_count, tree_release,
                     tree_unwrap, tree_wrap)
from .placement import (NodeTarget, PlacementDecision, PlacementService,
                        WireCostModel)
from .placement import service as placement_service
from .placement import set_service as set_placement_service
from .scheduler import ChunkScheduler, split_offload
from .signature import In, InOut, KernelSignature, Local, NDRange, Out, Priv, dim_vec

__all__ = [
    "Actor", "ActorRef", "ActorSystem", "Message",
    "ActorPool", "KernelDecl", "Pipeline", "kernel",
    "ComposedActor", "compose", "fuse",
    "AccessViolation", "ActorError", "ActorFailed", "ArityMismatchError",
    "DanglingPortError", "DeadlineExceeded", "DownMessage", "ExitMessage",
    "GraphCycleError", "GraphError", "MailboxClosed",
    "PortTypeMismatchError", "SignatureMismatch",
    "KernelActor",
    "Graph", "GraphNode", "GraphPlan", "GraphRef", "Port", "PortType",
    "Device", "DeviceManager", "Platform", "Program",
    "DeviceRef", "RefRegistry", "as_device_array", "default_device",
    "live_ref_count", "memory_stats", "reset_transfer_stats",
    "transfer_count", "tree_release", "tree_unwrap", "tree_wrap",
    "NodeTarget", "PlacementDecision", "PlacementService", "WireCostModel",
    "placement_service", "set_placement_service", "payload_nbytes",
    "ChunkScheduler", "split_offload",
    "In", "InOut", "KernelSignature", "Local", "NDRange", "Out", "Priv", "dim_vec",
]
