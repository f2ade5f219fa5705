"""Network-transparent distribution: nodes, brokers, and the spill-based
wire format (paper §2.1/§3.5 taken across the process boundary) — the
port of the JAX package's ``repro.net``.

    system = ActorSystem("driver")                    # binds cuda:0
    node = NodeRuntime(system, name="driver", listen=("127.0.0.1", 0))
    # ... a worker process connects and publishes actors ...
    node.wait_for_peer("worker")
    stage = node.remote_actor("worker", "stage-square")
    out_ref = stage.ask(DeviceRef.put(x))   # spill → wire → unspill → ref

Remote handles are ordinary :class:`~repro_torch.core.ActorRef`\\ s
(:class:`RemoteActorRef`), so pools, schedulers, pipelines and the serve
mesh take them unchanged. Inbound refs land on the receiving node's
device (its system's, unless ``unspill_device=`` names another).
"""
from .node import NodeDown, NodeRuntime, PayloadError, RemoteActorRef
from . import wire

__all__ = ["NodeDown", "NodeRuntime", "PayloadError", "RemoteActorRef",
           "wire"]
