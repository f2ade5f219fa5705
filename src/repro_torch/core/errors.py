"""Failure/exit message types for actor supervision (paper §2.1).

The actor model addresses fault-tolerance by letting actors monitor each
other: when an actor dies, the runtime sends a ``DownMessage`` to every
monitor and an ``ExitMessage`` to every link (bidirectional monitor).
"""
from __future__ import annotations

import dataclasses
from typing import Any


class ActorError(Exception):
    """Base class for actor-runtime errors."""


class ActorFailed(ActorError):
    """Raised when requesting from an actor that terminated abnormally."""


class MailboxClosed(ActorError):
    """Message sent to an actor that already terminated."""


class SignatureMismatch(ActorError):
    """Message payload does not match the kernel signature (paper §3.4)."""


class AccessViolation(ActorError):
    """Operation not permitted by a DeviceRef's access rights (paper §3.5:
    "a reference type includes ... memory access rights")."""


class DeadlineExceeded(ActorError):
    """A deadline-carrying request or chunk missed its deadline before (or
    while) being served; the serve engine surfaces this per request."""


class GraphError(ActorError):
    """Base class for dataflow-graph construction/validation errors
    (``repro_torch.core.graph``). Every subclass message names the offending
    node path (``<graph>/<node>``) — the build-time typed-actor check the
    paper gets from CAF's typed actor interfaces (§3.5)."""


class GraphCycleError(GraphError):
    """The graph topology contains a cycle; the message lists the node
    paths along the cycle."""


class DanglingPortError(GraphError):
    """An input slot was never wired, or a produced port has no consumer
    and is not a graph output (device-resident data that would leak)."""


class ArityMismatchError(GraphError):
    """A node is wired with a different number of input ports than its
    kernel signature declares."""


class PortTypeMismatchError(GraphError):
    """An edge's dtype/shape does not match the consumer's declared
    signature (or the producer's abstract-eval'd output type)."""


@dataclasses.dataclass(frozen=True)
class DownMessage:
    """Sent to monitors when a watched actor terminates (paper §2.1)."""

    actor_id: int
    reason: Any  # None for normal termination, the exception otherwise


@dataclasses.dataclass(frozen=True)
class ExitMessage:
    """Sent over links; by default kills the receiver unless it traps exits."""

    actor_id: int
    reason: Any
