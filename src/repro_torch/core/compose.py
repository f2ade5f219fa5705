"""Actor composition — multi-stage kernel pipelines (paper §3.5).

The unified builder lives in :class:`repro_torch.core.api.Pipeline`; this
module keeps the v1 surface as thin shims plus the :class:`ComposedActor`
runtime primitive both levels share:

* :func:`compose` — **staged** composition (``Pipeline(mode="staged")``).
  ``C = B ⊙ A`` spawns a new actor that forwards any message to ``A`` and
  delegates ``A``'s response to ``B`` via a response *promise*. When
  stages exchange :class:`~repro_torch.core.memref.DeviceRef` payloads,
  intermediate data stays device-resident; because kernel launches are
  asynchronous on the device's stream, stage *n+1* is enqueued while
  stage *n* still runs on the device — the paper's OpenCL-event chaining.

* :func:`fuse` — **fused** composition (``Pipeline(mode="fused")``; "an
  alternative level of composition uses kernels as building blocks to
  compose a single OpenCL actor", §3.6). The stage callables are chained
  into one callable behind one actor, eliminating per-stage dispatch.

Both functions are deprecated in favor of the Pipeline builder.
"""
from __future__ import annotations

import warnings
from concurrent.futures import Future
from typing import Any, Callable, Optional, Sequence, Union

from .actor import Actor, ActorRef, ActorSystem
from .memref import DeviceRef
from .signature import NDRange

__all__ = ["compose", "fuse", "ComposedActor"]


class ComposedActor(Actor):
    """Forwards messages through ``stages`` left→right, responding with the
    final stage's result (promise delegation, paper §3.5).

    Intermediate :class:`DeviceRef` results are owned by the chain: once
    the next stage has consumed a forwarded ref, it is released (paper:
    "dropping a reference argument simply releases its memory on the
    device"), so a pipeline run leaves no live intermediate refs behind.
    The caller's input refs and the final stage's result are never touched.
    """

    def __init__(self, stages: Sequence[ActorRef]):
        super().__init__()
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)

    def receive(self, *payload: Any) -> Future:
        out: Future = Future()
        self._run_stage(0, payload, out, owned=())
        return out  # promise: the runtime delegates the response

    def _run_stage(self, idx: int, payload, out: Future,
                   owned: tuple = ()) -> None:
        fut = self.stages[idx].request(*payload)

        def _done(f: Future):
            exc = f.exception()
            if exc is not None:
                for r in owned:
                    r.release()
                out.set_exception(exc)
                return
            result = f.result()
            nxt = result if isinstance(result, tuple) else (result,)
            # stage idx has consumed its inputs: refs the chain owns
            # (produced by stage idx-1) are dead now — drop their buffers,
            # EXCEPT any ref the stage passed through into its own result
            # (still in flight, or owed to the caller at the final stage).
            # release() is idempotent, so donated in_out refs are fine.
            passing = {id(v) for v in nxt if isinstance(v, DeviceRef)}
            for r in owned:
                if id(r) not in passing:
                    r.release()
            if idx + 1 == len(self.stages):
                out.set_result(result)
            else:
                self._run_stage(
                    idx + 1, nxt, out,
                    owned=tuple(v for v in nxt if isinstance(v, DeviceRef)))

        fut.add_done_callback(_done)


def compose(system: ActorSystem, *stages: ActorRef) -> ActorRef:
    """``compose(sys, A, B, C)`` builds C⊙B⊙A (A applied first).

    Deprecated shim over ``Pipeline(system, mode="staged")``;
    ``ActorRef.__mul__`` provides the paper's infix form:
    ``fuse = move_elems * count_elems * prepare`` (Listing 5).
    """
    from .api import Pipeline  # local import: avoid cycle
    warnings.warn(
        "compose() is deprecated; use repro_torch.core.Pipeline(mode=\"staged\") "
        "— or build a dataflow Graph directly for non-linear topologies",
        DeprecationWarning, stacklevel=2)
    return Pipeline(system, mode="staged").stages(stages).build()


def fuse(system: ActorSystem, *stages: Union[ActorRef, Callable],
         nd_range: Optional[NDRange] = None, name: str = "fused",
         device=None) -> ActorRef:
    """Fuse kernel stages into a **single** actor.

    Deprecated shim over ``Pipeline(system, mode="fused")``. ``stages``
    are kernel-actor refs (their ``fn`` is extracted) or plain
    callables acting as adapters between stages. The fused actor takes
    the first stage's input signature and produces the last stage's
    output signature; intermediates never materialize as messages.
    """
    from .api import Pipeline  # local import: avoid cycle
    warnings.warn(
        "fuse() is deprecated; use repro_torch.core.Pipeline(mode=\"fused\") or "
        "repro_torch.core.Graph.build(fuse=True), which run the build-time "
        "fusion pass", DeprecationWarning, stacklevel=2)
    return Pipeline(system, mode="fused", name=name, device=device,
                    nd_range=nd_range).stages(stages).build()
