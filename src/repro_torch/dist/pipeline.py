"""Pipeline parallelism from stage actors — the port of the JAX package's
``repro/dist/pipeline.py``.

:func:`make_layer_stage_actors` slices a model's layers into contiguous
stages, each owned by one actor; the :class:`PipelineRunner` streams
microbatches through the stage chain with a bounded in-flight depth — the
paper's async event-chaining (Listing 4) applied to 1F pipeline
schedules: stage *n+1* of microbatch *i* overlaps stage *n* of microbatch
*i+1*.

The stage chain itself is built with the port's :class:`repro_torch.core.
Pipeline` surface (``mode="staged"``), so the same composition object
covers kernel actors and model stages.

There is no ``jit`` to port: a stage runs its layers eagerly through
``models.transformer.apply_layers``, the fused
:meth:`~repro_torch.models.Model.forward`'s own loop, under
``torch.no_grad`` (grad mode is thread-local and an actor
thread starts with it on), so it takes the fused forward's own path. The
[B, S, D] activation crosses actors as a :class:`DeviceRef`, which
records the stream that produced it; the next stage reads it through
``DeviceRef.array``, which makes that stage's current stream wait on the
producer's where the two differ.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, List, Optional, Sequence

import torch

from .. import trace
from ..core import ActorRef, ActorSystem
from ..core.api import Pipeline
from ..core.memref import DeviceRef, as_device_array
from ..models.transformer import (_logits, apply_layers, default_positions,
                                  embed_inputs, layer_kinds, unit_starts)

__all__ = ["PipelineRunner", "make_layer_stage_actors"]


# ----------------------------------------------------------------------------
# stage construction
# ----------------------------------------------------------------------------
def _stage_fn(model, params, layers, first: bool, last: bool):
    """A ``x → x`` function for one stage over ``layers``, a list of
    ``(block params, kind, unit start)``.

    The first stage embeds tokens; the last applies the final norm and LM
    head, by the fused forward's own head function. Middle stages are
    residual-stream transforms, so only the [B, S, D] activation crosses
    actor boundaries. The stage runs in a
    ``stage`` span, its input's transfer, embedding and positions in
    ``stage.embed``, the head in ``stage.head``."""
    cfg = model.cfg

    def stage(x):
        with trace.span("stage"), torch.no_grad():
            with trace.span("stage.embed"):
                x = as_device_array(x, device=model.device)
                if first:
                    x = embed_inputs(params, cfg, x)
                b, s = x.shape[0], x.shape[1]
                positions = default_positions(
                    cfg, torch.zeros((), dtype=torch.int64, device=x.device),
                    b, s)
            x, _ = apply_layers(layers, cfg, x, positions, model.attn_impl)
            if not last:
                return DeviceRef(x)
            with trace.span("stage.head"):
                return _logits(params, cfg, x)

    return stage


def make_layer_stage_actors(system: ActorSystem, model, params,
                            n_stages: int) -> List[ActorRef]:
    """Split the layers into ``n_stages`` contiguous stage actors.

    The staged forward reproduces ``model.forward`` exactly (the same
    per-layer ops in the same order); only the logits (not the MoE aux
    loss) leave the last stage. Stages take tokens (host arrays, tensors
    or :class:`DeviceRef`\\ s, moved to the model's device by the first
    stage) and hand the activation on as a ``DeviceRef``."""
    cfg = model.cfg
    if cfg.family == "encdec":
        raise NotImplementedError("stage split targets decoder-only stacks")
    layers = list(zip(params["layers"], layer_kinds(cfg), unit_starts(cfg)))
    n_layers = len(layers)
    if not 1 <= n_stages <= n_layers:
        raise ValueError(f"n_stages={n_stages} not in [1, {n_layers}]")
    sizes = [n_layers // n_stages + (1 if i < n_layers % n_stages else 0)
             for i in range(n_stages)]
    stages, lo = [], 0
    for si, sz in enumerate(sizes):
        fn = _stage_fn(model, params, layers[lo:lo + sz], first=(si == 0),
                       last=(si == n_stages - 1))
        lo += sz
        stages.append(system.spawn(fn))
    return stages


# ----------------------------------------------------------------------------
# microbatch streaming
# ----------------------------------------------------------------------------
class PipelineRunner:
    """Streams microbatches through a stage chain with ≤ ``depth`` in
    flight; results come back in submission order and the first stage
    failure aborts the run.

    :meth:`submit` is the asynchronous single-microbatch entry point —
    staged *serving* across layer actors drives it directly (one request's
    activations per call, concurrent up to ``depth``); :meth:`run` is the
    batch-mode loop over it.

    Construction takes either ``stages`` (a linear actor chain, built
    through the :class:`~repro_torch.core.api.Pipeline` wrapper) **or**
    ``graph=`` — a :class:`repro_torch.core.graph.Graph` (built on the
    fly) or an already-built :class:`~repro_torch.core.graph.GraphRef` —
    so microbatch streaming works over any device-resident DAG, not just
    chains.
    """

    def __init__(self, system: ActorSystem,
                 stages: Optional[Sequence[ActorRef]] = None,
                 depth: int = 2, *, graph=None):
        if (stages is None) == (graph is None):
            raise ValueError("pass exactly one of stages or graph")
        self.depth = depth
        if graph is not None:
            from ..core.graph import Graph
            self._chain = graph.build() if isinstance(graph, Graph) else graph
        else:
            if not stages:
                raise ValueError("need at least one stage")
            self._chain = Pipeline(system, mode="staged").stages(
                stages).build()
        # shared in-flight window: concurrent submit() callers (a serve
        # engine's request threads) and run() draw from the same budget
        self._sem = threading.Semaphore(depth)

    def submit(self, mb: Any, *, emit: str = "value",
               timeout: Optional[float] = None) -> Future:
        """Admit one microbatch into the stage chain; returns a future for
        its result. At most ``depth`` microbatches are in flight — a full
        window blocks the caller (backpressure) until a slot frees, or
        raises ``TimeoutError`` after ``timeout`` seconds.

        ``emit`` selects the result representation:

        * ``"value"`` — whatever the last stage produced (default);
        * ``"ref"``   — wrap each result as a :class:`DeviceRef`, the
          stay-on-device handoff to a downstream consumer;
        * ``"spill"`` — wrap **and spill**: the explicit host-serialization
          stage boundary (paper §3.5 option (b)) for cross-node transport —
          spilled refs pickle.
        """
        if emit not in ("value", "ref", "spill"):
            raise ValueError(f"emit must be value|ref|spill, got {emit!r}")
        with trace.request("pipeline.submit"):
            with trace.span("pipeline.admit"):
                admitted = self._sem.acquire(timeout=timeout)
            if not admitted:
                raise TimeoutError(
                    f"pipeline in-flight window ({self.depth}) still full "
                    f"after {timeout}s")
            payload = mb if isinstance(mb, tuple) else (mb,)
            try:
                fut = self._chain.request(*payload)
            except BaseException:
                # the window is instance state: a synchronous request
                # failure must hand its slot back or the runner shrinks
                self._sem.release()
                raise
        out: Future = Future()

        def _done(f):
            self._sem.release()
            exc = f.exception()
            if exc is not None:
                out.set_exception(exc)
                return
            res = f.result()
            if emit != "value":
                ref = (res if isinstance(res, DeviceRef)
                       else DeviceRef(as_device_array(res)))
                if emit == "spill":
                    ref.spill()
                res = ref
            out.set_result(res)

        fut.add_done_callback(_done)
        return out

    def run(self, microbatches: Sequence[Any],
            timeout: Optional[float] = 300.0, emit: str = "value") -> list:
        """Stream the microbatches; returns results in submission order.

        Microbatches may be host arrays, tensors **or**
        :class:`DeviceRef`\\ s (the first stage unwraps refs, so data
        already on the device never bounces through the host). A thin loop
        over :meth:`submit`; the first stage failure stops further
        admissions and aborts the run.
        """
        futures: list[Future] = []
        for mb in microbatches:
            if any(f.done() and f.exception() is not None for f in futures):
                break  # a stage already failed: stop admitting
            futures.append(self.submit(mb, emit=emit, timeout=timeout))
        results: list = [None] * len(microbatches)
        first_error: Optional[BaseException] = None
        for i, f in enumerate(futures):
            try:
                results[i] = f.result(timeout)
            except Exception as exc:
                if first_error is None:
                    first_error = exc
        if first_error is not None:
            raise first_error
        return results
