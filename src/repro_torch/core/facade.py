"""``actor_facade`` — wrap a data-parallel kernel as an actor (paper §3.2).

Whenever the facade receives a message it (paper's three-part behavior,
§3.6):

1. runs the **pre-processing** function (default: pattern-match the payload
   against all ``In``/``InOut`` declarations and move host data to the
   device),
2. dispatches the **kernel** — a callable on tensors, run eagerly with the
   actor's device current and its stream the current stream. Kernel
   launches return once enqueued: the returned tensors are futures for
   device buffers, reproducing the paper's ``clEnqueueNDRangeKernel`` +
   event pipeline (Listing 4) — downstream actors on the same device
   enqueue behind them in stream order before the kernel finishes,
3. runs the **post-processing** function (default: wrap each
   ``Out``/``InOut`` result as a value — explicit host read-back — or as a
   :class:`~repro_torch.core.memref.DeviceRef` when the spec asked for
   reference semantics).

``InOut`` arguments are updated in place: the kernel receives the buffer
itself and may write it. An incoming ``DeviceRef`` is **donated**
(``DeviceRef.donate()``), making buffer ownership transfer explicit —
using the ref afterwards raises. A kernel spawned with ``donate=False``
receives a copy instead, so the caller's buffer is never written.

DeviceRefs are the native currency on both sides of the behavior: incoming
refs are unwrapped (with access-rights checks — an ``in`` argument needs
read rights, ``in_out`` needs read+write), outgoing tensors are wrapped as
refs whenever the spec asks for reference semantics *or* the actor was
spawned with ``emit="ref"`` (how ``Pipeline`` keeps intermediate stages
device-resident). The facade itself never calls ``to_value()``; the only
host read-back is the explicit value-semantics path, counted in the
registry as a ``readback``.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from .actor import Actor
from .errors import AccessViolation, SignatureMismatch
from .manager import Device, Program
from .memref import DeviceRef, as_device_array, registry, to_numpy
from .signature import KernelSignature, NDRange, dtype_name

__all__ = ["KernelActor", "detect_fn_kwargs", "eval_output_structs"]

#: static keywords a kernel callable may accept from the runtime
_KERNEL_KWARGS = ("nd_range", "out_shapes", "local_shapes")


def detect_fn_kwargs(fn: Callable) -> set:
    """Which of the runtime-supplied static keywords ``fn`` accepts — the
    single source of truth shared by :class:`KernelActor` and
    :meth:`~repro_torch.core.api.KernelDecl.out_structs`."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # pragma: no cover - builtins
        return set()
    return {k for k in _KERNEL_KWARGS if k in params}


def _bind_static(fn: Callable, signature: KernelSignature,
                 nd_range: Optional[NDRange], fn_kwargs) -> Callable:
    """``fn`` with its static keywords bound, always returning a tuple."""
    static_kwargs = {}
    if "nd_range" in fn_kwargs:
        static_kwargs["nd_range"] = nd_range
    if "local_shapes" in fn_kwargs:
        static_kwargs["local_shapes"] = tuple(
            s.resolved_shape() for s in signature.local_specs)

    def wrapped(*inputs):
        out = fn(*inputs, **static_kwargs)
        return out if isinstance(out, tuple) else (out,)

    return wrapped


def eval_output_structs(fn: Callable, signature: KernelSignature,
                        nd_range: Optional[NDRange], fn_kwargs,
                        input_structs: Sequence) -> Tuple:
    """Abstract-evaluate a kernel: the output meta tensors (shape and
    dtype, no data) for the given input meta tensors, without running it.

    This is how ``repro_torch.core.graph`` derives *typed ports* from a
    :class:`KernelSignature` at build time (paper §3.5: composition over
    statically checkable typed actor interfaces). Every hand-written
    kernel is a ``torch.library.custom_op`` with a fake implementation,
    so a kernel callable built from them evaluates on ``meta`` tensors;
    one that inspects data raises, and the graph keeps the declared specs.
    """
    metas = tuple(t if isinstance(t, torch.Tensor) and t.is_meta
                  else torch.empty(tuple(t.shape), dtype=t.dtype,
                                   device="meta")
                  for t in input_structs)
    return _bind_static(fn, signature, nd_range, fn_kwargs)(*metas)


class KernelActor(Actor):
    """The paper's ``actor_facade`` adapted to PyTorch."""

    def __init__(self, fn: Callable, name: str, nd_range: Optional[NDRange],
                 specs: Sequence, device: Device,
                 program: Optional[Program] = None,
                 preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None,
                 donate: bool = True, emit: str = "declared",
                 fused_from: Sequence[str] = ()):
        super().__init__()
        if emit not in ("declared", "ref"):
            raise ValueError(f"emit must be 'declared' or 'ref', got {emit!r}")
        self.fn = fn
        #: node paths of the graph region this actor was fused from
        #: (empty for ordinary single-kernel actors) — introspection for
        #: the Graph fusion pass
        self.fused_from = tuple(fused_from)
        self.kernel_name = name
        self.nd_range = nd_range
        self.signature = KernelSignature(*specs)
        self.device = device
        self.program = program
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.donate = donate
        #: "declared" honours each Out spec's as_ref; "ref" forces every
        #: output to stay device-resident (intermediate pipeline stages)
        self.emit = emit
        self._call = None
        # Kernels may want the index space / local sizes; detect which
        # keywords the callable accepts once.
        self._fn_kwargs = detect_fn_kwargs(fn)

    # -- building ---------------------------------------------------------
    def _build(self):
        def build():
            return _bind_static(self.fn, self.signature, self.nd_range,
                                self._fn_kwargs)
        if self.program is not None:
            return self.program.compiled(("call", self.kernel_name), build)
        return build()

    def on_start(self):
        if self._call is None:
            self._call = self._build()

    # -- behavior ------------------------------------------------------
    def receive(self, *payload: Any) -> Any:
        if self.preprocess is not None:
            converted = self.preprocess(*payload)
            if converted is None:  # pattern did not match → drop (paper §2.1)
                return None
            payload = converted if isinstance(converted, tuple) else (converted,)

        sig = self.signature
        inputs = sig.match_inputs(payload)
        if self._call is None:
            self.on_start()
        with self.device.launch_context():
            response = self._dispatch(sig, inputs)
        result = tuple(response)
        if self.postprocess is not None:
            result = self.postprocess(*result)
            if result is not None and not isinstance(result, tuple):
                result = (result,)
        if result is None:
            return None
        return result[0] if len(result) == 1 else result

    def _dispatch(self, sig: KernelSignature, inputs) -> list:
        """Unwrap, launch and wrap, inside the device's launch context."""
        dev = self.device.torch_device
        arrays = []
        consumed_refs = []
        for spec, value in zip(sig.input_specs, inputs):
            if isinstance(value, DeviceRef):
                if not value.readable:
                    raise AccessViolation(
                        f"kernel {self.kernel_name!r}: {spec.direction!r} "
                        f"argument requires read rights, ref grants "
                        f"{value.access!r}")
                if spec.direction == "in_out":
                    if not value.writable:
                        raise AccessViolation(
                            f"kernel {self.kernel_name!r}: 'in_out' argument "
                            f"requires write rights, ref grants "
                            f"{value.access!r}")
                    if self.donate:
                        consumed_refs.append(value)
                arr = value.array
                if arr.device != dev:
                    arr = arr.to(dev)
                elif spec.direction == "in_out" and not self.donate:
                    arr = arr.clone()       # never write the caller's buffer
            else:
                # Untyped Python scalars/lists adopt the spec dtype; arrays
                # keep theirs so mismatches are caught (pattern matching).
                cast = None if hasattr(value, "dtype") else spec.torch_dtype
                arr = as_device_array(value, device=dev, dtype=cast)
            if not spec.matches(arr.dtype):
                raise SignatureMismatch(
                    f"kernel {self.kernel_name!r}: argument dtype "
                    f"{dtype_name(arr.dtype)} does not match spec "
                    f"{dtype_name(spec.torch_dtype)}")
            arrays.append(arr)

        self.device._dispatch_started()
        try:
            outputs = self._call(*arrays)
        finally:
            self.device._dispatch_finished()

        # donated buffers: ownership moved into the kernel (donate-after-use
        # on the incoming ref now raises)
        for ref in consumed_refs:
            ref.donate()

        if len(outputs) != len(sig.output_specs):
            raise SignatureMismatch(
                f"kernel {self.kernel_name!r} returned {len(outputs)} outputs, "
                f"signature declares {len(sig.output_specs)}")
        response = []
        for spec, arr in zip(sig.output_specs, outputs):
            if not spec.matches(arr.dtype):
                raise SignatureMismatch(
                    f"kernel {self.kernel_name!r}: output dtype "
                    f"{dtype_name(arr.dtype)} does not match spec "
                    f"{dtype_name(spec.torch_dtype)}")
            if spec.as_ref or self.emit == "ref":
                response.append(DeviceRef(arr))      # stays device-resident
            else:
                registry.count_readback()            # explicit host read-back
                response.append(to_numpy(arr))
        return response

    def out_structs(self, input_structs: Sequence) -> Tuple:
        """Abstract output types for ``input_structs`` (graph port typing)."""
        return eval_output_structs(self.fn, self.signature, self.nd_range,
                                   self._fn_kwargs, input_structs)

    def clone(self, emit: Optional[str] = None) -> "KernelActor":
        """A fresh (unspawned) actor sharing this one's declaration.

        ``Pipeline._build_staged`` uses this to derive ref-emitting
        intermediate stages from existing actors without mutating them."""
        return KernelActor(fn=self.fn, name=self.kernel_name,
                           nd_range=self.nd_range,
                           specs=self.signature.specs, device=self.device,
                           program=self.program, preprocess=self.preprocess,
                           postprocess=self.postprocess, donate=self.donate,
                           emit=emit or self.emit,
                           fused_from=self.fused_from)

    def on_exit(self, reason):
        self._call = None
