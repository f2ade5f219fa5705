"""Compressed collectives — the port of the JAX package's
``repro/dist/collectives.py``: the int8 wire codec, and the all-reduce of
int8-quantized contributions with error feedback.

Each payload is quantized to int8 with one absmax scale: ``scale =
absmax / 127`` (1 for an all-zero payload), ``q = clip(round(x / scale),
-127, 127)`` with ``round`` half to even, and expanded back as ``q *
scale``. Every step is IEEE f32 on both packages (``torch.round`` and
``jnp.round`` both round half to even), so the codec is bit-exact with
the JAX one on the same inputs, on the CPU and on the card alike. It
runs as plain PyTorch on the ref's own device: the JAX package has no
Pallas kernel here either.

:func:`quantize_ref` / :func:`dequantize_ref` work on
:class:`~repro_torch.core.memref.DeviceRef`\\ s at the host boundary: the
compressed payload stays device-resident as an int8 ref, and spilling
*that* ref ships 4x fewer bytes over the wire than spilling the float
original (``repro_torch.net.wire``'s ``compress=True``).

:func:`compressed_psum` and :func:`tree_psum_with_error_feedback` run on
``torch.distributed`` (any backend: gloo on the CPU, nccl on the card),
over a process group in place of JAX's mesh axis name. Each rank
quantizes its contribution with its own absmax scale and the group
all-reduces the **dequantized f32** values, as JAX's ``psum`` over the
dequantized payload does: the quantization error is what the int8 wire
would carry, the reduction itself is f32.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..core.memref import DeviceRef, as_device_array
from ..core.signature import to_torch_dtype

__all__ = ["compressed_psum", "tree_psum_with_error_feedback",
           "quantize_ref", "dequantize_ref"]


def _quantize_wire(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (int8 payload, f32 scale as a 0-d tensor on ``x``'s device)."""
    xf = x.float()
    amax = xf.abs().max()
    # the divisor is a tensor on amax's device: divided by a Python
    # scalar, a CUDA tensor is multiplied by the scalar's f32 reciprocal,
    # which misses IEEE division (and the JAX codec) by an ulp for ~5 %
    # of absmax values
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize(x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (int8 payload, f32 scale, dequantized f32 value)."""
    q, scale = _quantize_wire(x)
    return q, scale, q.float() * scale


def quantize_ref(x) -> tuple:
    """Compress a tensor or :class:`DeviceRef` to its int8 wire format.

    → ``(DeviceRef[int8], float scale)``. The payload stays on the input's
    device; combined with ``DeviceRef.spill()`` this is the compressed
    host-serialization boundary (4x fewer wire bytes than the original).
    The input ref is *not* consumed.
    """
    q, scale = _quantize_wire(as_device_array(x))
    return DeviceRef(q), float(scale)


def dequantize_ref(q, scale: float, dtype=torch.float32,
                   access: str = "rw") -> DeviceRef:
    """Inverse of :func:`quantize_ref`: expand an int8 payload (tensor or
    ref) back to a ``dtype`` ref on its device. Relative error ≤ 1/254.
    ``access`` restores the original ref's rights (the wire format must
    not widen a restricted view back to ``rw``)."""
    arr = as_device_array(q)
    s = torch.tensor(scale, dtype=torch.float32, device=arr.device)
    return DeviceRef((arr.float() * s).to(to_torch_dtype(dtype)),
                     access=access)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce-sum of int8-quantized contributions over ``group`` (the
    default group when ``None``), in ``x``'s dtype.

    Each rank quantizes with its own absmax scale, so the reduction runs
    over dequantized int8 payloads — per-rank relative error ≤ 1/254.
    ``x`` is not written."""
    _, _, deq = _quantize(x)
    dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
    return deq.to(x.dtype)


def tree_psum_with_error_feedback(grads: Any, errors: Any, group=None
                                  ) -> Tuple[Any, Any]:
    """Mean-reduce a gradient tree over ``group`` through int8
    quantization, carrying each rank's quantization residual forward.

    → ``(mean_grads, new_errors)``; both trees match the input structure
    (a bare tensor is a single-leaf tree). Each rank quantizes ``g + e``,
    keeps ``g + e - deq`` as its new error and contributes ``deq`` to the
    mean: the sum over the group divided by its size, as JAX's ``pmean``.
    """
    g_leaves, spec = pytree.tree_flatten(grads)
    e_leaves, e_spec = pytree.tree_flatten(errors)
    if e_spec != spec:
        raise ValueError("errors must have the structure of grads")
    n = dist.get_world_size(group)
    means, new_errors = [], []
    for g, e in zip(g_leaves, e_leaves):
        corrected = g.float() + e.float()
        _, _, deq = _quantize(corrected)
        new_errors.append((corrected - deq).to(e.dtype))
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        # a tensor divisor: IEEE division, as for the codec's scale
        means.append((deq / deq.new_tensor(float(n))).to(g.dtype))
    return (pytree.tree_unflatten(means, spec),
            pytree.tree_unflatten(new_errors, spec))
