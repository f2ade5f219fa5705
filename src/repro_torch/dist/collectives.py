"""The int8 wire codec of the JAX package's ``repro/dist/collectives.py``.

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

``compressed_psum`` and ``tree_psum_with_error_feedback`` come with
training, on ``torch.distributed`` (ROADMAP A10).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.memref import DeviceRef, as_device_array
from ..core.signature import to_torch_dtype

__all__ = ["quantize_ref", "dequantize_ref"]


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
