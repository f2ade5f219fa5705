"""Sharding-hint API — the port of the JAX package's ``repro/dist/api.py``.

The model code calls ``hint``/``hint_vocab``/``hint_named``
unconditionally. Outside a distribution context they are the identity;
inside one, a ``DTensor`` is redistributed to the pinned sharding, eager
PyTorch's counterpart of ``with_sharding_constraint``. A sharding is a
``(DeviceMesh, placements)`` pair (:func:`repro_torch.dist.sharding.
placements` gives a spec's placements). A plain tensor is never touched:
it lies whole on one device, so there is nothing to pin.

This indirection keeps the model free of mesh types: the layers never
import ``torch.distributed``, the launcher decides placement. Contexts are
thread-local, so concurrent actors (pipeline stages, engine workers) do
not leak pins into each other.

The layout helpers (``flatten``, ``unflatten``, ``unshard``,
``index_copy_``, ``match_layout``) stand in for the model's reshapes,
cache writes and reductions where GSPMD lays a sharded tensor out by
itself and eager DTensor refuses or gets the layout wrong. On a plain
tensor each is the plain operation.
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Dict, Optional

__all__ = [
    "activation_sharding", "vocab_sharding", "spec_map",
    "hint", "hint_vocab", "hint_named", "flatten", "unflatten",
    "unshard", "index_copy_", "match_layout",
]

_state = threading.local()


def _get(name: str):
    return getattr(_state, name, None)


@contextlib.contextmanager
def activation_sharding(sharding):
    """Pin the residual stream ([B, S, D]) to ``sharding`` within scope."""
    prev = _get("act")
    _state.act = sharding
    try:
        yield
    finally:
        _state.act = prev


@contextlib.contextmanager
def vocab_sharding(sharding):
    """Pin vocab-dim tensors ([B, S, V]) to ``sharding`` within scope."""
    prev = _get("vocab")
    _state.vocab = sharding
    try:
        yield
    finally:
        _state.vocab = prev


@contextlib.contextmanager
def spec_map(mapping: Optional[Dict[str, Any]]):
    """Named-site pins (Megatron-style TP output pins). ``mapping`` maps
    hint-site names (``attn_q``, ``attn_kv``, ``mlp_hidden``) to
    shardings; ``None`` disables all named hints."""
    prev = _get("specmap")
    _state.specmap = mapping
    try:
        yield
    finally:
        _state.specmap = prev


def _constrain(x, sharding):
    if sharding is None:
        return x
    # imported here: torch.distributed.tensor takes about a second to
    # import, and only a pinned context needs it
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, placements = sharding
    return x.redistribute(mesh, placements)


def hint(x):
    """Pin a residual-stream activation (identity outside a context)."""
    return _constrain(x, _get("act"))


def hint_vocab(x):
    """Pin a vocab-dim tensor (identity outside a context)."""
    return _constrain(x, _get("vocab"))


def hint_named(x, name: str):
    """Pin a named hint site, if the active spec map pins it."""
    mapping = _get("specmap")
    if not mapping:
        return x
    return _constrain(x, mapping.get(name))


def unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``. A ``DTensor`` whose ``dim`` is split
    over a number of shards that the first of ``sizes`` other than 1 is
    no multiple of is first replicated on those mesh dims: GSPMD lays
    such a reshape out by itself, DTensor refuses to unflatten a dim
    unevenly. A plain tensor is only unflattened."""
    # a DTensor exists only once torch.distributed.tensor is imported
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(x, dtensor.DTensor):
        d = dim % x.ndim
        ways = [i for i, p in enumerate(x.placements)
                if isinstance(p, dtensor.Shard) and p.dim == d]
        lead = next((n for n in sizes if n != 1), 1)
        if lead % math.prod(x.device_mesh.size(i) for i in ways):
            places = [dtensor.Replicate() if i in ways else p
                      for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, places)
    return x.unflatten(dim, sizes)


def flatten(x, start_dim: int, end_dim: int):
    """``x.flatten(start_dim, end_dim)``. A ``DTensor`` result that takes
    part in a gradient is pinned to its own layout (a no-op forward), so
    its gradient comes back in that layout and the flatten's backward, an
    unflatten, is one DTensor can take: a gradient sharded 16 ways on 16
    heads does not unflatten into 8 KV heads × 2. A plain tensor is only
    flattened."""
    y = x.flatten(start_dim, end_dim)
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(y, dtensor.DTensor) and \
            y.requires_grad:
        y = y.redistribute(y.device_mesh, y.placements)
    return y


def unshard(x, dim: int):
    """``x`` with ``dim`` whole on every device: a ``DTensor`` split along
    ``dim`` is replicated on those mesh dims (an all-gather), so a
    reduction over ``dim`` (the serve step's argmax over the vocabulary)
    runs on whole rows; DTensor's own split argmax fails at batch 1. A
    plain tensor is returned as it is."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return x
    d = dim % x.ndim
    places = [dtensor.Replicate() if isinstance(p, dtensor.Shard) and
              p.dim == d else p for p in x.placements]
    return x.redistribute(x.device_mesh, places)


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)`` for one index (``index`` [1]).
    DTensor's in-place ``index_copy_`` on a ``dst`` sharded along ``dim``
    (a decode cache sharded on its sequence dim) rewrites ``dst``'s
    placements and leaves its local shard as it was, so its shape no
    longer fits them. Such a ``dst`` takes the row by a select over the
    slots that keeps its layout, as GSPMD's ``dynamic_update_slice``
    writes into a sharded cache; a plain tensor is written in place."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is not None and isinstance(dst, dtensor.DTensor) and any(
            isinstance(p, dtensor.Shard) and p.dim == dim % dst.ndim and
            dst.device_mesh.size(i) > 1 for i, p in enumerate(dst.placements)):
        import torch
        slots = torch.arange(dst.shape[dim], device=index.device) == index
        shape = [1] * dst.ndim
        shape[dim] = -1
        return dst.copy_(torch.where(slots.reshape(shape), src.to(dst.dtype),
                                     dst))
    return dst.index_copy_(dim, index, src)


def match_layout(x):
    """``x``, or for a ``DTensor`` whose recorded strides order its dims
    otherwise than its local shard's do, the same shard rewrapped with
    strides in the shard's order; nothing is copied. DTensor records the
    strides its sharding propagation predicts from an op's inputs, but an
    input it has to redistribute first (a ``Partial`` one) comes out of
    the collective contiguous, and a later ``view`` that the recorded
    strides allow then fails on the shard. A plain tensor is returned as
    it is."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    if dtensor is None or not isinstance(x, dtensor.DTensor):
        return x
    local = x.to_local()

    def order(strides):
        return [d for d in sorted(range(x.ndim), key=lambda d: (-strides[d], d))
                if x.shape[d] > 1]

    if order(x.stride()) == order(local.stride()):
        return x
    stride, acc = [0] * x.ndim, 1
    for d in sorted(range(x.ndim), key=lambda d: (local.stride(d), -d)):
        stride[d] = acc
        acc *= x.shape[d]
    return dtensor.DTensor.from_local(local, x.device_mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=tuple(stride))
