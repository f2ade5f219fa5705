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
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional

__all__ = [
    "activation_sharding", "vocab_sharding", "spec_map",
    "hint", "hint_vocab", "hint_named",
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
