"""Carry data from the JAX package (or any host arrays) into the port.

The slices so far hold no model parameters: their state is the data —
values, fills, literals and matrices — made from a seed with numpy and
handed to both packages. :func:`from_jax_arrays` turns such a tree into
tensors on one device with every dtype kept, uint32 and bfloat16
included, so both packages compute from identical inputs.
"""
from __future__ import annotations

import torch.utils._pytree as pytree

from .core.memref import as_device_array

__all__ = ["from_jax_arrays"]


def from_jax_arrays(tree, device=None):
    """Every array leaf of ``tree`` (numpy arrays or any object with
    ``__array__``, such as a ``jax.Array``) as a tensor on ``device``,
    with its dtype kept. A bfloat16 array (numpy dtype named
    ``bfloat16``) goes through float32, which is exact. ``None`` leaves
    pass through. ``device`` defaults to the current CUDA device
    (:class:`LookupError` without one); pass ``"cpu"`` for the CPU."""
    def convert(leaf):
        if leaf is None:
            return None
        return as_device_array(leaf, device=device)

    return pytree.tree_map(convert, tree)
