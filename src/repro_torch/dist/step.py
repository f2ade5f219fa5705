"""Serve step builder — the port of ``build_serve_step`` from the JAX
package's ``repro/dist/step.py``.

``jax.jit`` has no counterpart here: the step runs eagerly, one PyTorch
call per operation. It is pure, like the JAX step without donation: the
cache it is given is not written, so a failed step can be replayed on
the same cache. The train steps come with training (ROADMAP A10).
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["build_serve_step"]


def build_serve_step(model) -> Callable:
    """One greedy decode step: ``(params, cache, tokens[B,1]) →
    (next[B,1] int32, logits[B,1,V], cache)``. Ties go to the lowest
    token id, as in ``jnp.argmax``."""

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, tokens, cache)
        nxt = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step
