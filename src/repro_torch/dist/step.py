"""Train / serve step builders — the port of the JAX package's
``repro/dist/step.py``.

``jax.jit`` has no counterpart here: the steps run eagerly, one PyTorch
call per operation. Both are pure, like the JAX steps without donation:
the train step returns a new state and never writes the one it was
given, and the serve step leaves its cache as it was, so a failed step
can be replayed on the same input (:class:`~repro_torch.dist.fault.
RecoverableTrainer` relies on it).

The train state is the JAX package's pytree ``{"params", "opt": {"m",
"v", "count"}, "step"}`` of plain tensors: the parameters as
:func:`~repro_torch.models.layers.plain_tree`'s nested dicts, never a
frozen ``ParamTree``. Gradients come from ``torch.autograd.grad`` over
detached copies of the parameter leaves that require grad; nothing
accumulates in ``.grad``. Gradient accumulation loops over microbatches
with ``accum_dtype`` sums, as the JAX ``lax.scan`` does. ``grad_shardings``
pins ``DTensor`` gradients to their placements before the optimizer, as
the JAX step constrains its gradients.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree

from .. import trace
from ..core.memref import as_device_array
from ..models.layers import plain_tree
from ..optim import adamw
from . import api as dist_api

__all__ = ["init_train_state", "loss_and_grads", "build_train_step",
           "build_serve_step"]


def init_train_state(model, seed: int, ocfg) -> Dict[str, Any]:
    """→ ``{"params", "opt", "step"}`` — the canonical train-state pytree,
    on the model's device, parameters from ``model.init(seed)``."""
    params = plain_tree(model.init(seed))
    return {
        "params": params,
        "opt": adamw.init(params, ocfg),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def _split_microbatches(batch: Dict[str, Any], accum: int) -> Dict[str, Any]:
    """``[B, ...] → [A, B/A, ...]``; ``positions`` [3,B,S] → [A,3,B/A,S]."""
    out = {}
    for k, v in batch.items():
        if k == "positions":
            three, b, s = v.shape
            out[k] = v.reshape(three, accum, b // accum, s).movedim(1, 0)
        else:
            b = v.shape[0]
            out[k] = v.reshape((accum, b // accum) + tuple(v.shape[1:]))
    return out


def _value_and_grad(model, params, batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    leaves, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        with trace.span("train.forward"):
            loss, parts = model.loss(pytree.tree_unflatten(leaves, spec),
                                     batch)
        with trace.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, pytree.tree_unflatten(grads, spec)


def loss_and_grads(model, params, batch: Dict[str, Any], *,
                   grad_accum: int = 1, accum_dtype: str = "float32",
                   presplit: bool = False):
    """``(loss f32, parts, grads)`` of ``model.loss`` at ``params`` (a
    plain tree) on ``batch``. With ``grad_accum > 1`` the batch is split
    into that many microbatches (``presplit``: it comes as ``[A, B/A,
    ...]`` already) and the gradients are summed in ``accum_dtype``, each
    divided by ``grad_accum``; the loss and the parts are their means."""
    batch = {k: as_device_array(v, device=model.device)
             for k, v in batch.items()}
    if grad_accum <= 1:
        loss, parts, grads = _value_and_grad(model, params, batch)
        return loss.float(), parts, grads
    adt = getattr(torch, accum_dtype)
    mbs = batch if presplit else _split_microbatches(batch, grad_accum)
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    # laid out as the parameters (a sharded one's accumulator is sharded)
    grads = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=adt), params)
    parts_sum = None
    for i in range(grad_accum):
        mb = {k: v[i] for k, v in mbs.items()}
        l, parts, g = _value_and_grad(model, params, mb)
        grads = pytree.tree_map(lambda a, b: a + b.to(adt) / grad_accum,
                                grads, g)
        loss = loss + l.float() / grad_accum
        parts_sum = parts if parts_sum is None else \
            {k: parts_sum[k] + v for k, v in parts.items()}
    return loss, {k: v / grad_accum for k, v in parts_sum.items()}, grads


def _pin(grad: torch.Tensor, placements) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if not isinstance(grad, DTensor):
        return grad
    return grad.redistribute(grad.device_mesh, placements)


def build_train_step(model, ocfg, *, grad_accum: int = 1,
                     lr_schedule: Optional[Callable] = None,
                     accum_dtype: str = "float32",
                     presplit: bool = False,
                     grad_shardings=None) -> Callable:
    """One optimizer step, ``(state, batch) → (new state, metrics)``: loss
    and gradients (accumulated over ``grad_accum`` microbatches), global
    norm clip, AdamW update. ``metrics`` holds 0-d device tensors:
    ``loss``, ``ce``, ``aux`` and ``grad_norm``. ``batch`` may hold host
    arrays; it goes to the model's device.

    ``grad_shardings``, a tree of DTensor placements matching the
    parameters (``dist.sharding.placements`` of each spec), redistributes
    each ``DTensor`` gradient to its placements before the optimizer; a
    plain tensor is left as it is."""

    def train_step(state, batch):
        with trace.request("train.step"):
            params, opt, step = state["params"], state["opt"], state["step"]
            loss, parts, grads = loss_and_grads(
                model, params, batch, grad_accum=grad_accum,
                accum_dtype=accum_dtype, presplit=presplit)
            if grad_shardings is not None:
                grads = pytree.tree_map(_pin, grads, grad_shardings)
            lr_scale = lr_schedule(step) if lr_schedule is not None else 1.0
            with torch.no_grad():
                new_params, new_opt, opt_metrics = adamw.update(
                    grads, opt, params, ocfg, lr_scale)
            metrics = {"loss": loss, **parts, **opt_metrics}
            return {"params": new_params, "opt": new_opt,
                    "step": step + 1}, metrics

    return train_step


def build_serve_step(model) -> Callable:
    """One greedy decode step: ``(params, cache, tokens[B,1]) →
    (next[B,1] int32, logits[B,1,V], cache)``. Ties go to the lowest
    token id, as in ``jnp.argmax``."""

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, tokens, cache)
        last = dist_api.unshard(logits[:, -1:, :], -1)
        nxt = torch.argmax(last, dim=-1).to(torch.int32)
        return nxt, logits, cache

    return serve_step
