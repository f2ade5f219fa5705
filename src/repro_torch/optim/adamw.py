"""AdamW with a dtype-configurable state and global-norm clipping — the
port of the JAX package's ``repro/optim/adamw.py``, as pure functions on
trees of tensors (``torch.utils._pytree``): nothing is updated in place.

The semantics are the JAX package's, which ``torch.optim.AdamW`` does not
share: the gradients are clipped by their global norm (``+ 1e-9``); the
bias correction takes ``count`` as f32; weight decay applies to every
leaf, norms included, and is added to the normalised step; the update is
computed in f32 and cast back to the parameter's dtype; ``m`` and ``v``
are kept in ``state_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.utils._pytree as pytree

from .. import trace

__all__ = ["AdamWConfig", "init", "global_norm", "update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"


def init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero ``m`` and ``v`` like ``params`` in ``cfg.state_dtype``, and
    ``count`` 0 (int32), on the parameters' device."""
    dt = getattr(torch, cfg.state_dtype)
    leaves = pytree.tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {
        "m": pytree.tree_map(zeros, params),
        "v": pytree.tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm of every leaf of ``tree`` together."""
    sums = [torch.sum(torch.square(x.float()))
            for x in pytree.tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def update(grads, state, params, cfg: AdamWConfig,
           lr_scale: Union[torch.Tensor, float] = 1.0
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """→ ``(new_params, new_state, {"grad_norm"})``; ``grads``, ``state``
    and ``params`` are not written. Runs in an ``optim.adamw`` span, the
    global norm and clip in ``optim.norm``, the loop over the leaves in
    ``optim.leaves``."""
    with trace.span("optim.adamw"):
        count = state["count"] + 1
        with trace.span("optim.norm"):
            gnorm = global_norm(grads)
            if cfg.clip_norm is not None:
                scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9),
                                    max=1.0)
                grads = pytree.tree_map(lambda g: g * scale.to(g.dtype),
                                        grads)

        b1, b2 = cfg.b1, cfg.b2
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, c)
        bc2 = 1.0 - torch.pow(b2, c)
        lr = cfg.lr * lr_scale
        sdt = getattr(torch, cfg.state_dtype)

        def upd(g, m, v, p):
            gf = g.float()
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + torch.square(gf) * (1 - b2)
            mhat = mf / bc1
            vhat = vf / bc2
            step = mhat / (torch.sqrt(vhat) + cfg.eps) + \
                cfg.weight_decay * p.float()
            new_p = p.float() - lr * step
            return new_p.to(p.dtype), mf.to(sdt), vf.to(sdt)

        g_leaves, spec = pytree.tree_flatten(grads)
        with trace.span("optim.leaves"):
            out = [upd(g, m, v, p) for g, m, v, p in zip(
                g_leaves, pytree.tree_leaves(state["m"]),
                pytree.tree_leaves(state["v"]), pytree.tree_leaves(params))]
        new_params, new_m, new_v = (
            pytree.tree_unflatten([o[i] for o in out], spec)
            for i in range(3))
        return new_params, {"m": new_m, "v": new_v, "count": count}, \
            {"grad_norm": gnorm}
