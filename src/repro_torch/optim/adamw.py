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
from ..kernels import adamw as fused_adamw

__all__ = ["AdamWConfig", "init", "global_norm", "leaf_update", "update"]


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


def leaf_update(g, m, v, p, bc1, bc2, lr, cfg: AdamWConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf of the loop, the plain version of the kernel's update:
    ``(p', m', v')`` from the clipped gradient ``g``, with ``p'`` in
    ``p``'s dtype and ``m'``, ``v'`` in ``cfg.state_dtype``."""
    sdt = getattr(torch, cfg.state_dtype)
    b1, b2 = cfg.b1, cfg.b2
    gf = g.float()
    mf = m.float() * b1 + gf * (1 - b1)
    vf = v.float() * b2 + torch.square(gf) * (1 - b2)
    mhat = mf / bc1
    vhat = vf / bc2
    step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    new_p = p.float() - lr * step
    return new_p.to(p.dtype), mf.to(sdt), vf.to(sdt)


def update(grads, state, params, cfg: AdamWConfig,
           lr_scale: Union[torch.Tensor, float] = 1.0
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """→ ``(new_params, new_state, {"grad_norm"})``; ``grads``, ``state``
    and ``params`` are not written. Runs in an ``optim.adamw`` span, the
    global norm and clip in ``optim.norm``, the update of the leaves in
    ``optim.leaves``.

    Plain CUDA tensors go through the hand-written kernel
    (:mod:`repro_torch.kernels.adamw`: the norm in two launches, the
    update in one, whatever the number of leaves), which gives the loop's
    bits for the same clip scale; CPU, ``meta`` and ``DTensor`` leaves (a
    sharded step's norm needs DTensor's collectives) take the loop of
    :func:`leaf_update`. Counts ``optim.fused_leaves`` and
    ``optim.loop_leaves`` while recording."""
    with trace.span("optim.adamw"):
        count = state["count"] + 1
        g_leaves, spec = pytree.tree_flatten(grads)
        m_leaves, v_leaves, p_leaves = (pytree.tree_leaves(t) for t in (
            state["m"], state["v"], params))
        sdt = getattr(torch, cfg.state_dtype)
        fused = None
        if fused_adamw.takes(g_leaves + m_leaves + v_leaves + p_leaves):
            fused = fused_adamw.Leaves(g_leaves, m_leaves, v_leaves,
                                       p_leaves, sdt)
        trace.count("optim.fused_leaves", len(g_leaves) if fused else 0)
        trace.count("optim.loop_leaves", 0 if fused else len(g_leaves))
        with trace.span("optim.norm"):
            if fused:
                gnorm = torch.sqrt(torch.sum(fused.sums_of_squares()))
            else:
                gnorm = global_norm(g_leaves)
            scale = None
            if cfg.clip_norm is not None:
                scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9),
                                    max=1.0)
                if not fused:
                    g_leaves = [g * scale.to(g.dtype) for g in g_leaves]

        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(cfg.b1, c)
        bc2 = 1.0 - torch.pow(cfg.b2, c)
        lr = cfg.lr * lr_scale

        with trace.span("optim.leaves"):
            if fused:
                dev = gnorm.device
                if scale is None:
                    scale = torch.ones((), dtype=torch.float32, device=dev)
                lr_t = (lr.to(dev, torch.float32)
                        if isinstance(lr, torch.Tensor) else
                        torch.full((), lr, dtype=torch.float32, device=dev))
                out = fused.update(torch.stack([scale, bc1, bc2, lr_t]),
                                   b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                                   weight_decay=cfg.weight_decay)
            else:
                out = tuple(zip(*(
                    leaf_update(g, m, v, p, bc1, bc2, lr, cfg)
                    for g, m, v, p in zip(g_leaves, m_leaves, v_leaves,
                                          p_leaves))))
        new_params, new_m, new_v = (pytree.tree_unflatten(list(o), spec)
                                    for o in out)
        return new_params, {"m": new_m, "v": new_v, "count": count}, \
            {"grad_norm": gnorm}
