"""Top-k routed mixture-of-experts (GShard/Switch-style dense dispatch) —
the port of the JAX package's ``repro/models/moe.py``.

Routing becomes one-hot dispatch and combine einsums, as in JAX, so the
port routes token for token as the JAX package does: tokens are routed in
groups of at most ``group_size``, each expert takes at most C = ⌈k·g/E·cf⌉
tokens of a group (earlier tokens first, then lower choices), and a
dropped token passes through the residual. The auxiliary load-balancing
loss is Switch's (eq. 4). The experts' weights are stacked ``[E, d, f]``.
Where ``cfg.moe.shared_d_ff`` is set, a shared expert (an MLP of that
width, ``shared``) takes every token besides, and its output is added to
the routed experts'.

While recording (:mod:`repro_torch.trace`) a layer's routing, dispatch,
experts, combine and shared expert run in ``moe.*`` spans, and it counts
``moe.slots`` (the capacity slots it allocates, E·C a group) and
``moe.assigned`` (its top-k assignments) on the host, and ``moe.filled``
(the assignments kept) on the device, one add a layer;
``trace.counters()`` gives ``moe.dropped`` (those past capacity) as their
difference.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import trace
from ..configs.base import ModelConfig
from .layers import apply_mlp, init_mlp, normal

__all__ = ["init_moe", "route", "apply_moe"]

trace.difference("moe.dropped", "moe.assigned", "moe.filled")


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The f32 router ``[d, E]``, the experts' ``w_gate``, ``w_up``
    ``[E, d, f]`` and ``w_out`` ``[E, f, d]``, and with a shared expert its
    MLP, ``shared``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": normal(gen, (d, e), s_in, torch.float32, device),
        "w_gate": normal(gen, (e, d, f), s_in, dtype, device),
        "w_up": normal(gen, (e, d, f), s_in, dtype, device),
        "w_out": normal(gen, (e, f, d), s_out, dtype, device),
    }
    if cfg.moe.shared_d_ff:
        p["shared"] = init_mlp(gen, d, cfg.moe.shared_d_ff, cfg.mlp, dtype,
                               device)
    return p


def route(p, cfg: ModelConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [G,g,D] → (router probabilities [G,g,E] f32, the top-k weights
    renormalised to sum to 1 and the top-k expert indices, both [G,g,k],
    in descending order of probability)."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    return probs, topv / topv.sum(-1, keepdim=True), topi


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] → (y [B,S,D], aux loss f32 0-d). S must be a multiple of
    the routing group length ``min(group_size, S)``."""
    from ..dist import api as dist_api
    x = x_in = dist_api.stream(x)
    b_in, s_in, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    g = min(cfg.moe.group_size, s_in)
    if s_in % g:
        raise ValueError(f"sequence {s_in} is no multiple of the MoE routing "
                         f"group {g}")
    x = x.reshape(b_in * (s_in // g), g, d)
    b, s, _ = x.shape

    with trace.span("moe.route"):
        probs, topv, topi = route(p, cfg, x)                   # [B,S,k]
    capacity = max(int(math.ceil(k * s / e * cfg.moe.capacity_factor)), 1)

    with trace.span("moe.dispatch"):
        onehot = F.one_hot(topi, e).float()                    # [B,S,k,E]
        # position of each (token, choice) within its expert's queue (per
        # group); priority: earlier tokens first, then lower k
        flat = onehot.reshape(b, s * k, e)
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
        pos_idx = (pos * onehot).sum(-1).to(torch.int64)          # [B,S,k]
        keep = ((pos < capacity) & (onehot > 0)).any(-1)          # [B,S,k]

        # one-hot over the capacity slots; a position past the last slot
        # is all zeros, as jax.nn.one_hot gives it
        cap_onehot = (pos_idx[..., None] == torch.arange(
            capacity, device=x.device)).float()                   # [B,S,k,C]
        disp = torch.einsum("bske,bskc->bsec", onehot * keep[..., None],
                            cap_onehot)
        comb = torch.einsum("bske,bskc->bsec",
                            onehot * (topv * keep)[..., None], cap_onehot)
        if trace.enabled():
            trace.count("moe.slots", b * e * capacity)
            trace.count("moe.assigned", keep.numel())
            trace.count("moe.filled", keep.sum())

    # Switch aux loss: E · Σ_e fraction_tokens(e) · mean_prob(e). It comes
    # before the experts: under remat the backward recomputes the layer up
    # to the last tensor it saves, and the aux product saves two, so taken
    # last it would recompute the combine einsum, which XLA drops in JAX
    frac = onehot.sum(2).mean((0, 1))                               # [E]
    mean_prob = probs.mean((0, 1))                                  # [E]
    aux = e * (frac * mean_prob).sum() * cfg.moe.aux_loss_weight

    cd = x.dtype
    with trace.span("moe.experts"):
        expert_in = torch.einsum("bsec,bsd->becd", disp.to(cd), x)  # [B,E,C,D]
        if cfg.mlp in ("swiglu", "geglu"):
            gate = torch.einsum("becd,edf->becf", expert_in, p["w_gate"])
            gate = F.silu(gate) if cfg.mlp == "swiglu" else \
                F.gelu(gate, approximate="tanh")
            h = gate * torch.einsum("becd,edf->becf", expert_in, p["w_up"])
        else:
            h = F.gelu(torch.einsum("becd,edf->becf", expert_in,
                                    p["w_up"]), approximate="tanh")
        expert_out = torch.einsum("becf,efd->becd", dist_api.match_layout(h),
                                  p["w_out"])                       # [B,E,C,D]
    with trace.span("moe.combine"):
        y = torch.einsum("bsec,becd->bsd", comb.to(cd), expert_out)

    # pinned per routing group: the combine's layout may split a group
    y = dist_api.stream(y).reshape(b_in, s_in, d)
    if "shared" in p:
        with trace.span("moe.shared"):
            y = y + apply_mlp(p["shared"], x_in, cfg.mlp)
    return y, aux.float()
