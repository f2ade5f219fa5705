"""Shared model layers: norms, rotary embeddings, the MLPs, initializers —
the port of the JAX package's ``repro/models/layers.py``.

Pure functions over parameter trees that read like the JAX package's
dicts (``p["scale"]``): :class:`ParamTree` holds them as nested
``nn.Module``\\ s, so a served model's layers are modules of their own
on one device; training takes the same tensors as plain nested dicts
(:func:`plain_tree`). Initializers take an explicit ``torch.Generator``
and device and return plain dicts of tensors.
"""
from __future__ import annotations

import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ParamTree", "plain_tree", "init_norm", "apply_norm", "rope_freqs",
           "rope_tables", "m_rope_tables", "rotate", "apply_rope",
           "apply_m_rope", "sinusoidal_positions", "MLP_KINDS", "init_mlp",
           "apply_mlp", "init_embedding", "init_linear", "apply_linear",
           "normal"]


class ParamTree(nn.Module):
    """Parameters as nested modules that read like the JAX package's
    parameter dicts: ``tree["attn"]["wq"]``. Mappings become
    :class:`ParamTree`\\ s, lists ``nn.ModuleList``\\ s of them, tensors
    frozen ``nn.Parameter``\\ s: a served model takes no gradient. The
    training functions take :func:`plain_tree`'s dicts instead."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v) for v in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        if name in self._modules:
            return self._modules[name]
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def plain_tree(params):
    """The tensors of a :class:`ParamTree` (or of nested mappings and
    lists) as plain nested dicts and lists of detached tensors, storage
    shared. Dict keys are sorted, as JAX flattens a dict, so
    ``torch.utils._pytree`` flattens the tree in the JAX package's leaf
    order. This is the form the train state holds."""
    if isinstance(params, torch.Tensor):
        return params.detach()
    if isinstance(params, ParamTree):
        params = {**params._parameters, **params._modules}
    if isinstance(params, Mapping):
        return {k: plain_tree(params[k]) for k in sorted(params)}
    return [plain_tree(v) for v in params]


def normal(gen: torch.Generator, shape, std: float, dtype, device
           ) -> torch.Tensor:
    """Gaussian weights of standard deviation ``std``, drawn in f32 from
    ``gen`` on ``device`` and cast to ``dtype``."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


# ----------------------------------------------------------------------------
# normalization
# ----------------------------------------------------------------------------
def init_norm(d: int, kind: str, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in f32, cast back."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r}")
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ----------------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [B,S,1,d/2] f32 for positions [B,S] ints, made once and
    shared by every layer that rotates at these positions."""
    freqs = rope_freqs(head_dim, theta, positions.device)        # (d/2,)
    angles = positions[..., None].float() * freqs                 # [B,S,d/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def m_rope_tables(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE's (cos, sin) [B,S,1,d/2] (Qwen2-VL,
    arXiv:2409.12191) for ``positions3`` [3,B,S] — temporal, height and
    width position ids. The head dim's frequency pairs are split into
    ``sections``, each rotated by its own position stream."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {head_dim // 2}")
    freqs = rope_freqs(head_dim, theta, positions3.device)       # (d/2,)
    # section id of each frequency pair: [d/2] in {0, 1, 2}
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=positions3.device),
        torch.tensor(sections, device=positions3.device),
        output_size=head_dim // 2)
    pos = positions3.index_select(0, sec_ids)                     # [d/2,B,S]
    angles = pos.permute(1, 2, 0).float() * freqs                 # [B,S,d/2]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B,S,H,D]; positions: [B,S] ints. Half-split (NeoX) convention."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))


def apply_m_rope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                 sections: Tuple[int, int, int]) -> torch.Tensor:
    """x: [B,S,H,D]; positions3: [3,B,S] ints (:func:`m_rope_tables`)."""
    return rotate(x, *m_rope_tables(positions3, x.shape[-1], theta, sections))


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table [n, d], f32."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """x: [B,S,H,D] rotated by :func:`rope_tables`' ``cos``/``sin``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------------
MLP_KINDS = ("swiglu", "geglu", "gelu", "relu2")


def init_mlp(gen: torch.Generator, d: int, f: int, kind: str, dtype, device
             ) -> dict:
    """``w_gate``, ``w_up`` [d,f] and ``w_out`` [f,d] for the gated kinds
    (swiglu, geglu); ``w_up`` and ``w_out`` for gelu and relu2."""
    if kind not in MLP_KINDS:
        raise ValueError(f"unknown MLP {kind!r}; expected one of {MLP_KINDS}")
    p = {}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (d, f), 1.0 / math.sqrt(d), dtype, device)
    p["w_up"] = normal(gen, (d, f), 1.0 / math.sqrt(d), dtype, device)
    p["w_out"] = normal(gen, (f, d), 1.0 / math.sqrt(f), dtype, device)
    return p


def apply_mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP of ``kind``. gelu is the tanh approximation, which
    ``jax.nn.gelu`` computes by default; relu2 is the squared ReLU
    (Primer; Nemotron-4). ``x`` and the output are pinned to the residual
    stream's layout (``dist.api.stream``)."""
    from ..dist import api as dist_api
    x = dist_api.stream(x)
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif kind == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    elif kind == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:
        raise ValueError(f"unknown MLP {kind!r}; expected one of {MLP_KINDS}")
    h = dist_api.hint_named(h, "mlp_hidden")
    return dist_api.stream(h @ p["w_out"])


# ----------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype, device
                   ) -> torch.Tensor:
    return normal(gen, (vocab, d), 0.02, dtype, device)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
                bias: bool = False) -> dict:
    """``w`` [d_in, d_out] of standard deviation ``1 / sqrt(d_in)`` and,
    with ``bias``, a zero ``b`` [d_out]."""
    p = {"w": normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype,
                     device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w``, plus ``b`` where ``p`` has one."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
