"""Decoder-only LM assembly, dense family — the port of the JAX package's
``repro/models/transformer.py`` for the forward pass (prefill).

The JAX package stacks each layer group's parameters along a leading
``count`` axis and runs the group as one ``jax.lax.scan``. PyTorch runs
eagerly, so here every layer is a module of its own (``params["layers"]``,
in execution order) and the forward pass is a Python loop over them.
The moe, ssm, hybrid, encdec and vlm families, the loss and the decode
path come later (ROADMAP A9, A10).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from .layers import (ParamTree, apply_mlp, apply_norm, init_embedding,
                     init_mlp, init_norm)

__all__ = ["check_family", "layer_groups", "init_params", "embed_inputs",
           "forward"]


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense decoder family; "
            f"{cfg.family!r} models are still to be ported (ROADMAP A10)")


def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """``(unit of block kinds, repeat count)`` per group, as in the JAX
    package; the dense family is one group of attention blocks."""
    check_family(cfg)
    return [(("attn",), cfg.n_layers)]


def _init_block(gen: torch.Generator, cfg: ModelConfig, dtype, device
                ) -> dict:
    return {"norm1": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "attn": attn_mod.init_attention(gen, cfg, dtype, device),
            "norm2": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                            device)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                vocab: Optional[int] = None, *, device) -> ParamTree:
    """Random parameters drawn from ``gen`` on ``device`` (the generator's
    device): ``embed``, ``layers`` (one module per layer), ``final_norm``
    and, without tied embeddings, ``head``."""
    dtype = getattr(torch, cfg.param_dtype)
    vocab = vocab or cfg.vocab_size
    layers = [_init_block(gen, cfg, dtype, device)
              for unit, count in layer_groups(cfg)
              for _ in range(count) for _kind in unit]
    params = {"embed": init_embedding(gen, vocab, cfg.d_model, dtype, device),
              "layers": layers,
              "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = init_embedding(gen, vocab, cfg.d_model, dtype,
                                        device).T.contiguous()
    return ParamTree(params)


def _apply_block(block, cfg: ModelConfig, x: torch.Tensor, positions,
                 attn_impl: str) -> torch.Tensor:
    h = apply_norm(block["norm1"], x, cfg.norm)
    x = x + attn_mod.attention(block["attn"], cfg, h, positions, causal=True,
                               window=None, impl=attn_impl)
    h = apply_norm(block["norm2"], x, cfg.norm)
    return x + apply_mlp(block["mlp"], h, cfg.mlp)


def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params["embed"][tokens].to(cfg.dtype())


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            attn_impl: str = "ref") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] → (logits [B,S,V], aux loss, 0 for the dense family)."""
    check_family(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed_inputs(params, cfg, tokens)
    for block in params["layers"]:
        x = _apply_block(block, cfg, x, positions, attn_impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ head.to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
