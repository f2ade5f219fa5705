"""Whisper-style encoder–decoder backbone (arXiv:2212.04356) — the port of
the JAX package's ``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in JAX: the inputs are precomputed
frame embeddings [B, n_frames, d_model]. The encoder is bidirectional
self-attention blocks over the frames with sinusoidal positions; the
decoder is causal self-attention plus cross-attention with learned
positions and a head tied to the token embedding. Each stack's layers are
modules of their own (``params["enc"]["layers"]``,
``params["dec"]["layers"]``), where JAX stacks them along a leading axis.
Decode carries a self-attention KV cache and each layer's cross K/V, made
once from the encoder's output; the cache keeps JAX's structure
``{"len", "self": {"k", "v"}, "cross": {"k", "v"}}`` with leaves
``[L, B, S, Hkv, Dh]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import attention as attn_mod
from .layers import (ParamTree, apply_mlp, apply_norm, init_embedding,
                     init_mlp, init_norm, sinusoidal_positions)
from .transformer import apply_remat, cross_entropy

__all__ = ["init_params", "encode", "forward", "loss_fn", "init_cache",
           "decode_step"]


def _init_enc_block(gen, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    return {"norm1": init_norm(d, cfg.norm, dtype, device),
            "attn": attn_mod.init_attention(gen, cfg, dtype, device),
            "norm2": init_norm(d, cfg.norm, dtype, device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp, dtype, device)}


def _init_dec_block(gen, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    return {"norm1": init_norm(d, cfg.norm, dtype, device),
            "self_attn": attn_mod.init_attention(gen, cfg, dtype, device),
            "norm_x": init_norm(d, cfg.norm, dtype, device),
            "cross_attn": attn_mod.init_attention(gen, cfg, dtype, device),
            "norm2": init_norm(d, cfg.norm, dtype, device),
            "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp, dtype, device)}


def init_params(gen: torch.Generator, cfg: ModelConfig,
                vocab: Optional[int] = None, max_dec_len: int = 448, *,
                device) -> ParamTree:
    """Random parameters drawn from ``gen`` on ``device``: ``enc``
    (``layers``, ``final_norm``) and ``dec`` (``embed``, ``pos_embed``
    [max_dec_len, d], ``layers``, ``final_norm``)."""
    dtype = getattr(torch, cfg.param_dtype)
    vocab = vocab or cfg.vocab_size
    d = cfg.d_model
    return ParamTree({
        "enc": {"layers": [_init_enc_block(gen, cfg, dtype, device)
                           for _ in range(cfg.encdec.n_enc_layers)],
                "final_norm": init_norm(d, cfg.norm, dtype, device)},
        "dec": {"embed": init_embedding(gen, vocab, d, dtype, device),
                "pos_embed": init_embedding(gen, max_dec_len, d, dtype,
                                            device),
                "layers": [_init_dec_block(gen, cfg, dtype, device)
                           for _ in range(cfg.n_layers)],
                "final_norm": init_norm(d, cfg.norm, dtype, device)},
    })


def _enc_block(block, cfg: ModelConfig, x: torch.Tensor, attn_impl: str
               ) -> torch.Tensor:
    from ..dist import api as dist_api
    block = dist_api.gather_weights(block)
    h = apply_norm(block["norm1"], x, cfg.norm)
    x = x + attn_mod.attention(block["attn"], cfg, h, None, causal=False,
                               impl=attn_impl)
    h = apply_norm(block["norm2"], x, cfg.norm)
    return x + apply_mlp(block["mlp"], h, cfg.mlp)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, *,
           attn_impl: str = "ref") -> torch.Tensor:
    """frames [B,T,D] (the stub frontend's output) → encoder states
    [B,T,D]."""
    t = frames.shape[1]
    x = frames.to(cfg.dtype())
    x = x + sinusoidal_positions(t, cfg.d_model, x.device).to(x.dtype)
    body = _enc_block
    if torch.is_grad_enabled():
        body = apply_remat(_enc_block, cfg.remat)
    for block in params["enc"]["layers"]:
        x = body(block, cfg, x, attn_impl)
    return apply_norm(params["enc"]["final_norm"], x, cfg.norm)


def _dec_block(block, cfg: ModelConfig, x: torch.Tensor,
               enc_out: torch.Tensor, attn_impl: str) -> torch.Tensor:
    from ..dist import api as dist_api
    block = dist_api.gather_weights(block)
    h = apply_norm(block["norm1"], x, cfg.norm)
    x = x + attn_mod.attention(block["self_attn"], cfg, h, None, causal=True,
                               impl=attn_impl)
    h = apply_norm(block["norm_x"], x, cfg.norm)
    kv = attn_mod.project_kv(block["cross_attn"], cfg, enc_out)
    x = x + attn_mod.attention(block["cross_attn"], cfg, h, None,
                               cross_kv=kv, impl=attn_impl)
    h = apply_norm(block["norm2"], x, cfg.norm)
    return x + apply_mlp(block["mlp"], h, cfg.mlp)


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's token embeddings [B,S,D], pinned to the residual
    stream's layout (a vocab-sharded table gives partial sums)."""
    from ..dist import api as dist_api
    return dist_api.stream(torch.nn.functional.embedding(
        tokens, params["dec"]["embed"]))


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["dec"]["final_norm"], x, cfg.norm)
    return x @ params["dec"]["embed"].T.to(x.dtype)       # tied head


def forward(params, cfg: ModelConfig, frames: torch.Tensor,
            tokens: torch.Tensor, *, attn_impl: str = "ref"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(frames [B,T,D], tokens [B,S]) → (logits [B,S,V], aux = 0)."""
    enc_out = encode(params, cfg, frames, attn_impl=attn_impl)
    s = tokens.shape[1]
    pos_embed = params["dec"]["pos_embed"]
    pos = torch.arange(s, device=tokens.device).clamp(
        max=pos_embed.shape[0] - 1)
    x = _embed(params, tokens) + pos_embed[pos]
    x = x.to(cfg.dtype())
    body = _dec_block
    if torch.is_grad_enabled():
        body = apply_remat(_dec_block, cfg.remat)
    for block in params["dec"]["layers"]:
        x = body(block, cfg, x, enc_out, attn_impl)
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32,
                                                device=x.device)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            attn_impl: str = "ref"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy of the decoder: ``(loss, {"ce",
    "aux"})``."""
    logits, aux = forward(params, cfg, batch["frames"], batch["tokens"],
                          attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"])
    return ce, {"ce": ce, "aux": aux}


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def init_cache(params, cfg: ModelConfig, frames: torch.Tensor, max_len: int,
               *, attn_impl: str = "ref") -> Dict[str, Any]:
    """Prefill: run the encoder once over ``frames`` [B,T,D] and make each
    decoder layer's cross K/V; the self-attention cache is zero."""
    enc_out = encode(params, cfg, frames, attn_impl=attn_impl)
    dtype = cfg.dtype()
    cross = [attn_mod.project_kv(block["cross_attn"], cfg, enc_out)
             for block in params["dec"]["layers"]]
    self_kv = attn_mod.init_kv_cache(cfg, frames.shape[0], max_len, dtype,
                                     cfg.n_layers, frames.device)
    return {"len": torch.zeros((), dtype=torch.int32, device=frames.device),
            "self": self_kv,
            "cross": {"k": torch.stack([k for k, _ in cross]).to(dtype),
                      "v": torch.stack([v for _, v in cross]).to(dtype)}}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [B,1] + cache → (logits [B,1,V], a new cache); ``cache`` is
    not written. The self K/V are copied once and each layer writes its
    row into its slice; the cross K/V are shared."""
    cache_len = cache["len"]
    pos_embed = params["dec"]["pos_embed"]
    pos = torch.clamp(cache_len, max=pos_embed.shape[0] - 1).reshape(1)
    x = _embed(params, tokens) + pos_embed.index_select(0, pos)
    x = x.to(cfg.dtype())
    k_all, v_all = cache["self"]["k"].clone(), cache["self"]["v"].clone()
    smax = k_all.shape[2]
    index = attn_mod.write_index(cache_len, smax)
    masked = attn_mod.decode_mask(cache_len, smax, None)
    cross = cache["cross"]
    for li, block in enumerate(params["dec"]["layers"]):
        h = apply_norm(block["norm1"], x, cfg.norm)
        x = x + attn_mod.decode_attention_into(
            block["self_attn"], cfg, h, k_all[li], v_all[li], index, masked,
            None)
        h = apply_norm(block["norm_x"], x, cfg.norm)
        x = x + attn_mod.attention(block["cross_attn"], cfg, h, None,
                                   cross_kv=(cross["k"][li],
                                             cross["v"][li]))
        h = apply_norm(block["norm2"], x, cfg.norm)
        x = x + apply_mlp(block["mlp"], h, cfg.mlp)
    return _logits(params, cfg, x), {"len": cache_len + 1,
                                     "self": {"k": k_all, "v": v_all},
                                     "cross": cross}
