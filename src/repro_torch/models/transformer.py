"""Decoder-only LM assembly, dense family — the port of the JAX package's
``repro/models/transformer.py``: the forward pass (prefill and training),
the loss, and the cache-carrying decode step.

The JAX package stacks each layer group's parameters along a leading
``count`` axis and runs the group as one ``jax.lax.scan``. PyTorch runs
eagerly, so here every layer is a module of its own (``params["layers"]``,
in execution order) and the forward pass is a Python loop over them.

The decode cache keeps the JAX package's structure, ``{"len": int32 0-d,
"groups": [[{"k", "v"}]]}`` with leaves stacked ``[count, B, S, Hkv,
Dh]`` per group, so caches convert between the packages leaf for leaf
(``convert.cache_from_jax``). :func:`decode_step` is pure: it returns a
new cache and never writes the one it was given.

While grad is enabled, each layer runs under the remat policy of
``cfg.remat`` (:func:`apply_remat`), as each scan body does in JAX.

The moe, ssm, hybrid, encdec and vlm families come later (ROADMAP A10);
their unit kinds raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from . import attention as attn_mod
from .layers import (ParamTree, apply_mlp, apply_norm, init_embedding,
                     init_mlp, init_norm)

__all__ = ["check_family", "REMAT_POLICIES", "apply_remat", "layer_groups",
           "init_params", "embed_inputs", "forward", "loss_fn",
           "cross_entropy", "init_cache", "decode_step"]

REMAT_POLICIES = ("none", "full", "dots")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense decoder family; "
            f"{cfg.family!r} models are still to be ported (ROADMAP A10)")


# the products whose outputs the "dots" policy keeps: ``x @ W`` folds its
# batch axes into ``mm``, the attention einsums run as ``bmm``
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_remat(body: Callable, remat: str) -> Callable:
    """Remat policy for one layer, as ``apply_remat`` gives the JAX scan
    body:

    * ``none`` — no remat: everything the backward needs is saved.
    * ``full`` — recompute the layer in the backward
      (``jax.checkpoint``).
    * ``dots`` — save the matrix products' outputs and recompute the rest
      (``dots_saveable``), by selective checkpointing.
    """
    if remat == "none":
        return body
    if remat == "full":
        return functools.partial(checkpoint, body, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, body, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat={remat!r}; the port has {REMAT_POLICIES}")


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
    block_fn = _apply_block
    if torch.is_grad_enabled():
        block_fn = apply_remat(_apply_block, cfg.remat)
    for block in params["layers"]:
        x = block_fn(block, cfg, x, positions, attn_impl)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ head.to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            attn_impl: str = "ref"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy (+ the aux loss, 0 for the dense
    family): ``(loss, {"ce", "aux"})``, all f32 0-d tensors."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean of ``logsumexp`` minus the label logit, in f32. A gather picks
    the label logit, the value JAX's one-hot select sums to."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    label_logit = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - label_logit).mean()


# ----------------------------------------------------------------------------
# decode (one token, cache-carrying)
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device
               ) -> Dict[str, Any]:
    """A zero cache for ``batch`` sequences of up to ``max_len`` tokens on
    ``device`` (``"meta"`` for shapes only)."""
    dtype = cfg.dtype()
    groups = []
    for unit, count in layer_groups(cfg):
        unit_caches = []
        for kind in unit:
            if kind != "attn":
                raise NotImplementedError(
                    f"{kind!r} decode units come with their model family "
                    "(ROADMAP A10)")
            unit_caches.append(attn_mod.init_kv_cache(
                cfg, batch, max_len, dtype, count, device))
        groups.append(unit_caches)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "groups": groups}


def _decode_block(block, cfg: ModelConfig, x: torch.Tensor, k, v, index,
                  masked, rope):
    h = apply_norm(block["norm1"], x, cfg.norm)
    x = x + attn_mod.decode_attention_into(block["attn"], cfg, h, k, v,
                                           index, masked, rope)
    h = apply_norm(block["norm2"], x, cfg.norm)
    return x + apply_mlp(block["mlp"], h, cfg.mlp)


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any], *,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [B,1] + cache → (logits [B,1,V], a new cache). Each group's
    stacked K and V are copied once, and every layer writes its row into
    its slice of the copy; ``cache`` itself is left as it was. The write
    index, the validity mask and the RoPE tables are made once a step."""
    b = tokens.shape[0]
    cache_len = cache["len"]
    if positions is None:
        positions = cache_len.reshape(1, 1).expand(b, 1)
    smax = cache["groups"][0][0]["k"].shape[2]
    index = attn_mod.write_index(cache_len, smax)
    masked = attn_mod.decode_mask(cache_len, smax, None)
    rope = attn_mod.decode_rope(cfg, positions)
    x = embed_inputs(params, cfg, tokens)
    layers = iter(params["layers"])
    new_groups = []
    for gi, (unit, count) in enumerate(layer_groups(cfg)):
        for kind in unit:
            if kind != "attn":
                raise NotImplementedError(
                    f"{kind!r} decode units come with their model family "
                    "(ROADMAP A10)")
        new = [{"k": c["k"].clone(), "v": c["v"].clone()}
               for c in cache["groups"][gi]]
        for ci in range(count):
            for unit_cache in new:
                x = _decode_block(next(layers), cfg, x, unit_cache["k"][ci],
                                  unit_cache["v"][ci], index, masked, rope)
        new_groups.append(new)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ head.to(x.dtype)
    return logits, {"len": cache_len + 1, "groups": new_groups}
