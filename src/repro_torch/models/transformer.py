"""Decoder-only LM assembly — the port of the JAX package's
``repro/models/transformer.py``: the forward pass (prefill and training),
the loss, and the cache-carrying decode step, for the dense, moe, ssm,
hybrid and vlm families (encdec is ``models/encdec.py``).

A model is a list of *groups*, each a repeating *unit* of block kinds
(``("attn",)`` for dense, moe and vlm, ``("ssm",)`` for mamba2,
``("rec", "rec", "attn")`` for RecurrentGemma's 1:2 hybrid pattern,
granite-4.0-h's nine ``"ssm"`` and one global ``"attn"``, with a shorter
remainder group where the layers do not fill whole units). Every block
but the ssm family's follows its mixer with ``norm2`` and an FFN: the
experts wherever the config has them, else the MLP. The
JAX package stacks each group's parameters along a leading ``count`` axis
and runs the group as one ``jax.lax.scan``. PyTorch runs eagerly, so here
every layer is a module of its own (``params["layers"]``, in execution
order, :func:`layer_kinds`) and the forward pass is a Python loop over
them.

The decode cache keeps the JAX package's structure, ``{"len": int32 0-d,
"groups": [[leaves of each unit block]]}`` with leaves stacked ``[count,
B, ...]`` per group (attention ``{"k", "v"}``, ssm and rec ``{"state",
"conv"}``), so caches convert between the packages leaf for leaf
(``convert.cache_from_jax``). :func:`decode_step` is pure: it returns a
new cache and never writes the one it was given.

While grad is enabled, each layer runs under the remat policy of
``cfg.remat`` (:func:`apply_remat`), as each scan body does in JAX.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import trace
from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import (ParamTree, apply_mlp, apply_norm, init_embedding,
                     init_mlp, init_norm)

__all__ = ["REMAT_POLICIES", "apply_remat", "layer_groups", "layer_kinds",
           "unit_starts", "init_params", "embed_inputs", "default_positions",
           "apply_layers", "forward", "loss_fn", "cross_entropy",
           "init_cache", "decode_step"]

REMAT_POLICIES = ("none", "full", "dots")


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
        options = {}
    elif remat == "dots":
        options = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    else:
        raise ValueError(f"remat={remat!r}; the port has {REMAT_POLICIES}")

    def remat_body(*args):
        return checkpoint(_spanned_recompute(body), *args,
                          use_reentrant=False, **options)

    return remat_body


def _spanned_recompute(body: Callable) -> Callable:
    """``body`` as ``checkpoint`` calls it: first in the forward, inside
    the caller's open ``layer`` span, then again in the backward, where
    the recompute gets a ``layer`` span of its own (``recompute`` 1) under
    the span then open on the forward's thread (``train.backward``),
    though the autograd engine may run it on another thread."""
    outer = trace.current()
    if outer is None or outer.name != "layer":
        return body
    forward_thread = trace.here()
    attrs = dict(outer.attrs, recompute=1)
    calls = 0

    def run(*args):
        nonlocal calls
        calls += 1
        if calls == 1:
            return body(*args)
        with trace.span_within(forward_thread, "layer", **attrs):
            return body(*args)

    return run


def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """``(unit of block kinds, repeat count)`` per group, as in the JAX
    package; an unknown family raises ``ValueError``."""
    if cfg.family in ("dense", "moe", "vlm"):
        return [(("attn",), cfg.n_layers)]
    if cfg.family == "ssm":
        return [(("ssm",), cfg.n_layers)]
    if cfg.family == "hybrid":
        pat = tuple(cfg.hybrid.pattern)
        full, rem = divmod(cfg.n_layers, len(pat))
        groups: List[Tuple[Tuple[str, ...], int]] = [(pat, full)]
        if rem:
            groups.append((pat[:rem], 1))
        return groups
    raise ValueError(f"{cfg.name}: no decoder-only family {cfg.family!r}")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The block kind of each entry of ``params["layers"]``, in execution
    order: group by group, unit by unit."""
    return [kind for unit, count in layer_groups(cfg)
            for _ in range(count) for kind in unit]


def unit_starts(cfg: ModelConfig) -> List[bool]:
    """Whether each entry of ``params["layers"]`` begins a unit: where the
    JAX package's scan body pins the residual stream (``dist.api.stream``)."""
    return [i == 0 for unit, count in layer_groups(cfg)
            for _ in range(count) for i in range(len(unit))]


def _init_ffn(gen: torch.Generator, cfg: ModelConfig, dtype, device
              ) -> dict:
    """A block's FFN after ``norm2``: the experts wherever the config has
    them, else the MLP."""
    if cfg.moe.n_experts:
        return {"moe": moe_mod.init_moe(gen, cfg, dtype, device)}
    return {"mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                            device)}


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype,
                device) -> dict:
    """``norm1`` and the mixer of ``kind``, then ``norm2`` and the FFN in
    every block but the ssm family's, whose blocks are the mixer alone."""
    d = cfg.d_model
    if kind == "attn":
        mixer = {"attn": attn_mod.init_attention(gen, cfg, dtype, device)}
    elif kind == "ssm":
        mixer = {"ssm": ssm_mod.init_ssm(gen, cfg, dtype, device)}
    elif kind == "rec":
        mixer = {"rec": rglru_mod.init_rglru(gen, cfg, dtype, device)}
    else:
        raise ValueError(kind)
    p = {"norm1": init_norm(d, cfg.norm, dtype, device), **mixer}
    if cfg.family != "ssm":
        p["norm2"] = init_norm(d, cfg.norm, dtype, device)
        p.update(_init_ffn(gen, cfg, dtype, device))
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig,
                vocab: Optional[int] = None, *, device) -> ParamTree:
    """Random parameters drawn from ``gen`` on ``device`` (the generator's
    device): ``embed``, ``layers`` (one module per layer, in
    :func:`layer_kinds`' order), ``final_norm`` and, without tied
    embeddings, ``head``."""
    dtype = getattr(torch, cfg.param_dtype)
    vocab = vocab or cfg.vocab_size
    layers = [_init_block(gen, cfg, kind, dtype, device)
              for kind in layer_kinds(cfg)]
    params = {"embed": init_embedding(gen, vocab, cfg.d_model, dtype, device),
              "layers": layers,
              "final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = init_embedding(gen, vocab, cfg.d_model, dtype,
                                        device).T.contiguous()
    return ParamTree(params)


def _residual(cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """``x + m·y``, m the residual multiplier; one add either way."""
    m = cfg.residual_multiplier
    return x + y if m == 1.0 else torch.add(x, y, alpha=m)


def _ffn(block, cfg: ModelConfig, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's experts or MLP over ``h``: (y, the aux loss or None)."""
    if "moe" in block:
        return moe_mod.apply_moe(block["moe"], cfg, h)
    return apply_mlp(block["mlp"], h, cfg.mlp), None


def _apply_block(block, cfg: ModelConfig, kind: str, x: torch.Tensor,
                 positions, attn_impl: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer: ``(x, the MoE aux loss of the layer or None)``. Its
    FSDP-sharded weights are gathered here, inside the remat boundary, so
    a recompute gathers them again and the step never holds them all."""
    from ..dist import api as dist_api
    block = dist_api.gather_weights(block)
    h = apply_norm(block["norm1"], x, cfg.norm, cfg.norm_eps)
    if kind == "attn":
        window = cfg.hybrid.window if cfg.family == "hybrid" else None
        y = attn_mod.attention(block["attn"], cfg, h, positions, causal=True,
                               window=window, impl=attn_impl)
    elif kind == "ssm":
        y = ssm_mod.apply_ssm(block["ssm"], cfg, h)
    elif kind == "rec":
        y = rglru_mod.apply_rglru(block["rec"], cfg, h)
    else:
        raise ValueError(kind)
    x = _residual(cfg, x, y)
    if "norm2" not in block:
        return x, None
    y, aux = _ffn(block, cfg, apply_norm(block["norm2"], x, cfg.norm,
                                         cfg.norm_eps))
    return _residual(cfg, x, y), aux


def embed_inputs(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Token embeddings [B,S,D] in the compute dtype, times the embedding
    multiplier; ``vision_embeds`` [B,P,D] (the vlm family's stub frontend)
    replace the first P."""
    from ..dist import api as dist_api
    x = dist_api.stream(F.embedding(tokens,
                                  dist_api.gather_weights(params["embed"])))
    if vision_embeds is not None:
        n = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, n:, :]], dim=1)
    x = x.to(cfg.dtype())
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def default_positions(cfg: ModelConfig, start: torch.Tensor, b: int, s: int
                      ) -> torch.Tensor:
    """Positions ``start .. start + s - 1`` of ``b`` sequences: [B,S], or
    [3,B,S] (all three streams alike) under M-RoPE."""
    base = (start + torch.arange(s, device=start.device)).expand(b, s)
    return base.expand(3, b, s) if cfg.m_rope else base


def apply_layers(layers, cfg: ModelConfig, x: torch.Tensor, positions,
                 attn_impl: str, block_fn: Callable = _apply_block
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``layers``, ``(block params, kind, unit start)`` triples in
    execution order, over the residual stream ``x`` → (x, the MoE layers'
    aux loss summed, f32 0-d). The stream is pinned at each unit's start
    (``dist.api.stream``, the identity on a plain tensor), where
    the JAX package's scan body pins it. Each layer runs in a ``layer``
    span (``index`` in ``layers``, ``kind``, ``recompute`` 0)."""
    from ..dist import api as dist_api
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    on = trace.enabled()
    for index, (block, kind, start) in enumerate(layers):
        if start:
            x = dist_api.stream(x)
        with (trace.span("layer", index=index, kind=kind, recompute=0)
              if on else trace.NOOP):
            x, a = block_fn(block, cfg, kind, x, positions, attn_impl)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            vision_embeds: Optional[torch.Tensor] = None,
            attn_impl: str = "ref") -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] → (logits [B,S,V], aux loss f32 0-d: the MoE layers'
    sum, else 0)."""
    b, s = tokens.shape
    if positions is None:
        positions = default_positions(
            cfg, torch.zeros((), dtype=torch.int64, device=tokens.device),
            b, s)
    x = embed_inputs(params, cfg, tokens, vision_embeds)
    block_fn = _apply_block
    if torch.is_grad_enabled():
        block_fn = apply_remat(_apply_block, cfg.remat)
    x, aux = apply_layers(zip(params["layers"], layer_kinds(cfg),
                              unit_starts(cfg)),
                          cfg, x, positions, attn_impl, block_fn)
    return _logits(params, cfg, x), aux


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head (the tied embedding's transpose
    without a ``head``) over the stream ``x``; the logit divisor divides
    the normed rows before the head, which gives the same product."""
    from ..dist import api as dist_api
    top = dist_api.gather_weights(
        {k: params[k] for k in ("embed", "head", "final_norm") if k in params})
    x = apply_norm(top["final_norm"], x, cfg.norm, cfg.norm_eps)
    if cfg.logits_scaling != 1.0:
        x = x / cfg.logits_scaling
    head = top["embed"].T if cfg.tie_embeddings else top["head"]
    return x @ head.to(x.dtype)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            attn_impl: str = "ref"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy + the MoE aux loss: ``(loss, {"ce",
    "aux"})``, all f32 0-d tensors."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          vision_embeds=batch.get("vision_embeds"),
                          attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean of ``logsumexp`` minus the label logit, in f32. The label
    logit is JAX's one-hot select: a sum over the vocabulary of the logits
    where the label is and zeros elsewhere, exactly the logit a gather
    picks. The f32 logits, the one-hot mask and the select are pinned to
    the vocab sharding (``dist.api.hint_vocab``), as JAX pins them, so a
    vocab-sharded ``DTensor`` never replicates V (a gather along a sharded
    vocab dim is a case DTensor's sharding propagation cannot take), and
    ``logsumexp`` reduces the local shards (``dist.api.logsumexp``)."""
    from ..dist import api as dist_api
    lf = dist_api.hint_vocab(logits.float())
    lse = dist_api.logsumexp(lf, -1)
    vocab_iota = torch.arange(lf.shape[-1], device=labels.device)
    onehot = dist_api.hint_vocab(labels.long()[..., None] == vocab_iota)
    label_logit = dist_api.hint_vocab(
        torch.where(onehot, lf, 0.0)).sum(-1)
    # pinned per token, so the mean's gradient does not re-lay the logits
    return dist_api.stream(lse - label_logit).mean()


# ----------------------------------------------------------------------------
# decode (one token, cache-carrying)
# ----------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device
               ) -> Dict[str, Any]:
    """A zero cache for ``batch`` sequences of up to ``max_len`` tokens on
    ``device`` (``"meta"`` for shapes only). The hybrid family's local
    attention keeps a ring of ``min(max_len, window)`` slots; its global
    attention (no window) keeps ``max_len``."""
    dtype = cfg.dtype()
    groups = []
    for unit, count in layer_groups(cfg):
        unit_caches = []
        for kind in unit:
            if kind == "attn":
                window = cfg.hybrid.window if cfg.family == "hybrid" \
                    else None
                slots = max_len if window is None else min(max_len, window)
                unit_caches.append(attn_mod.init_kv_cache(
                    cfg, batch, slots, dtype, count, device))
            elif kind == "ssm":
                unit_caches.append(ssm_mod.init_ssm_cache(
                    cfg, batch, dtype, count, device))
            elif kind == "rec":
                unit_caches.append(rglru_mod.init_rglru_cache(
                    cfg, batch, dtype, count, device))
        groups.append(unit_caches)
    return {"len": torch.zeros((), dtype=torch.int32, device=device),
            "groups": groups}


def _decode_block(block, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  cache: Dict[str, torch.Tensor], ci: int, attn
                  ) -> torch.Tensor:
    """One layer of a decode step. ``cache`` holds the group's stacked
    leaves, copies that this layer writes its slice ``ci`` of; ``attn`` is
    the step's (write index, validity mask, RoPE tables)."""
    from ..dist import api as dist_api
    block = dist_api.gather_weights(block)
    h = apply_norm(block["norm1"], x, cfg.norm, cfg.norm_eps)
    if kind == "attn":
        y = attn_mod.decode_attention_into(
            block["attn"], cfg, h, cache["k"][ci], cache["v"][ci], *attn)
    else:
        step = ssm_mod.decode_ssm if kind == "ssm" else rglru_mod.decode_rglru
        y, state, conv = step(block[kind], cfg, h, cache["state"][ci],
                              cache["conv"][ci])
        cache["state"][ci].copy_(state)
        cache["conv"][ci].copy_(conv)
    x = _residual(cfg, x, y)
    if "norm2" in block:
        y, _ = _ffn(block, cfg, apply_norm(block["norm2"], x, cfg.norm,
                                           cfg.norm_eps))
        x = _residual(cfg, x, y)
    return x


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict[str, Any], *,
                positions: Optional[torch.Tensor] = None,
                vision_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens [B,1] + cache → (logits [B,1,V], a new cache). Each group's
    stacked leaves are copied once, and every layer writes its slice of
    the copy; ``cache`` itself is left as it was. The attention write
    index (a ring slot, ``len % capacity``, for the hybrid family's local
    attention), the validity mask and the RoPE tables are made once a
    step."""
    from ..dist import api as dist_api
    b = tokens.shape[0]
    cache_len = cache["len"]
    if positions is None:
        positions = default_positions(cfg, cache_len, b, 1)
    attn = None
    kv = [c for (unit, _), gc in zip(layer_groups(cfg), cache["groups"])
          for kind, c in zip(unit, gc) if kind == "attn"]
    if kv:
        smax = kv[0]["k"].shape[2]
        pos = cache_len % smax if cfg.family == "hybrid" else cache_len
        attn = (attn_mod.write_index(pos, smax),
                attn_mod.decode_mask(cache_len, smax, None),
                attn_mod.decode_rope(cfg, positions))
    x = embed_inputs(params, cfg, tokens, vision_embeds)
    layers = iter(params["layers"])
    new_groups = []
    for (unit, count), gc in zip(layer_groups(cfg), cache["groups"]):
        # an SSD state [L,B,H,N,P] is laid out by heads, as its layers
        # step them (``ssm.decode_ssm``)
        new = [{name: dist_api.split_model(leaf.clone(), 2, batch_dim=1)
                if kind == "ssm" and name == "state" else leaf.clone()
                for name, leaf in c.items()} for kind, c in zip(unit, gc)]
        for ci in range(count):
            for kind, unit_cache in zip(unit, new):
                x = _decode_block(next(layers), cfg, kind, x, unit_cache, ci,
                                  attn)
        new_groups.append(new)
    return _logits(params, cfg, x), {"len": cache_len + 1,
                                     "groups": new_groups}
