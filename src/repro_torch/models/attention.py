"""Attention: GQA/MQA with qk-norm, QKV bias, RoPE, M-RoPE or none
(NoPE, ``cfg.rope`` false), local windows and cross-attention — the port
of the JAX package's ``repro/models/attention.py``. The softmax scale is
``cfg.attention_multiplier``, 1/√Dh where it is None
(:func:`softmax_scale`).

``impl="kernel"`` is the counterpart of the JAX package's ``"pallas"``:
it runs ``ops.flash_attention``, which launches the hand-written flash
kernel for CUDA tensors and takes its plain version on the CPU; the
kernel has no logit softcap, so a config with one raises there, and it
has no backward, so it raises under grad on every device (the CPU's
plain version would differentiate, the card's kernel would not).
``impl="ref"`` (the default, as ``"xla"`` is in JAX) is the grouped-head
einsum, which never repeats K/V per query head. ``impl="ref_chunked"``
(or ``"ref_chunked:N"``, chunks of N queries, 512 by default) is JAX's
``"xla_chunked"``: the same einsums over one query chunk at a time, so
the score tensor is ``[B,H,N,Skv]``; a sequence the chunk does not
divide (whisper's 1500 frames) takes the plain path, as in JAX.

The decode path (:func:`init_kv_cache`, :func:`decode_attention`) is
plain PyTorch, as it is plain XLA in the JAX package: one new token
against the whole cache, scores in f32. It is pure: the new K/V row is
written into a copy of the cache at a device-side position, and the input
cache is never written, so a decode step can be replayed on the same
cache. A decode step over many layers makes that copy, the write index,
the validity mask and the RoPE tables once for all its layers and hands
them to :func:`decode_attention_into`, which writes into the copy.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import (apply_norm, init_norm, m_rope_tables, normal,
                     rope_tables, rotate)

__all__ = ["ATTN_IMPLS", "check_impl", "softmax_scale", "init_attention",
           "attention", "project_kv", "init_kv_cache", "decode_rope",
           "decode_mask", "write_index", "decode_attention_into",
           "decode_attention"]

ATTN_IMPLS = ("ref", "kernel", "ref_chunked")
#: query rows a chunk of ``"ref_chunked"`` without a ``:N``
DEFAULT_Q_CHUNK = 512


def check_impl(impl: str) -> str:
    """``impl`` if it names an attention implementation: one of
    :data:`ATTN_IMPLS`, or ``"ref_chunked:N"`` with N a positive int;
    else ``ValueError``."""
    name, _, chunk = impl.partition(":")
    if name in ATTN_IMPLS and (not chunk or (name == "ref_chunked" and
                                             chunk.isdigit() and int(chunk))):
        return impl
    raise ValueError(f"attn_impl={impl!r}; expected one of {ATTN_IMPLS} or "
                     "'ref_chunked:N'")


def softmax_scale(cfg: ModelConfig) -> float:
    """The scale of the attention logits: ``cfg.attention_multiplier``, or
    1/√Dh where the config gives none."""
    if cfg.attention_multiplier is None:
        return cfg.resolved_head_dim ** -0.5
    return cfg.attention_multiplier


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, device
                   ) -> dict:
    d, h, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal(gen, (d, h * hd), s, dtype, device),
        "wk": normal(gen, (d, hkv * hd), s, dtype, device),
        "wv": normal(gen, (d, hkv * hd), s, dtype, device),
        "wo": normal(gen, (h * hd, d), 1.0 / math.sqrt(h * hd), dtype, device),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, "rmsnorm", dtype, device)
        p["k_norm"] = init_norm(hd, "rmsnorm", dtype, device)
    return p


def decode_rope(cfg: ModelConfig, positions: Optional[torch.Tensor]
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The RoPE tables for ``positions`` [B,S], or M-RoPE's for
    ``positions`` [3,B,S] where ``cfg.m_rope`` (None: no rotation, also
    where the config has no position embedding)."""
    if positions is None or not cfg.rope:
        return None
    if cfg.m_rope:
        return m_rope_tables(positions, cfg.resolved_head_dim,
                             cfg.rope_theta, cfg.mrope_sections)
    return rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, rope, *,
                 kv: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """(q, k, v) of ``x`` [B,S,D], each [B,S,heads,Dh]; with ``kv=False``
    (cross-attention, whose K/V come from the encoder) only q, and None
    twice: eager PyTorch would run the discarded projections, which XLA
    drops from the JAX package's program."""
    from ..dist import api as dist_api

    def project(name: str, heads: int, norm: Optional[str], pin: str):
        y = x @ p["w" + name]
        if cfg.attn_bias:
            y = y + p["b" + name]
        y = dist_api.unflatten(y, -1, (heads, cfg.resolved_head_dim))
        if cfg.qk_norm and norm:
            y = apply_norm(p[norm], y, "rmsnorm")
        if rope is not None and norm:
            y = rotate(y, *rope)
        return dist_api.hint_named(y, pin)

    q = project("q", cfg.n_heads, "q_norm", "attn_q")
    if not kv:
        return q, None, None
    return (q, project("k", cfg.n_kv_heads, "k_norm", "attn_kv"),
            project("v", cfg.n_kv_heads, None, "attn_kv"))


def _mha(q, k, v, *, causal: bool, window: Optional[int],
         softcap: Optional[float], impl: str, scale: float) -> torch.Tensor:
    """q: [B,Sq,H,D] → [B,Sq,H,D]; k/v: [B,Skv,Hkv,D]; ``scale`` multiplies
    the logits. A sharded ``q`` runs on each device's own heads or query
    rows (``dist.api.local_attention``)."""
    from ..dist import api as dist_api
    sq = q.shape[1]

    def local(q, k, v, first, combine):
        return _mha_local(q, k, v, k.shape[1] - sq + first, causal=causal,
                          window=window, softcap=softcap, impl=impl,
                          scale=scale, combine=combine)

    return dist_api.local_attention(local, q, k, v)


def _mha_local(q, k, v, q_offset: int, *, causal: bool,
               window: Optional[int], softcap: Optional[float], impl: str,
               scale: float, combine=None) -> torch.Tensor:
    """:func:`_mha` on tensors whose query i sits at key position
    ``q_offset + i``; with ``combine`` the keys are one device's share of
    them, unmasked (``dist.api.local_attention``)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    sq = qt.shape[2]
    if impl == "kernel":
        if q.requires_grad or k.requires_grad or v.requires_grad:
            raise NotImplementedError(
                "attn_impl='kernel' under grad: the flash attention kernel "
                "is forward only (ROADMAP B6); train with attn_impl='ref'")
        if softcap is not None:
            raise NotImplementedError(
                "attn_impl='kernel': the flash attention kernel has no logit "
                "softcap (ROADMAP B6); use attn_impl='ref'")
        if q_offset != kt.shape[2] - sq or combine is not None:
            raise NotImplementedError(
                "attn_impl='kernel' takes whole rows of whole keys; queries "
                "or keys split over devices need attn_impl='ref'")
        out = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                  scale=scale)
        return out.transpose(1, 2)
    if impl.startswith("ref_chunked"):
        _, _, chunk = impl.partition(":")
        q_chunk = min(int(chunk) if chunk else DEFAULT_Q_CHUNK, sq)
        if sq % q_chunk == 0:
            return _mha_chunked(qt, kt, vt, q_offset, causal=causal,
                                window=window, softcap=softcap, scale=scale,
                                q_chunk=q_chunk, combine=combine
                                ).transpose(1, 2)
    # (a sequence the chunk does not divide, such as whisper's 1500-frame
    # encoder, falls through to the plain path, as in JAX)
    out = _scores_softmax_pv(qt, kt, vt, q_offset, causal=causal,
                             window=window, softcap=softcap, scale=scale,
                             combine=combine)
    return out.transpose(1, 2).to(q.dtype)


def _scores_softmax_pv(qt, kt, vt, q_offset: int, *, causal: bool,
                       window: Optional[int], softcap: Optional[float],
                       scale: float, combine=None) -> torch.Tensor:
    """The grouped-head einsum attention of the queries ``qt`` [B,H,Sq,D]
    over ``kt``, ``vt`` [B,Hkv,Skv,D] → [B,H,Sq,D] in ``vt``'s dtype, the
    logits times ``scale``. Query i sits at key position ``q_offset + i``
    for the masks. With
    ``combine`` the keys are one device's share of an unmasked attention:
    the softmax is taken with their own maximum and ``combine(o, l, m)``
    merges every device's (``dist.api.local_attention``)."""
    h, sq = qt.shape[1:3]
    hkv, skv = kt.shape[1], kt.shape[2]
    from ..dist import api as dist_api
    qg = dist_api.unflatten(qt, 1, (hkv, h // hkv))
    logits = torch.einsum("bkgqd,bkKd->bkgqK", qg.float(),
                          kt.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if causal or window is not None:
        qpos = torch.arange(sq, device=qt.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=qt.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=qt.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > (qpos - window)
        if combine is not None:
            raise NotImplementedError("keys split over devices take no mask")
        logits = logits.masked_fill(~mask, -1e30)
    if combine is not None:
        m = logits.amax(-1, keepdim=True)
        e = torch.exp(logits - m)
        out = combine(torch.einsum("bkgqK,bkKd->bkgqd", e, vt.float()),
                      e.sum(-1, keepdim=True), m).to(vt.dtype)
        return out.flatten(1, 2)
    probs = torch.softmax(logits, dim=-1).to(vt.dtype)
    return dist_api.flatten(
        torch.einsum("bkgqK,bkKd->bkgqd", probs, vt), 1, 2)      # [B,H,Sq,D]


def _mha_chunked(qt, kt, vt, q_offset: int, *, causal: bool,
                 window: Optional[int], softcap: Optional[float],
                 scale: float, q_chunk: int, combine=None) -> torch.Tensor:
    """Sarathi-style chunked prefill: one query chunk at a time, so the
    score tensor is [B,H,qc,Skv] instead of [B,H,Sq,Skv] (JAX's
    ``lax.scan`` over chunks). qt [B,H,Sq,D] → [B,H,Sq,D] in qt's dtype;
    query i sits at key position ``q_offset + i``."""
    sq = qt.shape[2]
    outs = [_scores_softmax_pv(qt[:, :, c:c + q_chunk], kt, vt, c + q_offset,
                               causal=causal, window=window, softcap=softcap,
                               scale=scale, combine=combine)
            for c in range(0, sq, q_chunk)]
    return torch.cat(outs, dim=2).to(qt.dtype)


def attention(p, cfg: ModelConfig, x: torch.Tensor, positions, *,
              causal: bool = True, window: Optional[int] = None,
              impl: str = "ref", cross_kv: Optional[Tuple] = None
              ) -> torch.Tensor:
    """Full-sequence attention (training / prefill): x [B,S,D] → [B,S,D].
    ``positions`` [B,S], or [3,B,S] under M-RoPE (None: no rotation).

    ``cross_kv=(k, v)`` switches to cross-attention (the whisper
    decoder): K/V [B,T,Hkv,Dh] come from the encoder (:func:`project_kv`),
    with no causal mask and no window.
    """
    check_impl(impl)
    from ..dist import api as dist_api
    x = dist_api.stream(x)
    q, k, v = _project_qkv(p, cfg, x, decode_rope(cfg, positions),
                           kv=cross_kv is None)
    if cross_kv is not None:
        k, v = cross_kv
        causal, window = False, None
    out = _mha(q, k, v, causal=causal, window=window,
               softcap=cfg.attn_logit_softcap, impl=impl,
               scale=softmax_scale(cfg))
    return dist_api.stream(dist_api.flatten(out, 2, 3) @ p["wo"])


def project_kv(p, cfg: ModelConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder-side K/V [B,T,Hkv,Dh] for cross-attention (computed once a
    request)."""
    from ..dist import api as dist_api
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    x = dist_api.stream(x)
    k = dist_api.unflatten(x @ p["wk"], -1, (hkv, hd))
    v = dist_api.unflatten(x @ p["wv"], -1, (hkv, hd))
    if cfg.attn_bias:
        k = k + p["bk"].reshape(hkv, hd)
        v = v + p["bv"].reshape(hkv, hd)
    if cfg.qk_norm:
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    return k, v


# ----------------------------------------------------------------------------
# decode path — one new token against a KV cache
# ----------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  n_layers: int, device) -> dict:
    """Zero K and V caches of shape ``[n_layers, B, max_len, Hkv, Dh]``;
    ``device="meta"`` gives their shapes without memory."""
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_index(pos: torch.Tensor, smax: int) -> torch.Tensor:
    """Sequence index [1] int64 of a K/V row written at ``pos`` (a 0-d
    device tensor) into a cache of ``smax`` slots, clamped into the cache
    as ``dynamic_update_slice`` clamps its start."""
    return pos.reshape(1).to(torch.int64).clamp(0, smax - 1)


def decode_mask(cache_len: torch.Tensor, smax: int, window: Optional[int]
                ) -> torch.Tensor:
    """[smax] bool, true at the cache slots a decode step must not read.
    ``cache_len`` drives it, saturated at the capacity: once a ring-buffer
    cache has wrapped, every slot is live."""
    kpos = torch.arange(smax, device=cache_len.device)
    valid = kpos <= torch.clamp(cache_len, max=smax - 1)
    if window is not None:
        valid = valid & (kpos > (cache_len - window))
    return ~valid


def decode_attention_into(p, cfg: ModelConfig, x: torch.Tensor, k_cache,
                          v_cache, index: torch.Tensor, masked: torch.Tensor,
                          rope) -> torch.Tensor:
    """One-token attention that writes the new K/V row into ``k_cache``
    and ``v_cache`` [B,Smax,Hkv,Dh] in place, at ``index`` (from
    :func:`write_index`), and attends over the slots that ``masked`` (from
    :func:`decode_mask`) leaves. ``rope`` is :func:`decode_rope`'s. The
    caller owns the caches: they are copies, never a step's input.
    Returns out [B,1,D]."""
    from ..dist import api as dist_api
    b = x.shape[0]
    x = dist_api.stream(x)
    q, k_new, v_new = _project_qkv(p, cfg, x, rope)
    dist_api.index_copy_(k_cache, 1, index, k_new.to(k_cache.dtype))
    dist_api.index_copy_(v_cache, 1, index, v_new.to(v_cache.dtype))
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qg = dist_api.unflatten(q, 2, (hkv, h // hkv))[:, 0]          # [B,Hkv,G,D]
    out = dist_api.local_decode_attention(
        functools.partial(_decode_attend, scale=softmax_scale(cfg),
                          softcap=cfg.attn_logit_softcap),
        qg, k_cache, v_cache, masked).to(x.dtype)
    return dist_api.stream(out.reshape(b, 1, h * hd) @ p["wo"])


def _decode_attend(qg, k, v, masked, combine, *, scale: float,
                   softcap: Optional[float]) -> torch.Tensor:
    """One token's attention: ``qg`` [B,Hkv,G,D] over the slots of ``k``,
    ``v`` [B,S,Hkv,D] that ``masked`` [S] leaves → [B,Hkv,G,D] f32, the
    scores in f32. With ``combine`` these are one device's slots of a
    cache split over several: the softmax is taken with their own maximum
    and ``combine(o, l, m)`` merges the unnormalised outputs, the sums and
    the maxima of every device's slots (``dist.api.local_decode_attention``)."""
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = logits.masked_fill(masked, -1e30)
    if combine is None:
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m)
    return combine(torch.einsum("bkgs,bskd->bkgd", e, v.float()),
                   e.sum(-1, keepdim=True), m)


def decode_attention(p, cfg: ModelConfig, x: torch.Tensor, k_cache, v_cache,
                     cache_len, positions, *, window: Optional[int] = None,
                     write_pos=None):
    """One-token attention. x: [B,1,D]; caches: [B,Smax,Hkv,Dh];
    ``cache_len`` a 0-d int tensor on x's device.

    Returns (out [B,1,D], new_k_cache, new_v_cache). The new K/V row is
    written at ``write_pos`` (default ``cache_len``; ring-buffer caches
    pass ``cache_len % capacity``) into copies of the caches;
    ``cache_len`` always drives the validity mask, saturated at the cache
    capacity. Nothing here reads a device value back to the host.
    """
    if write_pos is None:
        write_pos = cache_len
    smax = k_cache.shape[1]
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    out = decode_attention_into(
        p, cfg, x, k_cache, v_cache, write_index(write_pos, smax),
        decode_mask(cache_len, smax, window), decode_rope(cfg, positions))
    return out, k_cache, v_cache
