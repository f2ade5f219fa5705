"""Full-sequence attention (prefill): GQA/MQA with qk-norm, QKV bias and
RoPE — the port of the JAX package's ``repro/models/attention.py`` up to
``attention()``.

``impl="kernel"`` is the counterpart of the JAX package's ``"pallas"``:
it runs ``ops.flash_attention``, which launches the hand-written flash
kernel for CUDA tensors and takes its plain version on the CPU; the
kernel has no logit softcap, so a config with one raises there.
``impl="ref"`` (the default, as ``"xla"`` is in JAX) is the grouped-head
einsum, which never repeats K/V per query head. Decode with a KV cache,
the chunked path and cross-attention come with serving (ROADMAP A9).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import apply_norm, apply_rope, init_norm, normal

__all__ = ["ATTN_IMPLS", "init_attention", "attention"]

ATTN_IMPLS = ("ref", "kernel")


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


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor, positions
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    if positions is not None:
        if cfg.m_rope:
            raise NotImplementedError("M-RoPE comes with the vlm family "
                                      "(ROADMAP A10)")
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mha(q, k, v, *, causal: bool, window: Optional[int],
         softcap: Optional[float], impl: str) -> torch.Tensor:
    """q: [B,S,H,D] → [B,S,H,D]; k/v: [B,S,Hkv,D]."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if impl == "kernel":
        if softcap is not None:
            raise NotImplementedError(
                "attn_impl='kernel': the flash attention kernel has no logit "
                "softcap (ROADMAP B6); use attn_impl='ref'")
        out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
        return out.transpose(1, 2)
    b, h, sq, d = qt.shape
    hkv, skv = kt.shape[1], kt.shape[2]
    qg = qt.reshape(b, hkv, h // hkv, sq, d)
    logits = torch.einsum("bkgqd,bkKd->bkgqK", qg.float(),
                          kt.float()) * (d ** -0.5)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > (qpos - window)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(vt.dtype)
    out = torch.einsum("bkgqK,bkKd->bkgqd", probs, vt).reshape(b, h, sq, d)
    return out.transpose(1, 2).to(q.dtype)


def attention(p, cfg: ModelConfig, x: torch.Tensor, positions, *,
              causal: bool = True, window: Optional[int] = None,
              impl: str = "ref") -> torch.Tensor:
    """Full-sequence self-attention (prefill): x [B,S,D] → [B,S,D]."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn impl {impl!r}; expected one of {ATTN_IMPLS}")
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _mha(q, k, v, causal=causal, window=window,
               softcap=cfg.attn_logit_softcap, impl=impl)
    return out.reshape(b, s, -1) @ p["wo"]
