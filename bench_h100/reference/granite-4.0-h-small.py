"""granite-4.0-h-small's plain reference: Mamba-2 SSD mixers and global
NoPE attention, each layer followed by 72 top-10 experts with GShard
capacity and a shared expert, in plain PyTorch, computed in float32 with
TF32 off, one layer at a time.

It takes the configuration file's ``run`` sizes and the weights the
benchmark drew (bf16 leaves, upcast here layer by layer), and imports
nothing of the program. It reuses ``model.py``'s RMSNorm, causal
attention in blocks of queries, SwiGLU and capacity MoE, and ``mode="fp8"``
is ``model.py``'s control: every product's two operands rounded to float8
e4m3 (one scale per tensor) before an f32 product.

The equations, in the layout of the port's weight tree (``x @ W``),
with m_e, m_r, s_l the embedding, residual and logit multipliers and
eps the norm's:

* x = m_e · E[t];
* each layer: x ← x + m_r · mixer(RMSNorm₁(x)), then
  x ← x + m_r · (MoE(h) + Shared(h)) with h = RMSNorm₂(x);
* logits = RMSNorm_f(x) · Eᵀ / s_l.
* Attention: causal softmax(q kᵀ · ``attention_multiplier``) v, GQA
  (query head i reads key head i // (H / Hkv)), no position embedding.
* Mamba-2: [z | xBC | dt] = h W_in; xBC ← SiLU(causal depthwise conv of
  width W over time + b); Δ = softplus(dt + dt_bias), A = −exp(a_log);
  per head the state S_t = exp(Δ_t A) S_{t−1} + Δ_t B_t ⊗ x_t and the
  output y_t = C_t · S_t + D x_t; out = RMSNorm(y ⊙ SiLU(z)) W_out. B and
  C are shared by the heads of a group.

The recurrence is computed in its closed form, not by chunks:
y_i = Σ_{j ≤ i} (C_i · B_j) exp(Σ_{j < k ≤ i} Δ_k A) Δ_j x_j + D x_i,
in blocks of queries and of heads, the decay's exponent taken as the
difference of running sums kept in float64.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .model import (Arith, causal_attention, exact, f32, moe_block, rmsnorm,
                    swiglu)

__all__ = ["exact", "kinds", "logits_at"]

#: query rows and heads of one block of the SSD's closed form
SSD_Q_BLOCK = 1024
SSD_H_BLOCK = 16


def kinds(run: Dict[str, Any]) -> List[str]:
    """The mixer of each layer: the configuration's pattern repeated."""
    pattern = run["hybrid"]["pattern"]
    return [pattern[i % len(pattern)] for i in range(run["n_layers"])]


def attention(p, run, x: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Causal GQA without a position embedding, the logits scaled by
    ``attention_multiplier``: ``causal_attention`` scales by Dh^-½, so q
    is multiplied by the ratio first."""
    b, s, _ = x.shape
    h, hkv, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    ratio = run["attention_multiplier"] * math.sqrt(hd)
    q = ar.mm(x, f32(p["wq"])).reshape(b, s, h, hd) * ratio
    k = ar.mm(x, f32(p["wk"])).reshape(b, s, hkv, hd)
    v = ar.mm(x, f32(p["wv"])).reshape(b, s, hkv, hd)
    o = causal_attention(q, k, v, ar).reshape(b, s, h * hd)
    return ar.mm(o, f32(p["wo"]))


def ssd(cm: torch.Tensor, bm: torch.Tensor, xw: torch.Tensor,
        log_decay: torch.Tensor, ar: Arith) -> torch.Tensor:
    """Σ_{j ≤ i} (C_i · B_j) exp(Σ_{j < k ≤ i} a_k) xw_j for C, B
    [B,S,G,N], xw = Δ x [B,S,H,P] and the log decays a = Δ A [B,S,H] →
    [B,S,H,P]."""
    b, s, h, p = xw.shape
    per_group = h // cm.shape[2]
    cum = torch.cumsum(log_decay.double(), dim=1)               # [B,S,H]
    out = torch.empty_like(xw)
    pos = torch.arange(s, device=xw.device)
    for bi in range(b):
        for q0 in range(0, s, SSD_Q_BLOCK):
            q1 = min(q0 + SSD_Q_BLOCK, s)
            later = pos[None, :q1] > pos[q0:q1, None]           # [Qb,K]
            # C_i · B_j of each group, keys 0..q1-1
            cb = ar.mm(cm[bi, q0:q1].transpose(0, 1),
                       bm[bi, :q1].permute(1, 2, 0))             # [G,Qb,K]
            for h0 in range(0, h, SSD_H_BLOCK):
                h1 = min(h0 + SSD_H_BLOCK, h)
                expo = (cum[bi, q0:q1, h0:h1].T[:, :, None] -
                        cum[bi, :q1, h0:h1].T[:, None, :])       # [Hb,Qb,K]
                decay = torch.exp(expo.float().masked_fill(later,
                                                           -math.inf))
                groups = torch.arange(h0, h1, device=xw.device) // per_group
                m = cb[groups] * decay
                y = torch.bmm(ar.cast(m), ar.cast(
                    xw[bi, :q1, h0:h1].permute(1, 0, 2)))        # [Hb,Qb,P]
                out[bi, q0:q1, h0:h1] = y.permute(1, 0, 2)
    return out


def mamba(p, run, x: torch.Tensor, eps: float, ar: Arith) -> torch.Tensor:
    """The Mamba-2 mixer over x [B,S,D] → [B,S,D]."""
    ssm = run["ssm"]
    b, s, _ = x.shape
    di = ssm["expand"] * run["d_model"]
    n, hp, g = ssm["state_dim"], ssm["head_dim"], ssm.get("n_groups", 1)
    h, width = di // hp, ssm["conv_width"]
    z, xbc, dt = ar.mm(x, f32(p["in_proj"])).split(
        [di, di + 2 * g * n, h], dim=-1)
    conv_w = f32(p["conv_w"])                                     # [W,C]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    xbc = F.silu(sum(padded[:, i:i + s] * conv_w[i] for i in range(width))
                 + f32(p["conv_b"]))
    xs = xbc[..., :di].reshape(b, s, h, hp)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    delta = F.softplus(dt + f32(p["dt_bias"]))                    # [B,S,H]
    a = -torch.exp(f32(p["a_log"]))                               # [H]
    y = ssd(cm, bm, xs * delta[..., None], delta * a, ar)
    y = y + xs * f32(p["d_skip"])[:, None]
    y = (y * F.silu(z).reshape(b, s, h, hp)).reshape(b, s, di)
    y = rmsnorm(y, f32(p["norm"]["scale"]), eps)
    return ar.mm(y, f32(p["out_proj"]))


def layer(p, run, kind: str, x: torch.Tensor, eps: float,
          ar: Arith) -> torch.Tensor:
    r = run["residual_multiplier"]
    h = rmsnorm(x, f32(p["norm1"]["scale"]), eps)
    mixer = attention(p["attn"], run, h, ar) if kind == "attn" else \
        mamba(p["ssm"], run, h, eps, ar)
    x = x + r * mixer
    h = rmsnorm(x, f32(p["norm2"]["scale"]), eps)
    moe = p["moe"]
    sh = moe["shared"]
    ffn = moe_block(moe, run, h, ar) + swiglu(
        h, f32(sh["w_gate"]), f32(sh["w_up"]), f32(sh["w_out"]), ar)
    return x + r * ffn


def logits_at(params, config: Dict[str, Any], tokens: torch.Tensor,
              rows: torch.Tensor, cols: torch.Tensor, mode: str = "f32"
              ) -> torch.Tensor:
    """The logits [n, V] f32 of ``tokens`` [B,S] at the positions
    ``(rows[i], cols[i])``."""
    run = config["run"]
    eps = float(run["norm_eps"])
    ar = Arith(mode)
    with torch.no_grad():
        embed = f32(params["embed"])
        x = embed[tokens] * run["embedding_multiplier"]
        for p, kind in zip(params["layers"], kinds(run)):
            x = layer(p, run, kind, x, eps, ar)
        h = rmsnorm(x[rows, cols], f32(params["final_norm"]["scale"]), eps)
        return ar.mm(h, embed.T) / run["logits_scaling"]
