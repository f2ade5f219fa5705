"""Model/arch configuration schema: a copy of the JAX package's
``repro/configs/base.py``, pure data, with :meth:`ModelConfig.dtype`
returning a torch dtype.

Every architecture the port runs gets a ``configs/<id>.py`` exporting
``config()`` (the exact published shape) and ``smoke_config()`` (a reduced
same-family config for CPU tests). The registry in ``configs/__init__``
resolves an arch id.

The port's own fields (the shared expert, a global attention layer in a
hybrid, and :class:`ModelConfig`'s last group: NoPE, the softmax scale,
the embedding, residual and logit multipliers, the norm eps) are not in
the JAX package's schema; each defaults to what the JAX package computes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    #: routing group length; capacity C = ⌈k·g/E·cf⌉ is independent of S
    group_size: int = 4096
    #: width of a shared expert that every token passes through beside the
    #: routed ones (port only; 0: none)
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128       # N
    head_dim: int = 64         # P
    expand: int = 2            # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256           # SSD chunk length
    n_groups: int = 1          # B/C groups


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    #: repeating unit of temporal mixers, e.g. ("rec", "rec", "attn")
    pattern: Tuple[str, ...] = ()
    #: local-attention window; None: global attention (port only)
    window: Optional[int] = 2048
    lru_width: Optional[int] = None
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 0
    n_frames: int = 1500       # stub frontend: precomputed frame embeddings


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention details
    qk_norm: bool = False
    attn_bias: bool = False            # qwen1.5 QKV bias
    attn_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    m_rope: bool = False               # qwen2-vl 3-axis rotary
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # mlp
    mlp: str = "swiglu"                # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    tie_embeddings: bool = False
    # sub-configs
    moe: MoEConfig = MoEConfig()
    ssm: SSMConfig = SSMConfig()
    hybrid: HybridConfig = HybridConfig()
    encdec: EncDecConfig = EncDecConfig()
    # vlm stub frontend
    n_vision_tokens: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # distribution knobs (overridable per run)
    remat: str = "full"                # none | full
    scan_layers: bool = True
    #: long-context support class, used to decide long_500k applicability
    subquadratic: bool = False
    # port only (granite-4.0-h); each default computes as the JAX package
    rope: bool = True                  # False: no position embedding (NoPE)
    #: attention softmax scale; None: 1/√head_dim
    attention_multiplier: Optional[float] = None
    embedding_multiplier: float = 1.0  # x = m · E[token]
    residual_multiplier: float = 1.0   # x + m · block(x)
    logits_scaling: float = 1.0        # logits = head(x) / s
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper is enc-dec)

    def padded_vocab(self, multiple: int) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS and reporting)."""
        d, f, v, l = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        qkvo = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + \
            self.n_heads * hd * d
        gated = self.mlp in ("swiglu", "geglu")
        mlp = d * f * (3 if gated else 2)
        if self.moe.n_experts:
            mlp *= self.moe.n_experts
            mlp += d * self.moe.n_experts  # router
            mlp += d * self.moe.shared_d_ff * (3 if gated else 2)
        di = self.ssm.expand * d
        n = self.ssm.state_dim
        nh = di // self.ssm.head_dim
        g = self.ssm.n_groups
        ssm = d * (2 * di + 2 * g * n + nh) + di * d
        if self.family == "ssm":
            qkvo = ssm
            mlp = 0
        if self.family == "hybrid":
            lru = self.hybrid.lru_width or d
            rec = d * lru * 2 + lru * d + 3 * lru  # branches + out + gates
            att = qkvo
            pat = self.hybrid.pattern or ("rec",)
            frac_rec = sum(1 for p in pat if p == "rec") / len(pat)
            frac_ssm = sum(1 for p in pat if p == "ssm") / len(pat)
            qkvo = rec * frac_rec + ssm * frac_ssm + \
                att * (1 - frac_rec - frac_ssm)
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.family == "encdec":
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.encdec.n_enc_layers * (qkvo + mlp)
            qkvo = 2 * qkvo  # decoder self + cross
        return int(l * (qkvo + mlp) + emb + enc)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts)."""
        if not self.moe.n_experts:
            return self.param_count()
        d, f, l = self.d_model, self.d_ff, self.n_layers
        gated = self.mlp in ("swiglu", "geglu")
        per_expert = d * f * (3 if gated else 2)
        total = self.param_count()
        inactive = l * per_expert * (self.moe.n_experts - self.moe.top_k)
        return int(total - inactive)
