"""qwen2-vl-2b [arXiv:2409.12191; hf]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936 — M-RoPE, dynamic
resolution (vision frontend stubbed as precomputed patch embeddings)."""
from .base import ModelConfig

ARCH = "qwen2-vl-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_ff=8960, vocab_size=151936, head_dim=128,
        mlp="swiglu", attn_bias=True, m_rope=True,
        mrope_sections=(16, 24, 24), n_vision_tokens=256,
        tie_embeddings=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mlp="swiglu", attn_bias=True, m_rope=True, mrope_sections=(2, 3, 3),
        n_vision_tokens=8, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32")
