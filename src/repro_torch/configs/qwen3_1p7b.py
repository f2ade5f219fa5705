"""qwen3-1.7b [hf:Qwen/Qwen3-8B family; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936 — qk_norm, GQA."""
from .base import ModelConfig

ARCH = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=6144, vocab_size=151936, head_dim=128,
        qk_norm=True, mlp="swiglu", tie_embeddings=True,
        rope_theta=1_000_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        qk_norm=True, mlp="swiglu", tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32")
