"""llama3-8b [arXiv:2407.21783; unverified]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256 — GQA, 128k vocab."""
from .base import ModelConfig

ARCH = "llama3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab_size=128256, head_dim=128,
        mlp="swiglu", rope_theta=500_000.0)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mlp="swiglu", param_dtype="float32", compute_dtype="float32")
