"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16e top-2."""
from .base import ModelConfig, MoEConfig

ARCH = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=6400, vocab_size=32064, head_dim=128,
        mlp="swiglu", moe=MoEConfig(n_experts=16, top_k=2))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mlp="swiglu", moe=MoEConfig(n_experts=4, top_k=2),
        param_dtype="float32", compute_dtype="float32")
