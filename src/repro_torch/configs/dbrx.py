"""dbrx-132b [hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4."""
from .base import ModelConfig, MoEConfig

ARCH = "dbrx-132b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=10752, vocab_size=100352, head_dim=128,
        mlp="swiglu", moe=MoEConfig(n_experts=16, top_k=4))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mlp="swiglu", moe=MoEConfig(n_experts=4, top_k=4),
        param_dtype="float32", compute_dtype="float32")
