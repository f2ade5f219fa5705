"""recurrentgemma-9b [arXiv:2402.19427; unverified]
38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000 — RG-LRU + local
attention, 1:2 pattern, window 2048."""
from .base import HybridConfig, ModelConfig

ARCH = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, d_ff=12288, vocab_size=256000, head_dim=256,
        mlp="geglu", tie_embeddings=True,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=2048,
                            lru_width=4096, conv_width=4),
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=256, head_dim=16,
        mlp="geglu", tie_embeddings=True,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"), window=16,
                            lru_width=64, conv_width=4),
        subquadratic=True, param_dtype="float32", compute_dtype="float32")
