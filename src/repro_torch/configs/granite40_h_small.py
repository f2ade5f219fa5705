"""granite-4.0-h-small [hf:ibm-granite/granite-4.0-h-small; hf]
40L d_model=4096, 36 Mamba-2 SSD mixers (128 heads of 64, state 128) and 4
global NoPE attention layers (32H, GQA kv=8, head 128) at 5, 15, 25, 35;
every layer has 72 experts top-10 of width 768 and a shared expert of 1536;
vocab=100352 tied. Port only: the JAX package has no such model."""
from .base import HybridConfig, ModelConfig, MoEConfig, SSMConfig

ARCH = "granite-4.0-h-small"

#: the published ``layer_types``: a period of ten, attention sixth
PATTERN = ("ssm",) * 5 + ("attn",) + ("ssm",) * 4


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=768, vocab_size=100352, head_dim=128,
        mlp="swiglu", tie_embeddings=True,
        moe=MoEConfig(n_experts=72, top_k=10, shared_d_ff=1536),
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk=256, n_groups=1),
        hybrid=HybridConfig(pattern=PATTERN, window=None),
        rope=False, attention_multiplier=0.0078125,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=16.0, norm_eps=1e-5)


def smoke_config() -> ModelConfig:
    """Both mixer kinds, the experts and the shared expert at CPU sizes:
    a period of three over four layers (a whole unit and a remainder)."""
    return ModelConfig(
        name=ARCH + "-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        mlp="swiglu", tie_embeddings=True,
        moe=MoEConfig(n_experts=8, top_k=3, shared_d_ff=64),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      chunk=8, n_groups=1),
        hybrid=HybridConfig(pattern=("ssm", "attn", "ssm"), window=None),
        rope=False, attention_multiplier=0.0078125,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        logits_scaling=16.0, norm_eps=1e-5,
        param_dtype="float32", compute_dtype="float32")
