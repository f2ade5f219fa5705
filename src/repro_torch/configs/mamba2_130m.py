"""mamba2-130m [arXiv:2405.21060; unverified]
24L d_model=768 (attention-free) vocab=50280, ssm_state=128 — SSD."""
from .base import ModelConfig, SSMConfig

ARCH = "mamba2-130m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm", n_layers=24, d_model=768, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=50280, tie_embeddings=True,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                      chunk=256),
        subquadratic=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=256, tie_embeddings=True,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      chunk=16),
        subquadratic=True, param_dtype="float32", compute_dtype="float32")
