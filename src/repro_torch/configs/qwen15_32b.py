"""qwen1.5-32b [hf:Qwen/Qwen1.5 family; hf]
64L d_model=5120 40H (kv=40, MHA) d_ff=27392 vocab=152064 — QKV bias."""
from .base import ModelConfig

ARCH = "qwen1.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, d_ff=27392, vocab_size=152064, head_dim=128,
        attn_bias=True, mlp="swiglu")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        attn_bias=True, mlp="swiglu",
        param_dtype="float32", compute_dtype="float32")
