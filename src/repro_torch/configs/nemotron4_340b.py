"""nemotron-4-340b [arXiv:2402.16819; unverified]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000 — squared-ReLU."""
from .base import ModelConfig

ARCH = "nemotron-4-340b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=96, d_model=18432, n_heads=96,
        n_kv_heads=8, d_ff=73728, vocab_size=256000, head_dim=192,
        mlp="relu2")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        mlp="relu2", param_dtype="float32", compute_dtype="float32")
