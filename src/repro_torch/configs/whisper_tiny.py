"""whisper-tiny [arXiv:2212.04356; unverified]
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 — enc-dec, conv frontend
stub (input_specs provides precomputed frame embeddings)."""
from .base import EncDecConfig, ModelConfig

ARCH = "whisper-tiny"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="encdec", n_layers=4, d_model=384, n_heads=6,
        n_kv_heads=6, d_ff=1536, vocab_size=51865, head_dim=64,
        mlp="gelu", norm="layernorm", tie_embeddings=True,
        encdec=EncDecConfig(n_enc_layers=4, n_frames=1500))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="encdec", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
        mlp="gelu", norm="layernorm", tie_embeddings=True,
        encdec=EncDecConfig(n_enc_layers=2, n_frames=32),
        param_dtype="float32", compute_dtype="float32")
