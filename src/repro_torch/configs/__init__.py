"""Architecture registry of the port: arch id → exact published config,
the JAX package's ``repro/configs/__init__.py`` for the port.

Every architecture has ``configs/<id>.py`` with ``config()`` (the
published shape) and ``smoke_config()`` (reduced, CPU-testable), in the
JAX package's order: the dense decoders (qwen3-1.7b, llama3-8b,
qwen1.5-32b, nemotron-4-340b), the moe (phi-3.5-moe, dbrx-132b), ssm
(mamba2-130m), hybrid (recurrentgemma-9b), encdec (whisper-tiny) and vlm
(qwen2-vl-2b) families. ``wah_paper`` holds the paper's own indexing
workload, which is no model and has no entry here.
"""
from . import (dbrx, llama3_8b, mamba2_130m, nemotron4_340b, phi35_moe,
               qwen2_vl, qwen3_1p7b, qwen15_32b, recurrentgemma_9b,
               whisper_tiny)
from .base import ModelConfig

_MODULES = {
    m.ARCH: m
    for m in (phi35_moe, dbrx, whisper_tiny, qwen2_vl, mamba2_130m,
              qwen3_1p7b, qwen15_32b, nemotron4_340b, llama3_8b,
              recurrentgemma_9b)
}

ARCHS = tuple(_MODULES)

#: assigned input shapes: name → (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _module(arch: str):
    try:
        return _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; the port runs {ARCHS}") from None


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def list_archs():
    return list(ARCHS)


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "get_config", "get_smoke_config",
           "list_archs", "shape_applicable"]
