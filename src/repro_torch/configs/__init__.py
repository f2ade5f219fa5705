"""Architecture registry of the port: arch id → exact published config.

Only the architectures the port can run are listed: the ``dense``
decoder family (qwen3-1.7b, llama3-8b, qwen1.5-32b, nemotron-4-340b).
The JAX package's other configs (moe, ssm, hybrid, encdec, vlm) come
with their model families (ROADMAP A10).
"""
from . import llama3_8b, nemotron4_340b, qwen3_1p7b, qwen15_32b
from .base import ModelConfig

_MODULES = {m.ARCH: m for m in (qwen3_1p7b, llama3_8b, qwen15_32b,
                                nemotron4_340b)}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    try:
        return _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; the port runs {ARCHS}") from None


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ARCHS", "ModelConfig", "get_config", "get_smoke_config"]
