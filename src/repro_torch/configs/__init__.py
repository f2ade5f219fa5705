"""Architecture registry of the port: arch id → exact published config,
the JAX package's ``repro/configs/__init__.py`` for the port.

Every architecture has ``configs/<id>.py`` with ``config()`` (the
published shape) and ``smoke_config()`` (reduced, CPU-testable), in the
JAX package's order: the dense decoders (qwen3-1.7b, llama3-8b,
qwen1.5-32b, nemotron-4-340b), the moe (phi-3.5-moe, dbrx-132b), ssm
(mamba2-130m), hybrid (recurrentgemma-9b), encdec (whisper-tiny) and vlm
(qwen2-vl-2b) families. ``wah_paper`` holds the paper's own indexing
workload, which is no model and has no entry here.

:data:`ARCHS` and :func:`list_archs` are the JAX package's list. The port
runs one architecture besides, which the JAX package has no counterpart
of: granite-4.0-h-small (a hybrid of SSD mixers and NoPE attention with
experts and a shared expert in every layer); :func:`get_config` and
:func:`get_smoke_config` resolve it, :data:`PORT_ONLY` names it.
"""
from . import (dbrx, granite40_h_small, llama3_8b, mamba2_130m,
               nemotron4_340b, phi35_moe, qwen2_vl, qwen3_1p7b, qwen15_32b,
               recurrentgemma_9b, whisper_tiny)
from .base import ModelConfig

_MODULES = {
    m.ARCH: m
    for m in (phi35_moe, dbrx, whisper_tiny, qwen2_vl, mamba2_130m,
              qwen3_1p7b, qwen15_32b, nemotron4_340b, llama3_8b,
              recurrentgemma_9b)
}

#: the architectures the port runs that the JAX package does not
_PORT_ONLY_MODULES = {m.ARCH: m for m in (granite40_h_small,)}

ARCHS = tuple(_MODULES)
PORT_ONLY = tuple(_PORT_ONLY_MODULES)

#: assigned input shapes: name → (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _module(arch: str):
    try:
        return _MODULES.get(arch) or _PORT_ONLY_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; the port runs "
                       f"{ARCHS + PORT_ONLY}") from None


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


__all__ = ["ARCHS", "PORT_ONLY", "SHAPES", "ModelConfig", "get_config",
           "get_smoke_config", "list_archs", "shape_applicable"]
