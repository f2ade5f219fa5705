"""cfg-bound model facade — the port of the JAX package's
``repro/models/model.py``: ``init``, ``loss`` (training), ``forward``
(prefill), and the serving half, ``init_cache`` and ``decode_step``.

A ``Model`` is bound to a device: the current CUDA device unless the
caller names another (``LookupError`` without a card), like every entry
point of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.memref import as_device_array, default_device
from . import transformer
from .attention import ATTN_IMPLS
from .layers import ParamTree

__all__ = ["Model", "train_input_specs", "serve_input_specs"]


class Model:
    """Dense decoder bound to a config, an attention implementation
    (``"ref"``: grouped einsum, the default; ``"kernel"``: the flash
    attention kernel) and a device."""

    def __init__(self, cfg: ModelConfig, vocab: Optional[int] = None,
                 attn_impl: str = "ref", device=None):
        transformer.check_family(cfg)
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of "
                             f"{ATTN_IMPLS}")
        self.cfg = cfg
        self.vocab = vocab or cfg.vocab_size
        self.attn_impl = attn_impl
        self.device = default_device() if device is None \
            else torch.device(device)

    def init(self, seed: int) -> ParamTree:
        """Random parameters on the model's device from a seeded
        ``torch.Generator`` there."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.init_params(gen, self.cfg, self.vocab,
                                       device=self.device)

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: as_device_array(v, device=self.device)
                for k, v in batch.items()}

    # -- training ----------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy of ``batch`` (``tokens`` and
        ``labels`` [B,S], host arrays or tensors) → ``(loss, {"ce",
        "aux"})``, differentiable in ``params``: a :class:`ParamTree` or
        :func:`~repro_torch.models.layers.plain_tree`'s dicts. Under grad
        each layer runs under ``cfg.remat``."""
        return transformer.loss_fn(params, self.cfg, self._batch(batch),
                                   attn_impl=self.attn_impl)

    def forward(self, params: ParamTree, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` [B,S] (host array or tensor) → (logits
        [B,S,V], aux loss)."""
        batch = self._batch(batch)
        with torch.no_grad():
            return transformer.forward(params, self.cfg, batch["tokens"],
                                       positions=batch.get("positions"),
                                       attn_impl=self.attn_impl)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device=None
                   ) -> Dict[str, Any]:
        """A zero decode cache on the model's device, or on ``device``
        (``"meta"``: shapes and dtypes only, the port's ``eval_shape``)."""
        return transformer.init_cache(
            self.cfg, batch, max_len,
            device=self.device if device is None else torch.device(device))

    def decode_step(self, params: ParamTree, tokens: torch.Tensor,
                    cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens [B,1] on the model's device + cache → (logits [B,1,V],
        new cache); ``cache`` is not written."""
        with torch.no_grad():
            return transformer.decode_step(params, self.cfg, tokens, cache)


def train_input_specs(cfg: ModelConfig, batch: int, seq: int
                      ) -> Dict[str, torch.Tensor]:
    """A train batch's inputs as ``meta`` tensors: ``tokens`` and
    ``labels`` [B,S] int32 (the dense family's; the others raise)."""
    transformer.check_family(cfg)
    return {k: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}


def serve_input_specs(cfg: ModelConfig, batch: int
                      ) -> Dict[str, torch.Tensor]:
    """One decode step's fresh inputs as ``meta`` tensors (the cache's
    come from ``Model.init_cache(..., device="meta")``)."""
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32,
                                  device="meta")}
