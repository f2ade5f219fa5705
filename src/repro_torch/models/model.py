"""cfg-bound model facade — the port of the JAX package's
``repro/models/model.py``: ``init`` and ``param_shapes``, ``loss``
(training), ``forward`` (prefill), and the serving half, ``init_cache``
and ``decode_step``, over the decoder-only families (``transformer``)
and the encoder–decoder one (``encdec``).

A ``Model`` is bound to a device: the current CUDA device unless the
caller names another (``LookupError`` without a card), like every entry
point of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.memref import as_device_array, default_device
from . import encdec, transformer
from .attention import check_impl
from .layers import ParamTree

__all__ = ["Model", "train_input_specs", "serve_input_specs"]


class Model:
    """A model bound to a config, an attention implementation (``"ref"``:
    grouped einsum, the default; ``"kernel"``: the flash attention kernel;
    ``"ref_chunked[:N]"``: the einsum one query chunk at a time) and a
    device. An unknown family raises ``ValueError``."""

    def __init__(self, cfg: ModelConfig, vocab: Optional[int] = None,
                 attn_impl: str = "ref", device=None,
                 max_dec_len: int = 448):
        if cfg.family != "encdec":
            transformer.layer_groups(cfg)
        self.cfg = cfg
        self.vocab = vocab or cfg.vocab_size
        self.attn_impl = check_impl(attn_impl)
        self.max_dec_len = max_dec_len
        self.device = default_device() if device is None \
            else torch.device(device)

    def init(self, seed: int) -> ParamTree:
        """Random parameters on the model's device from a seeded
        ``torch.Generator`` there."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self._init(gen, self.device)

    def param_shapes(self) -> ParamTree:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        storage, no draw (the JAX package's ``eval_shape`` of ``init``).
        A generator cannot live on ``meta``, and nothing is drawn there."""
        return self._init(None, torch.device("meta"))

    def _init(self, gen: Optional[torch.Generator], device) -> ParamTree:
        if self.cfg.family == "encdec":
            return encdec.init_params(gen, self.cfg, self.vocab,
                                      max_dec_len=self.max_dec_len,
                                      device=device)
        return transformer.init_params(gen, self.cfg, self.vocab,
                                       device=device)

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: as_device_array(v, device=self.device)
                for k, v in batch.items()}

    # -- training ----------------------------------------------------------
    def loss(self, params, batch: Dict[str, Any]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy (+ the MoE aux loss) of ``batch``
        (``tokens`` and ``labels`` [B,S], and the family's extras:
        ``frames``, ``vision_embeds``, ``positions``; host arrays or
        tensors) → ``(loss, {"ce", "aux"})``, differentiable in
        ``params``: a :class:`ParamTree` or
        :func:`~repro_torch.models.layers.plain_tree`'s dicts. Under grad
        each layer runs under ``cfg.remat``."""
        batch = self._batch(batch)
        if self.cfg.family == "encdec":
            return encdec.loss_fn(params, self.cfg, batch,
                                  attn_impl=self.attn_impl)
        return transformer.loss_fn(params, self.cfg, batch,
                                   attn_impl=self.attn_impl)

    def forward(self, params: ParamTree, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``batch["tokens"]`` [B,S] (and ``frames``, ``vision_embeds``,
        ``positions`` where the family takes them; host arrays or
        tensors) → (logits [B,S,V], aux loss)."""
        batch = self._batch(batch)
        with torch.no_grad():
            if self.cfg.family == "encdec":
                return encdec.forward(params, self.cfg, batch["frames"],
                                      batch["tokens"],
                                      attn_impl=self.attn_impl)
            return transformer.forward(
                params, self.cfg, batch["tokens"],
                positions=batch.get("positions"),
                vision_embeds=batch.get("vision_embeds"),
                attn_impl=self.attn_impl)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, params=None, frames=None,
                   device=None) -> Dict[str, Any]:
        """A decode cache on the model's device, or on ``device``
        (``"meta"``: shapes and dtypes only, the port's ``eval_shape``).
        Zero for the decoder-only families; for encdec the prefill:
        ``params`` encode ``frames`` [B,T,D] once into each layer's cross
        K/V."""
        if self.cfg.family == "encdec":
            if params is None or frames is None:
                raise ValueError("an encdec cache needs params and frames")
            with torch.no_grad():
                return encdec.init_cache(
                    params, self.cfg,
                    as_device_array(frames, device=self.device), max_len,
                    attn_impl=self.attn_impl)
        return transformer.init_cache(
            self.cfg, batch, max_len,
            device=self.device if device is None else torch.device(device))

    def decode_step(self, params: ParamTree, tokens: torch.Tensor,
                    cache: Dict[str, Any]
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """tokens [B,1] on the model's device + cache → (logits [B,1,V],
        new cache); ``cache`` is not written."""
        with torch.no_grad():
            if self.cfg.family == "encdec":
                return encdec.decode_step(params, self.cfg, tokens, cache)
            return transformer.decode_step(params, self.cfg, tokens, cache)


def train_input_specs(cfg: ModelConfig, batch: int, seq: int
                      ) -> Dict[str, torch.Tensor]:
    """A train batch's inputs as ``meta`` tensors: ``tokens`` and
    ``labels`` [B,S] int32, plus ``frames`` [B,T,D] (encdec), or
    ``vision_embeds`` [B,P,D] and ``positions`` [3,B,S] int32 (vlm), of the
    compute dtype. An unknown family raises ``ValueError``."""
    if cfg.family != "encdec":
        transformer.layer_groups(cfg)
    i32, dt = torch.int32, cfg.dtype()
    specs = {k: torch.empty((batch, seq), dtype=i32, device="meta")
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        specs["frames"] = torch.empty(
            (batch, cfg.encdec.n_frames, cfg.d_model), dtype=dt,
            device="meta")
    if cfg.family == "vlm":
        specs["vision_embeds"] = torch.empty(
            (batch, cfg.n_vision_tokens, cfg.d_model), dtype=dt,
            device="meta")
        specs["positions"] = torch.empty((3, batch, seq), dtype=i32,
                                         device="meta")
    return specs


def serve_input_specs(cfg: ModelConfig, batch: int
                      ) -> Dict[str, torch.Tensor]:
    """One decode step's fresh inputs as ``meta`` tensors (the cache's
    come from ``Model.init_cache(..., device="meta")``)."""
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32,
                                  device="meta")}
