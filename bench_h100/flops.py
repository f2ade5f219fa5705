"""Frozen counts of model work, from a configuration file's ``run`` sizes
and a request's or a step's shape.

Model FLOPs count the products a model needs: 2 per multiply-add of every
weight a token passes through (the attention projections, the MLP or the
top-k experts and the router, and the LM head, tied or not; not the
embedding lookup), plus causal attention's QK and PV, 4·Dh per (query,
key) pair the mask leaves, for every head. Training counts three times
the forward (6·N·T and 3× the attention term). Nothing here reads the
program: a fusion or a dispatch that does extra work changes its time,
never this count.
"""
from __future__ import annotations

from typing import Any, Dict

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S


def _head_dim(run: Dict[str, Any]) -> int:
    return run.get("head_dim") or run["d_model"] // run["n_heads"]


def matmul_params_per_token(run: Dict[str, Any]) -> int:
    """Weights one token multiplies: every layer's projections, MLP or
    top-k experts and router, and the LM head."""
    d, f, hd = run["d_model"], run["d_ff"], _head_dim(run)
    h, hkv = run["n_heads"], run["n_kv_heads"]
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    gated = run.get("mlp", "swiglu") in ("swiglu", "geglu")
    mlp = d * f * (3 if gated else 2)
    if run.get("family") == "moe":
        moe = run["moe"]
        mlp = mlp * moe["top_k"] + d * moe["n_experts"]
    return run["n_layers"] * (attn + mlp) + d * run["vocab_size"]


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask leaves in a sequence of ``s``."""
    return s * (s + 1) // 2


def attention_flops(run: Dict[str, Any], batch: int, seq: int) -> float:
    """Forward QK and PV of every layer over the causal pairs."""
    return (4.0 * batch * run["n_heads"] * _head_dim(run) *
            causal_pairs(seq) * run["n_layers"])


def prefill_flops(run: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` sequences of ``seq``."""
    return (2.0 * matmul_params_per_token(run) * batch * seq +
            attention_flops(run, batch, seq))


def train_flops(run: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one train step: forward and backward, 3× the
    forward, no recompute counted."""
    return 3.0 * prefill_flops(run, batch, seq)


def flash_bound_s(run: Dict[str, Any], batch: int, seq: int,
                  elem_bytes: int = 2) -> float:
    """The least time of one causal flash-attention launch over ``batch``
    sequences of ``seq`` (one layer): the larger of its FLOPs at the bf16
    peak and its bytes (q, k, v read once, the output written once) at
    HBM's."""
    hd, h, hkv = _head_dim(run), run["n_heads"], run["n_kv_heads"]
    flops = 4.0 * batch * h * hd * causal_pairs(seq)
    nbytes = elem_bytes * batch * seq * hd * (2 * h + 2 * hkv)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
