"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) —
the port of the JAX package's ``repro/models/rglru.py``.

The recurrence h_t = a_t · h_{t-1} + √(1−a_t²) · (i_t ⊙ x_t) is linear in
h. JAX runs it as a ``jax.lax.associative_scan``, which torch has no
eager counterpart of, and a loop over time would take one step per token
in every recurrent layer. Here it runs as a chunked scan: within a chunk
of ``RGLRU_CHUNK`` steps, h_t = Σ_{j≤t} exp(Σ_{j<i≤t} log a_i) b_j +
exp(Σ_{i≤t} log a_i) h_0, with h_0 the state carried in from the chunk
before; across chunks the state is carried by a Python loop. Every weight
lies in [0, 1], and each segment's sum of log a is taken on its own
(Mamba-2's segment sum). The form A_t · Σ_j b_j / A_j, with A the running product
of a, would overflow f32: log a_t reaches −72 a step here (the gate takes
−8 · softplus(Λ) · r), so 1/A_j passes 3e38 within two steps; and the
difference of two running sums of log a would cancel, since a fast
channel's running sum reaches thousands within a chunk. Decode is the
single-step recurrence against an (lru state, conv state) cache.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import normal

__all__ = ["RGLRU_CHUNK", "init_rglru", "apply_rglru", "init_rglru_cache",
           "decode_rglru"]

_C = 8.0  # Griffin's fixed gate sharpness
#: time steps a chunk of the scan: its [B, W, Q, Q] weights take 67 MB at
#: recurrentgemma-9b's width 4096 and batch 1
RGLRU_CHUNK = 64


def _width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype, device
               ) -> dict:
    """The two branches ``w_x``, ``w_y`` [d, W], the depthwise conv, the
    gates ``w_a``, ``w_i`` [W, W] with f32 biases ``b_a``, ``b_i``, the f32
    ``lam`` (Λ, so that a = sigmoid(Λ)^c lies in (0.9, 0.999) at r = 1,
    the paper's §2.4) and ``w_out`` [W, d]."""
    d = cfg.d_model
    w = _width(cfg)
    cw = cfg.hybrid.conv_width
    s = 1.0 / math.sqrt(d)
    lo, hi = 0.9 ** (1 / _C), 0.999 ** (1 / _C)
    u = torch.rand((w,), generator=gen, device=device) * (hi - lo) + lo
    return {
        "w_x": normal(gen, (d, w), s, dtype, device),
        "w_y": normal(gen, (d, w), s, dtype, device),
        "conv_w": normal(gen, (cw, w), 1.0 / math.sqrt(cw), dtype, device),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "w_a": normal(gen, (w, w), 1.0 / math.sqrt(w), dtype, device),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=device),
        "w_i": normal(gen, (w, w), 1.0 / math.sqrt(w), dtype, device),
        "b_i": torch.zeros((w,), dtype=torch.float32, device=device),
        "lam": torch.log(u / (1.0 - u)),
        "w_out": normal(gen, (w, d), 1.0 / math.sqrt(w), dtype, device),
    }


def _gates(params, x: torch.Tensor, matmul=torch.matmul
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log a, gated input b), both f32, for x [..., W]; ``matmul`` takes
    the two gate products."""
    from ..dist import api as dist_api
    xf = x.float()
    r = torch.sigmoid(dist_api.split_model(matmul(xf, params["w_a"].float()),
                                           -1) + params["b_a"])
    i = torch.sigmoid(dist_api.split_model(matmul(xf, params["w_i"].float()),
                                           -1) + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r           # log a_t, a in (0,1)
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return log_a, gated_x


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def _scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, for log a and b [B,S,W]
    f32, in chunks of RGLRU_CHUNK steps → h [B,S,W] f32."""
    bsz, s, w = b.shape
    la, bw = log_a.transpose(1, 2), b.transpose(1, 2)             # [B,W,S]
    h0 = torch.zeros((bsz, w), dtype=torch.float32, device=b.device)
    outs = []
    for c0 in range(0, s, RGLRU_CHUNK):
        x = la[:, :, c0:c0 + RGLRU_CHUNK]                         # [B,W,Q]
        q = x.shape[-1]
        t = torch.arange(q, device=b.device)
        # seg[t, j] = Σ_{j<i≤t} log a_i, each segment summed on its own
        seg = x[..., :, None].expand(*x.shape, q).masked_fill(
            t[:, None] <= t[None, :], 0.0).cumsum(dim=-2)
        weights = torch.exp(seg.masked_fill(t[:, None] < t[None, :],
                                            -torch.inf))          # [B,W,Q,Q]
        h = (weights @ bw[:, :, c0:c0 + q, None])[..., 0] + \
            torch.exp(torch.cumsum(x, dim=-1)) * h0[..., None]    # [B,W,Q]
        outs.append(h)
        h0 = h[..., -1]
    return torch.cat(outs, dim=-1).transpose(1, 2)


def apply_rglru(params, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence Griffin recurrent block. u: [B,S,D] → [B,S,D]."""
    from ..dist import api as dist_api
    u = dist_api.stream(u)
    x = _causal_conv(u @ params["w_x"], params["conv_w"], params["conv_b"])
    log_a, gx = _gates(params, x)                                 # [B,S,W]
    h = dist_api.local_map(_scan, log_a, gx, dim=2)   # each channel's own
    y = h.to(u.dtype) * F.gelu(u @ params["w_y"], approximate="tanh")
    return dist_api.stream(y @ params["w_out"])


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, n_layers: int,
                     device) -> dict:
    """``state`` [L,B,W] f32 and ``conv`` [L,B,CW-1,W] of ``dtype``."""
    w = _width(cfg)
    cw = cfg.hybrid.conv_width
    return {
        "state": torch.zeros((n_layers, batch, w), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_layers, batch, cw - 1, w), dtype=dtype,
                            device=device),
    }


def decode_rglru(params, cfg: ModelConfig, u: torch.Tensor, state, conv
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step. u: [B,1,D]; state: [B,W]; conv: [B,CW-1,W] → (y [B,1,D],
    new state, new conv); the inputs are not written."""
    from ..dist import api as dist_api
    u = dist_api.stream(u)
    xt = u[:, 0, :] @ params["w_x"]                               # [B,W]
    window = torch.cat([conv, xt[:, None, :].to(conv.dtype)], dim=1)
    new_conv = window[:, 1:, :]
    x = torch.einsum("bwc,wc->bc", window.float(),
                     params["conv_w"].float()) + params["conv_b"].float()
    log_a, gx = _gates(params, x, dist_api.idle_split_product)
    state = torch.exp(log_a) * state + gx
    y = state.to(u.dtype)[:, None, :] * F.gelu(u @ params["w_y"],
                                               approximate="tanh")
    return dist_api.stream(y @ params["w_out"]), state, new_conv
