"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060) — the port of
the JAX package's ``repro/models/ssm.py``.

Chunked SSD: within a chunk the recurrence is a masked attention-like
quadratic form, and across chunks the [H, N, P] state is carried. JAX
runs the quadratic forms for all chunks at once and the carry as a
``lax.scan``; here one Python loop over the chunks does both, so a
chunk's [B, Q, Q, H] decay matrix is the largest intermediate. Decode is
the pure recurrence against a (state, conv) cache. Attention-free.

While recording (:mod:`repro_torch.trace`) a full-sequence mixer runs in
spans ``ssm.in`` (the input projection), ``ssm.conv`` (the causal conv),
``ssm.scan`` (the chunk loop, the skip and the gate) and ``ssm.out`` (the
gated norm and ``out_proj``), and counts the chunks it runs, ``ssm.chunks``
(one a chunk and sequence batch), on the host, and on a CUDA device the
card's ns over each ``ssm.scan``, ``ssm.scan_device_ns``
(:func:`trace.device_time`).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import trace
from ..configs.base import ModelConfig
from .layers import apply_norm, init_norm, normal

__all__ = ["init_ssm", "apply_ssm", "init_ssm_cache", "decode_ssm"]


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    di = cfg.ssm.expand * d
    n = cfg.ssm.state_dim
    p = cfg.ssm.head_dim
    h = di // p
    g = cfg.ssm.n_groups
    conv_dim = di + 2 * g * n
    return d, di, n, p, h, g, conv_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """``in_proj`` [d, 2·di + 2·g·N + H] (order: z | xBC | dt), the
    depthwise ``conv_w`` [W, C] and ``conv_b``, the f32 ``a_log``,
    ``d_skip`` and ``dt_bias`` [H], the gated RMSNorm and ``out_proj``."""
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    w = cfg.ssm.conv_width
    return {
        "in_proj": normal(gen, (d, 2 * di + 2 * g * n + h),
                          1.0 / math.sqrt(d), dtype, device),
        "conv_w": normal(gen, (w, conv_dim), 1.0 / math.sqrt(w), dtype,
                         device),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=device)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": init_norm(di, "rmsnorm", dtype, device),
        "out_proj": normal(gen, (di, d), 1.0 / math.sqrt(di), dtype, device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU. xbc: [B,S,C]; w: [W,C]."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di:di + conv_dim],
            zxbcdt[..., di + conv_dim:])


def apply_ssm(params, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD. u: [B,S,D] → [B,S,D]; S must be a multiple of
    the chunk ``min(cfg.ssm.chunk, S)``."""
    from ..dist import api as dist_api
    u = dist_api.stream(u)
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    b, s, _ = u.shape
    q = min(cfg.ssm.chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is no multiple of the SSD chunk {q}")

    # the split points of z | xBC | dt do not fall on the projection's
    # shards: it is gathered once, and each device mixes its own heads
    with trace.span("ssm.in"):
        zxbcdt = dist_api.unshard(
            dist_api.split_product(u, params["in_proj"]), -1)
    y = dist_api.local_heads(
        functools.partial(_mix, cfg=cfg, q=q), h, (zxbcdt,),
        [params[k] for k in ("conv_w", "conv_b", "dt_bias", "a_log",
                             "d_skip")])                          # [B,S,H,P]
    with trace.span("ssm.out"):
        # split evenly again for the row-parallel out_proj (heads that the
        # model axis does not divide were gathered to flatten them)
        y = dist_api.split_model(dist_api.flatten(y, 2, 3), -1)
        y = apply_norm(params["norm"], y, "rmsnorm", cfg.norm_eps)
        return dist_api.stream(y @ params["out_proj"])


def _mix(part: slice, zxbcdt, conv_w, conv_b, dt_bias, a_log, d_skip, *,
         cfg: ModelConfig, q: int) -> torch.Tensor:
    """The SSD mixer of the heads ``part`` from the input projection
    ``zxbcdt`` [B,S,·]: the causal conv, the chunked recurrence, the skip
    and the gate → [B,S,heads,P], before the gated norm."""
    p = cfg.ssm.head_dim
    cols = slice(part.start * p, part.stop * p)
    z, xbc, dt = _split(cfg, zxbcdt)
    with trace.span("ssm.conv"):
        xbc = _causal_conv(xbc, conv_w, conv_b)
    with trace.span("ssm.scan"), \
            trace.device_time("ssm.scan_device_ns", xbc.device):
        return _scan(z, xbc, dt, dt_bias, a_log, d_skip, part, cols,
                     cfg=cfg, q=q)


def _scan(z, xbc, dt, dt_bias, a_log, d_skip, heads: slice, cols: slice, *,
          cfg: ModelConfig, q: int) -> torch.Tensor:
    """The heads ``heads`` (x channels ``cols``) of the conv's output
    ``xbc``: the chunked recurrence, the skip and the gate by ``z`` →
    [B,S,heads,P] in ``z``'s dtype."""
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    b, s = xbc.shape[:2]
    hl = heads.stop - heads.start
    x = xbc[..., :di][..., cols].reshape(b, s, hl, p)
    # groups broadcast over heads
    bmat = xbc[..., di:di + g * n].reshape(b, s, g, n).repeat_interleave(
        h // g, dim=2)[:, :, heads].float()                      # [B,S,H,N]
    cmat = xbc[..., di + g * n:].reshape(b, s, g, n).repeat_interleave(
        h // g, dim=2)[:, :, heads].float()

    dt = F.softplus(dt[..., heads].float() + dt_bias[heads])      # [B,S,H]
    delta = dt * -torch.exp(a_log[heads])                         # log decay
    xw = x.float() * dt[..., None]                                # [B,S,H,P]
    y = _ssd_chunks(cmat, bmat, xw, delta, q=q)                   # [B,S,H,P]
    y = y + x.float() * d_skip[heads][None, None, :, None]
    return y.to(z.dtype) * F.silu(z[..., cols]).reshape(b, s, hl, p)


def _ssd_chunks(cmat, bmat, xw, delta, *, q: int) -> torch.Tensor:
    """The SSD recurrence over chunks of ``q`` steps from a zero state:
    ``cmat``, ``bmat`` [B,S,H,N], ``xw`` [B,S,H,P] and the log decays
    ``delta`` [B,S,H], all f32 → y [B,S,H,P] f32. Each head and each
    sequence is computed on its own."""
    b, s, h, n = bmat.shape
    p = xw.shape[-1]
    t = torch.arange(q, device=xw.device)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xw.device)
    if trace.enabled():
        trace.count("ssm.chunks", s // q)
    ys = []
    for c0 in range(0, s, q):
        cm, bm = cmat[:, c0:c0 + q], bmat[:, c0:c0 + q]
        xc = xw[:, c0:c0 + q]
        dl = delta[:, c0:c0 + q]                                  # [B,Q,H]
        cum = torch.cumsum(dl, dim=1)
        # intra-chunk: scores[i,j] = (C_i·B_j) exp(Σ_{j<k≤i} delta_k), j ≤ i.
        # Each segment is summed on its own (Mamba-2's segment sum): the
        # difference cum_i - cum_j of two running sums that reach -10^3 in
        # a chunk would cancel to a few bits. The mask is on the exponent
        # (not the result), so masked entries get a zero gradient instead
        # of 0·inf = NaN in the backward pass.
        seg = dl[:, :, None, :].expand(b, q, q, h).masked_fill(
            (t[:, None] <= t[None, :])[None, :, :, None], 0.0).cumsum(dim=1)
        decay = torch.exp(seg.masked_fill(
            (t[:, None] < t[None, :])[None, :, :, None], -1e30))  # [B,Q,Q,H]
        cb = torch.einsum("bihn,bjhn->bijh", cm, bm)
        y = torch.einsum("bijh,bjhp->bihp", cb * decay, xc)
        # inter-chunk: y_i += C_i · (exp(cum_i) · S_prev)
        y = y + torch.einsum("bihn,bhnp,bih->bihp", cm, state, torch.exp(cum))
        ys.append(y)
        # the chunk's state: Σ_j exp(Σ_{j<k<Q} delta_k) B_j ⊗ xw_j, the
        # tail sums taken from the chunk's end
        rev = torch.flip(torch.cumsum(torch.flip(dl, [1]), 1), [1])
        tail = torch.exp(F.pad(rev[:, 1:], (0, 0, 0, 1)))          # [B,Q,H]
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + \
            torch.einsum("bjh,bjhn,bjhp->bhnp", tail, bm, xc)
    return torch.cat(ys, dim=1)


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, n_layers: int,
                   device) -> dict:
    """``state`` [L,B,H,N,P] f32 and ``conv`` [L,B,W-1,C] of ``dtype``."""
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    w = cfg.ssm.conv_width
    return {
        "state": torch.zeros((n_layers, batch, h, n, p), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_layers, batch, w - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def decode_ssm(params, cfg: ModelConfig, u: torch.Tensor, state, conv
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step. u: [B,1,D]; state: [B,H,N,P]; conv: [B,W-1,C] → (y
    [B,1,D], new state, new conv); the inputs are not written."""
    from ..dist import api as dist_api
    u = dist_api.stream(u)
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    zxbcdt = dist_api.unshard(
        dist_api.split_product(u[:, 0, :], params["in_proj"]), -1)
    xbc = _split(cfg, zxbcdt)[1]
    window = torch.cat([conv, xbc[:, None, :].to(conv.dtype)], dim=1)
    new_conv = window[:, 1:, :]
    # each device steps its own heads; the new state stays split by them
    y, state = dist_api.local_heads(
        functools.partial(_step, cfg=cfg), h, (zxbcdt, window),
        [params[k] for k in ("conv_w", "conv_b", "dt_bias", "a_log",
                             "d_skip")], dims=(1, 1), split=(state,))
    y = dist_api.split_model(dist_api.flatten(y, 1, 2), -1)
    y = apply_norm(params["norm"], y, "rmsnorm", cfg.norm_eps)
    return dist_api.stream((y @ params["out_proj"])[:, None, :]), state, \
        new_conv


def _step(part: slice, zxbcdt, window, state, conv_w, conv_b, dt_bias,
          a_log, d_skip, *, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step of the heads ``part``: (their gated output
    [B,heads,P] in ``zxbcdt``'s dtype, before the norm, and their new
    state [B,heads,N,P]) from the projection ``zxbcdt`` [B,·], the conv
    ``window`` [B,W,C] and their old ``state`` [B,heads,N,P]. The conv
    runs on the heads' own x channels and every B/C channel."""
    d, di, n, p, h, g, conv_dim = _dims(cfg)
    b = zxbcdt.shape[0]
    heads, cols = part, slice(part.start * p, part.stop * p)
    xl = (part.stop - part.start) * p
    z, _, dt = _split(cfg, zxbcdt)
    if xl < di:
        keep = torch.cat([torch.arange(di, device=window.device)[cols],
                          torch.arange(di, conv_dim, device=window.device)])
        window, conv_w, conv_b = window[..., keep], conv_w[:, keep], \
            conv_b[keep]
    xbc = F.silu(torch.einsum("bwc,wc->bc", window.float(), conv_w.float())
                 + conv_b.float())
    x = xbc[:, :xl].reshape(b, -1, p)
    bm = xbc[:, xl:xl + g * n].reshape(b, g, n).repeat_interleave(
        h // g, 1)[:, heads]
    cm = xbc[:, xl + g * n:].reshape(b, g, n).repeat_interleave(
        h // g, 1)[:, heads]

    dt = F.softplus(dt[:, heads].float() + dt_bias[heads])        # [B,H]
    decay = torch.exp(dt * -torch.exp(a_log[heads]))              # [B,H]
    xw = x * dt[..., None]                                        # [B,H,P]
    state = state * decay[..., None, None] + \
        torch.einsum("bhn,bhp->bhnp", bm, xw)
    y = torch.einsum("bhn,bhnp->bhp", cm, state) + \
        x * d_skip[heads][None, :, None]
    return y.to(zxbcdt.dtype) * F.silu(z[:, cols]).reshape(b, -1, p), state
