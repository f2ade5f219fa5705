"""Plain PyTorch versions of the hand-written kernels.

Each function computes exactly what its kernel computes, with the output
contract of the JAX package's Pallas kernel (``repro/kernels/*.py``) or
oracle (``repro/kernels/ref.py``). The CPU tests run them, the kernel
wrappers take them for tensors that lie on the CPU, and ``chip_smoke.py``
holds each kernel against its plain version on the card.

uint32 words: PyTorch has ``torch.uint32`` but few operators for it (no
shifts, no ``index_put_``, no ordering comparisons on the CPU). Words move
through ``view(torch.int32)``, which is bit-exact, and arithmetic on them
runs in int64 (:func:`u32_to_i64` / :func:`i64_to_u32`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "u32_to_i64", "i64_to_u32",
    "matmul",
    "MandelbrotView", "mandelbrot_view", "mandelbrot_rows", "mandelbrot",
    "radix_pass", "radix_histogram", "radix_onesweep", "check_payload",
    "radix_sort_u32",
    "local_compact", "stream_compact",
    "wah_interleave",
    "flash_attention",
]


# ----------------------------------------------------------------------------
# uint32 helpers
# ----------------------------------------------------------------------------
def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """The unsigned values of a 32-bit word tensor, as int64."""
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"expected uint32 or int32 words, got {x.dtype}")
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2**32, as uint32 words."""
    return x.to(torch.int32).view(torch.uint32)


def _take(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` for any dtype, uint32 included."""
    if values.dtype == torch.uint32:
        return values.view(torch.int32)[idx].view(torch.uint32)
    return values[idx]


def _blocks(n: int, bs: int) -> int:
    return -(-n // bs)


# ----------------------------------------------------------------------------
# paper §3.3 — matrix product
# ----------------------------------------------------------------------------
def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in float32, cast to ``a``'s dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


# ----------------------------------------------------------------------------
# paper §5.4 — Mandelbrot iteration counts
# ----------------------------------------------------------------------------
class MandelbrotView(NamedTuple):
    """A frame's coordinate origin and steps, each an exact f32 value."""
    re_min: float
    im_min: float
    re_step: float
    im_step: float


def _f32(x: float) -> float:
    return float(np.float32(x))


def mandelbrot_view(width: int, total_height: int, re_min: float,
                    re_max: float, im_min: float, im_max: float
                    ) -> MandelbrotView:
    """The steps of a ``total_height x width`` frame, computed in double
    and rounded to f32 once, with the origin rounded to f32 — what the
    JAX package's weakly typed Python floats become
    (``repro/kernels/ops.py:72-75``)."""
    return MandelbrotView(
        _f32(re_min), _f32(im_min),
        _f32((re_max - re_min) / max(width - 1, 1)),
        _f32((im_max - im_min) / max(total_height - 1, 1)))


def mandelbrot_rows(height: int, width: int, max_iter: int,
                    view: MandelbrotView, row_offset: int, device
                    ) -> torch.Tensor:
    """int32 counts of rows ``[row_offset, row_offset + height)`` under
    ``view``, on ``device``: coordinates ``re_min + x * re_step`` and
    ``im_min + y * im_step``, each operation rounded to f32, then
    :func:`mandelbrot`."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device) + row_offset
    re0 = f32(view.re_min) + x * f32(view.re_step)
    im0 = f32(view.im_min) + y * f32(view.im_step)
    return mandelbrot(re0[None, :], im0[:, None], max_iter)


def mandelbrot(re0: torch.Tensor, im0: torch.Tensor, max_iter: int
               ) -> torch.Tensor:
    """int32 iteration counts of z <- z^2 + c until |z| > 2, for
    broadcastable f32 coordinate grids: a masked loop of elementwise ops,
    each rounded to f32, in the JAX oracle's order."""
    re0, im0 = torch.broadcast_tensors(re0, im0)
    zr = torch.zeros_like(re0)
    zi = torch.zeros_like(re0)
    count = torch.zeros(re0.shape, dtype=torch.int32, device=re0.device)
    for _ in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        alive = (zr2 + zi2) <= 4.0
        new_zr = zr2 - zi2 + re0
        new_zi = 2.0 * zr * zi + im0
        zr = torch.where(alive, new_zr, zr)
        zi = torch.where(alive, new_zi, zi)
        count += alive
    return count


# ----------------------------------------------------------------------------
# paper §4 — LSD radix sort
# ----------------------------------------------------------------------------
def radix_pass(x: torch.Tensor, *, bs: int = 256, bits: int = 8,
               shift: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One digit pass: ``(hist[nb, 2**bits], rank[nb, bs])``, both int32.

    ``hist[b, d]`` counts the keys of block ``b`` whose digit
    ``(x >> shift) & (2**bits - 1)`` is ``d``; ``rank`` is each key's
    stable rank among its block's keys with the same digit. For a length
    that ``bs`` does not divide, the last block's missing lanes count
    nowhere and get rank 0.
    """
    n = x.shape[0]
    nb, nbins = _blocks(n, bs), 1 << bits
    digit = (u32_to_i64(x) >> shift) & (nbins - 1)
    digit = torch.cat([digit, digit.new_full((nb * bs - n,), nbins)])
    # one group per (block, digit); digit nbins marks padding lanes
    key = torch.arange(nb * bs, device=x.device) // bs * (nbins + 1) + digit
    counts = torch.bincount(key, minlength=nb * (nbins + 1))
    start = torch.cumsum(counts, 0) - counts
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel(), device=x.device) - start[key[order]]
    rank = torch.where(digit == nbins, 0, rank)
    hist = counts.reshape(nb, nbins + 1)[:, :nbins]
    return hist.to(torch.int32), rank.reshape(nb, bs).to(torch.int32)


def radix_histogram(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """``hist[32 // bits, 2**bits]`` int32: row ``p`` counts the keys whose
    digit ``(key >> p * bits) & (2**bits - 1)`` is each value."""
    k, nbins = u32_to_i64(keys), 1 << bits
    return torch.stack([torch.bincount((k >> p * bits) & (nbins - 1),
                                       minlength=nbins)
                        for p in range(32 // bits)]).to(torch.int32)


def radix_onesweep(keys: torch.Tensor, idx: Optional[torch.Tensor],
                   digit_counts: torch.Tensor, bits: int, shift: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable LSD pass: ``keys`` and their int32 payload ``idx`` (each
    key's position where ``idx`` is None) ordered by the digit
    ``(key >> shift) & (2**bits - 1)``, equal digits in input order.
    ``digit_counts`` must be the keys' count of each digit (the pass's row
    of :func:`radix_histogram`): the kernel starts each digit's run at its
    exclusive scan, where a stable sort puts it; a ValueError says when it
    is not."""
    digit = (u32_to_i64(keys) >> shift) & ((1 << bits) - 1)
    if not torch.equal(torch.bincount(digit, minlength=1 << bits),
                       digit_counts.to(torch.int64)):
        raise ValueError("digit_counts is not the keys' digit histogram")
    order = torch.argsort(digit, stable=True)
    if idx is None:
        return _take(keys, order), order.to(torch.int32)
    return _take(keys, order), idx[order]


def check_payload(values: Optional[torch.Tensor]) -> None:
    """A radix sort's payload is 1-d: :class:`ValueError` otherwise."""
    if values is not None and values.ndim != 1:
        raise ValueError(f"radix_sort takes a 1-d payload, got shape "
                         f"{tuple(values.shape)}")


def radix_sort_u32(keys: torch.Tensor, values: Optional[torch.Tensor] = None,
                   bits_per_pass: int = 16):
    """Stable LSD radix sort of uint32 keys (optionally with a payload),
    one stable argsort per digit pass. The payload must be 1-d
    (:class:`ValueError` otherwise), as in ``ops.radix_sort``."""
    check_payload(values)
    if 32 % bits_per_pass:
        raise ValueError(f"bits_per_pass={bits_per_pass} must divide 32")
    k = u32_to_i64(keys)
    idx = torch.arange(k.shape[0], device=keys.device)
    for p in range(32 // bits_per_pass):
        digit = (k >> (p * bits_per_pass)) & ((1 << bits_per_pass) - 1)
        order = torch.argsort(digit, stable=True)
        k = k[order]
        idx = idx[order]
    k = i64_to_u32(k)
    if values is None:
        return k
    return k, _take(values, idx)


# ----------------------------------------------------------------------------
# paper §4 — stream compaction (Billeter et al.)
# ----------------------------------------------------------------------------
def local_compact(x: torch.Tensor, *, bs: int = 256, drop_value: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block compaction: ``(blocks[nb, bs] uint32, counts[nb, 1]
    int32)``; ``blocks[b, :counts[b]]`` are block ``b``'s words that differ
    from ``drop_value``, in order, followed by zeros. Missing lanes of a
    ragged last block count as dropped."""
    n = x.shape[0]
    nb = _blocks(n, bs)
    pad = nb * bs - n
    vals = u32_to_i64(x)
    keep = vals != (drop_value & 0xFFFFFFFF)
    keep = torch.cat([keep, keep.new_zeros(pad)]).reshape(nb, bs)
    vals = torch.cat([vals, vals.new_zeros(pad)]).reshape(nb, bs)
    cnt = keep.sum(1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    out = torch.gather(vals, 1, order)
    lane = torch.arange(bs, device=x.device)
    out = torch.where(lane[None, :] < cnt[:, None], out, 0)
    return i64_to_u32(out), cnt.to(torch.int32)[:, None]


def stream_compact(x: torch.Tensor, drop_value: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Remove every word equal to ``drop_value``.

    Returns ``(compacted, count)``: ``compacted`` has the input's length
    and dtype with the ``count`` survivors first, in order, then zeros
    (the prefix-valid layout of the JAX package); ``count`` is a 0-d int32
    tensor.
    """
    vals = u32_to_i64(x)
    valid = vals != (drop_value & 0xFFFFFFFF)
    count = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    i = torch.arange(x.shape[0], device=x.device)
    out = torch.where(i < count, vals[order], 0)
    return i64_to_u32(out).view(x.dtype), count.to(torch.int32)


# ----------------------------------------------------------------------------
# paper §4 — fuseFillsLiterals 'prepare_index': interleave fills & literals
# ----------------------------------------------------------------------------
def wah_interleave(fills: torch.Tensor, literals: torch.Tensor) -> torch.Tensor:
    """``out[2i] = fills[i]; out[2i+1] = literals[i]`` (length 2n)."""
    if fills.shape != literals.shape:
        raise ValueError(f"shapes differ: {tuple(fills.shape)} vs "
                         f"{tuple(literals.shape)}")
    pair = torch.stack([fills.view(torch.int32),
                        literals.view(torch.int32)], dim=1)
    return pair.reshape(-1).view(fills.dtype)


# ----------------------------------------------------------------------------
# LM prefill — attention with an online-softmax kernel
# ----------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``[B,H,Sq,D]`` over k, v ``[B,Hkv,Skv,D]`` (GQA when
    Hkv divides H) in f32, cast to q's dtype. Query positions are
    right-aligned (``Skv - Sq`` ahead of the keys'); ``window`` keeps the
    last ``window`` positions. A query that sees no key gives 0 — the
    kernel's rule; the JAX oracle gives NaN there."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > (qpos - window)
    logits = logits.masked_fill(~mask, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = probs.masked_fill(~mask.any(-1)[:, None], 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)
