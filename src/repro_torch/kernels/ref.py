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

from typing import Optional, Tuple

import torch

__all__ = [
    "u32_to_i64", "i64_to_u32",
    "matmul",
    "radix_pass", "radix_sort_u32",
    "local_compact", "stream_compact",
    "wah_interleave",
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


def radix_sort_u32(keys: torch.Tensor, values: Optional[torch.Tensor] = None,
                   bits_per_pass: int = 16):
    """Stable LSD radix sort of uint32 keys (optionally with a payload),
    one stable argsort per digit pass."""
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
