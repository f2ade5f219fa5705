"""Public operators of the kernel layer.

Each operator runs on the device of the tensors it is given. For a CPU
tensor the kernel wrappers (:mod:`.matmul`, :mod:`.radix_sort`,
:mod:`.stream_compact`, :mod:`.wah`, :mod:`.flash_attention`) take their
plain versions; for a CUDA tensor they launch the hand-written kernels
or raise, with no other path. :func:`mandelbrot` takes no tensor: it runs on the ``device`` it is
given, by default the current CUDA device (``LookupError`` without one).
``impl="ref"`` is the explicit choice of the whole plain version
(:mod:`.ref`), which the tests and ``chip_smoke.py`` compare against.

The JAX package leaves the global halves around its Pallas kernels to
XLA (``repro/kernels/ops.py:92-103`` and ``:122-134``). The compaction
gather over the per-block outputs stays a plain PyTorch operator here;
the radix sort's digit offsets and scatter run inside its onesweep
kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.memref import default_device
from . import ref
from .flash_attention import flash_attention as _flash_attention_kernel
from .mandelbrot import mandelbrot as _mandelbrot_kernel
from .matmul import matmul as _matmul_kernel
from .radix_sort import OnesweepScratch, radix_histogram, radix_onesweep
from .ref import _take
from .stream_compact import local_compact
from .wah import wah_interleave as _wah_interleave_kernel

__all__ = ["matmul", "mandelbrot", "stream_compact", "compact_gather",
           "radix_sort", "wah_interleave", "flash_attention"]

_IMPLS = ("auto", "ref")


def _plain(impl: str) -> bool:
    if impl not in _IMPLS:
        raise ValueError(f"impl={impl!r}; expected one of {_IMPLS}")
    return impl == "ref"


# ----------------------------------------------------------------------------
def matmul(a: torch.Tensor, b: torch.Tensor, *, impl: str = "auto"
           ) -> torch.Tensor:
    """``a @ b`` accumulated in f32, cast to ``a``'s dtype."""
    if _plain(impl):
        return ref.matmul(a, b)
    return _matmul_kernel(a, b)


# ----------------------------------------------------------------------------
def mandelbrot(*, height: int, width: int, max_iter: int,
               re_min: float, re_max: float, im_min: float, im_max: float,
               row_offset: int = 0, total_height: Optional[int] = None,
               impl: str = "auto", device=None) -> torch.Tensor:
    """int32 escape counts of rows ``[row_offset, row_offset + height)``
    of a ``total_height x width`` frame (paper §5.4), on ``device``."""
    device = default_device() if device is None else torch.device(device)
    th = total_height if total_height is not None else height
    view = ref.mandelbrot_view(width, th, re_min, re_max, im_min, im_max)
    if _plain(impl):
        return ref.mandelbrot_rows(height, width, max_iter, view, row_offset,
                                   device)
    return _mandelbrot_kernel(height=height, width=width, max_iter=max_iter,
                              view=view, row_offset=row_offset,
                              device=device)


# ----------------------------------------------------------------------------
def compact_gather(blocks: torch.Tensor, counts: torch.Tensor, n: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Billeter's phase 3 as one gather: output ``i`` comes from block
    ``searchsorted(offsets, i)`` at local index ``i - offsets[block]``.
    Returns the prefix-valid uint32 array of length ``n`` and the 0-d
    int32 survivor count."""
    nb, bs = blocks.shape
    counts = counts.reshape(-1).to(torch.int64)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    total = offsets[-1]
    i = torch.arange(n, device=blocks.device)
    blk = (torch.searchsorted(offsets, i, right=True) - 1).clamp(0, nb - 1)
    local = (i - offsets[blk]).clamp(0, bs - 1)
    vals = blocks.view(torch.int32)[blk, local]
    out = torch.where(i < total, vals, 0)
    return out.view(torch.uint32), total.to(torch.int32)


def stream_compact(x: torch.Tensor, *, bs: int = 256, drop_value: int = 0,
                   impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Compacted array (prefix-valid layout, ``x``'s dtype) + surviving
    count. ``x`` holds 32-bit integer words (uint32 or int32) on both
    paths; any other dtype raises :class:`TypeError`."""
    _check_words(x)
    if _plain(impl):
        return ref.stream_compact(x, drop_value)
    blocks, counts = local_compact(x.view(torch.uint32), bs=bs,
                                   drop_value=drop_value)
    out, total = compact_gather(blocks, counts, x.shape[0])
    return out.view(x.dtype), total


def _check_words(x: torch.Tensor) -> None:
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"stream_compact takes uint32 or int32 words, got "
                        f"{x.dtype}")


# ----------------------------------------------------------------------------
def radix_sort(keys: torch.Tensor, values: Optional[torch.Tensor] = None, *,
               bits_per_pass: int = 8, bs: int = 256, impl: str = "auto"):
    """Stable LSD radix sort of uint32 keys (+ optional payload).

    One :func:`radix_histogram` gives every pass's digit counts; each of
    the ``32 // bits_per_pass`` passes is one :func:`radix_onesweep` of the
    keys and an int32 payload. A 1-d payload of 32-bit words (``values``
    of the keys' length in int32, uint32 or float32) rides through the
    passes as it is; any other payload is gathered at the end
    (``jnp.take(values, idx)`` in the JAX package) by an index that the
    passes carry, and that the first pass makes from the positions. A CPU
    tensor runs the same steps through the plain versions.

    ``bs`` is accepted for the JAX signature and unused: a onesweep tile is
    the kernel's own (``radix_sort.TILE`` keys). Digits wider than 8 bits
    take the plain sort, as in the JAX package
    (``repro/kernels/ops.py:113``).

    A payload that is not 1-d raises :class:`ValueError` on both paths:
    the JAX package's ``jnp.take`` with no axis reads such a payload
    flattened and mixes its rows, which the port does not copy.
    """
    if _plain(impl) or bits_per_pass > 8:
        return ref.radix_sort_u32(keys, values, bits_per_pass=bits_per_pass)
    ref.check_payload(values)
    if 32 % bits_per_pass:
        raise ValueError(f"bits_per_pass={bits_per_pass} must divide 32")
    n, passes = keys.shape[0], 32 // bits_per_pass
    hist = radix_histogram(keys, bits=bits_per_pass)
    scratch = (None if keys.device.type == "cpu" else
               OnesweepScratch(n, bits_per_pass, keys.device, passes))
    carried = (values is not None and values.shape == keys.shape and
               values.element_size() == 4)
    k, payload = keys, (values.view(torch.int32) if carried else None)
    for p in range(passes):
        k, payload = radix_onesweep(k, payload, hist[p], bits_per_pass,
                                    p * bits_per_pass, scratch=scratch)
    if values is None:
        return k
    if carried:
        return k, payload.view(values.dtype)
    return k, _take(values, payload)


# ----------------------------------------------------------------------------
def wah_interleave(fills: torch.Tensor, literals: torch.Tensor, *,
                   impl: str = "auto") -> torch.Tensor:
    """``out[2i] = fills[i]; out[2i+1] = literals[i]``."""
    if _plain(impl):
        return ref.wah_interleave(fills, literals)
    return _wah_interleave_kernel(fills, literals)


# ----------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, impl: str = "auto"
                    ) -> torch.Tensor:
    """Online-softmax attention, q ``[B,H,Sq,D]``, k/v ``[B,Hkv,Skv,D]``,
    the logits times ``scale`` (None: 1/√D); a query that sees no key
    gives 0."""
    if _plain(impl):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return _flash_attention_kernel(q, k, v, causal=causal, window=window,
                                   scale=scale)
