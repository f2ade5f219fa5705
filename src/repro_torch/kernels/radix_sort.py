"""One LSD radix-sort digit pass on the card (paper §4): the port of the
JAX package's ``kernels/radix_sort.py::pallas_radix_pass``.

The kernel is ``csrc/radix_pass.cu``: warp ``__match_any_sync`` votes
give each key its stable rank and a per-warp count table in shared memory
gives the block's histogram (the TPU version needs one-hot matrix
products for both). :func:`radix_pass` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors. ``ops.radix_sort``
turns the pass's outputs into global destinations and scatters the keys.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "radix_pass"]

KERNEL = CudaKernel(
    "radix_pass", "radix_pass.cu",
    {"radix_pass": (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p)},
    replaces="src/repro/kernels/radix_sort.py:52")


def _check(x: torch.Tensor, bs: int, bits: int, shift: int) -> None:
    if x.dim() != 1 or x.dtype != torch.uint32:
        raise TypeError(f"radix_pass takes 1-d uint32 keys, got "
                        f"{x.dtype}{list(x.shape)}")
    if not 1 <= bits <= 8 or not 0 <= shift <= 32 - bits:
        raise ValueError(f"radix_pass digit bits={bits} shift={shift} must "
                         "be 1..8 bits inside the 32-bit key")
    if bs % 32 or not 32 <= bs <= 1024:
        raise ValueError(f"radix_pass block size {bs} must be a multiple of "
                         "32 in 32..1024")


@torch.library.custom_op("repro_torch::radix_pass", mutates_args=())
def _radix_pass_cuda(x: torch.Tensor, bs: int, bits: int, shift: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not x.is_cuda:
        raise ValueError(f"radix_pass kernel needs a CUDA tensor, got {x.device}")
    x = x.contiguous()
    n = x.shape[0]
    nb = -(-n // bs)
    hist = torch.empty((nb, 1 << bits), dtype=torch.int32, device=x.device)
    rank = torch.empty((nb, bs), dtype=torch.int32, device=x.device)
    if n:
        KERNEL.launch("radix_pass", x.data_ptr(), n, shift, bits, bs,
                      hist.data_ptr(), rank.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return hist, rank


@_radix_pass_cuda.register_fake
def _(x, bs, bits, shift):
    nb = -(-x.shape[0] // bs)
    return (x.new_empty((nb, 1 << bits), dtype=torch.int32),
            x.new_empty((nb, bs), dtype=torch.int32))


def radix_pass(x: torch.Tensor, *, bs: int = 256, bits: int = 8,
               shift: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hist[nb, 2**bits], rank[nb, bs])`` int32 for one digit of ``x``;
    see :func:`repro_torch.kernels.ref.radix_pass` for the contract."""
    _check(x, bs, bits, shift)
    if x.device.type == "cpu":
        return ref.radix_pass(x, bs=bs, bits=bits, shift=shift)
    return _radix_pass_cuda(x, bs, bits, shift)
