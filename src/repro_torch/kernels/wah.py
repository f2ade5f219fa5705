"""WAH ``prepare_index`` on the card (paper §4, Listing 5): the port of
the JAX package's ``kernels/wah.py::pallas_wah_interleave``.

The kernel is ``csrc/wah_interleave.cu``: one 64-bit store per
fill/literal pair. :func:`wah_interleave` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "wah_interleave"]

KERNEL = CudaKernel(
    "wah_interleave", "wah_interleave.cu",
    {"wah_interleave": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_void_p)},
    replaces="src/repro/kernels/wah.py:28")


@torch.library.custom_op("repro_torch::wah_interleave", mutates_args=())
def _wah_interleave_cuda(fills: torch.Tensor, literals: torch.Tensor
                         ) -> torch.Tensor:
    if not (fills.is_cuda and literals.device == fills.device):
        raise ValueError(f"wah_interleave kernel needs both inputs on one "
                         f"CUDA device, got {fills.device} and "
                         f"{literals.device}")
    fills, literals = fills.contiguous(), literals.contiguous()
    n = fills.shape[0]
    out = torch.empty(2 * n, dtype=torch.uint32, device=fills.device)
    if n:
        KERNEL.launch("wah_interleave", fills.data_ptr(), literals.data_ptr(),
                      out.data_ptr(), n,
                      torch.cuda.current_stream(fills.device).cuda_stream)
    return out


@_wah_interleave_cuda.register_fake
def _(fills, literals):
    return fills.new_empty((2 * fills.shape[0],), dtype=torch.uint32)


def wah_interleave(fills: torch.Tensor, literals: torch.Tensor
                   ) -> torch.Tensor:
    """``out[2i] = fills[i]; out[2i+1] = literals[i]`` for uint32 words."""
    if fills.dim() != 1 or fills.shape != literals.shape or \
            fills.dtype != torch.uint32 or literals.dtype != torch.uint32:
        raise TypeError(f"wah_interleave takes two 1-d uint32 arrays of one "
                        f"length, got {fills.dtype}{list(fills.shape)} and "
                        f"{literals.dtype}{list(literals.shape)}")
    if fills.device.type == "cpu" and literals.device.type == "cpu":
        return ref.wah_interleave(fills, literals)
    return _wah_interleave_cuda(fills, literals)
