"""Per-block stream compaction on the card (paper §4, Billeter et al.):
the port of the JAX package's
``kernels/stream_compact.py::pallas_local_compact``.

The kernel is ``csrc/local_compact.cu``: warp ``__ballot_sync`` +
``__popc`` place each survivor and a shuffle scan over the warp counts
gives each warp its base (the TPU version moves the block with a one-hot
permutation matrix instead). :func:`local_compact` takes the plain
version for CPU tensors and launches the kernel for CUDA tensors.
``ops.stream_compact`` gathers the blocks into one prefix-valid array.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "local_compact"]

KERNEL = CudaKernel(
    "local_compact", "local_compact.cu",
    {"local_compact": (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p)},
    replaces="src/repro/kernels/stream_compact.py:49")


@torch.library.custom_op("repro_torch::local_compact", mutates_args=())
def _local_compact_cuda(x: torch.Tensor, bs: int, drop_value: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    if not x.is_cuda:
        raise ValueError(f"local_compact kernel needs a CUDA tensor, got "
                         f"{x.device}")
    x = x.contiguous()
    n = x.shape[0]
    nb = -(-n // bs)
    blocks = torch.empty((nb, bs), dtype=torch.uint32, device=x.device)
    counts = torch.empty((nb, 1), dtype=torch.int32, device=x.device)
    if n:
        KERNEL.launch("local_compact", x.data_ptr(), n,
                      drop_value & 0xFFFFFFFF, bs, blocks.data_ptr(),
                      counts.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    return blocks, counts


@_local_compact_cuda.register_fake
def _(x, bs, drop_value):
    nb = -(-x.shape[0] // bs)
    return (x.new_empty((nb, bs), dtype=torch.uint32),
            x.new_empty((nb, 1), dtype=torch.int32))


def local_compact(x: torch.Tensor, *, bs: int = 256, drop_value: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(blocks[nb, bs] uint32, counts[nb, 1] int32)``; see
    :func:`repro_torch.kernels.ref.local_compact` for the contract."""
    if x.dim() != 1 or x.dtype != torch.uint32:
        raise TypeError(f"local_compact takes 1-d uint32 words, got "
                        f"{x.dtype}{list(x.shape)}")
    if bs % 32 or not 32 <= bs <= 1024:
        raise ValueError(f"local_compact block size {bs} must be a multiple "
                         "of 32 in 32..1024")
    if x.device.type == "cpu":
        return ref.local_compact(x, bs=bs, drop_value=drop_value)
    return _local_compact_cuda(x, bs, drop_value)
