"""Matrix product on the card (paper §3.3): the port of the JAX package's
``kernels/matmul.py::pallas_matmul``.

The kernel is ``csrc/matmul.cu``, a shared-memory tiled SIMT product with
an f32 accumulator, for f32 and bf16 operands of any shape; its header
says what bounds it and how it is laid out. :func:`matmul` takes the
plain version for CPU tensors and launches the kernel for CUDA tensors;
there is no other path.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "matmul"]

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_FN = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}

KERNEL = CudaKernel("matmul", "matmul.cu",
                    {"matmul_f32": _ARGS, "matmul_bf16": _ARGS},
                    replaces="src/repro/kernels/matmul.py:39")


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _FN:
        raise TypeError(f"matmul kernel takes f32 or bf16 pairs, got "
                        f"{a.dtype} and {b.dtype}")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel():
        KERNEL.launch(_FN[a.dtype], a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      m, n, k, torch.cuda.current_stream(a.device).cuda_stream)
    return c


@_matmul_cuda.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 and cast to ``a``'s dtype."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul(a, b)
    return _matmul_cuda(a, b)
