"""Mandelbrot escape-time counts on the card (paper §5.4): the port of the
JAX package's ``kernels/mandelbrot.py::pallas_mandelbrot``.

The kernel is ``csrc/mandelbrot.cu``: one thread per pixel, rounding
after every f32 operation so that it equals the plain version bit for
bit. It takes no input tensor, so :func:`mandelbrot` names its device;
for the CPU it takes the plain version, for a CUDA device it launches the
kernel, with no other path.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "mandelbrot"]

KERNEL = CudaKernel(
    "mandelbrot", "mandelbrot.cu",
    {"mandelbrot": (ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_float,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p)},
    replaces="src/repro/kernels/mandelbrot.py:54")

#: grid rows are one CUDA grid dimension (at most 65535 blocks)
_MAX_ROWS = 65535


@torch.library.custom_op("repro_torch::mandelbrot", mutates_args=())
def _mandelbrot_cuda(device: torch.device, height: int, width: int,
                     row_offset: int, max_iter: int, re_min: float,
                     im_min: float, re_step: float, im_step: float
                     ) -> torch.Tensor:
    if device.type != "cuda":
        raise ValueError(f"mandelbrot kernel needs a CUDA device, got {device}")
    out = torch.empty((height, width), dtype=torch.int32, device=device)
    if out.numel():
        KERNEL.launch("mandelbrot", out.data_ptr(), height, width, row_offset,
                      max_iter, re_min, im_min, re_step, im_step,
                      torch.cuda.current_stream(device).cuda_stream)
    return out


@_mandelbrot_cuda.register_fake
def _(device, height, width, row_offset, max_iter, re_min, im_min, re_step,
      im_step):
    return torch.empty((height, width), dtype=torch.int32, device=device)


def mandelbrot(*, height: int, width: int, max_iter: int,
               view: ref.MandelbrotView, row_offset: int = 0,
               device: torch.device) -> torch.Tensor:
    """int32 ``[height, width]`` counts of rows ``[row_offset, row_offset +
    height)`` under ``view`` (:func:`~repro_torch.kernels.ref.mandelbrot_view`)."""
    if height < 0 or width < 0 or row_offset < 0:
        raise ValueError(f"mandelbrot rows [{row_offset}, {row_offset}+"
                         f"{height}) x {width} columns")
    if height > _MAX_ROWS or row_offset + height >= 1 << 24:
        raise ValueError(f"mandelbrot takes at most {_MAX_ROWS} rows per "
                         f"call below row 2**24, got {height} at {row_offset}")
    device = torch.device(device)
    if device.type == "cpu":
        return ref.mandelbrot_rows(height, width, max_iter, view, row_offset,
                                   device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _mandelbrot_cuda(device, height, width, row_offset, max_iter,
                            *view)
