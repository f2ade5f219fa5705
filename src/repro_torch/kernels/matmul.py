"""Matrix product on the card (paper §3.3): the port of the JAX package's
``kernels/matmul.py::pallas_matmul``.

The kernels are in ``csrc/matmul.cu``; its header says what bounds each
on an H100 and how it is laid out. Both are bound by operations at the
main path's shapes:

* f32 runs as IEEE f32 on the SIMT FMA pipes (67 TFLOP/s; the tensor
  cores would round to TF32): 128x128 tiles of C, 8x8 a thread in
  registers, K steps of 32 streamed through a three-stage ``cp.async``
  ring. A grid of 128x128 tiles that would leave SMs without a block
  takes 64x64 tiles (:func:`f32_tile`). An operand is copied 16 bytes a
  thread where its base and row pitch allow it, else 4 bytes a thread
  (:func:`f32_vector_loads`); the kernel reads both through their row
  pitch, so only an operand whose last axis is not contiguous is copied
  first (:func:`f32_operand`).
* bf16 runs on the tensor cores (989 TFLOP/s): ``wgmma`` on 128x256
  tiles of C (128x128 for small grids, :func:`bf16_tile`) from a
  four-stage ring that a producer warp fills by TMA. TMA reads a matrix
  in place only if its base and row pitch are multiples of 16 bytes
  (:func:`tma_ready`); any other operand is first copied to a buffer
  with a 16-byte row pitch (:func:`tma_operand`).

:func:`matmul` takes the plain version for CPU tensors and launches a
kernel for CUDA tensors; no shape or layout takes another path.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from . import ref
from .build import CudaKernel, device_sm_count

__all__ = ["KERNEL", "matmul", "kernel_info", "f32_operand",
           "f32_vector_loads", "f32_tile", "bf16_tile", "tma_ready",
           "tma_operand", "INSTANTIATIONS"]

_INFO_ARGS = (ctypes.c_int, ctypes.POINTER(ctypes.c_int),
              ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

KERNEL = CudaKernel(
    "matmul", "matmul.cu",
    {"matmul_f32": (_P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _P),
     "matmul_bf16": (_P, _P, _P, _I, _I, _I, _L, _L, _I, _P),
     "matmul_info": _INFO_ARGS},
    replaces="src/repro/kernels/matmul.py:39")

#: the compiled kernels, in ``matmul_info``'s order
INSTANTIATIONS = tuple(
    [f"f32 {t}x{t}, A {'16' if va else '4'}-byte, B {'16' if vb else '4'}-byte copies"
     for t in (128, 64) for va in (False, True) for vb in (False, True)]
    + [f"bf16 128x{t} wgmma + TMA" for t in (256, 128)])
#: f32 output tile edges: the large tile, and the one for small grids
F32_TILES = (128, 64)
#: bf16 output tile widths (128 rows): the large tile, and the one for
#: small grids
BF16_TILES = (256, 128)
#: alignment of a 16-byte copy (f32) and of TMA's base and row pitch
ALIGN = 16


def f32_operand(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``t`` as the f32 kernel reads it, and its row pitch in elements:
    the tensor itself when its last axis is contiguous (any row pitch,
    even 0 for rows broadcast by ``expand``), else a contiguous copy.
    A single row's pitch is never used and is given as 0."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, (t.stride(0) if t.shape[0] > 1 else 0)


def f32_vector_loads(t: torch.Tensor, ld: int) -> bool:
    """Whether the f32 kernel copies ``t`` (row pitch ``ld``) 16 bytes a
    thread: its base on 16 bytes and its row pitch a multiple of 4
    floats, so that no 16-byte chunk of a row straddles an alignment."""
    return t.data_ptr() % ALIGN == 0 and ld % 4 == 0


def _fills(rows: int, cols: int, m: int, n: int, sm_count: int) -> bool:
    """Whether a grid of ``rows x cols`` tiles over ``m x n`` holds at
    least one block for each SM."""
    return -(-m // rows) * -(-n // cols) >= sm_count


def f32_tile(m: int, n: int, sm_count: int) -> int:
    """The f32 output tile edge for an ``m x n`` product: 128, unless a
    grid of 128x128 tiles would hold fewer blocks than the card has SMs
    (the 512x512 quickstart: 16 blocks on 132 SMs); then 64."""
    big, small = F32_TILES
    return big if _fills(big, big, m, n, sm_count) else small


def bf16_tile(m: int, n: int, sm_count: int) -> int:
    """The bf16 output tile width (the tile has 128 rows): 256, unless a
    grid of 128x256 tiles would hold fewer blocks than the card has SMs;
    then 128."""
    big, small = BF16_TILES
    return big if _fills(128, big, m, n, sm_count) else small


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read the bf16 matrix ``t`` where it lies: its last
    axis contiguous, its base on 16 bytes, and (with more than one row)
    a positive row pitch that is a multiple of 16 bytes."""
    es = t.element_size()
    rows, cols = t.shape
    return ((cols <= 1 or t.stride(1) == 1) and t.data_ptr() % ALIGN == 0
            and (rows == 1 or (t.stride(0) > 0 and
                               t.stride(0) * es % ALIGN == 0)))


def tma_operand(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``t`` as the bf16 kernel reads it, and its row pitch in elements:
    the tensor itself where :func:`tma_ready`, else a copy into a fresh
    buffer whose row pitch is ``t``'s width rounded up to 16 bytes (the
    padding columns are never read: the tensor map spans the width)."""
    rows, cols = t.shape
    if not tma_ready(t):
        per = ALIGN // t.element_size()
        buf = torch.empty((rows, -(-cols // per) * per), dtype=t.dtype,
                          device=t.device)
        buf[:, :cols].copy_(t)
        t = buf[:, :cols]
    return t, t.stride(0)


def kernel_info() -> List[Dict[str, object]]:
    """Each compiled B1 kernel (:data:`INSTANTIATIONS`): registers a
    thread, local (spill) bytes a thread and dynamic shared memory a
    block. Builds the library; launches nothing."""
    out = []
    for which, name in enumerate(INSTANTIATIONS):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        KERNEL.query("matmul_info", which, ctypes.byref(regs),
                     ctypes.byref(local), ctypes.byref(smem))
        out.append({"kernel": name, "registers": regs.value,
                    "spill_bytes": local.value, "smem_bytes": smem.value})
    return out


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"matmul kernel needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul kernel takes f32 or bf16 pairs, got "
                        f"{a.dtype} and {b.dtype}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if not c.numel():
        return c
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if a.dtype == torch.float32:
        a, lda = f32_operand(a)
        b, ldb = f32_operand(b)
        KERNEL.launch("matmul_f32", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      m, n, k, lda, ldb, int(f32_vector_loads(a, lda)),
                      int(f32_vector_loads(b, ldb)),
                      f32_tile(m, n, device_sm_count(a.device.index)), stream)
    else:
        a, lda = tma_operand(a)
        b, ldb = tma_operand(b)
        KERNEL.launch("matmul_bf16", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      m, n, k, lda, ldb,
                      bf16_tile(m, n, device_sm_count(a.device.index)), stream)
    return c


@_matmul_cuda.register_fake
def _(a, b):
    return a.new_empty((a.shape[0], b.shape[1]))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in f32 and cast to ``a``'s dtype."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.matmul(a, b)
    return _matmul_cuda(a, b)
