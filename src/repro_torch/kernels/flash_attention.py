"""Flash attention forward on the card: the port of the JAX package's
``kernels/flash_attention.py::pallas_flash_attention``.

The kernel is ``csrc/flash_attention.cu``: one block per (batch, head,
64-query tile), an online softmax in f32 over 64-key tiles staged in
shared memory, GQA by indexing the K/V head, causal and local-window
masks on right-aligned positions, and the key tiles outside the masks
skipped. :func:`flash_attention` takes the plain version for CPU tensors
and launches the kernel for CUDA tensors; there is no other path.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "flash_attention"]

_STRIDES = ctypes.c_longlong * 3
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
         ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_void_p)
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 64, 128)

KERNEL = CudaKernel("flash_attention", "flash_attention.cu",
                    {name: _ARGS for name in _FN.values()},
                    replaces="src/repro/kernels/flash_attention.py:88")


def _strides(t: torch.Tensor) -> "ctypes.Array":
    return _STRIDES(*t.stride()[:3])


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int, scale: float
                          ) -> torch.Tensor:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if out.numel():
        KERNEL.launch(_FN[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), _strides(q), _strides(k), _strides(v),
                      b, h, hkv, sq, skv, d, int(causal), window, scale,
                      torch.cuda.current_stream(q.device).cuda_stream)
    return out


@_flash_attention_cuda.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``[B,H,Sq,D]`` over k, v ``[B,Hkv,Skv,D]`` (Hkv
    divides H), with right-aligned query positions; the output has q's
    shape and dtype. A query that sees no key gives 0."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {q.shape[3]}")
    return _flash_attention_cuda(q, k, v, causal, window or 0, scale)
