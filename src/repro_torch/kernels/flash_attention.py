"""Flash attention forward on the card: the port of the JAX package's
``kernels/flash_attention.py::pallas_flash_attention``.

The kernels are in ``csrc/flash_attention.cu``. bf16 runs on the Hopper
tensor cores: one block per (head, batch, 128-query tile), a producer
warp loading K and V tiles by TMA into a two-stage ring, two consumer
warpgroups computing S = QKᵀ and O += PV with ``wgmma`` and the online
softmax in registers. f32 runs as IEEE f32 on the SIMT FMA pipes: one
256-thread block per (head, batch, query tile), K and V tiles of 64 keys
copied by ``cp.async`` under the FMAs, 8 rows x 4 keys of S and 8 rows x
8 columns of O a thread in registers, the softmax in registers. Its
query tile is 128 rows, or 64 where a grid of 128-row tiles would leave
SMs without a block, and always 64 above head dim 128, where a 128-row
tile does not fit in shared memory or its output in registers
(:func:`f32_query_tile`); bf16 takes key tiles of 64 there for the same
reasons. Both take GQA by indexing the K/V head, causal and local-window
masks on right-aligned positions, and skip the key tiles outside the
masks. Like the TPU kernel, both take any head dim D >= 1. Up to
:data:`MAX_KERNEL_WIDTH` each is built for the widths :data:`HEAD_DIMS`,
and a head dim runs on the next width up (:func:`kernel_width`), its
tiles zero-filled past it. Above it O is cut into n slabs of one of
:data:`SLAB_WIDTHS` (:func:`kernel_slabs`), each computed by its own
block, which takes S = QKᵀ over the whole head dim in panels (bf16) or
chunks (f32) of Q and K streamed through shared memory: S is computed
once a slab. :func:`flash_attention` takes the plain version for CPU
tensors and launches a kernel for CUDA tensors, once a call; there is no
other path.

TMA reads a tensor where it lies only if its base address and outer
strides are multiples of 16 bytes; :func:`kernel_operand` decides, per
tensor, whether it is passed through or copied first to rows at a
16-byte pitch, so every bf16 shape still reaches the kernel. The f32
kernel reads any tensor whose last axis is contiguous, 16 bytes a thread
where the base and strides allow it and 4 bytes a thread elsewhere
(:func:`f32_vector_loads`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from .. import trace
from . import ref
from .build import CudaKernel, device_sm_count

__all__ = ["KERNEL", "HEAD_DIMS", "MAX_KERNEL_WIDTH", "SLAB_WIDTHS",
           "F32_QUERY_TILES", "flash_attention", "kernel_width",
           "kernel_slabs", "kernel_info",
           "kernel_operand", "tma_ready", "f32_vector_loads",
           "f32_query_tiles", "f32_query_tile"]

_STRIDES = ctypes.c_longlong * 3
#: q, k, v, out; their strides; batch, heads, KV heads, Sq, Skv, the head
#: dim, the kernel's width, causal, window; the scale; the stream
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
         ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p)
#: the f32 launch also takes the query tile and the copy widths (bits)
_F32_ARGS = _ARGS[:-1] + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
#: the slab launches take the number of slabs after the width; f32 also
#: the copy widths
_SLAB_ARGS = _ARGS[:14] + (ctypes.c_int,) + _ARGS[14:]
_F32_SLAB_ARGS = _SLAB_ARGS[:-1] + (ctypes.c_int, ctypes.c_void_p)
_INFO_ARGS = (ctypes.c_int, ctypes.POINTER(ctypes.c_int),
              ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
_F32_INFO_ARGS = (ctypes.c_int,) + _INFO_ARGS
_DTYPES = (torch.float32, torch.bfloat16)
#: widths the kernels are built for: the smoke configs' 16, whisper-tiny's
#: 64, the 128 of the dense, moe and vlm configs, nemotron-4-340b's 192,
#: recurrentgemma-9b's 256, and 32, 96 and 160 between them, so that a
#: head dim above 16 runs less than 2x wide and one above 64 less than
#: 1.5x (phi-2's 80 and phi-3-mini's 96 on 96)
HEAD_DIMS = (16, 32, 64, 96, 128, 160, 192, 256)
#: the widest kernel: a head dim above it runs in slabs
MAX_KERNEL_WIDTH = HEAD_DIMS[-1]
#: widths of the slabs that head dims above MAX_KERNEL_WIDTH run in: with
#: the fewest columns, no head dim from 257 to 4096 runs more than 1.25x
#: wide (the worst, 385, on 3 x 160)
SLAB_WIDTHS = (128, 160, 192, 256)
#: f32 query tiles (rows a block): the large tile, and the one for grids
#: that would leave SMs without a block
F32_QUERY_TILES = (128, 64)
#: the widest kernel with the large f32 tile: at 192 its Q, K, V and P
#: take 242 KB of shared memory, at 256 300 KB, more than an SM has; at 160
#: its 80 f32 of O a thread would not fit in registers
F32_LARGE_TILE_MAX_D = 128
#: TMA's alignment of a tensor's base address and strides, in bytes, and
#: that of the f32 kernel's 16-byte copies
TMA_ALIGN = 16
#: how the bf16 kernel feeds P to the P·V product: two bf16 halves of the
#: f32 probabilities, hi = bf16(P) and lo = bf16(P - hi), into one f32
#: accumulator (``csrc/flash_attention.cu``)
PV_VARIANT = "P split into bf16 hi + lo, two wgmma per k16 step"

KERNEL = CudaKernel("flash_attention", "flash_attention.cu",
                    {"flash_attention_f32": _F32_ARGS,
                     "flash_attention_bf16": _ARGS,
                     "flash_attention_f32_slabs": _F32_SLAB_ARGS,
                     "flash_attention_bf16_slabs": _SLAB_ARGS,
                     "flash_attention_f32_info": _F32_INFO_ARGS,
                     "flash_attention_bf16_info": _INFO_ARGS,
                     "flash_attention_f32_slabs_info": _INFO_ARGS,
                     "flash_attention_bf16_slabs_info": _INFO_ARGS},
                    replaces="src/repro/kernels/flash_attention.py:88")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` (``[B,H,S,D]``) where it lies: the last
    axis contiguous, and the base address and the stride of every other
    axis longer than 1 a positive multiple of 16 bytes."""
    es = t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % TMA_ALIGN == 0 and all(
        n == 1 or (st > 0 and st * es % TMA_ALIGN == 0)
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def kernel_slabs(d: int) -> tuple:
    """How head dim ``d`` runs: ``(n, w)``, n slabs of the kernel of width
    w, whose output rows are n w wide. Up to :data:`MAX_KERNEL_WIDTH` one
    slab of the smallest of :data:`HEAD_DIMS` not below ``d``; above it
    the fewest columns n w >= d over :data:`SLAB_WIDTHS`, a tie to the
    fewer slabs. Raises ``ValueError`` below 1."""
    if d < 1:
        raise ValueError(f"flash_attention kernel takes head dims >= 1, "
                         f"got {d}")
    if d <= MAX_KERNEL_WIDTH:
        return 1, next(w for w in HEAD_DIMS if w >= d)
    return min(((-(-d // w), w) for w in SLAB_WIDTHS),
               key=lambda nw: (nw[0] * nw[1], nw[0]))


def kernel_width(d: int) -> int:
    """The width of the kernel that runs head dim ``d``: the width of its
    slabs (:func:`kernel_slabs`)."""
    return kernel_slabs(d)[1]


def kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel of its dtype reads it: the tensor itself where
    it can (bf16: :func:`tma_ready`; f32: last axis contiguous), else a
    copy that can: f32 contiguous, bf16 into rows whose pitch is the head
    dim rounded up to 16 bytes (a view of those rows; the padding columns
    are never read, the tensor maps span the head dim)."""
    if t.dtype != torch.bfloat16:
        return t if t.stride(-1) == 1 else \
            t.clone(memory_format=torch.contiguous_format)
    if tma_ready(t):
        return t
    per = TMA_ALIGN // t.element_size()
    d = t.shape[-1]
    buf = torch.empty((*t.shape[:-1], -(-d // per) * per), dtype=t.dtype,
                      device=t.device)
    buf[..., :d].copy_(t)
    return buf[..., :d]


def f32_vector_loads(t: torch.Tensor) -> bool:
    """Whether the f32 kernel copies ``t`` (``[B,H,S,D]``, last axis
    contiguous) 16 bytes a thread: its base on 16 bytes, D and the stride
    of every other axis longer than 1 multiples of 4 floats, so that no
    row's 16-byte chunk straddles an alignment or the row's end. Else 4
    bytes a thread."""
    return t.data_ptr() % TMA_ALIGN == 0 and t.shape[-1] % 4 == 0 and all(
        n == 1 or st % 4 == 0 for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def f32_query_tiles(d: int) -> tuple:
    """The f32 kernel's query tiles built for head dim ``d``'s width
    (:func:`kernel_width`): both of :data:`F32_QUERY_TILES`, or only 64
    rows above :data:`F32_LARGE_TILE_MAX_D` and in slabs."""
    n, width = kernel_slabs(d)
    return F32_QUERY_TILES if n == 1 and width <= F32_LARGE_TILE_MAX_D \
        else F32_QUERY_TILES[1:]


def f32_query_tile(batch: int, heads: int, sq: int, sm_count: int,
                   d: int = 128) -> int:
    """The f32 kernel's query tile for a grid of ``batch x heads`` blocks
    over ``sq`` queries at head dim ``d``: 128 rows, unless 128-row tiles
    would give fewer blocks than the card has SMs (qwen3-1.7b's 1 x 16
    heads x 512: 64 blocks on 132 SMs), or ``d`` has only the 64-row tile
    (:func:`f32_query_tiles`); then 64."""
    big, small = F32_QUERY_TILES
    if big not in f32_query_tiles(d):
        return small
    return big if batch * heads * -(-sq // big) >= sm_count else small


def _strides(t: torch.Tensor) -> "ctypes.Array":
    return _STRIDES(*t.stride()[:3])


def kernel_info(d: int, dtype: torch.dtype = torch.bfloat16,
                query_tile: int = F32_QUERY_TILES[0]) -> Dict[str, object]:
    """The kernel of ``dtype`` that runs head dim ``d`` (the one built
    for :func:`kernel_slabs` of it; f32 up to :data:`MAX_KERNEL_WIDTH`:
    and ``query_tile``, in slabs always 64) as compiled: registers a
    thread, local (spill) bytes a thread and dynamic shared memory a
    block; bf16 also says how P enters the P·V product. Builds the
    library; launches nothing."""
    slabs, width = kernel_slabs(d)
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    out = ctypes.byref(regs), ctypes.byref(local), ctypes.byref(smem)
    kind = "_slabs" if slabs > 1 else ""
    if dtype == torch.float32:
        if slabs > 1:
            query_tile = F32_QUERY_TILES[1]
            KERNEL.query("flash_attention_f32_slabs_info", width, *out)
        else:
            KERNEL.query("flash_attention_f32_info", width, query_tile, *out)
        extra = {"query_tile": query_tile}
    else:
        KERNEL.query(f"flash_attention_bf16{kind}_info", width, *out)
        extra = {"pv": PV_VARIANT}
    return {"head_dim": d, "kernel_width": width, "slabs": slabs,
            "dtype": str(dtype),
            "registers": regs.value, "spill_bytes": local.value,
            "smem_bytes": smem.value, **extra}


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, window: int, scale: float
                          ) -> torch.Tensor:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    with trace.span("kernel.flash_attention"):
        b, h, sq, d = q.shape
        hkv, skv = k.shape[1], k.shape[2]
        slabs, width = kernel_slabs(d)
        q, k, v = (kernel_operand(t) for t in (q, k, v))
        out = torch.empty((b, h, sq, slabs * width), dtype=q.dtype,
                          device=q.device)
        if not out.numel():
            return out[..., :d]
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _strides(q), _strides(k), _strides(v), b, h, hkv, sq, skv, d,
                width) + ((slabs,) if slabs > 1 else ()) + (
                    int(causal), window, scale)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kind = "_slabs" if slabs > 1 else ""
        if q.dtype == torch.float32:
            vec = sum(int(f32_vector_loads(t)) << i
                      for i, t in enumerate((q, k, v)))
            if slabs == 1:
                args += (f32_query_tile(
                    b, h, sq, device_sm_count(q.device.index), d),)
            KERNEL.launch(f"flash_attention_f32{kind}", *args, vec, stream)
        else:
            KERNEL.launch(f"flash_attention_bf16{kind}", *args, stream)
        return out[..., :d]


@_flash_attention_cuda.register_fake
def _(q, k, v, causal, window, scale):
    b, h, sq, d = q.shape
    slabs, width = kernel_slabs(d)
    return q.new_empty((b, h, sq, slabs * width))[..., :d]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q ``[B,H,Sq,D]`` over k, v ``[B,Hkv,Skv,D]`` (Hkv
    divides H), with right-aligned query positions; the output has q's
    shape and dtype. A query that sees no key gives 0. On the card the
    output is the first D columns of rows n w wide, ``(n, w) =``
    :func:`kernel_slabs` (D): contiguous where D is one of
    :data:`HEAD_DIMS` or n w."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    scale = q.shape[3] ** -0.5 if scale is None else scale
    if q.device.type == "cpu" and k.device.type == "cpu" and \
            v.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return _flash_attention_cuda(q, k, v, causal, window or 0, scale)
