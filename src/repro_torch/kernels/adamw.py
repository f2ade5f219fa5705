"""AdamW over every leaf of a parameter tree in three launches: the
card's path of :func:`repro_torch.optim.adamw.update`.

The kernel is ``csrc/adamw.cu``. It replaces no TPU kernel: the JAX
package has no Pallas kernel for AdamW, and under ``jit`` XLA fused its
update into one loop. It is bound by bytes: 24 a parameter with bf16
parameters and gradients and f32 state (the norm reads g, 2; the update
reads g, m, v and p, 12, and writes p, m and v, 10); the eager loop that
``optim/adamw.py`` keeps as the plain version moves about eight times
as many in about 23 launches a leaf.

:class:`Leaves` lays one update's leaves out for the kernel: it allocates
the new parameters, ``m`` and ``v`` (``torch.empty_like``; nothing is
written in place) and copies one table of pointers, sizes and dtypes to
the card from pinned memory. :meth:`Leaves.sums_of_squares` then gives
each gradient leaf's f32 sum of squares in a fixed order (two launches),
and :meth:`Leaves.update` writes the outputs (one launch) from a
four-float device array ``[scale, bc1, bc2, lr]``, so nothing is read
back to the host.

Not a ``torch.library.custom_op``, unlike the other kernels here: a call
takes some 1,200 tensors, whose boxing through the dispatcher would cost
about a millisecond of host a step, and nothing traces it (``meta``
leaves and ``DTensor`` leaves take the loop).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .build import CudaKernel

__all__ = ["KERNEL", "CHUNK", "takes", "Leaves"]

_P = ctypes.c_void_p
_F = ctypes.c_float

KERNEL = CudaKernel(
    "adamw", "adamw.cu",
    {"adamw_norm_chunks": (_P, _P, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, _P, _P),
     "adamw_norm_leaves": (_P, ctypes.c_int, _P, _P, _P),
     "adamw_update": (_P, _P, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_longlong, _P, _F, _F, _F, _F, _F, _F, _P)},
    replaces="none: XLA fused src/repro/optim/adamw.py:update under jit")

#: elements a block takes (a multiple of the kernel's 8-element vectors:
#: 256 threads x 8 elements x 16 rounds)
CHUNK = 32768

#: the words of one leaf in the table: g, m, v, p, p_out, m_out, v_out,
#: element count, dtype bits (``csrc/adamw.cu``'s ``Leaf``)
_LEAF_WORDS = 9

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
#: (g, p, state dtype) -> the kernel's variant: bit 0 g bf16, bit 1 p
#: bf16, bit 2 m and v bf16
_VARIANTS = {(g, p, s): _BF16[g] | _BF16[p] << 1 | _BF16[s] << 2
             for g in _BF16 for p in _BF16 for s in _BF16}


def takes(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel takes an update's leaves: every one a plain
    tensor (not a subclass such as ``DTensor``) on a CUDA device. CPU,
    ``meta`` and ``DTensor`` leaves take the loop."""
    return bool(tensors) and all(type(t) is torch.Tensor and t.is_cuda
                                 for t in tensors)


class Leaves:
    """One update's leaves as the kernel reads them. ``g``, ``m``, ``v``
    and ``p`` are lists of CUDA tensors of one size a leaf (``m`` and
    ``v`` of ``state_dtype``); a non-contiguous one is read through a
    contiguous copy, kept as long as the table that points at it. Builds
    the outputs and the table on the card; the kernels launch on the
    current stream, as often as they are called."""

    def __init__(self, g: List[torch.Tensor], m: List[torch.Tensor],
                 v: List[torch.Tensor], p: List[torch.Tensor],
                 state_dtype: torch.dtype):
        if not len(g) == len(m) == len(v) == len(p):
            raise ValueError(f"AdamW trees of {len(g)}, {len(m)}, {len(v)} "
                             f"and {len(p)} leaves")
        self.device = p[0].device
        index = p[0].get_device()
        words: List[int] = []
        first = [0]
        chunks = 0
        # contiguous copies of non-contiguous leaves: the table points at
        # them, so they live as long as it does
        self._inputs = []
        self.p_out, self.m_out, self.v_out = [], [], []
        # the loop runs once a leaf, some 300 times a step: names bound
        # here, and numel rather than shape (a torch.Size costs more)
        empty_like, put = torch.empty_like, words.extend
        put_p, put_m, put_v = (self.p_out.append, self.m_out.append,
                               self.v_out.append)
        for gi, mi, vi, pi in zip(g, m, v, p):
            n = pi.numel()
            if not gi.numel() == mi.numel() == vi.numel() == n:
                raise ValueError(
                    "AdamW leaves of one index differ in size: "
                    f"{[tuple(t.shape) for t in (gi, mi, vi, pi)]}")
            if mi.dtype is not state_dtype or vi.dtype is not state_dtype:
                raise TypeError(f"AdamW state of {mi.dtype} and {vi.dtype}, "
                                f"not {state_dtype}")
            bits = _VARIANTS.get((gi.dtype, pi.dtype, state_dtype))
            if bits is None:
                raise TypeError(
                    f"the AdamW kernel takes bf16 or f32 gradients, "
                    f"parameters and state, got {gi.dtype}, {pi.dtype} and "
                    f"{state_dtype}")
            if not (gi.get_device() == mi.get_device() == vi.get_device() ==
                    pi.get_device() == index):
                raise ValueError("AdamW leaves on more than one device")
            if not (gi.is_contiguous() and mi.is_contiguous() and
                    vi.is_contiguous() and pi.is_contiguous()):
                gi, mi, vi, pi = (t.contiguous() for t in (gi, mi, vi, pi))
                self._inputs.append((gi, mi, vi, pi))
            po, mo, vo = empty_like(pi), empty_like(mi), empty_like(vi)
            put_p(po)
            put_m(mo)
            put_v(vo)
            put((gi.data_ptr(), mi.data_ptr(), vi.data_ptr(), pi.data_ptr(),
                 po.data_ptr(), mo.data_ptr(), vo.data_ptr(), n, bits))
            chunks -= -n // CHUNK
            first.append(chunks)
        self.n_leaves = len(first) - 1
        self.n_chunks = first[-1]
        # one copy from pinned memory; the host allocator keeps the pinned
        # block until the copy has run
        self.table = torch.tensor(words + first, dtype=torch.int64,
                                  pin_memory=True).to(self.device,
                                                      non_blocking=True)
        self._first = self.table.data_ptr() + 8 * _LEAF_WORDS * self.n_leaves
        self._stream = torch.cuda.current_stream(self.device).cuda_stream

    def sums_of_squares(self) -> torch.Tensor:
        """f32 ``[n_leaves]``: each gradient leaf's sum of its f32
        squares, summed in f64 in an order fixed by the shapes alone."""
        partial = torch.empty(self.n_chunks, dtype=torch.float64,
                              device=self.device)
        sums = torch.empty(self.n_leaves, dtype=torch.float32,
                           device=self.device)
        if self.n_chunks:
            KERNEL.launch("adamw_norm_chunks", self.table.data_ptr(),
                          self._first, self.n_leaves, CHUNK, self.n_chunks,
                          partial.data_ptr(), self._stream)
        KERNEL.launch("adamw_norm_leaves", self._first, self.n_leaves,
                      partial.data_ptr(), sums.data_ptr(), self._stream)
        return sums

    def update(self, scalars: torch.Tensor, *, b1: float, b2: float,
               eps: float, weight_decay: float
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                          List[torch.Tensor]]:
        """Write and return the new ``(p, m, v)`` leaves. ``scalars`` is a
        contiguous f32 device array ``[scale, bc1, bc2, lr]``: the clip
        scale (1 for no clip), the two bias corrections and the learning
        rate."""
        if (scalars.dtype != torch.float32 or scalars.shape != (4,) or
                scalars.device != self.device):
            raise ValueError(f"AdamW scalars must be f32 [4] on "
                             f"{self.device}, got {scalars.dtype}"
                             f"{list(scalars.shape)} on {scalars.device}")
        scalars = scalars.contiguous()
        if self.n_chunks:
            KERNEL.launch("adamw_update", self.table.data_ptr(), self._first,
                          self.n_leaves, CHUNK, self.n_chunks,
                          scalars.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps,
                          weight_decay, self._stream)
        return self.p_out, self.m_out, self.v_out
