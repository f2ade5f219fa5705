"""The LSD radix sort on the card (paper §4): the port of the JAX package's
``kernels/radix_sort.py::pallas_radix_pass`` and of the digit offsets and
scatter that its ``ops.radix_sort`` leaves to XLA.

One library, ``csrc/radix_pass.cu``, exports three launch functions built
on one device function (warp ``__match_any_sync`` ranks and a per-warp
count table in shared memory):

* :func:`radix_pass`: the TPU kernel's own contract, one digit's
  per-block histogram and stable ranks. No sort launches it.
* :func:`radix_histogram`: the digit counts of every pass from one read of
  the keys.
* :func:`radix_onesweep`: one digit pass with the offsets (a decoupled
  look-back across tiles) and the scatter of keys and an int32 payload
  inside the kernel.

``ops.radix_sort`` is one :func:`radix_histogram` and one
:func:`radix_onesweep` a pass. Each wrapper takes the plain version of
:mod:`.ref` for CPU tensors and launches its kernel for CUDA tensors.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from . import ref
from .build import CudaKernel

__all__ = ["KERNEL", "TILE", "MAX_KEYS", "OnesweepScratch", "radix_pass",
           "radix_histogram", "radix_onesweep", "kernel_info"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_INT_P = ctypes.POINTER(ctypes.c_int)

KERNEL = CudaKernel(
    "radix_pass", "radix_pass.cu",
    {"radix_pass": (_P, _L, _I, _I, _I, _P, _P, _P),
     "radix_histogram": (_P, _L, _I, _P, _I, _P),
     "radix_onesweep": (_P, _P, _P, _P, _L, _I, _I, _P, _I, _P, _P, _P),
     "radix_info": (_I, _INT_P, _INT_P, _INT_P)},
    replaces="src/repro/kernels/radix_sort.py:52")

#: keys of a radix_onesweep tile (the kernel's kTile: 256 threads x 16
#: keys); the launcher refuses a status array sized for another tile
TILE = 4096
#: the int32 payload limits a sort to fewer keys than this
MAX_KEYS = 1 << 31
#: the kernels radix_info reports on, in its order
INFO_KERNELS = ("radix_histogram", "radix_onesweep")
#: radix_histogram's grid: this many blocks an SM at most, and at least
#: this many keys a block
_HIST_BLOCKS_PER_SM = 8
_HIST_KEYS_PER_BLOCK = 1024


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


def _check_sort_keys(what: str, keys: torch.Tensor, bits: int) -> None:
    if keys.dim() != 1 or keys.dtype != torch.uint32:
        raise ValueError(f"{what} takes 1-d uint32 keys, got "
                         f"{keys.dtype}{list(keys.shape)}")
    if keys.shape[0] >= MAX_KEYS:
        raise ValueError(f"{what}: {keys.shape[0]} keys; the int32 payload "
                         f"holds fewer than 2**31")
    if not 1 <= bits <= 8:
        raise ValueError(f"{what}: digits of {bits} bits; the kernel takes "
                         "1..8")


# -- radix_pass: the TPU kernel's contract ------------------------------------
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


# -- radix_histogram ----------------------------------------------------------
@torch.library.custom_op("repro_torch::radix_histogram", mutates_args=())
def _radix_histogram_cuda(keys: torch.Tensor, bits: int) -> torch.Tensor:
    if not keys.is_cuda:
        raise ValueError(f"radix_histogram kernel needs a CUDA tensor, got "
                         f"{keys.device}")
    keys = keys.contiguous()
    n = keys.shape[0]
    hist = torch.zeros((32 // bits, 1 << bits), dtype=torch.int32,
                       device=keys.device)
    if n:
        sms = torch.cuda.get_device_properties(
            keys.device).multi_processor_count
        blocks = min(-(-n // _HIST_KEYS_PER_BLOCK), _HIST_BLOCKS_PER_SM * sms)
        KERNEL.launch("radix_histogram", keys.data_ptr(), n, bits,
                      hist.data_ptr(), blocks,
                      torch.cuda.current_stream(keys.device).cuda_stream)
    return hist


@_radix_histogram_cuda.register_fake
def _(keys, bits):
    return keys.new_empty((32 // bits, 1 << bits), dtype=torch.int32)


def radix_histogram(keys: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """``hist[32 // bits, 2**bits]`` int32: row ``p`` counts the keys whose
    digit ``(key >> p * bits) & (2**bits - 1)`` is each value. ``bits``
    divides 32."""
    _check_sort_keys("radix_histogram", keys, bits)
    if 32 % bits:
        raise ValueError(f"radix_histogram: bits={bits} must divide 32")
    if keys.device.type == "cpu":
        return ref.radix_histogram(keys, bits)
    return _radix_histogram_cuda(keys, bits)


# -- radix_onesweep -----------------------------------------------------------
class OnesweepScratch:
    """The buffers of ``passes`` onesweep passes over ``n`` keys, allocated
    at once: two key and two int32 payload buffers that the passes write in
    turn (pass ``p`` reads what pass ``p - 1`` wrote), and for each pass its
    zeroed look-back status words and tile counter. :meth:`take` hands each
    pass its share once, so no status word is read twice and no kernel has
    to zero one."""

    def __init__(self, n: int, bits: int, device, passes: int):
        nbins, tiles = 1 << bits, max(1, -(-n // TILE))
        self.keys = [torch.empty(n, dtype=torch.uint32, device=device)
                     for _ in range(min(passes, 2))]
        self.idx = [torch.empty(n, dtype=torch.int32, device=device)
                    for _ in range(min(passes, 2))]
        self.status = torch.zeros((passes, tiles * nbins), dtype=torch.int64,
                                  device=device)
        self.counters = torch.zeros(passes, dtype=torch.int32, device=device)
        self.passes, self.taken = passes, 0

    def take(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """The next pass's ``(keys_out, idx_out, status, counter)``."""
        p = self.taken
        if p >= self.passes:
            raise RuntimeError(f"OnesweepScratch of {self.passes} passes is "
                               "used up")
        self.taken += 1
        return (self.keys[p % 2], self.idx[p % 2], self.status[p],
                self.counters[p:p + 1])


@torch.library.custom_op(
    "repro_torch::radix_onesweep",
    mutates_args=("keys_out", "idx_out", "status", "counter"))
def _radix_onesweep_cuda(keys: torch.Tensor, idx: Optional[torch.Tensor],
                         digit_counts: torch.Tensor, keys_out: torch.Tensor,
                         idx_out: torch.Tensor, status: torch.Tensor,
                         counter: torch.Tensor, bits: int, shift: int) -> None:
    tensors = (keys, digit_counts, keys_out, idx_out, status, counter,
               *(() if idx is None else (idx,)))
    if not all(t.is_cuda and t.device == keys.device for t in tensors):
        raise ValueError("radix_onesweep kernel needs every tensor on one "
                         "CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    n = keys.shape[0]
    if not all(t.is_contiguous() for t in tensors[2:6]):
        raise ValueError("radix_onesweep: outputs and scratch must be "
                         "contiguous")
    if keys_out.shape != keys.shape or idx_out.shape != keys.shape:
        raise ValueError(f"radix_onesweep: outputs of {keys_out.shape[0]} "
                         f"and {idx_out.shape[0]} words for {n} keys")
    if keys_out.data_ptr() == keys.data_ptr() or (
            idx is not None and idx_out.data_ptr() == idx.data_ptr()):
        raise ValueError("radix_onesweep: an output is also its input")
    if status.numel() < max(1, -(-n // TILE)) * (1 << bits):
        raise ValueError(f"radix_onesweep: {status.numel()} status words "
                         f"are too few for {n} keys")
    if n:
        keys, digit_counts = keys.contiguous(), digit_counts.contiguous()
        idx = None if idx is None else idx.contiguous()
        KERNEL.launch("radix_onesweep", keys.data_ptr(),
                      None if idx is None else idx.data_ptr(),
                      keys_out.data_ptr(), idx_out.data_ptr(), n, shift, bits,
                      digit_counts.data_ptr(), TILE, status.data_ptr(),
                      counter.data_ptr(),
                      torch.cuda.current_stream(keys.device).cuda_stream)


@_radix_onesweep_cuda.register_fake
def _(keys, idx, digit_counts, keys_out, idx_out, status, counter, bits,
      shift):
    return None


def radix_onesweep(keys: torch.Tensor, idx: Optional[torch.Tensor],
                   digit_counts: torch.Tensor, bits: int = 8, shift: int = 0,
                   *, scratch: Optional[OnesweepScratch] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stable LSD pass: ``(keys, idx)`` ordered by the digit
    ``(key >> shift) & (2**bits - 1)``, equal digits in input order.

    ``idx`` is an int32 payload of ``keys``'s length, or None for each
    key's position (a sort's first pass); ``digit_counts`` is
    the pass's row of :func:`radix_histogram` (the keys' count of each
    digit), which the kernel scans into each digit's first output index.
    On the card the outputs are ``scratch``'s buffers for the next pass
    (by default a scratch of one pass is allocated); see
    :func:`repro_torch.kernels.ref.radix_onesweep` for the contract.
    """
    _check_sort_keys("radix_onesweep", keys, bits)
    if not 0 <= shift <= 32 - bits:
        raise ValueError(f"radix_onesweep: shift={shift} puts a {bits}-bit "
                         "digit outside the key")
    if idx is not None and (idx.shape != keys.shape or
                            idx.dtype != torch.int32):
        raise ValueError(f"radix_onesweep takes an int32 payload of the "
                         f"keys' shape, got {idx.dtype}{list(idx.shape)}")
    if digit_counts.shape != (1 << bits,) or digit_counts.dtype != torch.int32:
        raise ValueError(f"radix_onesweep: digit_counts must be int32"
                         f"[{1 << bits}], got {digit_counts.dtype}"
                         f"{list(digit_counts.shape)}")
    if keys.device.type == "cpu":
        return ref.radix_onesweep(keys, idx, digit_counts, bits, shift)
    if scratch is None:
        scratch = OnesweepScratch(keys.shape[0], bits, keys.device, passes=1)
    keys_out, idx_out, status, counter = scratch.take()
    _radix_onesweep_cuda(keys, idx, digit_counts, keys_out, idx_out, status,
                         counter, bits, shift)
    return keys_out, idx_out


def kernel_info() -> List[Dict[str, object]]:
    """Each kernel of :data:`INFO_KERNELS`: registers a thread, local
    (spill) bytes a thread and static shared memory a block. Builds the
    library; launches nothing."""
    out = []
    for which, name in enumerate(INFO_KERNELS):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        KERNEL.query("radix_info", which, ctypes.byref(regs),
                     ctypes.byref(local), ctypes.byref(smem))
        out.append({"kernel": name, "registers": regs.value,
                    "spill_bytes": local.value, "smem_bytes": smem.value})
    return out
